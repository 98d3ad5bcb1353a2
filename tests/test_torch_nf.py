"""NF quantization in the PyTorch port gives the JAX package's codes
exactly and its scales and tables in f32, on the same weights."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flute_tpu.quantize import nf as jnf
from flute_tpu_torch.quantize import nf

GROUP = 64


def weights(dtype, seed):
    w = np.random.default_rng(seed).standard_normal((128, 512)).astype(np.float32)
    if dtype == "bfloat16":
        wj = jnp.asarray(w, jnp.bfloat16)
        wt = torch.from_numpy(w).to(torch.bfloat16)
    else:
        wj = jnp.asarray(w)
        wt = torch.from_numpy(w)
    # the bf16 rounding is the same in both frameworks
    np.testing.assert_array_equal(np.asarray(wj, np.float32), wt.float().numpy())
    return wj, wt


@pytest.mark.parametrize("bits", [2, 3, 4])
def test_nf_values_equal(bits):
    for sym in (False, True):
        np.testing.assert_array_equal(
            nf.nf_values(bits, symmetric=sym), np.asarray(jnf.nf_values(bits, sym))
        )
    np.testing.assert_array_equal(
        nf.nf_values_symmetric_exact(bits), jnf.nf_values_symmetric_exact(bits)
    )


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("bits", [3, 4])
def test_nf_quantize_matches(dtype, bits):
    wj, wt = weights(dtype, seed=bits)
    deq_j, codes_j, scales_j, table_j = jnf.nf_quantize(wj, bits, GROUP)
    deq_t, codes_t, scales_t, table_t = nf.nf_quantize(wt, bits, GROUP)
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_array_equal(scales_t.numpy(), np.asarray(scales_j, np.float32))
    np.testing.assert_array_equal(table_t.numpy(), np.asarray(table_j))
    np.testing.assert_allclose(deq_t.numpy(), np.asarray(deq_j), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_nf_quantize_symmetric_matches(dtype):
    wj, wt = weights(dtype, seed=9)
    _, codes_j, scales_j, table_j = jnf.nf_quantize_symmetric(wj, 4, GROUP)
    _, codes_t, scales_t, table_t = nf.nf_quantize_symmetric(wt, 4, GROUP)
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_array_equal(scales_t.numpy(), np.asarray(scales_j, np.float32))
    np.testing.assert_array_equal(table_t.numpy(), np.asarray(table_j))


def test_custom_scales_and_zero_groups():
    w = np.random.default_rng(2).standard_normal((16, 128)).astype(np.float32)
    w[3, :GROUP] = 0.0  # an all-zero group gets scale 1 in both
    cs = np.abs(np.random.default_rng(3).standard_normal((16, 2))).astype(np.float32)
    values = nf.nf_values(4)
    for custom in (None, cs):
        _, cj, sj = jnf.quantize_with_table(
            jnp.asarray(w), jnp.asarray(values), GROUP,
            None if custom is None else jnp.asarray(custom),
        )
        _, ct, st = nf.quantize_with_table(
            torch.from_numpy(w), values, GROUP,
            None if custom is None else torch.from_numpy(custom),
        )
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("symmetric", [False, True])
def test_nf_quantize_fake_matches(symmetric):
    w = np.random.default_rng(4).standard_normal((64, 256)).astype(np.float32)
    want = jnf.nf_quantize_fake(jnp.asarray(w), 4, GROUP, jnp.bfloat16, symmetric=symmetric)
    got = nf.nf_quantize_fake(torch.from_numpy(w), 4, GROUP, torch.bfloat16, symmetric=symmetric)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("custom", [False, True])
@pytest.mark.parametrize("bits", [2, 3, 4])
def test_numpy_helpers_match(bits, custom):
    """The host-side twins of the streaming quantizer: codes, scales and
    tables bit-equal to JAX's, with an all-zero group and custom scales."""
    rng = np.random.default_rng(20 + bits)
    w = rng.standard_normal((64, 512)).astype(np.float32)
    w[5, :GROUP] = 0.0
    cs = np.abs(rng.standard_normal((64, 512 // GROUP))).astype(np.float32) if custom else None
    values = nf.nf_values(bits)
    got = nf.quantize_with_table_np(w, values, GROUP, cs)
    want = jnf.quantize_with_table_np(w, np.asarray(jnf.nf_values(bits)), GROUP, cs)
    for g, x in zip(got, want):
        assert g.dtype == x.dtype
        np.testing.assert_array_equal(g, x)
    for g, x in zip(nf.nf_quantize_np(w, bits, GROUP, cs), jnf.nf_quantize_np(w, bits, GROUP, cs)):
        np.testing.assert_array_equal(g, np.asarray(x))
    if bits == 4:
        got = nf.nf_quantize_symmetric_np(w, bits, GROUP, cs)
        want = jnf.nf_quantize_symmetric_np(w, bits, GROUP, cs)
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g, x)
