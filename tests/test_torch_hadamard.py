"""The port's Hadamard rotation against the JAX package's.

The same seeded inputs go through ``flute_tpu.ops.hadamard`` and
``flute_tpu_torch.ops.hadamard`` on the CPU. Both take the products in f32,
scale in f32 and round once, so in bf16 they agree within one bf16 ulp (the
f32 sums may be added in another order) and in f32 to f32 rounding.
``qgemm_hadamard`` equals the rotation followed by the GEMM exactly, as the
JAX package's own test requires, and agrees with JAX's within the bf16
threshold.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flute_tpu import packing as jpacking
from flute_tpu.ops import hadamard as jhad
from flute_tpu.ops import lut_gemm as jlut
from flute_tpu.quantize import nf as jnf
from flute_tpu_torch import packing
from flute_tpu_torch.ops import hadamard, lut_gemm


def within_one_bf16_ulp(got: torch.Tensor, want) -> bool:
    """Every element of ``got`` is within one bf16 ulp of ``want``'s."""
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    mag = np.maximum(np.abs(w), np.finfo(np.float32).tiny)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    return bool(np.all(np.abs(g - w) <= ulp))


def inputs(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("log2n", range(1, 13))
def test_hadamard_transform_matches_jax(log2n):
    n = 2**log2n
    x = inputs((4, n), log2n)
    got = hadamard.hadamard_transform(torch.from_numpy(x).bfloat16())
    want = jhad.hadamard_transform(jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    assert within_one_bf16_ulp(got, want)
    got32 = hadamard.hadamard_transform(torch.from_numpy(x))
    want32 = np.asarray(jhad.hadamard_transform(jnp.asarray(x)))
    np.testing.assert_allclose(got32.numpy(), want32, rtol=1e-5, atol=1e-6)
    # against the dense matrix, as the JAX package's test holds it
    h = jhad._hadamard_matrix_np(n) / np.sqrt(n)
    np.testing.assert_allclose(got32.numpy(), x @ h, atol=1e-3)


def test_hadamard_matrix_and_scale():
    np.testing.assert_array_equal(hadamard.hadamard_matrix(16).numpy(),
                                  np.asarray(jhad.hadamard_matrix(16)))
    x = inputs((3, 1024), 20)
    twice = hadamard.hadamard_transform(hadamard.hadamard_transform(torch.from_numpy(x)))
    np.testing.assert_allclose(twice.numpy(), x, atol=1e-3)  # orthonormal involution
    got = hadamard.hadamard_transform(torch.from_numpy(x), scale=1.0)
    want = jhad.hadamard_transform(jnp.asarray(x), scale=1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    for bad in (3, 2**16):
        with pytest.raises(ValueError, match="power of two"):
            hadamard.hadamard_transform(torch.zeros(1, bad))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("had", [64, 128, 512])
def test_grouped_hadamard_matches_jax(had, dtype):
    x = inputs((2, 3, 1024), had)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = hadamard.grouped_hadamard_transform(torch.from_numpy(x).to(tdt), had)
    want = jhad.grouped_hadamard_transform(jnp.asarray(x, jdt), had)
    assert got.shape == x.shape and got.dtype == tdt
    if dtype == "bfloat16":
        assert within_one_bf16_ulp(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="multiple"):
        hadamard.grouped_hadamard_transform(torch.from_numpy(x), 48)


@pytest.mark.parametrize("bits", [2, 4])
def test_qgemm_hadamard_matches_jax(bits):
    rng = np.random.default_rng(3)
    k, n, g = 256, 256, 64
    codes = rng.integers(0, 2**bits, (k, n), dtype=np.int32)
    planes = jpacking.pack(codes, bits)
    scales = rng.uniform(0.5, 1.5, (k // g, n)).astype(np.float32)
    table = np.array(jnf.nf_values(bits), np.float32)
    x = rng.standard_normal((3, k)).astype(np.float32)
    want = jhad.qgemm_hadamard(jnp.asarray(x, jnp.bfloat16), planes,
                               jnp.asarray(scales, jnp.bfloat16), jnp.asarray(table), bits, g,
                               hadamard_size=128)
    tplanes = packing.pack_plane(torch.from_numpy(codes), bits)
    ts = torch.from_numpy(scales).bfloat16()
    tt = torch.from_numpy(table)
    xt = torch.from_numpy(x).bfloat16()
    got = hadamard.qgemm_hadamard(xt, tplanes, ts, tt, bits, g, hadamard_size=128)
    # the fusion is the rotation followed by the GEMM, exactly
    xr = hadamard.grouped_hadamard_transform(xt, 128)
    assert torch.equal(got, lut_gemm.lut_qgemm(xr, tplanes, ts, tt, num_bits=bits))
    w = np.asarray(want, np.float32)
    assert np.linalg.norm(got.float().numpy() - w) / np.linalg.norm(w) < 1.1e-2
    # JAX's own check of the same fusion
    jr = jhad.grouped_hadamard_transform(jnp.asarray(x, jnp.bfloat16), 128)
    assert within_one_bf16_ulp(xr, jr)
    np.testing.assert_array_equal(
        w, np.asarray(jlut.lut_qgemm(jr, planes, jnp.asarray(scales, jnp.bfloat16),
                                     jnp.asarray(table), num_bits=bits), np.float32))
