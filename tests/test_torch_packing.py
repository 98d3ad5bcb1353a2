"""The PyTorch port's packers write the JAX package's planes bit for bit.

Codes come from numpy seeds and go to both packages; the port's numpy
packers, its torch packers (``pack_plane``, ``pack_w3_wide``,
``pack_w4_sym``) and the unpackers are held against flute_tpu.packing
(numpy reference path, native packer off, and its on-device jnp packers).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flute_tpu import packing as jpacking
from flute_tpu_torch import packing

K, N = 512, 128


def codes_for(bits, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**bits, size=(K, N), dtype=np.int32)


@pytest.mark.parametrize("chunk", [128, 256])
@pytest.mark.parametrize("bits", [2, 3, 4])
def test_pair_planes_equal_jax(bits, chunk):
    codes = codes_for(bits, seed=bits)
    want = jpacking.pack_np(codes, bits, chunk=chunk, use_native=False)
    got = packing.pack_np(codes, bits, chunk=chunk)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(packing.unpack_np(got, bits, chunk=chunk), codes)


def test_w3_wide_equal_jax():
    codes = codes_for(3, seed=7)
    want = jpacking.pack_w3_wide_np(codes, use_native=False)[0]
    got = packing.pack_w3_wide_np(codes)[0]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(packing.unpack_w3_wide_np(got), codes)
    np.testing.assert_array_equal(packing.unpack_np([got], 3), codes)


@pytest.mark.parametrize("chunk", [128, 256])
@pytest.mark.parametrize("bits", [2, 3, 4])
def test_device_pack_plane_equal_jax(bits, chunk):
    codes = codes_for(bits, seed=20 + bits)
    want = jpacking.pack_np(codes, bits, chunk=chunk, use_native=False)
    want_jnp = jpacking.pack_jnp(jnp.asarray(codes), bits, chunk=chunk)
    got = packing.pack_plane(torch.from_numpy(codes), bits, chunk=chunk)
    assert len(got) == len(want) == len(want_jnp)
    for g, w, wj in zip(got, want, want_jnp):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(g.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(packing.unpack_plane(got, bits, chunk=chunk).numpy(), codes)
    np.testing.assert_array_equal(packing.unpack(got, bits, chunk=chunk).numpy(), codes)


@pytest.mark.parametrize("chunk", [256, 512])
def test_device_pack_w3_wide_equal_jax(chunk):
    codes = codes_for(3, seed=30)
    want = jpacking.pack_w3_wide_np(codes, chunk=chunk, use_native=False)[0]
    want_jnp = jpacking.pack_w3_wide_jnp(jnp.asarray(codes), chunk=chunk)[0]
    got = packing.pack_w3_wide(torch.from_numpy(codes), chunk=chunk)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_jnp))
    np.testing.assert_array_equal(packing.unpack_w3_wide(got, chunk=chunk).numpy(), codes)
    np.testing.assert_array_equal(packing.unpack([got], 3, chunk=chunk).numpy(), codes)
    np.testing.assert_array_equal(
        packing.unpack([got], 3, chunk=chunk, layout="w3wide").numpy(), codes
    )
    with pytest.raises(ValueError):
        packing.pack_w3_wide(torch.from_numpy(codes), chunk=128)


@pytest.mark.parametrize("chunk", [128, 256])
def test_w4sym_equal_jax(chunk):
    codes = codes_for(4, seed=11)
    want = jpacking.pack_w4_sym_np(codes, chunk=chunk, use_native=False)[0]
    got = packing.pack_w4_sym_np(codes, chunk=chunk)[0]
    np.testing.assert_array_equal(got, want)
    # the torch twin packs the same words, and both unpackers invert them
    got_t = packing.pack_w4_sym(torch.from_numpy(codes), chunk=chunk)
    assert got_t.dtype == torch.int32
    np.testing.assert_array_equal(got_t.numpy(), want)
    np.testing.assert_array_equal(packing.unpack_w4_sym_np(got, chunk=chunk), codes)
    np.testing.assert_array_equal(
        packing.unpack_w4_sym(got_t, chunk=chunk).numpy(), codes
    )


def test_pack_returns_tensors_on_requested_device():
    codes = codes_for(4, seed=3)
    planes = packing.pack(codes, 4, device="cpu")
    want = jpacking.pack_np(codes, 4, use_native=False)
    np.testing.assert_array_equal(planes[0].numpy(), want[0])
    wide = packing.pack(codes_for(3), 3, wide=True, device="cpu")
    np.testing.assert_array_equal(
        wide[0].numpy(), jpacking.pack_w3_wide_np(codes_for(3), use_native=False)[0]
    )


def test_pack_format_and_errors():
    fmt = packing.PackFormat(num_bits=3, chunk=256)
    assert fmt.packed_shapes(K, N) == jpacking.PackFormat(3, 256).packed_shapes(K, N)
    with pytest.raises(ValueError):
        packing.PackFormat(num_bits=5)
    with pytest.raises(ValueError):
        packing.pack_np(codes_for(4)[:200], 4)
    with pytest.raises(ValueError):
        packing.pack_w4_sym(torch.zeros((200, N), dtype=torch.int32))


def test_table_predicates_match_jax():
    from flute_tpu.quantize import nf as jnf

    from flute_tpu_torch.quantize import nf

    v = nf.nf_values_symmetric_exact(4)
    ts, perm = packing.sym_code_order(v)
    jts, jperm = jpacking.sym_code_order(np.asarray(jnf.nf_values_symmetric_exact(4)))
    np.testing.assert_array_equal(ts, jts)
    np.testing.assert_array_equal(perm, jperm)
    rng = np.random.default_rng(5)
    mags = np.sort(np.abs(rng.standard_normal(8))).astype(np.float32)
    tables = [
        ts, v, np.concatenate([mags, -mags]), np.asarray(nf.QLORA_NF4),
        np.concatenate([mags, -mags + 1e-3]),
    ]
    for t in tables:
        assert packing.is_symmetric_table(t, 4) == jpacking.is_symmetric_table(t, 4)
        assert packing.is_ascending_symmetric_table(
            t, 4
        ) == jpacking.is_ascending_symmetric_table(t, 4)
    planes = packing.pack_np(codes_for(3), 3)
    assert not packing.is_w3_wide(planes, 3, K)
    assert packing.is_w3_wide(packing.pack_w3_wide_np(codes_for(3)), 3, K)
