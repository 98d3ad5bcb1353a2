"""The port's plane and word primitives (``flute_tpu_torch.bitutils``) and
its GEMM report (``flute_tpu_torch.utils.benchmark.format_gemm_report``)
against the JAX package's (``flute_tpu/bitutils.py``,
``flute_tpu/utils/benchmark.py``): the same seeded numpy inputs through
both, bit for bit (int32 results) and string for string."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flute_tpu import bitutils as jbits
from flute_tpu.utils import benchmark as jbench
from flute_tpu_torch import bitutils
from flute_tpu_torch.utils import benchmark

PLANE_BITS = (1, 2, 4, 8)  # every plane width of PLANE_DECOMPOSITION
SHAPE = (24, 5)


def same(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.asarray(want).dtype == np.int32


def sub_codes(plane_bits: int, seed: int) -> np.ndarray:
    """``[r, *SHAPE]`` sub-codes of ``plane_bits`` bits, the top field's
    high bit set in some words (the packed word's sign bit)."""
    r = 32 // plane_bits
    sub = np.random.default_rng(seed).integers(0, 1 << plane_bits, (r, *SHAPE), dtype=np.int32)
    sub[-1, 0] = (1 << plane_bits) - 1
    return sub


def test_plane_widths_cover_the_decomposition():
    assert sorted({pb for planes in bitutils.PLANE_DECOMPOSITION.values() for pb in planes}) \
        == list(PLANE_BITS)
    assert bitutils.PLANE_DECOMPOSITION == jbits.PLANE_DECOMPOSITION


@pytest.mark.parametrize("num_bits", sorted(jbits.PLANE_DECOMPOSITION))
def test_plane_split_and_merge_match_jax(num_bits):
    codes = np.random.default_rng(num_bits).integers(0, 1 << num_bits, SHAPE).astype(np.int32)
    got = bitutils.plane_split(torch.from_numpy(codes), num_bits)
    want = jbits.plane_split(jnp.asarray(codes), num_bits)
    assert len(got) == len(want) == len(bitutils.planes_for_bits(num_bits))
    for g, w in zip(got, want, strict=True):
        same(g, w)
    merged = bitutils.plane_merge(got, num_bits)
    same(merged, jbits.plane_merge(want, num_bits))
    same(merged, codes)


def test_plane_split_and_merge_refuse():
    with pytest.raises(ValueError):
        bitutils.plane_split(torch.zeros(4, dtype=torch.int32), 5)
    with pytest.raises(ValueError):
        bitutils.plane_merge([torch.zeros(4, dtype=torch.int32)], 3)


@pytest.mark.parametrize("plane_bits", PLANE_BITS)
def test_pack_plane_words_match_jax(plane_bits):
    """Every plane width, with the top field setting the sign bit: the
    torch and numpy packers equal JAX's word for word, and unpacking gives
    the sub-codes back as JAX's unpack does."""
    sub = sub_codes(plane_bits, plane_bits)
    want = np.asarray(jbits.pack_plane_words(jnp.asarray(sub), plane_bits))
    assert (want < 0).any()
    got = bitutils.pack_plane_words(torch.from_numpy(sub), plane_bits)
    same(got, want)
    np_got = bitutils.np_pack_plane_words(sub, plane_bits)
    assert np_got.dtype == np.int32
    np.testing.assert_array_equal(np_got, jbits.np_pack_plane_words(sub, plane_bits))
    np.testing.assert_array_equal(np_got, want)
    back = bitutils.unpack_plane_words(got, plane_bits)
    same(back, jbits.unpack_plane_words(jnp.asarray(want), plane_bits))
    same(back, sub)


@pytest.mark.parametrize("plane_bits", PLANE_BITS)
def test_pack_plane_words_refuse_a_wrong_leading_dim(plane_bits):
    sub = sub_codes(plane_bits, 0)[:-1]
    for pack in (lambda: bitutils.pack_plane_words(torch.from_numpy(sub), plane_bits),
                 lambda: bitutils.np_pack_plane_words(sub, plane_bits)):
        with pytest.raises(ValueError, match="Leading dim"):
            pack()
    with pytest.raises(ValueError, match="Leading dim"):
        jbits.pack_plane_words(jnp.asarray(sub), plane_bits)


def test_pack_plane_words_keep_jax_int32_wrap():
    """Sub-codes wider than the field or negative are shifted as int32 and
    wrap there, as JAX's are."""
    sub = np.random.default_rng(3).integers(-40, 300, (8, *SHAPE)).astype(np.int32)
    same(bitutils.pack_plane_words(torch.from_numpy(sub), 4),
         jbits.pack_plane_words(jnp.asarray(sub), 4))


@pytest.mark.parametrize("args", [
    ("w4", 155.8e-6, 8, 28672, 8192, 4, 3350.0),
    ("w3 head", 1.2345e-3, 1, 129024, 4096, 3, 3350.0, 4096 * 2),
    ("w2", 3e-7, 16, 256, 512, 2, 819.0, 0),
])
def test_format_gemm_report_matches_jax(args):
    assert benchmark.format_gemm_report(*args) == jbench.format_gemm_report(*args)
