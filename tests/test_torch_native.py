"""The port's native host packer (``flute_tpu_torch.native``, its own copy
of the C++ source under ``flute_tpu_torch/csrc/``) against the port's
numpy packers, and the port's numpy packers against the JAX package's with
``use_native=False``: the cases of ``tests/test_native.py``, and w4sym.
The library is built with g++ here at its first use (about 7 s) under
``build/flute_tpu_torch/``, not in the package."""

import numpy as np
import pytest

from flute_tpu import packing as jpacking
from flute_tpu_torch import native, packing


@pytest.fixture(scope="module")
def lib_available():
    assert native.available(), "the native packer did not build"
    assert native.library_path(native.MARCHES[0]).parent == native.BUILD_DIR
    return True


def codes(seed, bits, k=1024, n=384):
    return np.random.default_rng(seed).integers(0, 2**bits, (k, n), dtype=np.int32)


@pytest.mark.parametrize("num_bits", [2, 3, 4])
@pytest.mark.parametrize("chunk", [128, 256])
def test_native_pack_matches_numpy(lib_available, num_bits, chunk):
    c = codes(0, num_bits)
    got = packing.pack_np(c, num_bits, chunk=chunk, use_native=True)
    want = packing.pack_np(c, num_bits, chunk=chunk, use_native=False)
    assert len(got) == len(want)
    for g, w, j in zip(got, want, jpacking.pack_np(c, num_bits, chunk=chunk, use_native=False)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(w, j)


@pytest.mark.parametrize("num_bits", [2, 3, 4])
def test_native_unpack_roundtrip(lib_available, num_bits):
    c = codes(1, num_bits, 512, 256)
    planes = packing.pack_np(c, num_bits, use_native=True)
    np.testing.assert_array_equal(packing.unpack_np(planes, num_bits, use_native=True), c)
    np.testing.assert_array_equal(packing.unpack_np(planes, num_bits, use_native=False), c)
    np.testing.assert_array_equal(jpacking.unpack_np(planes, num_bits, use_native=False), c)


@pytest.mark.parametrize("chunk", [256, 512])
def test_native_w3_wide_matches_numpy(lib_available, chunk):
    c = codes(3, 3)
    (got,) = packing.pack_w3_wide_np(c, chunk=chunk, use_native=True)
    (want,) = packing.pack_w3_wide_np(c, chunk=chunk, use_native=False)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, jpacking.pack_w3_wide_np(c, chunk=chunk, use_native=False)[0])
    np.testing.assert_array_equal(packing.unpack_w3_wide_np(got, chunk=chunk, use_native=True), c)
    np.testing.assert_array_equal(packing.unpack_w3_wide_np(got, chunk=chunk, use_native=False), c)


@pytest.mark.parametrize("chunk", [128, 256])
def test_native_w4_sym_matches_numpy(lib_available, chunk):
    c = codes(4, 4)
    (got,) = packing.pack_w4_sym_np(c, chunk=chunk, use_native=True)
    (want,) = packing.pack_w4_sym_np(c, chunk=chunk, use_native=False)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, jpacking.pack_w4_sym_np(c, chunk=chunk, use_native=False)[0])
    np.testing.assert_array_equal(packing.unpack_w4_sym_np(got, chunk=chunk, use_native=True), c)
    np.testing.assert_array_equal(packing.unpack_w4_sym_np(got, chunk=chunk, use_native=False), c)


def test_native_throughput_sane(lib_available):
    """Native pack of a 4096 x 4096 4-bit matrix is no slower than twice
    numpy's (no hard ratio: the host is shared)."""
    import time

    c = codes(2, 4, 4096, 4096)
    t0 = time.perf_counter()
    packing.pack_np(c, 4, use_native=True)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    packing.pack_np(c, 4, use_native=False)
    t_numpy = time.perf_counter() - t0
    assert t_native < max(t_numpy * 2.0, 1.0), (t_native, t_numpy)


def test_a_library_that_fails_its_check_is_replaced(tmp_path, monkeypatch):
    """A library left by another machine (here: not a library at all)
    fails the subprocess check and is rebuilt before it is loaded."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    stale = native.library_path(native.MARCHES[0])
    stale.write_bytes(b"not a library")
    assert native.available()
    assert stale.read_bytes()[:4] == b"\x7fELF"
    np.testing.assert_array_equal(
        native.unpack_plane(native.pack_plane(codes(5, 4, 256, 8), 0, 4, 256), 4, 256),
        codes(5, 4, 256, 8))
