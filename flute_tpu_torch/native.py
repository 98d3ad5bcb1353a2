"""ctypes bridge to the native host packer (``csrc/fastpack.cpp``),
counterpart of ``flute_tpu/native.py``.

Offline packing of a large checkpoint is a pure-CPU bit shuffle over tens
of GB, the one place where the numpy loops of :mod:`flute_tpu_torch.packing`
hurt. The library is built on first use with ``g++`` into
``build/flute_tpu_torch/`` at the repository root, keyed by a hash of the
source and the compiler's flags (as ``ops/_build.py`` keys the CUDA
kernels), and loaded with ``ctypes``. Every library is checked in a
subprocess before it is loaded: a ``-march=native`` build copied to another
machine can fault with SIGILL at call time, which ctypes cannot catch, so a
library that fails the check is rebuilt, and one that fails it again is
replaced by an ``-mtune=generic`` build. With no compiler, or when both
builds fail, :func:`available` is False and the packers run their numpy
paths: this is a host packer, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "csrc" / "fastpack.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "flute_tpu_torch"
# the vectorised build first (AVX2 runs the shift/or shuffle ~2x faster),
# the portable one where the first fails its check
MARCHES = ("-march=native", "-mtune=generic")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_PLANE_PACK_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int64]
_PLANE_UNPACK_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                      ctypes.c_int, ctypes.c_int64]
_WIDE_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
              ctypes.c_int64]

# a pack/unpack round trip through one library, run in a child process so
# that a library built for another CPU faults the child, not the caller
_SELFCHECK = """
import ctypes, sys
import numpy as np
lib = ctypes.CDLL(sys.argv[1])
c = np.random.default_rng(0).integers(0, 16, (256, 8), dtype=np.int32)
w = np.empty((32, 8), np.int32)
u = np.empty_like(c)
assert lib.flute_pack_plane(ctypes.c_void_p(c.ctypes.data), ctypes.c_void_p(w.ctypes.data),
    ctypes.c_int64(256), ctypes.c_int64(8), 0, 4, ctypes.c_int64(256)) == 0
assert lib.flute_unpack_plane(ctypes.c_void_p(w.ctypes.data), ctypes.c_void_p(u.ctypes.data),
    ctypes.c_int64(256), ctypes.c_int64(8), 4, ctypes.c_int64(256)) == 0
assert np.array_equal(u, c)
"""


def _flags(march: str) -> list[str]:
    return ["-O3", march, "-std=c++17", "-shared", "-fPIC", "-pthread"]


def library_path(march: str) -> Path:
    """Where the ``march`` build of the packer goes: keyed by the source and
    the compiler's flags."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(_flags(march)).encode())
    return BUILD_DIR / f"fastpack-{h.hexdigest()[:16]}.so"


def _build(out: Path, march: str) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run(["g++", *_flags(march), str(SRC), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return True


def _selfcheck(path: Path) -> bool:
    try:
        r = subprocess.run([sys.executable, "-c", _SELFCHECK, str(path)],
                           capture_output=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return False
    return r.returncode == 0


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.flute_pack_plane.argtypes = _PLANE_PACK_ARGS
    lib.flute_unpack_plane.argtypes = _PLANE_UNPACK_ARGS
    for fn in (lib.flute_pack_w3_wide, lib.flute_unpack_w3_wide, lib.flute_pack_w4_sym,
               lib.flute_unpack_w4_sym):
        fn.argtypes = _WIDE_ARGS
    for fn in (lib.flute_pack_plane, lib.flute_unpack_plane, lib.flute_pack_w3_wide,
               lib.flute_unpack_w3_wide, lib.flute_pack_w4_sym, lib.flute_unpack_w4_sym):
        fn.restype = ctypes.c_int
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library (built and checked at the first call of the
    process), or None where no build passes its check."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        for march in MARCHES:
            path = library_path(march)
            # a library left by another machine fails its check: rebuild it
            ok = path.exists() and _selfcheck(path)
            if ok or (_build(path, march) and _selfcheck(path)):
                _lib = _load(path)
                break
        return _lib


def available() -> bool:
    """Whether the packers run natively (else their numpy paths run)."""
    return get_lib() is not None


def _call(fn, src: np.ndarray, out: np.ndarray, *args) -> np.ndarray:
    rc = fn(src.ctypes.data, out.ctypes.data, *args)
    if rc != 0:
        raise ValueError(f"{fn.__name__} failed (rc={rc})")
    return out


def pack_plane(codes: np.ndarray, shift: int, plane_bits: int, chunk: int) -> Optional[np.ndarray]:
    """One pair plane ``[K * pb / 32, N]`` of the ``plane_bits`` bits of
    ``codes`` ``[K, N]`` from bit ``shift``; None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    k, n = codes.shape
    out = np.empty((k * plane_bits // 32, n), np.int32)
    return _call(lib.flute_pack_plane, codes, out, k, n, shift, plane_bits, chunk)


def unpack_plane(words: np.ndarray, plane_bits: int, chunk: int) -> Optional[np.ndarray]:
    """The ``[K, N]`` subcodes of one pair plane; None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    words = np.ascontiguousarray(words, dtype=np.int32)
    rows, n = words.shape
    k = rows * 32 // plane_bits
    return _call(lib.flute_unpack_plane, words, np.empty((k, n), np.int32), k, n,
                 plane_bits, chunk)


def pack_w3_wide(codes: np.ndarray, chunk: int) -> Optional[np.ndarray]:
    """Wide 3-bit pack: codes ``[K, N]`` -> words ``[3K/32, N]``; None
    without the library."""
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    k, n = codes.shape
    return _call(lib.flute_pack_w3_wide, codes, np.empty((k * 3 // 32, n), np.int32), k, n,
                 chunk)


def unpack_w3_wide(words: np.ndarray, chunk: int) -> Optional[np.ndarray]:
    """Wide 3-bit unpack: words ``[3K/32, N]`` -> codes ``[K, N]``; None
    without the library."""
    lib = get_lib()
    if lib is None:
        return None
    words = np.ascontiguousarray(words, dtype=np.int32)
    rows, n = words.shape
    k = rows * 32 // 3
    return _call(lib.flute_unpack_w3_wide, words, np.empty((k, n), np.int32), k, n, chunk)


def pack_w4_sym(codes: np.ndarray, chunk: int) -> Optional[np.ndarray]:
    """Sign-symmetric 4-bit pack: sign-magnitude codes ``[K, N]`` -> words
    ``[K/8, N]``; None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    k, n = codes.shape
    return _call(lib.flute_pack_w4_sym, codes, np.empty((k // 8, n), np.int32), k, n, chunk)


def unpack_w4_sym(words: np.ndarray, chunk: int) -> Optional[np.ndarray]:
    """Sign-symmetric 4-bit unpack: words ``[K/8, N]`` -> codes ``[K, N]``;
    None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    words = np.ascontiguousarray(words, dtype=np.int32)
    rows, n = words.shape
    k = rows * 8
    return _call(lib.flute_unpack_w4_sym, words, np.empty((k, n), np.int32), k, n, chunk)
