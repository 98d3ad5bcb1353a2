"""L1–L6, the six kernels of the Hopper kernel lab: counterparts of the
``pl.pallas_call`` experiments of ``scripts/kernel_lab.py``.

Every function is ``y[M, N] = x[M, K] @ W`` in bf16 with an f32 sum and one
rounding, over one 4-bit pair plane ``[K/8, N]`` int32 packed at chunk 256,
``[K/g, N]`` bf16 scales and a 16-entry table. They differ only in how the
operand ``W`` is dequantized, and they compute what the TPU kernels compute,
which is not always what their comments say:

* ``floor`` (L1, ``run_floor``): ``pltpu.repeat`` tiles the block's
  ``bk/8`` word rows four times and ``pltpu.bitcast`` turns int32 row ``i``
  into bf16 rows ``2i`` (low half) and ``2i+1`` (high half), so K row ``r``
  of a K block is half ``r % 2`` of word row ``(r // 2) mod (bk/8)`` of the
  block, read as a bf16 bit pattern. Scales and table are not read. The
  result depends on ``bk``, and real planes give non-finite values.
* ``unpack_only`` (L2, ``run_unpack``): the codes themselves as bf16 bit
  patterns, ``W[2p] = bits(ce)``, ``W[2p+1] = bits(co)``: subnormals
  ``c·2^-133``.
* ``gather16`` (L3, ``run_gather16``): ``bf16(bf16(T[c])·s[k // g])``, the
  reference dequantization.
* ``g8_ablate`` (L4, ``run_g8_ablate``): ``bf16(T[c])`` with ``chain``, else
  ``bf16(T[c & 7])``; times ``s[k // g]`` (rounded) with ``scale``. With
  ``wrap`` the TPU's gather takes the unmasked index, which the v5e's
  gather reads mod 8: the same entries as the mask (so ``g8_wrap`` equals
  ``g8_nochain``). The Pallas interpreter clamps the index instead.
* ``g8_rs`` (L5, ``run_g8_rs``) and ``g8_hoist`` (L6, ``run_g8_hoist``), one
  function: ``"repeat"`` scales K row ``r`` of K block ``kk`` by
  ``s[kk·bk/g + (r mod bk/g)]`` (``pltpu.repeat`` tiles the block's scale
  rows, so the result depends on ``bk``); ``"group_acc"`` sums
  ``(x_g @ bf16(T[c])_g)·s_g`` in f32 over the groups.

Each function takes the JAX signature. ``bm`` and ``bn`` are TPU tile sizes:
they are checked as the TPU grid needs them (``M % bm``, ``N % bn``) and
change nothing. ``bk`` is checked (``K % bk``, ``bk % 256``) and matters
where said. Dispatch is by ``x``'s device: on the CPU the plain PyTorch
version, on CUDA the Hopper kernel of ``csrc/kernel_lab.cu`` (one C entry per
function), which raises if it cannot be built or launched.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Sequence

import torch

from flute_tpu_torch import packing as _packing

# Launches of each kernel; a wrapper adds one where it launches its kernel
# and nowhere else.
LAUNCHES = {"floor": 0, "unpack_only": 0, "gather16": 0, "g8_ablate": 0, "g8_rs": 0,
            "g8_hoist": 0}

CHUNK = 256  # the lab's pack chunk
SOURCE = "kernel_lab.cu"
SCALE_MODES = ("repeat", "group_acc")
# the kernel keeps 16 rows of x for one K block in shared memory as f32:
# 16 * bk * 4 bytes of the 227 KB a block may have
MAX_BLOCK_K = 3584
# clears bit 14 and bit 30, the top exponent bit of each bf16 half of a word:
# every half is then a finite bf16 below 2 in magnitude
FINITE_HALVES = 0xBFFFBFFF - 2**32  # as int32

# ---------------------------------------------------------------------------
# The TPU operations the lab leans on, in torch
# ---------------------------------------------------------------------------


def pair_fields(plane: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(ce, co)`` int64 ``[K/2, N]`` of a 4-bit pair plane, in the order of
    JAX's ``_unpack_pair_fields``: pair row ``p`` holds K rows ``2p``
    (``ce``) and ``2p + 1`` (``co``)."""
    f = _packing._unpack_fields(plane, 8, CHUNK)
    return f & 15, f >> 4


def bitcast_rows(words: torch.Tensor) -> torch.Tensor:
    """``pltpu.bitcast(words, bfloat16)`` of int32 ``[R, N]``: bf16
    ``[2R, N]`` whose row ``2i`` is the low half of word row ``i`` and row
    ``2i + 1`` its high half, bit for bit."""
    r, n = words.shape
    halves = words.contiguous().view(torch.bfloat16).reshape(r, n, 2)  # little-endian
    return halves.transpose(1, 2).reshape(2 * r, n)


def _tiled_scales(scales: torch.Tensor, bk: int, g: int) -> torch.Tensor:
    """``pltpu.repeat(s_block, g, axis=0)`` for every K block: ``[K, N]``
    whose row ``kk·bk + r`` is ``s[kk·bk/g + (r mod bk/g)]``."""
    groups, n = scales.shape
    per_block = bk // g
    return scales.reshape(groups // per_block, per_block, n).repeat(1, g, 1).reshape(-1, n)


def _grouped_scales(scales: torch.Tensor, g: int) -> torch.Tensor:
    """``[K/g, N]`` -> ``[K, N]``, row ``k`` taking ``s[k // g]`` (JAX's
    ``_expand_scales``)."""
    groups, n = scales.shape
    return scales[:, None, :].expand(groups, g, n).reshape(groups * g, n)


def _codes(plane: torch.Tensor) -> torch.Tensor:
    """``[K, N]`` codes: ``ce`` on the even K rows, ``co`` on the odd."""
    ce, co = pair_fields(plane)
    return torch.stack([ce, co], dim=1).reshape(2 * ce.shape[0], -1)


# ---------------------------------------------------------------------------
# Plain versions: the dequantized operand, then the product
# ---------------------------------------------------------------------------


def finite_halves(plane: torch.Tensor) -> torch.Tensor:
    """``plane`` with every bf16 half of every word finite, so that floor's
    product can be compared (real planes give NaN and Inf)."""
    return plane & FINITE_HALVES


def floor_weight(plane: torch.Tensor, bk: int) -> torch.Tensor:
    """L1's operand ``[K, N]`` bf16 (the block's words tiled 4 times, then
    bitcast)."""
    rows, n = plane.shape
    blocks = plane.reshape(rows // (bk // 8), bk // 8, n).repeat(1, 4, 1)
    return bitcast_rows(blocks.reshape(-1, n))


def unpack_weight(plane: torch.Tensor) -> torch.Tensor:
    """L2's operand ``[K, N]`` bf16: the payload ``ce | co << 16``,
    bitcast."""
    ce, co = pair_fields(plane)
    payload = ce | (co << 16)  # < 2^20: fits int32
    return bitcast_rows(payload.to(torch.int32))


def table_weight(plane: torch.Tensor, table: torch.Tensor, *, chain: bool = True
                 ) -> torch.Tensor:
    """``bf16(T[c])`` (``chain``) or ``bf16(T[c & 7])`` ``[K, N]``."""
    codes = _codes(plane)
    if not chain:
        codes = codes & 7
    return table.to(device=plane.device, dtype=torch.bfloat16)[codes]


def _product(x: torch.Tensor, w: torch.Tensor, acc=torch.float32) -> torch.Tensor:
    return torch.matmul(x.to(acc), w.to(acc)).to(torch.bfloat16)


# floor's and unpack_only's operands hold f32 subnormals (unpack_only's
# only them); f64 holds them as normal numbers, so no library's flush to zero
# can touch the product


def floor_plain(x, plane, scales, table, bk, g):
    return _product(x, floor_weight(plane, bk), acc=torch.float64)


def unpack_only_plain(x, plane, scales, table, bk, g):
    return _product(x, unpack_weight(plane), acc=torch.float64)


def gather16_plain(x, plane, scales, table, bk, g):
    w = table_weight(plane, table) * _grouped_scales(scales, g)  # rounded in bf16
    return _product(x, w)


def g8_ablate_plain(x, plane, scales, table, bk, g, *, chain, scale, wrap):
    # wrap: the v5e's gather reads the unmasked index mod 8, which is the mask
    w = table_weight(plane, table, chain=chain)
    if scale:
        w = w * _grouped_scales(scales, g)
    return _product(x, w)


def group_parts(x: torch.Tensor, w: torch.Tensor, g: int) -> torch.Tensor:
    """``x_g @ w_g`` in f32 for every group of ``g`` K rows: ``[K/g, M, N]``."""
    m, k = x.shape
    return torch.einsum("mgk,gkn->gmn", x.float().reshape(m, k // g, g),
                        w.float().reshape(k // g, g, -1))


def group_acc_product(x: torch.Tensor, w: torch.Tensor, scales: torch.Tensor, g: int
                      ) -> torch.Tensor:
    """The TPU's ``group_acc``: ``bf16(Σ_g (x_g @ w_g)·s_g)``, every sum and
    product in f32."""
    return (group_parts(x, w, g) * scales.float()[:, None, :]).sum(dim=0).to(torch.bfloat16)


def g8_rs_plain(x, plane, scales, table, bk, g, *, scale_mode):
    w = table_weight(plane, table)
    if scale_mode == "repeat":
        return _product(x, w * _tiled_scales(scales, bk, g))
    return group_acc_product(x, w, scales, g)


# g8_hoist moves the TPU's select out of the gather loop: the same function
g8_hoist_plain = g8_rs_plain

PLAIN: dict[str, Callable] = {
    "floor": floor_plain,
    "unpack_only": unpack_only_plain,
    "gather16": gather16_plain,
    "g8_ablate": g8_ablate_plain,
    "g8_rs": g8_rs_plain,
    "g8_hoist": g8_hoist_plain,
}

# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

# function -> (C entry, pointer arguments, int arguments) before the stream:
# x, plane[, scales, table], y, then M, N, K, bk[, g[, flags]]
_ENTRIES = {
    "floor": ("flute_lab_floor", 3, 4),
    "unpack_only": ("flute_lab_unpack_only", 3, 4),
    "gather16": ("flute_lab_gather16", 5, 5),
    "g8_ablate": ("flute_lab_g8_ablate", 5, 7),
    "g8_rs": ("flute_lab_g8_rs", 5, 6),
    "g8_hoist": ("flute_lab_g8_hoist", 5, 6),
}


@functools.lru_cache(maxsize=None)
def _kernel_fn(name: str):
    """The C entry of lab function ``name`` (the library built at first
    use)."""
    from flute_tpu_torch.ops import _build

    entry, n_ptr, n_int = _ENTRIES[name]
    lib = _build.load(SOURCE)
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    lib.flute_cuda_error_string.restype = ctypes.c_char_p
    lib.flute_cuda_error_string.argtypes = [ctypes.c_int]
    return fn, lib.flute_cuda_error_string


def build_kernels() -> None:
    """Build (or load the already built) lab library and bind every entry."""
    for name in _ENTRIES:
        _kernel_fn(name)


def _launch(name: str, x, plane, scales, table, bk: int, g: int, flags: tuple[int, ...]
            ) -> torch.Tensor:
    """Launch lab kernel ``name`` on PyTorch's current stream and count the
    launch."""
    m, k = x.shape
    n = plane.shape[1]
    dev = x.device
    for t_name, t in (("plane", plane), ("scales", scales), ("table", table)):
        if t is not None and t.device != dev:
            raise ValueError(f"{t_name} is on {t.device}, x on {dev}")
    y = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    if m == 0:
        return y
    fn, error_string = _kernel_fn(name)
    ptrs = [x.data_ptr(), plane.data_ptr()]
    ints = [m, n, k, bk]
    if _ENTRIES[name][1] == 5:
        ptrs += [scales.data_ptr(), table.data_ptr()]
        ints += [g, *flags]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(*ptrs, y.data_ptr(), *ints, stream)
    if err != 0:
        raise RuntimeError(f"lab kernel {name} launch failed: {error_string(err).decode()} ({err})")
    LAUNCHES[name] += 1
    return y


def _run(name: str, x, planes, scales, table, bm, bn, bk, g, flags: tuple[int, ...] = (),
         **kw) -> torch.Tensor:
    """Check the operands as the TPU grid needs them, then run the plain
    version (CPU) or launch the kernel (CUDA)."""
    plane, scales, table = _check(x, planes, scales, table, bm, bn, bk, g)
    if x.device.type == "cpu":
        return PLAIN[name](x, plane, scales, table, bk, g, **kw)
    if x.device.type == "cuda":
        return _launch(name, x.contiguous(), plane.contiguous(), scales.contiguous(),
                       None if table is None else table.contiguous(), bk, g, flags)
    raise ValueError(f"unsupported device {x.device}")


def _check(x, planes: Sequence[torch.Tensor], scales, table, bm, bn, bk, g):
    """Raise ``ValueError`` on operands the lab does not take; returns the
    plane, the scales and the f32 table (None where the function reads
    none)."""
    if x.dim() != 2 or x.dtype != torch.bfloat16:
        raise ValueError(f"x must be 2-D bfloat16, got {x.dtype} {tuple(x.shape)}")
    m, k = x.shape
    if len(planes) != 1:
        raise ValueError(f"the lab reads one 4-bit plane, got {len(planes)}")
    plane = planes[0]
    n = scales.shape[1]
    if plane.dtype != torch.int32 or tuple(plane.shape) != (k // 8, n):
        raise ValueError(f"plane must be int32 [{k // 8}, {n}]")
    if scales.dtype != torch.bfloat16 or scales.dim() != 2 or g <= 0 or g % 2 \
            or scales.shape[0] * g != k:
        raise ValueError(f"scales must be bfloat16 [{k} / g, {n}] with an even g, got g={g}")
    if m % bm or n % bn or k % bk or bk % CHUNK or bk % g or not 0 < bk <= MAX_BLOCK_K:
        raise ValueError(
            f"M={m}, N={n}, K={k} do not tile by bm={bm}, bn={bn}, bk={bk} "
            f"(bk a multiple of {CHUNK} and of g={g}, at most {MAX_BLOCK_K})")
    if table is None:  # floor and unpack_only read no table
        return plane, scales, None
    table = torch.as_tensor(table, dtype=torch.float32).to(x.device)
    if tuple(table.shape) != (16,):
        raise ValueError(f"table must have 16 entries, got {tuple(table.shape)}")
    return plane, scales, table


# ---------------------------------------------------------------------------
# The lab's functions, with the JAX signatures
# ---------------------------------------------------------------------------


def floor(x, planes, scales, bm, bn, bk, g) -> torch.Tensor:
    """L1, ``run_floor``: the planes read as bf16 bit patterns (tiled and
    bitcast); scales are not read."""
    return _run("floor", x, planes, scales, None, bm, bn, bk, g)


def unpack_only(x, planes, scales, bm, bn, bk, g) -> torch.Tensor:
    """L2, ``run_unpack``: the codes themselves as bf16 bit patterns."""
    return _run("unpack_only", x, planes, scales, None, bm, bn, bk, g)


def gather16(x, planes, scales, table, bm, bn, bk, g) -> torch.Tensor:
    """L3, ``run_gather16``: the reference dequantization, with x split
    into even and odd K on the TPU."""
    return _run("gather16", x, planes, scales, table, bm, bn, bk, g)


def g8_ablate(x, planes, scales, table, bm, bn, bk, g, *, chain: bool, scale: bool,
              wrap: bool) -> torch.Tensor:
    """L4, ``run_g8_ablate``: ``T[c]`` (``chain``) or ``T[c & 7]``, scaled
    with ``scale``; ``wrap`` selects the same entries as the mask (the v5e's
    mod-8 index wrap)."""
    return _run("g8_ablate", x, planes, scales, table, bm, bn, bk, g,
                flags=(int(chain), int(scale)), chain=chain, scale=scale, wrap=wrap)


def _scale_mode(scale_mode: str) -> int:
    if scale_mode not in SCALE_MODES:
        raise ValueError(f"scale_mode must be one of {SCALE_MODES}, got {scale_mode!r}")
    return int(scale_mode == "group_acc")


def g8_rs(x, planes, scales, table, bm, bn, bk, g, scale_mode: str) -> torch.Tensor:
    """L5, ``run_g8_rs``: ``T[c]`` with tiled scales (``"repeat"``) or group
    sums times the scale (``"group_acc"``)."""
    return _run("g8_rs", x, planes, scales, table, bm, bn, bk, g,
                flags=(_scale_mode(scale_mode),), scale_mode=scale_mode)


def g8_hoist(x, planes, scales, table, bm, bn, bk, g, scale_mode: str) -> torch.Tensor:
    """L6, ``run_g8_hoist``: L5's function; the kernel reads both 8-entry
    halves of the table for every code and selects after."""
    return _run("g8_hoist", x, planes, scales, table, bm, bn, bk, g,
                flags=(_scale_mode(scale_mode),), scale_mode=scale_mode)


def plain(name: str, x, planes, scales, table, bm, bn, bk, g, **kw) -> torch.Tensor:
    """The plain version of lab function ``name`` on ``x``'s device (for
    holding a kernel against it on the card)."""
    plane, scales, table = _check(x, planes, scales, table, bm, bn, bk, g)
    if "scale_mode" in kw:
        _scale_mode(kw["scale_mode"])
    return PLAIN[name](x, plane, scales, table, bk, g, **kw)


FUNCTIONS: dict[str, Callable] = {
    "floor": floor,
    "unpack_only": unpack_only,
    "gather16": gather16,
    "g8_ablate": g8_ablate,
    "g8_rs": g8_rs,
    "g8_hoist": g8_hoist,
}


def run(name: str, x, planes, scales, table, bm, bn, bk, g, **kw) -> torch.Tensor:
    """Lab function ``name`` with keyword flags ``kw``, taking a table
    whether it reads one or not."""
    if name in ("floor", "unpack_only"):
        return FUNCTIONS[name](x, planes, scales, bm, bn, bk, g)
    return FUNCTIONS[name](x, planes, scales, table, bm, bn, bk, g, **kw)

