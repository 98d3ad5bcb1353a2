"""L7–L12, the second half of the Hopper kernel lab: counterparts of the
``pl.pallas_call`` experiments of ``scripts/kernel_lab2.py``.

L8–L12 are ``y[M, N] = x[M, K] @ W`` in bf16, each summed per group in f32
as the TPU's ``group_acc`` sums it: ``y = bf16(Σ_g (x_g @ W_g)·s_g)``, with
``s`` the ``[K/g, N]`` bf16 scales. ``pltpu.bitcast`` of the payload
``ge | go`` puts the even value of pair row ``p`` on K row ``2p`` and the odd
value on ``2p + 1`` (``ops.bitcast_rows``), so ``W`` is in the plane's pair
order. The TPU kernels index their gathers with raw fields, which the v5e's
gather reads mod 8 (``flute_tpu/ops/lut_gemm.py:72-75``); the Pallas
interpreter clamps such an index instead, so only a run with the wrap
modelled is a reference. They compute:

* ``pfdirect`` (L8, ``run_pfdirect``) and ``slabstream`` (L11,
  ``run_slabstream``): ``W = bf16(T[c])`` of one 4-bit plane and a 16-entry
  table. The TPU gathers from the raw 8-bit pair field ``f``: the even value
  from index ``f`` (read as ``f & 7``) in the half chosen by bit 3, the odd
  from ``f >> 4`` in the half chosen by bit 7, which is ``T[f & 15]`` and
  ``T[f >> 4]``. L11 builds the same operand slab by slab: the same
  function.
* ``sep`` (L9, ``run_sep``): a separable table ``T[c] = A[c & 3] + B[c >> 2]``
  over two 2-bit planes (of ``codes & 3`` and ``codes >> 2``) and two
  4-entry tables. ``one_mm=False`` sums two products in f32, which is
  ``W = bf16(A) + bf16(B)`` (an exact f32 sum); ``one_mm=True`` (``sep1``)
  takes one product on the bf16 sum ``W = bf16(bf16(A) + bf16(B))``.
* ``int4`` (L10, ``run_int4``): the affine table ``T[c] = z + c·δ`` with no
  lookup: ``Σ_g (x_g @ c_g)·(s_g·δ) + (Σ_k x_g)·(s_g·z)``, each product
  rounded to f32 on its own (unfused), ``c`` exact in bf16.
* ``w3wide`` (L12, ``run_w3wide``): ``W = bf16(T3[c])`` from the wide 3-bit
  layout (``packing.pack_w3_wide``) and an 8-entry table.
* ``vmembw`` (L7, ``run_vmembw``): not a GEMM. ``v ← v ^ (v >> 1)``
  (arithmetic shift) ``nops`` times on an int32 block.

Each GEMM takes the JAX signature. ``bm``, ``bn`` and ``bk`` are TPU tile
sizes: they are checked as the TPU grid needs them (``M % bm``, ``N % bn``,
``K % bk``, ``bk % 256``, ``bk % g``) and change nothing, since every kernel
here scales per group. Dispatch is by the first tensor's device: on the CPU
the plain PyTorch version, on CUDA the Hopper kernel of
``csrc/kernel_lab2.cu`` (one C entry per TPU function), which raises if it
cannot be built or launched.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Sequence

import torch

from flute_tpu_torch import packing as _packing
from flute_tpu_torch.lab.ops import CHUNK, bitcast_rows, group_acc_product, group_parts, \
    pair_fields

# Launches of each kernel; a wrapper adds one where it launches its kernel
# and nowhere else. ``sep`` counts both of its modes.
LAUNCHES = {"vmembw": 0, "pfdirect": 0, "sep": 0, "int4": 0, "slabstream": 0, "w3wide": 0}

SOURCE = "kernel_lab2.cu"
# plane word rows per K row, and table entries, of each GEMM's operands
PLANE_ROWS_PER_K = {"pfdirect": 1 / 8, "slabstream": 1 / 8, "int4": 1 / 8, "sep": 1 / 16,
                    "w3wide": 3 / 32}
TABLE_SIZE = {"pfdirect": 16, "slabstream": 16, "sep": 4, "w3wide": 8}

# ---------------------------------------------------------------------------
# Plain versions: the dequantized operand, then the product
# ---------------------------------------------------------------------------


def _bf16(table: torch.Tensor) -> torch.Tensor:
    return table.to(torch.bfloat16)


def payload_weight(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """The operand ``[K, N]`` bf16 that the TPU builds from bf16 ``[K/2, N]``
    even and odd values: the payload ``even | odd << 16``, bitcast."""
    lo = even.view(torch.int16).long() & 0xFFFF
    hi = odd.view(torch.int16).long() & 0xFFFF
    return bitcast_rows(_packing._to_int32_words(lo | (hi << 16)))


def pfdirect_plain(x, plane, scales, table, g):
    ce, co = pair_fields(plane)  # the wrapped indices f & 15 and f >> 4
    t = _bf16(table)
    return group_acc_product(x, payload_weight(t[ce], t[co]), scales, g)


# slabstream builds pfdirect's operand slab by slab: the same function
slabstream_plain = pfdirect_plain


def sep_weight(plane_a, plane_b, table_a, table_b, *, one_mm: bool) -> torch.Tensor:
    """L9's operand ``[K, N]``: f32 ``bf16(A) + bf16(B)`` (two products), or
    their bf16 sum (``one_mm``)."""
    wa = _bf16(table_a)[_packing.unpack_plane([plane_a], 2, chunk=CHUNK).long()]
    wb = _bf16(table_b)[_packing.unpack_plane([plane_b], 2, chunk=CHUNK).long()]
    return wa + wb if one_mm else wa.float() + wb.float()


def sep_plain(x, plane_a, plane_b, scales, table_a, table_b, g, *, one_mm: bool):
    w = sep_weight(plane_a, plane_b, table_a, table_b, one_mm=one_mm)
    return group_acc_product(x, w, scales, g)


def int4_plain(x, plane, scales, g, zero: float, delta: float):
    m, k = x.shape
    ce, co = pair_fields(plane)
    codes = torch.stack([ce, co], dim=1).reshape(k, -1).float()  # exact
    parts = group_parts(x, codes, g)  # [K/g, M, N]
    xs = x.float().reshape(m, k // g, g).sum(dim=2).T[:, :, None]  # [K/g, M, 1]
    s = scales.float()[:, None, :]  # times a Python float: the float rounded to f32 first
    return (parts * (s * float(delta)) + xs * (s * float(zero))).sum(dim=0).to(torch.bfloat16)


def w3wide_plain(x, plane, scales, table, g):
    codes = _packing.unpack_w3_wide(plane, chunk=CHUNK).long()
    return group_acc_product(x, _bf16(table)[codes], scales, g)


def vmembw_plain(w: torch.Tensor, nops: int) -> torch.Tensor:
    v = w
    for _ in range(nops):
        v = v ^ (v >> 1)
    return v


# the plain versions of the functions with one plane and one table
PLAIN: dict[str, Callable] = {
    "pfdirect": pfdirect_plain,
    "slabstream": slabstream_plain,
    "w3wide": w3wide_plain,
}


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# function -> (C entry, argument types before the stream)
_ENTRIES = {
    "vmembw": ("flute_lab2_vmembw", [_P, _P, _I, _I]),
    "pfdirect": ("flute_lab2_pfdirect", [_P] * 5 + [_I] * 4),
    "sep": ("flute_lab2_sep", [_P] * 7 + [_I] * 5),
    "int4": ("flute_lab2_int4", [_P] * 4 + [_I] * 4 + [_F] * 2),
    "slabstream": ("flute_lab2_slabstream", [_P] * 5 + [_I] * 4),
    "w3wide": ("flute_lab2_w3wide", [_P] * 5 + [_I] * 4),
}


@functools.lru_cache(maxsize=None)
def _kernel_fn(name: str):
    """The C entry of lab function ``name`` (the library built at first
    use)."""
    from flute_tpu_torch.ops import _build

    entry, argtypes = _ENTRIES[name]
    lib = _build.load(SOURCE)
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes + [ctypes.c_void_p]
    lib.flute_cuda_error_string.restype = ctypes.c_char_p
    lib.flute_cuda_error_string.argtypes = [ctypes.c_int]
    return fn, lib.flute_cuda_error_string


def build_kernels() -> None:
    """Build (or load the already built) library and bind every entry."""
    for name in _ENTRIES:
        _kernel_fn(name)


def _launch(name: str, out: torch.Tensor, tensors: Sequence[torch.Tensor], args: Sequence
            ) -> torch.Tensor:
    """Launch kernel ``name`` on ``tensors`` (then ``out``) and the scalar
    ``args``, on PyTorch's current stream, and count the launch."""
    dev = out.device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"an operand is on {t.device}, the output on {dev}")
    if out.numel() == 0:
        return out
    fn, error_string = _kernel_fn(name)
    tensors = [t.contiguous() for t in tensors]  # alive until the launch is queued
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(*[t.data_ptr() for t in tensors], out.data_ptr(), *args, stream)
    if err != 0:
        raise RuntimeError(f"lab kernel {name} launch failed: {error_string(err).decode()} ({err})")
    LAUNCHES[name] += 1
    return out


def _on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (the plain version); any other device raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type == "cuda"


def _check(name: str, x, planes: Sequence[torch.Tensor], scales, tables, bm, bn, bk, g):
    """Raise ``ValueError`` on operands the lab's TPU grid does not take;
    returns the plane and the f32 tables on x's device."""
    if x.dim() != 2 or x.dtype != torch.bfloat16:
        raise ValueError(f"x must be 2-D bfloat16, got {x.dtype} {tuple(x.shape)}")
    m, k = x.shape
    if len(planes) != 1:
        raise ValueError(f"{name} reads one plane per operand, got {len(planes)}")
    plane = planes[0]
    n = scales.shape[1]
    rows = int(k * PLANE_ROWS_PER_K[name])
    if plane.dtype != torch.int32 or tuple(plane.shape) != (rows, n):
        raise ValueError(f"{name}: plane must be int32 [{rows}, {n}]")
    if scales.dtype != torch.bfloat16 or scales.dim() != 2 or g <= 0 or g % 2 \
            or scales.shape[0] * g != k:
        raise ValueError(f"scales must be bfloat16 [{k} / g, {n}] with an even g, got g={g}")
    if m % bm or n % bn or k % bk or bk <= 0 or bk % CHUNK or bk % g:
        raise ValueError(
            f"M={m}, N={n}, K={k} do not tile by bm={bm}, bn={bn}, bk={bk} "
            f"(bk a multiple of {CHUNK} and of g={g})")
    out = []
    for t in tables:
        t = torch.as_tensor(t, dtype=torch.float32).to(x.device)
        if tuple(t.shape) != (TABLE_SIZE[name],):
            raise ValueError(f"{name}: a table must have {TABLE_SIZE[name]} entries, "
                             f"got {tuple(t.shape)}")
        out.append(t.contiguous())
    return plane, out


def _gemm_out(x, scales):
    return torch.empty((x.shape[0], scales.shape[1]), dtype=torch.bfloat16, device=x.device)


def _table_gemm(name, x, planes, scales, table, bm, bn, bk, g, *, kernel: bool):
    plane, (t,) = _check(name, x, planes, scales, [table], bm, bn, bk, g)
    if not kernel:
        return PLAIN[name](x, plane, scales, t, g)
    m, k = x.shape
    return _launch(name, _gemm_out(x, scales), [x, plane, scales, t],
                   [m, scales.shape[1], k, g])


def _sep(x, planes_a, planes_b, scales, table_a, table_b, bm, bn, bk, g, one_mm, *,
         kernel: bool):
    pa, (ta, tb) = _check("sep", x, planes_a, scales, [table_a, table_b], bm, bn, bk, g)
    pb, _ = _check("sep", x, planes_b, scales, [], bm, bn, bk, g)
    if not kernel:
        return sep_plain(x, pa, pb, scales, ta, tb, g, one_mm=one_mm)
    m, k = x.shape
    return _launch("sep", _gemm_out(x, scales), [x, pa, pb, scales, ta, tb],
                   [m, scales.shape[1], k, g, int(bool(one_mm))])


def _int4(x, planes, scales, bm, bn, bk, g, zero, delta, *, kernel: bool):
    plane, _ = _check("int4", x, planes, scales, [], bm, bn, bk, g)
    if not kernel:
        return int4_plain(x, plane, scales, g, zero, delta)
    m, k = x.shape
    return _launch("int4", _gemm_out(x, scales), [x, plane, scales],
                   [m, scales.shape[1], k, g, float(zero), float(delta)])


def _vmembw(w, nops, *, kernel: bool):
    if w.dtype != torch.int32 or nops < 0:
        raise ValueError(f"vmembw takes int32 and nops >= 0, got {w.dtype} and {nops}")
    if not kernel:
        return vmembw_plain(w, nops)
    return _launch("vmembw", torch.empty(w.shape, dtype=w.dtype, device=w.device), [w],
                   [w.numel(), nops])


# ---------------------------------------------------------------------------
# The lab's functions, with the JAX signatures
# ---------------------------------------------------------------------------


def pfdirect(x, planes, scales, table, bm, bn, bk, g) -> torch.Tensor:
    """L8, ``run_pfdirect``: ``bf16(T[c])`` indexed from the raw 8-bit pair
    field; the kernel writes each chunk's operand to shared memory before
    its products."""
    return _table_gemm("pfdirect", x, planes, scales, table, bm, bn, bk, g, kernel=_on_card(x))


def slabstream(x, planes, scales, table, bm, bn, bk, g) -> torch.Tensor:
    """L11, ``run_slabstream``: L8's function; the kernel feeds each decoded
    pair straight into its products, in registers."""
    return _table_gemm("slabstream", x, planes, scales, table, bm, bn, bk, g,
                       kernel=_on_card(x))


def w3wide(x, planes, scales, table, bm, bn, bk, g) -> torch.Tensor:
    """L12, ``run_w3wide``: ``bf16(T3[c])`` from the wide 3-bit layout."""
    return _table_gemm("w3wide", x, planes, scales, table, bm, bn, bk, g, kernel=_on_card(x))


def sep(x, planes_a, planes_b, scales, table_a, table_b, bm, bn, bk, g, one_mm: bool
        ) -> torch.Tensor:
    """L9, ``run_sep``: ``T[c] = A[c & 3] + B[c >> 2]`` over two 2-bit
    planes; two products (``one_mm=False``) or one on the bf16 sum."""
    return _sep(x, planes_a, planes_b, scales, table_a, table_b, bm, bn, bk, g, one_mm,
                kernel=_on_card(x))


def int4(x, planes, scales, bm, bn, bk, g, zero: float, delta: float) -> torch.Tensor:
    """L10, ``run_int4``: the affine table ``z + c·δ`` folded into the group
    sums; no table is read."""
    return _int4(x, planes, scales, bm, bn, bk, g, zero, delta, kernel=_on_card(x))


def vmembw(w: torch.Tensor, nops: int) -> torch.Tensor:
    """L7, ``run_vmembw``'s kernel: ``v ← v ^ (v >> 1)`` ``nops`` times on an
    int32 block."""
    return _vmembw(w, nops, kernel=_on_card(w))


_IMPL = {
    "pfdirect": functools.partial(_table_gemm, "pfdirect"),
    "slabstream": functools.partial(_table_gemm, "slabstream"),
    "w3wide": functools.partial(_table_gemm, "w3wide"),
    "sep": _sep,
    "int4": _int4,
    "vmembw": _vmembw,
}
FUNCTIONS: dict[str, Callable] = {
    "vmembw": vmembw, "pfdirect": pfdirect, "sep": sep, "int4": int4, "slabstream": slabstream,
    "w3wide": w3wide,
}


def plain(name: str, *args, **kw) -> torch.Tensor:
    """The plain version of lab function ``name``, with its JAX signature, on
    the device of its tensors (for holding a kernel against it on the
    card)."""
    return _IMPL[name](*args, **kw, kernel=False)
