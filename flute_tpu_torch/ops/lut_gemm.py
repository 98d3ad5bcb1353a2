"""Fused LUT-dequantize + GEMM, counterpart of ``flute_tpu/ops/lut_gemm.py``.

    y[M, N] = x[M, K] @ (table[codes[K, N]] * scales[K // g, N] expanded)

Dispatch is by the tensors' device:

* CPU: the plain PyTorch version (unpack -> :func:`dequantize_codes` or
  :func:`dequantize_codes_pair` -> f32-accumulated matmul) for every layout.
* CUDA: one Hopper kernel per layout (see the note at the top of each
  source): ``layout="w4sym"`` -> K1 ``csrc/lut_gemm_w4sym.cu``;
  ``layout="plane"`` at 2, 3 and 4 bits -> K2 ``csrc/lut_gemm_plane.cu``;
  ``layout="w3wide"`` -> K3 ``csrc/lut_gemm_w3wide.cu`` (K1, K2 and K3 run
  the tensor-core loop in bf16 and f16 and their SIMT kernel in f32 or at a
  chunk the loop does not take: :func:`lut_path`); ``pair_values``
  (joint pair lookup of HIGGS layers) on the plane layout at 2, 3 and 4
  bits -> K4 ``csrc/lut_gemm_pair.cu``, in bf16 or f16 only (an f32 call
  raises ``NotImplementedError``, as the JAX package's ``pair_lut`` mode
  does, and a wide 3-bit plane with ``pair_values`` raises ``ValueError``).
  A config with ``lut_mode="pair_lut"`` and no ``pair_values`` takes the
  same route on the plane layout, with the separable joint table that JAX
  builds from the scalar one. A build or launch failure raises.
  K1-K4 on the tensor cores take their route by M alone
  (:func:`~flute_tpu_torch.ops.kernel_config.mma_route`): the decode loop
  of ``csrc/lut_gemm_mma.cuh`` below
  :data:`~flute_tpu_torch.ops.kernel_config.MID_MIN_M` rows, the mid route
  of the wide-M kernel of ``csrc/lut_gemm_wide_m.cuh`` from it (row tiles
  of 16-64 rows, one split of K a block, the loop's workspace and
  reduction), and that kernel's wide route (warpgroup MMA, no split-K
  workspace) from :data:`~flute_tpu_torch.ops.kernel_config.WIDE_MIN_M`
  rows; each gives a row the loop's bits.

:func:`dequantize_codes`, :func:`dequantize_codes_pair` and
:func:`lut_qgemm_reference` are the oracle and define the semantics.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from flute_tpu_torch import bitutils
from flute_tpu_torch import packing as _packing
from flute_tpu_torch.ops.kernel_config import (
    MMA_BLOCK_N,
    KernelConfig,
    MmaPlan,
    launch_config,
    launch_path,
    mma_fields,
    mma_plan,
    mma_route,
    mma_takes_chunk,
    mma_word_rows,
    mid_plan,
    wide_plan,
)

# Launches of each kernel, by layout; a wrapper adds one where it launches
# its kernel and nowhere else, so a run can show which kernels its path
# went through.
LAUNCHES = {"w4sym": 0, "plane": 0, "w3wide": 0, "pair": 0}
# Of those, the launches that took the wide-M kernel (the route of K1-K4 at
# prefill M), by layout.
WIDE_LAUNCHES = {"w4sym_wide": 0, "plane_wide": 0, "w3wide_wide": 0, "pair_wide": 0}
# Of those, the launches that took the wide-M kernel's mid route (K1-K4
# from MID_MIN_M to WIDE_MIN_M rows), by layout.
MID_LAUNCHES = {"w4sym_mid": 0, "plane_mid": 0, "w3wide_mid": 0, "pair_mid": 0}

_DTYPE_TAG = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

# ---------------------------------------------------------------------------
# Oracle
# ---------------------------------------------------------------------------


def _expand_groups(scales: torch.Tensor, group_size: int) -> torch.Tensor:
    """``[K/g, N]`` -> ``[K, N]``, each row repeated ``g`` times (a view and
    one copy: unlike ``repeat_interleave`` it never syncs with the device,
    so it can be captured in a CUDA graph)."""
    g, n = scales.shape
    return scales[:, None, :].expand(g, group_size, n).reshape(g * group_size, n)


def dequantize_codes(
    codes: torch.Tensor, scales: torch.Tensor, table: torch.Tensor, dtype
) -> torch.Tensor:
    """``table[codes] * scales`` with group expansion; lookup and scale
    multiply are rounded in ``dtype`` as the kernel rounds them."""
    k = codes.shape[0]
    group_size = k // scales.shape[0]
    t = table.to(device=codes.device, dtype=dtype)
    return t[codes.long()] * _expand_groups(scales.to(dtype), group_size)


def dequantize_codes_pair(
    codes: torch.Tensor, scales: torch.Tensor, pair_values: torch.Tensor, dtype
) -> torch.Tensor:
    """Oracle for joint pair (vector) dequantization: rows (2j, 2j+1) take
    their values from ``pair_values[c_2j, c_2j+1]`` (shape [E, E, 2])."""
    k = codes.shape[0]
    group_size = k // scales.shape[0]
    pv = pair_values.to(device=codes.device, dtype=dtype)
    ce, co = codes[0::2].long(), codes[1::2].long()
    v = pv[ce, co]  # [K/2, N, 2]
    deq = torch.stack([v[..., 0], v[..., 1]], dim=1).reshape(codes.shape)
    return deq * _expand_groups(scales.to(dtype), group_size)


def separable_pair_values(table: torch.Tensor, num_bits: int) -> torch.Tensor:
    """The joint pair table ``[2^b, 2^b, 2]`` of a scalar table,
    ``pv[ce, co] = (table[ce], table[co])``: what JAX's ``pair_lut`` mode
    looks up when it is given no ``pair_values``."""
    e = 2**num_bits
    t = table.float()
    return torch.stack([t[:, None].expand(e, e), t[None, :].expand(e, e)], dim=-1)


def lut_qgemm_reference(
    x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor, table: torch.Tensor
) -> torch.Tensor:
    """Ground truth: dequantize in x's dtype, exact products accumulated in
    f32 (never TF32), one rounding to x's dtype."""
    deq = dequantize_codes(codes, scales, table, x.dtype)
    y = torch.matmul(x.float(), deq.float())
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Plain version and kernel
# ---------------------------------------------------------------------------


def lut_qgemm_plain(
    x2: torch.Tensor,
    planes: Sequence[torch.Tensor],
    scales: torch.Tensor,
    table: torch.Tensor,
    *,
    num_bits: int,
    chunk: int,
    layout: str,
    pair_values: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain PyTorch version of every layout for a 2-D ``x2``: unpack
    the codes, dequantize them, f32-accumulated matmul."""
    codes = _packing.unpack(list(planes), num_bits, chunk=chunk, layout=layout)
    if pair_values is not None:
        deq = dequantize_codes_pair(codes, scales, pair_values, x2.dtype)
        return torch.matmul(x2.float(), deq.float()).to(x2.dtype)
    return lut_qgemm_reference(x2, codes, scales, table)


# kernel -> (source, C entry, its pointer and int arguments before the
# stream, its tail): x, planes, scales, table (the pair table for "pair"),
# y [, the split-K workspace], then M, N, K, group_size, chunk [, num_bits],
# dtype, then the tail: "simt" block_m; "mma" m_tiles, splits and vec;
# "both" block_m, m_tiles, splits and vec, m_tiles 0 selecting the SIMT
# kernel
_KERNELS = {
    "w4sym": ("lut_gemm_w4sym.cu", "flute_lut_qgemm_w4sym", 6, 10, "both"),
    "plane": ("lut_gemm_plane.cu", "flute_lut_qgemm_plane", 7, 11, "both"),
    "w3wide": ("lut_gemm_w3wide.cu", "flute_lut_qgemm_w3wide", 6, 10, "both"),
    "pair": ("lut_gemm_pair.cu", "flute_lut_qgemm_pair", 7, 10, "mma"),
}


# the wide-M kernel's C entries, by layout: (source, C entry, pointer and
# int arguments before the stream): x, planes, scales, table, y, then M, N,
# K, group_size, chunk [, num_bits], dtype, splits and vec
_WIDE = {
    "w4sym": ("lut_gemm_w4sym.cu", "flute_lut_qgemm_w4sym_wide", 5, 8),
    "plane": ("lut_gemm_plane.cu", "flute_lut_qgemm_plane_wide", 6, 9),
    "w3wide": ("lut_gemm_w3wide.cu", "flute_lut_qgemm_w3wide_wide", 5, 8),
    "pair": ("lut_gemm_pair.cu", "flute_lut_qgemm_pair_wide", 6, 9),
}
# the mid route's C entries, by layout: (source, C entry, pointer and int
# arguments before the stream): x, planes, scales, table, y, the split-K
# workspace, then M, N, K, group_size, chunk [, num_bits], dtype, rows,
# splits and vec
_MID = {
    "w4sym": ("lut_gemm_w4sym.cu", "flute_lut_qgemm_w4sym_mid", 6, 9),
    "plane": ("lut_gemm_plane.cu", "flute_lut_qgemm_plane_mid", 7, 10),
    "w3wide": ("lut_gemm_w3wide.cu", "flute_lut_qgemm_w3wide_mid", 6, 9),
    "pair": ("lut_gemm_pair.cu", "flute_lut_qgemm_pair_mid", 7, 10),
}


@functools.lru_cache(maxsize=None)
def _entry(source: str, entry: str, n_ptr: int, n_int: int):
    """C entry ``entry`` of the library of ``csrc/<source>`` (built at
    first use) and the library's error-string function."""
    from flute_tpu_torch.ops import _build

    lib = _build.load(source)
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    lib.flute_cuda_error_string.restype = ctypes.c_char_p
    lib.flute_cuda_error_string.argtypes = [ctypes.c_int]
    return fn, lib.flute_cuda_error_string


def _kernel_fn(kernel: str):
    """The C entry of ``kernel``'s library (built at first use)."""
    return _entry(*_KERNELS[kernel][:4])


def build_kernels() -> None:
    """Build (or load the already built) kernel libraries, one ``nvcc``
    process per source, all at once."""
    from flute_tpu_torch.ops import _build

    _build.build_all([source for source, *_ in _KERNELS.values()])
    for kernel in _KERNELS:
        _kernel_fn(kernel)
    for wide in (*_WIDE.values(), *_MID.values()):
        _entry(*wide)


def _check_operands(
    x2: torch.Tensor,
    planes: Sequence[torch.Tensor],
    plane_rows: Sequence[int],
    scales: torch.Tensor,
    table: torch.Tensor,
    table_shape: tuple[int, ...],
    group_size: int,
    chunk: int,
    table_name: str = "table",
    simt_block_m: int = 0,
) -> None:
    """Raise ``ValueError`` on operands a kernel does not take: another
    device, a non-contiguous tensor, a dtype or shape it was not built for."""
    m, k = x2.shape
    n = scales.shape[1]
    dev = x2.device
    named = [("x", x2), *((f"plane{i}", p) for i, p in enumerate(planes)),
             ("scales", scales), (table_name, table)]
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x2.dtype not in _DTYPE_TAG:
        raise ValueError(f"unsupported compute dtype {x2.dtype}")
    if scales.dtype != x2.dtype:
        raise ValueError(f"scales dtype {scales.dtype} != x dtype {x2.dtype}")
    if len(planes) != len(plane_rows):
        raise ValueError(f"expected {len(plane_rows)} plane(s), got {len(planes)}")
    for i, (p, rows) in enumerate(zip(planes, plane_rows)):
        if p.dtype != torch.int32 or tuple(p.shape) != (rows, n):
            raise ValueError(f"plane{i} must be int32 [{rows}, {n}]")
    if table.dtype != torch.float32 or tuple(table.shape) != table_shape:
        raise ValueError(f"{table_name} must be float32 {list(table_shape)}")
    if k % chunk or group_size % 2 or k % group_size:
        raise ValueError(f"K={k} chunk={chunk} group_size={group_size} not supported")
    if -(-m // (simt_block_m or launch_config(m).block_m)) > 65535:
        raise ValueError(f"M={m} exceeds the kernel's grid")


def _launch(
    kernel: str,
    x2: torch.Tensor,
    plane_ptrs: Sequence[Optional[int]],
    scales: torch.Tensor,
    table: torch.Tensor,
    *,
    group_size: int,
    chunk: int,
    extra: tuple[int, ...] = (),
    plan: Optional[MmaPlan] = None,
    vec: bool = True,
    simt_block_m: int = 0,
) -> torch.Tensor:
    """Launch ``kernel`` on PyTorch's current stream (operands already
    checked) and count the launch; returns ``[M, N]`` in x's dtype. With a
    ``plan`` (the tensor-core loop) it passes the split-K workspace,
    allocated here, and the plan's fields; without one, K1, K2 and K3 run
    their SIMT kernel, with ``simt_block_m`` rows per block where a tuner
    chose them."""
    m, k = x2.shape
    n = scales.shape[1]
    dev = x2.device
    y = torch.empty((m, n), dtype=x2.dtype, device=dev)
    if m == 0:
        return y
    fn, error_string = _kernel_fn(kernel)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tail_kind = _KERNELS[kernel][4]
    ws = None
    if plan is not None:
        shape = plan.workspace_shape(m, n)
        ws = None if shape is None else torch.empty(shape, dtype=torch.float32, device=dev)
    simt = (simt_block_m or launch_config(m).block_m,)
    loop = (0, 1, 0) if plan is None else (plan.m_tiles, plan.splits, int(vec))
    work = () if tail_kind == "simt" else (None if ws is None else ws.data_ptr(),)
    tail = {"simt": simt, "mma": loop, "both": simt + loop}[tail_kind]
    with torch.cuda.device(dev):
        err = fn(
            x2.data_ptr(), *plane_ptrs, scales.data_ptr(), table.data_ptr(), y.data_ptr(), *work,
            m, n, k, group_size, chunk, *extra, _DTYPE_TAG[x2.dtype], *tail, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{kernel} kernel launch failed: {error_string(err).decode()} ({err})"
        )
    LAUNCHES[kernel] += 1
    return y


def _launch_wide(
    kernel: str,
    x2: torch.Tensor,
    plane_ptrs: Sequence[Optional[int]],
    scales: torch.Tensor,
    table: torch.Tensor,
    *,
    group_size: int,
    chunk: int,
    extra: tuple[int, ...] = (),
    vec: bool = True,
) -> torch.Tensor:
    """Launch the wide-M kernel for K1 (``kernel="w4sym"``), K2
    (``"plane"``), K3 (``"w3wide"``) or K4 (``"pair"``) on PyTorch's
    current stream (operands checked, x on a 16-byte boundary) with
    :func:`wide_plan`'s split, and count the launch; returns ``[M, N]`` in
    x's dtype. Raises on a refused launch."""
    m, k = x2.shape
    n = scales.shape[1]
    dev = x2.device
    y = torch.empty((m, n), dtype=x2.dtype, device=dev)
    if m == 0:
        return y
    fn, error_string = _entry(*_WIDE[kernel])
    plan = wide_plan(m, n, k, chunk)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(
            x2.data_ptr(), *plane_ptrs, scales.data_ptr(), table.data_ptr(), y.data_ptr(),
            m, n, k, group_size, chunk, *extra, _DTYPE_TAG[x2.dtype], plan.splits, int(vec),
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{kernel} wide-M kernel launch failed: {error_string(err).decode()} ({err})"
        )
    LAUNCHES[kernel] += 1
    WIDE_LAUNCHES[f"{kernel}_wide"] += 1
    return y


def _launch_mid(
    kernel: str,
    x2: torch.Tensor,
    plane_ptrs: Sequence[Optional[int]],
    scales: torch.Tensor,
    table: torch.Tensor,
    *,
    group_size: int,
    chunk: int,
    extra: tuple[int, ...] = (),
    vec: bool = True,
) -> torch.Tensor:
    """Launch the wide-M kernel's mid route for K1 (``kernel="w4sym"``), K2
    (``"plane"``), K3 (``"w3wide"``) or K4 (``"pair"``) on PyTorch's
    current stream (operands checked, x on a 16-byte boundary) with
    :func:`mid_plan`'s row tile and split, and the split-K workspace
    allocated here; count the launch (the kernel and, with several splits,
    the reduction: one call). Returns ``[M, N]`` in
    x's dtype. Raises on a refused launch."""
    m, k = x2.shape
    n = scales.shape[1]
    dev = x2.device
    y = torch.empty((m, n), dtype=x2.dtype, device=dev)
    if m == 0:
        return y
    fn, error_string = _entry(*_MID[kernel])
    plan = mid_plan(m, n, k, chunk)
    shape = plan.workspace_shape(m, n)
    ws = None if shape is None else torch.empty(shape, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(
            x2.data_ptr(), *plane_ptrs, scales.data_ptr(), table.data_ptr(), y.data_ptr(),
            None if ws is None else ws.data_ptr(), m, n, k, group_size, chunk, *extra,
            _DTYPE_TAG[x2.dtype], plan.rows, plan.splits, int(vec), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{kernel} mid-M kernel launch failed: {error_string(err).decode()} ({err})"
        )
    LAUNCHES[kernel] += 1
    MID_LAUNCHES[f"{kernel}_mid"] += 1
    return y


def kernel_instances(kernel: str, chunk: int = 256) -> list[dict]:
    """Each tensor-core instantiation of K1 (``kernel="w4sym"``), K2
    (``"plane"``) or K4 (``"pair"``) at 2, 3 and 4 bits, or K3
    (``"w3wide"``, with a chunk's scales once per field and with the
    per-field cache: ``scales`` "chunk" or "field"): the decode loop at 1, 2
    and 4 m16 tiles a warp and the wide-M kernel, in bf16 and f16, and the
    wide-M kernel's mid route at each row tile, with its registers, shared
    memory (static and dynamic at ``chunk``) and blocks per SM from the
    CUDA runtime on the current card."""
    count = {"w4sym": 8, "w3wide": 16}.get(kernel, 24)
    return (_instances(kernel, f"flute_lut_qgemm_{kernel}_instance", chunk, count)
            + _instances(kernel, f"flute_lut_qgemm_{kernel}_mid_instance", chunk, count))


def _instances(kernel: str, entry: str, chunk: int, count: int) -> list[dict]:
    """Instantiations 0..count-1 of ``entry`` (8 a bit width), as
    :func:`kernel_instances` reports them."""
    fn, error_string = _entry(_WIDE[kernel][0], entry, 0, 2)
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_char_p)] + [
        ctypes.POINTER(ctypes.c_int)] * 3
    out = []
    for i in range(count):
        name = ctypes.c_char_p()
        regs, smem, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        err = fn(i, chunk, ctypes.byref(name), ctypes.byref(regs), ctypes.byref(smem),
                 ctypes.byref(blocks))
        if err != 0:
            raise RuntimeError(f"{entry}({i}) failed: {error_string(err).decode()} ({err})")
        bits = {"w4sym": 4, "w3wide": 3}.get(kernel) or (2, 3, 4)[i // 8]
        row = dict(kernel=kernel, bits=bits, instance=name.value.decode(),
                   registers=regs.value, smem_bytes=smem.value,
                   blocks_per_sm=blocks.value, chunk=chunk)
        if kernel == "w3wide":
            row["scales"] = ("chunk", "field")[i // 8]
        out.append(row)
    return out


def probe_operands(trials: int, dtype: torch.dtype, seed: int = 0):
    """Inputs of :func:`wgmma_probe`, made with numpy: x and w ``[trials,
    128, 16]`` with 8 significant bits (exact in bf16 and f16), signs and
    exponents in [-12, 12) drawn per value, so a step's 16 products spread
    over 2^48 and the tensor core's alignment of them shows; c ``[trials,
    128, 128]`` f32 of spread magnitudes, zero in every fourth trial."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def values(shape):
        mant = rng.integers(128, 256, size=shape) / 128.0
        sign = rng.choice([-1.0, 1.0], size=shape)
        return (sign * mant * np.exp2(rng.integers(-12, 12, size=shape))).astype(np.float32)

    x = values((trials, 128, 16))
    w = values((trials, 128, 16))
    c = (rng.standard_normal((trials, 128, 128))
         * np.exp2(rng.integers(-16, 16, size=(trials, 128, 128)))).astype(np.float32)
    c[::4] = 0.0
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype), torch.from_numpy(c))


def wgmma_probe(device, dtype: torch.dtype = torch.bfloat16, trials: int = 512,
                seed: int = 0) -> dict:
    """The tensor core's bits on one k16 step, ``d = c + x w^T`` per row of x
    and column of w, on the card: by ``mma.sync.m16n8k16`` (the decode
    loop's instruction and operand roles), by wgmma with x as A and w as B
    from shared memory (orientation "a"), and by wgmma with w as A from
    registers and x as B (orientation "b", the wide-M kernel's). Returns
    each orientation's count of outputs whose bits differ from mma.sync's,
    and the largest error of each against the exact sum over its own
    rounding (a wrong operand layout would show there)."""
    x, w, c = (t.to(device) for t in probe_operands(trials, dtype, seed))
    out = torch.empty((trials, 3, 128, 128), dtype=torch.float32, device=device)
    fn, error_string = _entry("lut_gemm_w4sym.cu", "flute_wgmma_probe", 4, 2)
    with torch.cuda.device(device):
        err = fn(x.data_ptr(), w.data_ptr(), c.data_ptr(), out.data_ptr(), trials,
                 _DTYPE_TAG[dtype], torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flute_wgmma_probe failed: {error_string(err).decode()} ({err})")
    torch.cuda.synchronize(device)
    exact = c.double() + torch.matmul(x.double(), w.double().transpose(1, 2))
    bits = out.view(torch.int32)
    scale = exact.abs() + torch.matmul(x.double().abs(), w.double().abs().transpose(1, 2)) + \
        c.double().abs()
    res = {"trials": trials, "dtype": str(dtype).split(".")[-1], "outputs": trials * 128 * 128}
    for i, name in enumerate(("mma_sync", "a", "b")):
        if i:
            res[f"{name}_differs"] = int((bits[:, i] != bits[:, 0]).sum())
        res[f"{name}_max_rel_err"] = float(((out[:, i].double() - exact).abs() / scale).max())
    return res


def lut_path(dtype: torch.dtype, num_bits: int, chunk: int, layout: str = "plane") -> str:
    """The kernel that K1 (``layout="w4sym"``), K2 (``"plane"``) or K3
    (``"w3wide"``) runs for a call, chosen before the launch from the
    compute dtype, the layout and the pack chunk alone, never from M:
    ``"mma"``, the tensor-core loop, for bf16 and f16 at a chunk the loop
    takes (:func:`~flute_tpu_torch.ops.kernel_config.mma_takes_chunk`);
    ``"simt"``, the SIMT kernel, otherwise. (K4 always runs on the tensor
    cores.) On the tensor cores :func:`mma_route` then picks the loop, the
    wide-M kernel or its mid route by M."""
    return launch_path(dtype, num_bits, chunk, layout)


def _launch_planes(
    kernel: str,
    x2: torch.Tensor,
    planes: Sequence[torch.Tensor],
    scales: torch.Tensor,
    table: torch.Tensor,
    *,
    group_size: int,
    chunk: int,
    extra: tuple[int, ...] = (),
    loop: bool = True,
    m_tiles: int = 0,
    simt_block_m: int = 0,
) -> torch.Tensor:
    """Launch a LUT-GEMM with a loop path (K1–K4; operands checked). On the
    tensor cores (``loop``) x is copied to a 16-byte boundary if it is not
    on one and ``vec`` says whether the kernel may read planes and scales
    in 16- and 8-byte pieces; the call takes the route :func:`mma_route`
    gives its M: the wide-M kernel, its mid route, or the decode loop with
    :func:`mma_plan`'s plan (and a tuner's ``m_tiles`` where set). Else the
    SIMT kernel runs (with a tuner's ``simt_block_m`` where set)."""
    # the C entry's plane pointers (x, scales, table, y and the workspace
    # aside), null for a plane the layout does not have
    n_planes = _KERNELS[kernel][2] - 5
    ptrs = [p.data_ptr() for p in planes] + [None] * (n_planes - len(planes))
    kw = dict(group_size=group_size, chunk=chunk, extra=extra)
    if not loop:
        return _launch(kernel, x2, ptrs, scales, table, simt_block_m=simt_block_m, **kw)
    if x2.data_ptr() % 16:  # the loop copies x in 16-byte pieces
        x2 = x2.clone()
    m, k = x2.shape
    n = scales.shape[1]
    vec = (n % 4 == 0 and scales.data_ptr() % 8 == 0
           and all(p.data_ptr() % 16 == 0 for p in planes))
    bits = extra[0] if extra else (3 if kernel == "w3wide" else 4)
    route = mma_route(m, bits, chunk, kernel, group_size)
    if route == "wide":
        return _launch_wide(kernel, x2, ptrs, scales, table, vec=vec, **kw)
    if route == "mid":
        return _launch_mid(kernel, x2, ptrs, scales, table, vec=vec, **kw)
    return _launch(kernel, x2, ptrs, scales, table, plan=mma_plan(m, n, k, chunk, m_tiles),
                   vec=vec, **kw)


def lut_qgemm_w4sym_cuda(
    x2: torch.Tensor,
    plane: torch.Tensor,
    scales: torch.Tensor,
    table: torch.Tensor,
    *,
    group_size: int,
    chunk: int,
    m_tiles: int = 0,
    simt_block_m: int = 0,
) -> torch.Tensor:
    """Launch K1, the Hopper w4sym kernel (on the tensor cores, by the route
    :func:`mma_route` gives M, or the SIMT kernel, as :func:`lut_path`
    says), for a 2-D ``x2`` ``[M, K]``; returns ``[M, N]`` in x's dtype.
    Counts one launch per call."""
    k = x2.shape[1]
    if chunk % 8:
        raise ValueError(f"chunk={chunk} not supported by the w4sym layout")
    _check_operands(x2, [plane], [k // 8], scales, table, (16,), group_size, chunk,
                    simt_block_m=simt_block_m)
    return _launch_planes("w4sym", x2, [plane], scales, table, group_size=group_size,
                          chunk=chunk, loop=lut_path(x2.dtype, 4, chunk, "w4sym") == "mma",
                          m_tiles=m_tiles, simt_block_m=simt_block_m)


def lut_qgemm_plane_cuda(
    x2: torch.Tensor,
    planes: Sequence[torch.Tensor],
    scales: torch.Tensor,
    table: torch.Tensor,
    *,
    num_bits: int,
    group_size: int,
    chunk: int,
    m_tiles: int = 0,
    simt_block_m: int = 0,
) -> torch.Tensor:
    """Launch K2, the Hopper general-table pair-plane kernel (on the tensor
    cores, by the route :func:`mma_route` gives M, or the SIMT kernel, as
    :func:`lut_path` says), for a 2-D ``x2`` ``[M, K]`` and 2-, 3- (2+1
    planes) or 4-bit codes; returns ``[M, N]`` in x's dtype. Counts one
    launch per call."""
    if num_bits not in (2, 3, 4):
        raise ValueError(f"the plane kernel takes 2, 3 or 4 bits, not {num_bits}")
    fmt = _packing.PackFormat(num_bits=num_bits, chunk=chunk)  # validates chunk
    k = x2.shape[1]
    rows = [fmt.plane_rows(k, i) for i in range(len(fmt.plane_bits))]
    _check_operands(x2, planes, rows, scales, table, (2**num_bits,), group_size, chunk,
                    simt_block_m=simt_block_m)
    return _launch_planes("plane", x2, planes, scales, table, group_size=group_size,
                          chunk=chunk, extra=(num_bits,),
                          loop=lut_path(x2.dtype, num_bits, chunk) == "mma",
                          m_tiles=m_tiles, simt_block_m=simt_block_m)


def lut_qgemm_pair_cuda(
    x2: torch.Tensor,
    planes: Sequence[torch.Tensor],
    scales: torch.Tensor,
    pair_values: torch.Tensor,
    *,
    num_bits: int,
    group_size: int,
    chunk: int,
    m_tiles: int = 0,
) -> torch.Tensor:
    """Launch K4, the Hopper joint pair-lookup kernel (by the route
    :func:`mma_route` gives M: the tensor-core loop of
    ``csrc/lut_gemm_mma.cuh``, split-K as :func:`mma_plan` says, with an f32
    workspace and a second kernel that adds the splits in order, or from
    ``MID_MIN_M`` rows the wide-M kernel's mid route, or from
    ``WIDE_MIN_M`` rows the wide-M kernel, each with the loop's bits), for
    a 2-D ``x2`` ``[M, K]`` in bf16 or f16, 2-, 3- (2+1 planes) or 4-bit pair
    planes and a float32 pair table ``[2^b, 2^b, 2]``; returns ``[M, N]`` in
    x's dtype. Counts one launch per call."""
    if num_bits not in (2, 3, 4):
        raise ValueError(f"the pair kernel takes 2, 3 or 4 bits, not {num_bits}")
    if x2.dtype not in (torch.bfloat16, torch.float16):
        raise NotImplementedError("pair_lut requires a 16-bit compute dtype")
    fmt = _packing.PackFormat(num_bits=num_bits, chunk=chunk)  # validates chunk
    k = x2.shape[1]
    rows = [fmt.plane_rows(k, i) for i in range(len(fmt.plane_bits))]
    e = 2**num_bits
    _check_operands(x2, planes, rows, scales, pair_values, (e, e, 2), group_size, chunk,
                    table_name="pair_values")
    if not mma_takes_chunk(num_bits, chunk):
        raise ValueError(f"chunk={chunk} not taken by the pair kernel at {num_bits} bits "
                         "(its first plane needs a multiple of 4 word rows per chunk, and "
                         "a chunk's x ring must fit shared memory)")
    return _launch_planes("pair", x2, planes, scales, pair_values, group_size=group_size,
                          chunk=chunk, extra=(num_bits,), m_tiles=m_tiles)


def mma_k_order(num_bits: int, chunk: int, layout: str = "plane") -> torch.Tensor:
    """The loop's order of one pack chunk's K rows on the tensor cores (K4,
    K1 and K2 at 4 bits and at 2 and 3 in the same geometry, K3's word
    triples), mirrored from ``csrc/lut_gemm_mma.cuh``: entry ``[q, s, slot]``
    is the K row (within the chunk) that mma step ``(q, s)`` multiplies at
    k-slot ``slot`` (0..15). Item ``q`` is word rows ``4q..4q+3`` (first-plane
    rows, or triple rows for ``layout="w3wide"``), lane ``l`` taking row
    ``4q + l % 4``; step ``s`` takes field ``2s`` of those rows as slots 0..7
    and field ``2s + 1`` as slots 8..15, slot ``2t + h`` (``+ 8``) being row
    ``h`` of the pair of word row ``4q + t``. Field ``i`` of word row ``j``
    is pair-row ``i * kc + j`` (the packed format)."""
    kc = mma_word_rows(num_bits, chunk, layout)
    fields = mma_fields(num_bits, layout)
    q = torch.arange(kc // 4)[:, None, None]
    s = torch.arange(fields // 2)[None, :, None]
    slot = torch.arange(16)[None, None, :]
    field = 2 * s + slot // 8
    word_row = 4 * q + (slot % 8) // 2
    return 2 * (field * kc + word_row) + slot % 2


def wide_k_order(num_bits: int, chunk: int, layout: str = "plane") -> torch.Tensor:
    """The wide-M kernel's order of one pack chunk's K rows (K1, K2 and K4's
    pair planes; K3's triples with ``layout="w3wide"``), mirrored from the x
    side of ``csrc/lut_gemm_wide_m.cuh``: x is staged in 8-row stretches,
    and step ``(q, s)`` reads stretch ``s kc / 2 + q`` as k-slots 0..7 and
    the stretch ``kc / 4`` after it (the descriptor's leading-byte offset)
    as 8..15. Entry ``[q, s, slot]`` is the K row (within the chunk); it
    equals :func:`mma_k_order`'s."""
    kc = mma_word_rows(num_bits, chunk, layout)
    q = torch.arange(kc // 4)[:, None, None]
    s = torch.arange(mma_fields(num_bits, layout) // 2)[None, :, None]
    slot = torch.arange(16)[None, None, :]
    stretch = s * (kc // 2) + q + (slot // 8) * (kc // 4)
    return 8 * stretch + slot % 8


def wide_a_rows(num_bits: int, chunk: int, layout: str = "plane") -> torch.Tensor:
    """The K rows of the wide-M kernel's A registers, mirrored from its
    weight side: entry ``[q, s, t, r, h]`` is the K row (within the chunk)
    of half ``h`` of A register ``r`` of a lane with ``t = lane % 4`` at
    step ``(q, s)``, which holds field ``2s + r // 2`` of word row
    ``4q + t`` (registers 0 and 2 of column ``lane / 4``, 1 and 3 of the
    column 8 after it; at K3's 16 fields steps 0..3 and 4..7 of an item
    are two units of A registers, the same map). wgmma's A layout puts that
    register at k-slots ``2t + 8 (r // 2) + h``, so the entry must equal
    ``wide_k_order(...)[q, s, 2t + 8 (r // 2) + h]``."""
    kc = mma_word_rows(num_bits, chunk, layout)
    q = torch.arange(kc // 4)[:, None, None, None, None]
    s = torch.arange(mma_fields(num_bits, layout) // 2)[None, :, None, None, None]
    t = torch.arange(4)[None, None, :, None, None]
    r = torch.arange(4)[None, None, None, :, None]
    h = torch.arange(2)[None, None, None, None, :]
    field = 2 * s + r // 2
    return 2 * (field * kc + 4 * q + t) + h


def pair_table(layout: str, table: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The tensor-core loop's table of 16-bit pairs, mirrored from each
    kernel's fill (``csrc/lut_gemm_pair_decoder.cuh``): ``[entries, 2]`` in
    ``dtype``, row ``index`` the (even, odd) K rows' values that a field
    names, before the scale.

    * ``"pair"`` (K4): ``table`` is the joint ``[E, E, 2]``; index
      ``ce | co << b`` names ``table[ce, co]``.
    * ``"plane"`` (K2): ``table`` is ``[E]``; index ``ce | co << b`` names
      ``(table[ce], table[co])``.
    * ``"w3wide"`` (K3): ``table`` is ``[8]``; the six-bit field
      ``ce | co << 3`` is the index and names ``(table[ce], table[co])``.
    * ``"w4sym"`` (K1): ``table`` is ``[16]``; index the w4sym byte
      ``m_e | m_o << 3 | s_e << 6 | s_o << 7`` names ``(table[m_e],
      table[m_o])``, each rounded to ``dtype`` and its sign flipped where
      its sign bit is set (``table[c + 8] == -table[c]``).
    """
    dev = table.device
    if layout == "w4sym":
        f = torch.arange(256, device=dev)
        mags = table[:8].to(dtype)
        v = torch.stack([mags[f & 7], mags[(f >> 3) & 7]], dim=-1)
        sign = torch.stack([(f >> 6) & 1, f >> 7], dim=-1).bool()
        return torch.where(sign, -v, v)
    e = table.shape[0]
    if layout in ("plane", "w3wide"):
        pc = torch.arange(e * e, device=dev)
        t = table.to(dtype)
        return torch.stack([t[pc % e], t[pc // e]], dim=-1)
    if layout == "pair":
        return table.to(dtype).transpose(0, 1).reshape(e * e, 2)
    raise ValueError(f"no pair table for layout {layout!r}")


def mma_columns() -> torch.Tensor:
    """The loop's columns within a 128-column block, mirrored from
    ``csrc/lut_gemm_mma.cuh``: entry ``[warp, e, ns]`` is the column that
    n8 tile ``e`` of ``warp`` holds at n-slot ``ns`` (lane ``l`` loads the 4
    columns ``4 (l // 4) + e`` of its warp's 32)."""
    warp = torch.arange(MMA_BLOCK_N // 32)[:, None, None]
    e = torch.arange(4)[None, :, None]
    ns = torch.arange(8)[None, None, :]
    return 32 * warp + 4 * ns + e


def lut_qgemm_w3wide_cuda(
    x2: torch.Tensor,
    plane: torch.Tensor,
    scales: torch.Tensor,
    table: torch.Tensor,
    *,
    group_size: int,
    chunk: int,
    m_tiles: int = 0,
    simt_block_m: int = 0,
) -> torch.Tensor:
    """Launch K3, the Hopper wide 3-bit kernel (on the tensor cores, by the
    route :func:`mma_route` gives M, or the SIMT kernel, as :func:`lut_path`
    says), for a 2-D ``x2`` ``[M, K]``; returns ``[M, N]`` in x's dtype.
    Counts one launch per call."""
    k = x2.shape[1]
    if chunk % 256:
        raise ValueError(f"chunk={chunk} not supported by the wide 3-bit layout")
    _check_operands(x2, [plane], [3 * k // 32], scales, table, (8,), group_size, chunk,
                    simt_block_m=simt_block_m)
    return _launch_planes("w3wide", x2, [plane], scales, table, group_size=group_size,
                          chunk=chunk, loop=lut_path(x2.dtype, 3, chunk, "w3wide") == "mma",
                          m_tiles=m_tiles, simt_block_m=simt_block_m)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def lut_qgemm(
    x: torch.Tensor,
    qweight: Sequence[torch.Tensor] | torch.Tensor,
    scales: torch.Tensor,
    table: torch.Tensor,
    *,
    num_bits: int,
    config: KernelConfig | None = None,
    pair_values: Optional[torch.Tensor] = None,
    layout: str = "auto",
) -> torch.Tensor:
    """Fused LUT-dequant GEMM: ``x @ (table[codes] * scales_expanded)``.

    Args:
      x: ``[..., K]`` activations (bf16/f16/f32); any number of rows.
      qweight: packed int32 planes (:func:`flute_tpu_torch.packing.pack`).
      scales: ``[K // group_size, N]`` in x's dtype.
      table: ``[2^num_bits]`` float32 lookup table.
      num_bits: 2, 3 or 4.
      config: persisted kernel config; its ``chunk`` (the pack chunk of the
        layout) is used, and ``lut_mode="pair_lut"`` on the plane layout
        looks the weights up in pairs (K4 on CUDA) through the separable
        joint table of ``table`` when no ``pair_values`` is given; a tuned
        ``m_tiles`` or ``simt_block_m`` sets the CUDA launch (the same bits
        as the planner's); its block fields are TPU tiles and change
        nothing. Default chunk 256.
      pair_values: optional float32 joint pair table ``[2^b, 2^b, 2]``
        (HIGGS vector dequantization); replaces ``table``. On CUDA it needs
        the plane layout and a 16-bit x.
      layout: "auto" (wide 3-bit detected by plane shape, else the plane
        layout) or "w4sym", which cannot be shape-detected and must be
        passed by callers carrying w4sym weights.
    """
    if isinstance(qweight, torch.Tensor):
        qweight = [qweight]
    planes = tuple(qweight)
    n = scales.shape[1]
    *batch, k = x.shape
    if k % scales.shape[0] != 0:
        raise ValueError(f"K={k} not divisible by scale groups {scales.shape[0]}")
    group_size = k // scales.shape[0]
    if layout == "auto":
        layout = "w3wide" if _packing.is_w3_wide(planes, num_bits, k) else "plane"
    if layout not in ("plane", "w3wide", "w4sym"):
        raise ValueError(f"Unknown layout: {layout}")
    if layout == "w3wide":
        if num_bits != 3 or not _packing.is_w3_wide(planes, num_bits, k):
            raise ValueError("layout='w3wide' requires a wide 3-bit plane")
    elif layout == "w4sym":
        if num_bits != 4:
            raise ValueError("layout='w4sym' requires num_bits=4")
        want = (k // 8, n)
        if len(planes) != 1 or tuple(planes[0].shape) != want:
            raise ValueError(
                f"w4sym plane shape {[tuple(p.shape) for p in planes]} != "
                f"expected [{want}] for K={k}, N={n}"
            )
        if pair_values is not None:
            raise ValueError("pair_values incompatible with layout='w4sym'")
    else:
        plane_bits_chk = bitutils.planes_for_bits(num_bits)
        if len(planes) != len(plane_bits_chk):
            raise ValueError(
                f"{num_bits}-bit weights need {len(plane_bits_chk)} plane(s), "
                f"got {len(planes)}"
            )
        for p, pb in zip(planes, plane_bits_chk):
            want = (k * pb // bitutils.WORD_BITS, n)
            if tuple(p.shape) != want:
                raise ValueError(
                    f"packed plane shape {tuple(p.shape)} != expected {want} "
                    f"for K={k}, N={n}, plane bits={pb}"
                )
    if table is not None and table.shape[-1] not in (2**num_bits,):
        raise ValueError(
            f"table has {table.shape[-1]} entries, expected {2**num_bits}"
        )
    if table is None:
        table = torch.zeros((2**num_bits,), dtype=torch.float32, device=x.device)
    config = config or KernelConfig()
    chunk = config.chunk
    if config.lut_mode == "pair_lut" and pair_values is None and layout == "plane":
        pair_values = separable_pair_values(table, num_bits)

    x2 = x.reshape(-1, k)
    if x.device.type == "cpu":
        y = lut_qgemm_plain(
            x2, planes, scales, table, num_bits=num_bits, chunk=chunk,
            layout=layout, pair_values=pair_values,
        )
    elif x.device.type == "cuda":
        x2 = x2.contiguous()
        scales = scales.to(x2.dtype).contiguous()
        table = table.float().contiguous()
        kw = dict(group_size=group_size, chunk=chunk, m_tiles=config.m_tiles)
        simt = dict(simt_block_m=config.simt_block_m)
        if pair_values is not None:
            if layout == "w3wide":
                # the reference computes no pair lookup on this layout
                # (ROADMAP.md queue 3 item 6); refuse rather than guess
                raise ValueError("pair_values needs the plane layout, not a wide 3-bit plane")
            y = lut_qgemm_pair_cuda(x2, planes, scales, pair_values.float().contiguous(),
                                    num_bits=num_bits, **kw)
        elif layout == "w4sym":
            y = lut_qgemm_w4sym_cuda(x2, planes[0], scales, table, **kw, **simt)
        elif layout == "w3wide":
            y = lut_qgemm_w3wide_cuda(x2, planes[0], scales, table, **kw, **simt)
        else:
            y = lut_qgemm_plane_cuda(x2, planes, scales, table, num_bits=num_bits, **kw, **simt)
    else:
        raise ValueError(f"unsupported device {x.device}")
    return y.reshape(*batch, n)


def qgemm(
    x: torch.Tensor,
    qweight,
    scales: torch.Tensor,
    table: torch.Tensor,
    num_bits: int,
    group_size: int,
    config: KernelConfig | None = None,
    pair_values: Optional[torch.Tensor] = None,
    layout: str = "auto",
) -> torch.Tensor:
    """Reference-API-shaped alias with explicit num_bits/group_size. Runs
    where its tensors are: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    k = x.shape[-1]
    if scales.shape[0] != k // group_size:
        raise ValueError(
            f"scales shape {tuple(scales.shape)} inconsistent with K={k}, "
            f"group_size={group_size}"
        )
    return lut_qgemm(
        x, qweight, scales, table, num_bits=num_bits, config=config,
        pair_values=pair_values, layout=layout,
    )
