"""Paged GQA attention over a block-pool KV cache, counterpart of
``flute_tpu/ops/paged_attention.py``.

K/V live in fixed-size blocks of per-layer pools ``[NB, Hkv, BS, D]``; a
per-sequence block table maps logical block ``j`` (positions
``[j*BS, (j+1)*BS)``) to a pool row. Two functions:

* :func:`paged_decode_attention` (T = 1): row ``(b, h)`` attends the
  positions ``< lengths[b]``;
* :func:`paged_verify_attention` (T queries, for pool prefill and
  speculative verify): query ``t`` of sequence ``b`` sits at position
  ``lengths[b] + t`` and attends ``lengths[b] + t + 1`` positions.

Both take Gemma-2's logit ``softcap`` and a sliding ``window``. Dispatch is
by the tensors' device: on the CPU the plain versions
(:func:`paged_gqa_reference`, :func:`paged_verify_reference`); on CUDA the
Hopper kernels of ``csrc/paged_attention.cu`` (K5 decode, K6 verify; both
run their products on tensor cores in bf16 and f16, K5 split along each
sequence in spans of :data:`DECODE_SPAN` positions and merged in span
order), which read the block table themselves and skip dead blocks. A build or launch
failure raises. Table entries are clamped to ``[0, NB-1]`` first, so those
of blocks at or past a sequence's end may be anything.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

# Launches of each kernel; a wrapper adds one where it launches its kernel
# and nowhere else.
LAUNCHES = {"paged_decode": 0, "paged_verify": 0}

_DTYPE_TAG = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
HEAD_DIMS = (64, 128, 256)  # the kernels' column split (csrc/paged_attention.cu)
# K5's positions per block in bf16/f16 (a multiple of the kernel's 64-position
# stage). A constant: a sequence's spans, and so its output's bits, never
# depend on the batch or on other sequences' lengths.
DECODE_SPAN = 256


def _paged_reference(q4, k_pool, v_pool, tables, att, scale, softcap, window):
    """Dense attention of ``q4`` ``[B, T, H, D]`` over the gathered blocks,
    row ``(b, t)`` attending the positions ``< att[b, t]`` (and, with a
    window, ``>= att[b, t] - window``); f32 scores, -inf mask."""
    b, t, h, d = q4.shape
    nb, hkv, bs, _ = k_pool.shape
    mb = tables.shape[1]
    rep = h // hkv
    scale = scale if scale is not None else d**-0.5
    idx = tables.long()
    # [B, MB, Hkv, BS, D] -> [B, Hkv, MB*BS, D]
    kk = k_pool[idx].permute(0, 2, 1, 3, 4).reshape(b, hkv, mb * bs, d).float()
    vv = v_pool[idx].permute(0, 2, 1, 3, 4).reshape(b, hkv, mb * bs, d).float()
    qm = q4.reshape(b, t, hkv, rep, d).permute(0, 2, 1, 3, 4).float()  # [B, Hkv, T, rep, D]
    scores = torch.einsum("bhtrd,bhsd->bhtrs", qm, kk) * scale
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    pos = torch.arange(mb * bs, device=q4.device)
    lim = att[:, None, :, None, None]  # [B, 1, T, 1, 1]
    valid = pos < lim
    if window is not None:
        valid = valid & (pos >= lim - window)
    scores = scores.masked_fill(~valid, float("-inf"))
    # softmax written out as the kernels compute it, so that a row with no
    # position to attend (a parked slot of length 0) gives 0, not NaN
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhtrs,bhsd->bhtrd", p, vv) / den  # [B, Hkv, T, rep, D]
    return out.permute(0, 2, 1, 3, 4).reshape(b, t, h, d).to(q4.dtype)


def paged_gqa_reference(
    q: torch.Tensor,  # [B, H, D]
    k_pool: torch.Tensor,  # [NB, Hkv, BS, D]
    v_pool: torch.Tensor,  # [NB, Hkv, BS, D]
    tables: torch.Tensor,  # [B, MB] pool rows
    lengths: torch.Tensor,  # [B] valid positions
    *,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Plain version of K5: gather the blocks, masked GQA; ``window`` keeps
    the last ``window`` positions. Returns ``[B, H, D]`` in q's dtype."""
    att = lengths.long()[:, None]
    return _paged_reference(q[:, None], k_pool, v_pool, tables, att, scale, softcap,
                            window)[:, 0]


def paged_verify_reference(
    q: torch.Tensor,  # [B, T, H, D]
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    tables: torch.Tensor,  # [B, MB]
    lengths: torch.Tensor,  # [B] positions cached before the run
    *,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Plain version of K6: query ``t`` attends ``lengths[b] + t + 1``
    positions (its own pre-written K/V included). Returns ``[B, T, H, D]``."""
    t = q.shape[1]
    att = lengths.long()[:, None] + torch.arange(1, t + 1, device=q.device)[None, :]
    return _paged_reference(q, k_pool, v_pool, tables, att, scale, softcap, window)


# kernel -> C entry, its pointers (q, pools, tables, lengths, out [, the
# decode workspace]) and its int arguments between the pointers and the scale
_ENTRIES = {
    "paged_decode": ("flute_paged_decode_attention", 7, 8),  # B, H, Hkv, D, NB, BS, MB, span
    "paged_verify": ("flute_paged_verify_attention", 6, 8),  # B, T, H, Hkv, D, NB, BS, MB
}
SOURCE = "paged_attention.cu"


@functools.lru_cache(maxsize=None)
def _kernel_fn(kernel: str):
    """The C entry of ``kernel`` (the library is built at first use)."""
    from flute_tpu_torch.ops import _build

    entry, n_ptr, n_int = _ENTRIES[kernel]
    lib = _build.load(SOURCE)
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
        + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
           ctypes.c_int, ctypes.c_void_p]
    )
    lib.flute_cuda_error_string.restype = ctypes.c_char_p
    lib.flute_cuda_error_string.argtypes = [ctypes.c_int]
    return fn, lib.flute_cuda_error_string


def _check(q4, k_pool, v_pool, tables, lengths) -> None:
    """Raise ``ValueError`` on shapes that do not fit, and on CUDA on what
    the kernels do not take."""
    b, t, h, d = q4.shape
    nb, hkv, bs, dk = k_pool.shape
    if d != dk:
        raise ValueError(f"head_dim mismatch: q {d} vs pool {dk}")
    if h % hkv:
        raise ValueError(f"{h} query heads not a multiple of {hkv} kv heads")
    if tuple(v_pool.shape) != tuple(k_pool.shape):
        raise ValueError(f"v_pool {tuple(v_pool.shape)} != k_pool {tuple(k_pool.shape)}")
    if tables.ndim != 2 or tables.shape[0] != b or tuple(lengths.shape) != (b,):
        raise ValueError(f"tables {tuple(tables.shape)} / lengths {tuple(lengths.shape)} "
                         f"do not match batch {b}")
    if q4.device.type == "cuda":
        for name, x in (("k_pool", k_pool), ("v_pool", v_pool), ("tables", tables),
                        ("lengths", lengths)):
            if x.device != q4.device:
                raise ValueError(f"{name} is on {x.device}, q on {q4.device}")
        if q4.dtype not in _DTYPE_TAG or k_pool.dtype != q4.dtype or v_pool.dtype != q4.dtype:
            raise ValueError(f"q {q4.dtype} and pools {k_pool.dtype}/{v_pool.dtype} must share "
                             "one of float32, float16, bfloat16")
        if d not in HEAD_DIMS or bs not in (8, 16, 32) or (d * bs) % 1024:
            raise ValueError(f"head_dim {d} with blocks of {bs} is not supported by the kernel "
                             f"(head_dim in {HEAD_DIMS}, blocks of 8, 16 or 32, "
                             "head_dim * block size a multiple of 1024)")


def decode_spans(max_blocks: int, block_size: int, span: int = DECODE_SPAN) -> int:
    """K5's spans per sequence for a table of ``max_blocks`` pool blocks:
    its grid's first dimension, and the workspace's third where it is above
    1 (``csrc/paged_attention.cu::decode_spans``)."""
    return -(-max_blocks * block_size // span)


def _launch(kernel, q4, k_pool, v_pool, tables, lengths, scale, softcap, window,
            span=DECODE_SPAN):
    b, t, h, d = q4.shape
    nb, hkv, bs, _ = k_pool.shape
    mb = tables.shape[1]
    q4 = q4.contiguous()
    k_pool, v_pool = k_pool.contiguous(), v_pool.contiguous()
    tables = tables.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q4)
    fn, error_string = _kernel_fn(kernel)
    if kernel == "paged_decode":
        # bf16/f16 with more than one span in the table: each live span's
        # numerator, max and sum (f32), merged by a second kernel
        spans = decode_spans(mb, bs, span)
        ws = (torch.empty((b, h, spans, d + 2), dtype=torch.float32, device=q4.device)
              if q4.dtype != torch.float32 and spans > 1 else None)
        ptrs = (None if ws is None else ws.data_ptr(),)
        dims = (b, h, hkv, d, nb, bs, mb, span)
    else:
        ptrs, dims = (), (b, t, h, hkv, d, nb, bs, mb)
    stream = torch.cuda.current_stream(q4.device).cuda_stream
    with torch.cuda.device(q4.device):
        err = fn(
            q4.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), *ptrs, *dims, scale,
            int(softcap is not None), 0.0 if softcap is None else float(softcap),
            int(window is not None), 0 if window is None else int(window),
            _DTYPE_TAG[q4.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: {error_string(err).decode()} ({err})")
    LAUNCHES[kernel] += 1
    return out


def _dispatch(kernel, reference, q4, k_pool, v_pool, tables, lengths, scale, softcap, window):
    _check(q4, k_pool, v_pool, tables, lengths)
    nb = k_pool.shape[0]
    d = q4.shape[-1]
    scale_f = float(scale if scale is not None else d**-0.5)
    tables = torch.clamp(tables.to(torch.int32), 0, nb - 1)
    if q4.device.type == "cpu":
        return reference(scale_f, tables)
    if q4.device.type == "cuda":
        return _launch(kernel, q4, k_pool, v_pool, tables, lengths, scale_f, softcap, window)
    raise ValueError(f"unsupported device {q4.device}")


def paged_decode_attention(
    q: torch.Tensor,  # [B, H, D]
    k_pool: torch.Tensor,  # [NB, Hkv, BS, D]
    v_pool: torch.Tensor,
    tables: torch.Tensor,  # [B, MB] int
    lengths: torch.Tensor,  # [B] int
    *,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Paged GQA decode attention (T = 1), K5 on CUDA. ``softcap`` applies
    Gemma-2's tanh logit cap; ``window`` keeps the last ``window`` positions.
    In bf16 and f16 the kernel splits each sequence into spans of
    :data:`DECODE_SPAN` positions, rounds the probabilities to q's dtype
    before the second product and adds the spans in order; in f32 one block
    per (sequence, KV head) walks the sequence. Returns ``[B, H, D]`` in q's
    dtype."""
    if q.ndim != 3:
        raise ValueError(f"q must be [B, H, D], got {tuple(q.shape)}")
    q4 = q[:, None]
    out = _dispatch(
        "paged_decode",
        lambda s, tb: paged_gqa_reference(q, k_pool, v_pool, tb, lengths, scale=s,
                                          softcap=softcap, window=window)[:, None],
        q4, k_pool, v_pool, tables, lengths, scale, softcap, window,
    )
    return out[:, 0]


def paged_verify_attention(
    q: torch.Tensor,  # [B, T, H, D]
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    tables: torch.Tensor,  # [B, MB] int
    lengths: torch.Tensor,  # [B] int: positions cached before the run
    *,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Multi-query paged attention, K6 on CUDA: query ``t`` of sequence
    ``b`` sits at position ``lengths[b] + t`` with its K/V already in the
    pool and attends ``lengths[b] + t + 1`` positions. In bf16 and f16 the
    kernel (tensor cores) reads each pool position once per tile of 64
    query rows of a (sequence, KV head), that is ``ceil(T * rep / 64)``
    times (16 queries per tile at 32/8 heads), and rounds the probabilities
    to q's dtype before the second product; in f32 once per tile of 8
    rows. Returns ``[B, T, H, D]``."""
    if q.ndim != 4:
        raise ValueError(f"q must be [B, T, H, D], got {tuple(q.shape)}")
    return _dispatch(
        "paged_verify",
        lambda s, tb: paged_verify_reference(q, k_pool, v_pool, tb, lengths, scale=s,
                                             softcap=softcap, window=window),
        q, k_pool, v_pool, tables, lengths, scale, softcap, window,
    )
