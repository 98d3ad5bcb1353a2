"""bitsandbytes NF4/FP4 checkpoint import, counterpart of
``flute_tpu/quantize/bitsandbytes.py``: tensor math only, no bnb runtime.

A bnb ``Linear4bit``'s packed nibbles and (possibly double-quantized)
absmax scales are decoded into (codes, scales, table) and packed with
:func:`flute_tpu_torch.nn.from_codes` in the pair-plane layout, so the
layer serves on K2 (``csrc/lut_gemm_plane.cu``) with the bnb table.

BNB 4-bit storage:
  * ``qweight``: uint8 ``[numel/2]``, two 4-bit codes per byte, the FIRST
    element in the HIGH nibble;
  * ``absmax``: one scale per block of ``blocksize`` (64) weights; with
    double quantization ("nested") it is uint8, itself quantized per
    ``nested_blocksize`` (256) blocks: absmax = code2[absmax_q] *
    nested_absmax + nested_offset;
  * ``code``: the ``[16]`` float table (NF4 or FP4), ascending for NF4.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from flute_tpu_torch.integrations import safetensors_io
from flute_tpu_torch.nn import QuantizedLinear, from_codes


@dataclasses.dataclass
class BNBQuantState:
    """Array-level view of a bnb Linear4bit quant_state."""

    code: np.ndarray  # [16] float quantization table
    absmax: np.ndarray  # per-block scales (uint8 if nested, float otherwise)
    blocksize: int  # weights per absmax block (default 64)
    shape: tuple[int, int]  # [out_features, in_features]
    # double ("nested") quantization of absmax:
    nested_code: Optional[np.ndarray] = None  # [256] float
    nested_absmax: Optional[np.ndarray] = None  # per-256-block float scales
    nested_blocksize: int = 256
    offset: Optional[float] = None  # global absmax offset


def _np(a) -> np.ndarray:
    """A tensor or array as numpy (bfloat16 widened to float32)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a)


def decode_absmax(state: BNBQuantState) -> np.ndarray:
    """The (possibly nested) absmax dequantized to float32."""
    if state.nested_code is None:
        return np.asarray(state.absmax, np.float32)
    aq = np.asarray(state.absmax).astype(np.int64).reshape(-1)
    vals = np.asarray(state.nested_code, np.float32)[aq]
    nb = state.nested_blocksize
    scales = np.asarray(state.nested_absmax, np.float32)
    pad = (-len(vals)) % nb
    v = np.pad(vals, (0, pad)).reshape(-1, nb)
    v = v * scales[: v.shape[0], None]
    out = v.reshape(-1)[: len(vals)]
    if state.offset is not None:
        out = out + np.float32(state.offset)
    return out


def unpack_nibbles(qweight: np.ndarray, numel: int) -> np.ndarray:
    """uint8 packed nibbles -> int32 codes ``[numel]``; the first element of
    each pair sits in the HIGH nibble (bnb convention)."""
    q = np.asarray(qweight, np.uint8).reshape(-1)
    out = np.empty(q.size * 2, np.int32)
    out[0::2] = (q >> 4).astype(np.int32)
    out[1::2] = (q & 0xF).astype(np.int32)
    return out[:numel]


def dequantize_bnb(state: BNBQuantState, qweight: np.ndarray) -> np.ndarray:
    """Independent full dequantization ``[out, in]`` (for verification)."""
    n, k = state.shape
    codes = unpack_nibbles(qweight, n * k)
    absmax = decode_absmax(state)
    vals = np.asarray(state.code, np.float32)[codes]
    bs = state.blocksize
    w = vals.reshape(-1, bs) * absmax[: vals.size // bs, None]
    return w.reshape(n, k)


def convert_bnb_linear4bit(
    qweight,
    state: BNBQuantState,
    *,
    bias=None,
    dtype: torch.dtype = torch.bfloat16,
    verify: bool = True,
    device=None,
    **kw,
) -> QuantizedLinear:
    """Convert a BNB Linear4bit into a packed :class:`QuantizedLinear` on
    ``device`` (``cuda`` unless named).

    The group size is the bnb blocksize: bnb blocks run along the input dim
    of the row-major ``[out, in]`` weight, the per-K-group grouping after
    the transpose. A table that is not ascending (FP4's sign-magnitude
    order) is sorted and the codes permuted to match: the same values, and
    searchsorted-based tooling stays valid."""
    qweight = _np(qweight)
    n, k = state.shape
    if k % state.blocksize:
        raise ValueError(f"in_features {k} not a multiple of blocksize")
    codes = unpack_nibbles(qweight, n * k).reshape(n, k)
    absmax = decode_absmax(state).reshape(n, k // state.blocksize)
    table = np.asarray(state.code, np.float32)
    if not np.all(np.diff(table) > 0):
        order = np.argsort(table, kind="stable")
        inv = np.empty_like(order)
        inv[order] = np.arange(order.size)
        table = table[order]
        codes = inv[codes]

    if verify:
        want = dequantize_bnb(state, qweight)
        got = table[codes] * np.repeat(absmax, state.blocksize, axis=1)
        if not np.array_equal(got, want):
            raise AssertionError("lossless bnb decode verification failed")

    return from_codes(
        np.ascontiguousarray(codes.T).astype(np.int32),  # [K, N]
        torch.from_numpy(np.ascontiguousarray(absmax.T)).to(dtype),  # [K/g, N]
        table=table,
        num_bits=4,
        group_size=state.blocksize,
        bias=None if bias is None else torch.from_numpy(np.array(_np(bias))),
        device=device,
        **kw,
    )


# transformers serializes a bnb-4bit model as, per quantized linear:
#   <prefix>.weight                         uint8 packed nibbles
#   <prefix>.weight.absmax                  uint8 (nested) / float
#   <prefix>.weight.quant_map               float [16] code table
#   <prefix>.weight.nested_absmax           float      (nested only)
#   <prefix>.weight.nested_quant_map        float [256](nested only)
#   <prefix>.weight.quant_state.bitsandbytes__{nf4|fp4}
#       uint8 tensor holding a JSON dict: {"blocksize", "shape", "dtype",
#       "quant_type", "nested_blocksize", "nested_offset", ...}
_QS_SUFFIXES = (
    ".weight.quant_state.bitsandbytes__nf4",
    ".weight.quant_state.bitsandbytes__fp4",
)


def quant_state_from_tensors(tensors: dict, prefix: str) -> BNBQuantState:
    """The :class:`BNBQuantState` of ``<prefix>.weight`` from a flat
    ``{name: tensor or array}`` dict of an HF bnb checkpoint."""
    meta_raw = None
    for suf in _QS_SUFFIXES:
        if prefix + suf in tensors:
            meta_raw = tensors[prefix + suf]
            break
    if meta_raw is None:
        raise KeyError(f"no bnb quant_state tensor for {prefix}")
    meta = json.loads(bytes(np.asarray(_np(meta_raw), np.uint8)))
    nested = prefix + ".weight.nested_absmax" in tensors
    return BNBQuantState(
        code=np.asarray(_np(tensors[prefix + ".weight.quant_map"]), np.float32),
        absmax=_np(tensors[prefix + ".weight.absmax"]),
        blocksize=int(meta["blocksize"]),
        shape=tuple(int(s) for s in meta["shape"]),
        nested_code=(
            np.asarray(_np(tensors[prefix + ".weight.nested_quant_map"]), np.float32)
            if nested else None
        ),
        nested_absmax=(
            np.asarray(_np(tensors[prefix + ".weight.nested_absmax"]), np.float32)
            if nested else None
        ),
        nested_blocksize=int(meta.get("nested_blocksize", 256)),
        offset=float(meta["nested_offset"]) if "nested_offset" in meta else None,
    )


def load_bnb_checkpoint(model_dir: str, *, dtype: torch.dtype = torch.bfloat16,
                        device=None) -> dict:
    """Load a bnb-4bit HF checkpoint directory.

    Returns ``{name: QuantizedLinear | torch.Tensor}``: every serialized
    Linear4bit becomes a packed :class:`QuantizedLinear` on ``device``
    (``cuda`` unless named), keyed by its module prefix; dense tensors pass
    through as the CPU tensors read from the files."""
    if not os.path.isdir(model_dir):
        raise FileNotFoundError(f"no directory {model_dir}")
    tensors = dict(safetensors_io.iter_dir(model_dir))
    prefixes = {
        name[: -len(suf)]
        for name in tensors
        for suf in _QS_SUFFIXES
        if name.endswith(suf)
    }
    out: dict = {}
    consumed: set = set()
    for prefix in sorted(prefixes):
        state = quant_state_from_tensors(tensors, prefix)
        bias = tensors.get(prefix + ".bias")
        out[prefix] = convert_bnb_linear4bit(
            tensors[prefix + ".weight"], state, bias=bias, dtype=dtype, device=device
        )
        consumed.update(name for name in tensors if name.startswith(prefix + ".weight"))
        if bias is not None:
            consumed.add(prefix + ".bias")
    for name, t in tensors.items():
        if name not in consumed:
            out[name] = t
    return out
