"""NormalFloat (NF) quantization in torch, counterpart of
``flute_tpu/quantize/nf.py``.

Tables are built on the host with scipy (offline math); quantization runs in
float32 on the weight's own device, with ``torch.searchsorted(side="left")``
in the role of ``jnp.searchsorted``, so codes are identical to the JAX
package's for the same weight.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from flute_tpu_torch.packing import sym_code_order

# QLoRA NF4 table (public constant).
QLORA_NF4 = np.array(
    [
        -1.0,
        -0.6961928009986877,
        -0.5250730514526367,
        -0.39491748809814453,
        -0.28444138169288635,
        -0.18477343022823334,
        -0.09105003625154495,
        0.0,
        0.07958029955625534,
        0.16093020141124725,
        0.24611230194568634,
        0.33791524171829224,
        0.44070982933044434,
        0.5626170039176941,
        0.7229568362236023,
        1.0,
    ],
    dtype=np.float32,
)


def nf_values(num_bits: int = 4, symmetric: bool = False) -> np.ndarray:
    """NormalFloat code values, float32, ascending, normalized to [-1, 1]."""
    from scipy.stats import norm as _scipy_norm  # here: scipy.stats takes seconds to import

    offset = 0.5 * (1 / 32 + 1 / 30)
    if symmetric:
        probs = np.linspace(offset, 1 - offset, 2**num_bits)
        v = _scipy_norm.ppf(probs)
    else:
        half = 2 ** (num_bits - 1)
        p1 = np.linspace(1 - offset, 0.5, half)
        v1 = -_scipy_norm.ppf(p1)
        p2 = np.linspace(0.5, 1 - offset, half + 1)[1:]
        v2 = _scipy_norm.ppf(p2)
        v = np.concatenate([v1, v2])
    v = v / np.max(np.abs(v))
    if num_bits == 4 and not symmetric:
        v = QLORA_NF4
    return np.asarray(v, dtype=np.float32)


def nf_pivots(values: torch.Tensor) -> torch.Tensor:
    """Decision boundaries: midpoints between adjacent table values."""
    return (values[1:] + values[:-1]) / 2.0


def quantize_with_table(
    w: torch.Tensor,
    values,
    group_size: int,
    custom_scales: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Group-absmax quantize ``w`` against an ascending table, grouping the
    last axis in contiguous blocks of ``group_size``.

    Returns (dequantized f32, codes int32, scales f32) with shapes
    (w.shape, w.shape, w.shape[:-1] + (K // group_size,)).
    """
    values = torch.as_tensor(values, dtype=torch.float32, device=w.device)
    pivots = nf_pivots(values)
    orig_shape = w.shape
    qx = w.to(torch.float32).reshape(-1, group_size)
    if custom_scales is not None:
        absmax = custom_scales.to(torch.float32).reshape(-1, 1)
    else:
        absmax = qx.abs().amax(dim=1, keepdim=True)
    # all-zero groups get scale 1 (the JAX package's guard)
    absmax = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
    normalized = qx / absmax
    codes = torch.searchsorted(pivots, normalized, side="left").to(torch.int32)
    deq = values[codes.long()] * absmax
    scales_shape = tuple(orig_shape[:-1]) + (orig_shape[-1] // group_size,)
    return (
        deq.reshape(orig_shape),
        codes.reshape(orig_shape),
        absmax.reshape(scales_shape),
    )


def quantize_with_table_np(
    w: np.ndarray,
    values: np.ndarray,
    group_size: int,
    custom_scales: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side (numpy) twin of :func:`quantize_with_table` for streaming
    checkpoint quantization: the same codes and scales, no device round
    trip, no dequantized tensor. Returns (codes int32, scales f32)."""
    values = np.asarray(values, np.float32)
    pivots = (values[1:] + values[:-1]) / 2.0
    orig_shape = w.shape
    qx = np.asarray(w, np.float32).reshape(-1, group_size)
    if custom_scales is not None:
        absmax = np.asarray(custom_scales, np.float32).reshape(-1, 1)
    else:
        absmax = np.max(np.abs(qx), axis=1, keepdims=True)
    absmax = np.where(absmax == 0, 1.0, absmax)
    codes = np.searchsorted(pivots, qx / absmax, side="left").astype(np.int32)
    scales_shape = orig_shape[:-1] + (orig_shape[-1] // group_size,)
    return codes.reshape(orig_shape), absmax.reshape(scales_shape).astype(np.float32)


def nf_quantize_np(
    w: np.ndarray,
    num_bits: int,
    group_size: int,
    custom_scales: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side NF quantization: returns (codes, scales, table)."""
    values = nf_values(num_bits, symmetric=False)
    codes, scales = quantize_with_table_np(w, values, group_size, custom_scales)
    return codes, scales, values


def nf_quantize(
    w: torch.Tensor,
    num_bits: int,
    group_size: int,
    custom_scales: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """NF-quantize a weight. Returns (dequantized, codes, scales, table)."""
    values = torch.from_numpy(nf_values(num_bits, symmetric=False)).to(w.device)
    deq, codes, scales = quantize_with_table(w, values, group_size, custom_scales)
    return deq, codes, scales, values


def nf_values_symmetric_exact(num_bits: int) -> np.ndarray:
    """Ascending sign-symmetric NF table, symmetrized at the bit level
    (``v[i] == -v[2^b-1-i]`` exactly) so it meets the w4sym contract after
    any rounding."""
    v = nf_values(num_bits, symmetric=True).astype(np.float64)
    v = (v - v[::-1]) / 2.0  # cancel scipy.ppf roundoff asymmetry
    v = v / np.max(np.abs(v))
    return v.astype(np.float32)


def nf_quantize_symmetric(
    w: torch.Tensor,
    num_bits: int,
    group_size: int,
    custom_scales: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sign-symmetric NF quantization for the w4sym layout.

    Returns (dequantized, codes, scales, table): codes are sign-magnitude
    (c = s*2^(b-1) + m) and the table is in code order with
    ``table[c + 2^(b-1)] == -table[c]``.
    """
    v = nf_values_symmetric_exact(num_bits)
    table_sym, perm = sym_code_order(v)
    deq, codes_asc, scales = quantize_with_table(
        w, torch.from_numpy(v), group_size, custom_scales
    )
    perm_t = torch.from_numpy(perm).to(device=w.device, dtype=torch.int32)
    codes = perm_t[codes_asc.long()]
    return deq, codes, scales, torch.from_numpy(table_sym).to(w.device)


def nf_quantize_symmetric_np(
    w: np.ndarray,
    num_bits: int,
    group_size: int,
    custom_scales: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side twin of :func:`nf_quantize_symmetric` for streaming
    checkpoint quantization. Returns (codes, scales, table)."""
    v = nf_values_symmetric_exact(num_bits)
    table_sym, perm = sym_code_order(v)
    codes_asc, scales = quantize_with_table_np(w, v, group_size, custom_scales)
    return perm[codes_asc].astype(np.int32), scales, table_sym


def nf_quantize_fake(
    w: torch.Tensor,
    num_bits: int,
    group_size: int,
    dtype: torch.dtype,
    symmetric: bool = False,
) -> torch.Tensor:
    """Kernel-faithful fake quantization: table lookup and scale multiply
    are rounded in ``dtype`` exactly as the kernel computes them."""
    if symmetric:
        values = nf_values_symmetric_exact(num_bits)
    else:
        values = nf_values(num_bits, symmetric=False)
    values = torch.from_numpy(values).to(w.device)
    _, codes, scales = quantize_with_table(w, values, group_size)
    t = values.to(dtype)
    s = scales.to(dtype).repeat_interleave(group_size, dim=-1).reshape(w.shape)
    return (t[codes.long()] * s).to(dtype)
