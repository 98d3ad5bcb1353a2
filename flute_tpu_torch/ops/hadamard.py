"""Fast Walsh–Hadamard transform, the input rotation of HIGGS-quantized
layers; counterpart of ``flute_tpu/ops/hadamard.py``.

H_n for n = a*b factors as H_a ⊗ H_b, so the transform of x reshaped to
``[..., a, b]`` is ``H_a @ X @ H_b``: two small matrix products instead of one
n×n product. This is not a kernel of the JAX package (it is an XLA einsum
there), so plain ``torch.matmul`` computes it here too.

Numerics, as the JAX package computes them: the products are taken in f32
(H holds ±1, so every product is exact and only the f32 sums round), the
result is multiplied by the scale in f32, and rounded once to x's dtype. A
16-bit ``matmul`` would round before the scale and so round twice. The f32
products run with TF32 off (PyTorch's default for ``matmul``), which this
module does not change.

Supported sizes: powers of two 2^1..2^15.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

MAX_LOG2 = 15


@functools.lru_cache(maxsize=None)
def _hadamard_matrix_np(n: int) -> np.ndarray:
    """Sylvester-construction Hadamard matrix H_n (entries ±1), float32."""
    assert n & (n - 1) == 0 and n > 0
    h = np.array([[1.0]], np.float32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def hadamard_matrix(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.from_numpy(_hadamard_matrix_np(n)).to(device=device, dtype=dtype)


@functools.lru_cache(maxsize=None)
def _f32_matrix(n: int, device: torch.device) -> torch.Tensor:
    """H_n in f32 on ``device``, made once: a rotation per projection must
    not copy it from the host every call."""
    return hadamard_matrix(n, device=device)


def _split_factors(n: int) -> tuple[int, int]:
    """Factor n = a * b with a, b <= 256 and both powers of two."""
    lg = n.bit_length() - 1
    la = lg // 2
    return 1 << la, 1 << (lg - la)


def _fwht(x: torch.Tensor, scale: float) -> torch.Tensor:
    n = x.shape[-1]
    xf = x.float()
    if n <= 256:
        y = torch.matmul(xf, _f32_matrix(n, x.device))
    else:
        a, b = _split_factors(n)
        xg = xf.reshape(*x.shape[:-1], a, b)
        y = torch.matmul(torch.matmul(_f32_matrix(a, x.device), xg), _f32_matrix(b, x.device))
        y = y.reshape(x.shape)
    # the scale rounded to f32 first: the product is then the f32 product
    return (y * float(np.float32(scale))).to(x.dtype)


def hadamard_transform(x: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """FWHT along the last axis; the default scale 1/sqrt(n) makes it
    orthonormal (the HIGGS rotation's convention)."""
    n = x.shape[-1]
    if n & (n - 1) or not (1 <= n.bit_length() - 1 <= MAX_LOG2):
        raise ValueError(
            f"FWHT size must be a power of two in [2, 2^{MAX_LOG2}], got {n}"
        )
    if scale is None:
        scale = 1.0 / math.sqrt(n)
    return _fwht(x, scale)


def grouped_hadamard_transform(
    x: torch.Tensor, had_size: int, scale: Optional[float] = None
) -> torch.Tensor:
    """The FWHT applied independently to contiguous groups of ``had_size``
    along the last axis (HIGGS's blocked rotation)."""
    n = x.shape[-1]
    if n % had_size:
        raise ValueError(f"last dim {n} not a multiple of had_size {had_size}")
    xg = x.reshape(*x.shape[:-1], n // had_size, had_size)
    return hadamard_transform(xg, scale).reshape(x.shape)


def qgemm_hadamard(
    x: torch.Tensor,
    qweight,
    scales: torch.Tensor,
    table: torch.Tensor,
    num_bits: int,
    group_size: int,
    hadamard_size: int,
    **kw,
) -> torch.Tensor:
    """Rotate x, then the LUT-GEMM: ``qgemm(H x, ...)``."""
    from flute_tpu_torch.ops import lut_gemm

    xr = grouped_hadamard_transform(x, hadamard_size)
    return lut_gemm.qgemm(xr, qweight, scales, table, num_bits, group_size, **kw)
