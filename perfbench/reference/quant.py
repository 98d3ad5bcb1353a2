"""The weight formats of the benchmark's configurations, worked out again
in plain float32 PyTorch from the benchmark's own inputs.

A frozen copy of each format's definition, independent of the program:

* ``w4sym``: NormalFloat-4 on the sign-symmetric grid (16 values, ascending,
  ``v[i] == -v[15 - i]``), group-absmax scales over ``group_size``
  consecutive input rows, a weight's code the grid value nearest to its
  normalized value (ties to the lower one), the scale stored in bfloat16.
  The dequantized weight is ``grid[code] * scale``, exact in float32.
* ``higgs``: a vector code ``c`` in ``[0, 256)`` per pair of input rows
  ``(2j, 2j + 1)`` that dequantizes to ``grid[c]`` (two values), times the
  group scale of each row; the layer's input is rotated first by the
  orthonormal Hadamard transform over contiguous groups of
  ``hadamard_size`` features.

Nothing here imports the program or reads what it made.
"""

from __future__ import annotations

import math

import torch

# the sign-symmetric NF4 grid: the normal quantiles at 16 evenly spaced
# probabilities from 0.5 * (1/32 + 1/30) to 1 minus that, symmetrized and
# scaled to [-1, 1] (float32)
NF4_SYM = (
    -1.0, -0.7102504968643188, -0.5447699427604675, -0.4189668297767639,
    -0.31258153915405273, -0.2171417772769928, -0.1280563920736313,
    -0.042333465069532394, 0.042333465069532394, 0.1280563920736313,
    0.2171417772769928, 0.31258153915405273, 0.4189668297767639,
    0.5447699427604675, 0.7102504968643188, 1.0,
)


def nf4_sym_dequantized(w: torch.Tensor, group_size: int) -> torch.Tensor:
    """The w4sym weight of a dense ``[in, out]`` weight, ``[in, out]``
    float32: group-absmax scales over ``group_size`` input rows, rounded to
    bfloat16, each weight the nearest grid value times its group's scale."""
    k, n = w.shape
    grid = torch.tensor(NF4_SYM, dtype=torch.float32, device=w.device)
    pivots = (grid[1:] + grid[:-1]) / 2
    wg = w.float().T.reshape(n, k // group_size, group_size)
    absmax = wg.abs().amax(dim=-1, keepdim=True)
    absmax = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
    codes = torch.searchsorted(pivots, (wg / absmax).contiguous(), side="left")
    scale = absmax.to(torch.bfloat16).float()
    return (grid[codes] * scale).reshape(n, k).T.contiguous()


def higgs_dequantized(codes: torch.Tensor, grid: torch.Tensor, scales: torch.Tensor,
                      group_size: int) -> torch.Tensor:
    """The HIGGS weight ``[in, out]`` float32 of vector codes ``[in / 2,
    out]``, a ``[256, 2]`` grid and scales ``[in / group_size, out]``."""
    kp, n = codes.shape
    v = grid.float()[codes.long()]  # [in / 2, out, 2]
    w = v.permute(0, 2, 1).reshape(2 * kp, n)  # rows 2j, 2j + 1
    return w * scales.float().repeat_interleave(group_size, dim=0)


def hadamard(n: int, device) -> torch.Tensor:
    """The Sylvester Hadamard matrix of order ``n`` (a power of two), scaled
    by ``1 / sqrt(n)``: orthonormal, float32."""
    h = torch.ones((1, 1), dtype=torch.float32, device=device)
    while h.shape[0] < n:
        h = torch.cat([torch.cat([h, h], 1), torch.cat([h, -h], 1)], 0)
    return h / math.sqrt(n)


def rotate(x: torch.Tensor, size: int) -> torch.Tensor:
    """``x`` ``[..., K]`` rotated over contiguous groups of ``size``."""
    *lead, k = x.shape
    xg = x.float().reshape(*lead, k // size, size)
    return (xg @ hadamard(size, x.device)).reshape(*lead, k)
