"""HIGGS vector-quantization import, counterpart of
``flute_tpu/quantize/higgs.py``: the 2-D grid becomes the joint pair table.

HIGGS quantizes Hadamard-rotated weights in vectors of two against a grid of
2^(2b) 2-D points. A pair lookup table indexed by two b-bit sub-codes is
that vector dequantization, so the grid becomes the layer's
``pair_values``.

Code split: a vector code ``c`` in [0, 2^(2b)) splits into
``ce = c & (2^b - 1)`` (even K row) and ``co = c >> b`` (odd K row); the
pair table is indexed ``[ce, co]`` and holds ``grid[ce | co << b]``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from flute_tpu_torch.device import resolve_device
from flute_tpu_torch.nn import QuantizedLinear, from_codes
from flute_tpu_torch.ops.kernel_config import KernelConfig


def grid_to_pair_values(grid, num_bits: int) -> torch.Tensor:
    """``[2^(2b), 2]`` grid -> ``[2^b, 2^b, 2]`` float32 pair table indexed
    ``[ce, co]``."""
    e = 2**num_bits
    g = np.asarray(grid, np.float32)
    if g.shape != (e * e, 2):
        raise ValueError(f"grid must be [{e * e}, 2], got {g.shape}")
    return torch.from_numpy(np.ascontiguousarray(g.reshape(e, e, 2).swapaxes(0, 1)))


def from_higgs(
    codes,  # [K/2, N] vector codes in [0, 2^(2b))
    grid,  # [2^(2b), 2] dequantized vector values
    scales: torch.Tensor,  # [K // group_size, N]
    *,
    num_bits: int,
    group_size: int,
    hadamard_size: Optional[int] = None,
    bias: Optional[torch.Tensor] = None,
    config: Optional[KernelConfig] = None,
    chunk: int = 256,
    device=None,
) -> QuantizedLinear:
    """A pair-table :class:`QuantizedLinear` from HIGGS vector codes, split
    and packed on ``device`` (the codes' device for a tensor, else ``cuda``
    unless named). Its ``config_key`` carries ``lut_mode="pair_lut"``."""
    if isinstance(codes, torch.Tensor) and device is None:
        dev = codes.device
    else:
        dev = resolve_device(device)
    codes = torch.as_tensor(codes).to(dev, torch.int64)
    kp, n = codes.shape
    e = 2**num_bits
    if int(codes.min()) < 0 or int(codes.max()) >= e * e:
        raise ValueError("HIGGS codes out of range for num_bits")
    # rows 2j and 2j+1 take the even and odd sub-codes of vector row j
    codes_kn = torch.stack([codes & (e - 1), codes >> num_bits], dim=1).reshape(2 * kp, n)
    layer = from_codes(
        codes_kn.to(torch.int32), scales, None, num_bits, group_size,
        pair_values=grid_to_pair_values(grid, num_bits), bias=bias,
        config=config, chunk=chunk,
    )
    if layer.config.lut_mode != "pair_lut":
        layer = layer.with_config(dataclasses.replace(layer.config, lut_mode="pair_lut"))
    layer.hadamard_size = hadamard_size
    return layer


def from_higgs_scalar(
    codes,  # [K, N] scalar codes (vector size 1)
    grid,  # [2^b, 1] or [2^b]
    scales: torch.Tensor,
    *,
    num_bits: int,
    group_size: int,
    **kw,
) -> QuantizedLinear:
    """Vector size 1 is an ordinary scalar table."""
    table = np.asarray(grid, np.float32).reshape(-1)
    if table.shape[0] != 2**num_bits:
        raise ValueError("grid size mismatch")
    if isinstance(codes, torch.Tensor):
        codes = codes.to(torch.int32)
    else:
        codes = np.asarray(codes, np.int32)
    return from_codes(codes, scales, table, num_bits, group_size, **kw)
