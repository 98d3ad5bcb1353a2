"""Host-side resharding and repacking of packed layers, counterpart of
``flute_tpu/parallel/reshard.py``.

The pack layout (:mod:`flute_tpu_torch.packing`) is chunked along K and
independent per N column, so splitting a packed layer needs no unpack:

  * :func:`shard_linear` / :func:`merge_shards`: an N-shard is a column
    slice of every plane, of the scales and of the bias; a K-shard is a
    slice of whole row chunks (the local K a multiple of the pack chunk and
    of the group). Every shard is a contiguous copy that owns its storage:
    the kernels refuse non-contiguous operands, and a view would keep the
    whole unsharded layer alive beside it;
  * :func:`repack`: migration to another pack chunk or kernel config by
    unpack, then pack, with a lossless round-trip check.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from flute_tpu_torch import packing
from flute_tpu_torch.nn import QuantizedLinear
from flute_tpu_torch.ops.kernel_config import KernelConfig


def owned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` with storage of its own."""
    return t.clone(memory_format=torch.contiguous_format)


def shard_linear(layer: QuantizedLinear, num_shards: int, axis: str) -> list[QuantizedLinear]:
    """Split a packed layer into ``num_shards`` along ``axis`` ("n" = out
    features, "k" = in features). Exact (no unpack) by layout design."""
    if axis == "n":
        n = layer.out_features
        if n % num_shards:
            raise ValueError(f"N={n} not divisible by {num_shards}")
        ln = n // num_shards
        out = []
        for r in range(num_shards):
            sl = slice(r * ln, (r + 1) * ln)
            out.append(layer.replace(
                planes=tuple(owned(p[:, sl]) for p in layer.planes),
                scales=owned(layer.scales[:, sl]),
                bias=None if layer.bias is None else owned(layer.bias[sl]),
            ))
        return out
    if axis == "k":
        k = layer.in_features
        chunk = layer.chunk
        lk = k // num_shards
        if k % num_shards or lk % chunk or lk % layer.group_size:
            raise ValueError(
                f"K={k} shards of {lk} must be multiples of chunk={chunk} "
                f"and group={layer.group_size}"
            )
        if layer.bias is not None:
            raise ValueError("bias on a K-sharded layer is unsupported")
        g = lk // layer.group_size
        out = []
        for r in range(num_shards):
            frac = [p.shape[0] // num_shards for p in layer.planes]
            out.append(layer.replace(
                planes=tuple(owned(p[r * f:(r + 1) * f]) for p, f in zip(layer.planes, frac)),
                scales=owned(layer.scales[r * g:(r + 1) * g]),
            ))
        return out
    raise ValueError(f"axis must be 'n' or 'k', got {axis}")


def merge_shards(shards: Sequence[QuantizedLinear], axis: str) -> QuantizedLinear:
    """Inverse of :func:`shard_linear` (the all-gather direction)."""
    first = shards[0]
    if axis not in ("n", "k"):
        raise ValueError(f"axis must be 'n' or 'k', got {axis}")
    dim = 1 if axis == "n" else 0
    planes = tuple(torch.cat([s.planes[i] for s in shards], dim=dim)
                   for i in range(len(first.planes)))
    scales = torch.cat([s.scales for s in shards], dim=dim)
    if axis == "k":
        return first.replace(planes=planes, scales=scales)
    bias = None if first.bias is None else torch.cat([s.bias for s in shards])
    return first.replace(planes=planes, scales=scales, bias=bias)


def repack(
    layer: QuantizedLinear,
    *,
    new_config: Optional[KernelConfig] = None,
    new_chunk: Optional[int] = None,
    verify: bool = True,
) -> QuantizedLinear:
    """Migrate a layer to another pack chunk or kernel config by unpack,
    then pack, checking that the round trip is lossless. The w4sym and wide
    3-bit layouts stay in their layouts; pair-plane layers stay in planes."""
    old_chunk = layer.chunk
    if new_config is not None and new_chunk is not None and new_config.chunk != new_chunk:
        raise ValueError("new_config.chunk disagrees with new_chunk")
    chunk = new_config.chunk if new_config is not None else (new_chunk or old_chunk)
    planes_np = [p.cpu().numpy() for p in layer.planes]
    kernel_layout = layer.kernel_layout
    if kernel_layout == "w4sym":
        codes = packing.unpack_w4_sym_np(planes_np[0], chunk=old_chunk)
        planes = packing.pack_w4_sym_np(codes, chunk=chunk)
        back = packing.unpack_w4_sym_np(planes[0], chunk=chunk) if verify else None
    elif kernel_layout == "w3wide":
        codes = packing.unpack_w3_wide_np(planes_np[0], chunk=old_chunk)
        planes = packing.pack_w3_wide_np(codes, chunk=chunk)
        back = packing.unpack_w3_wide_np(planes[0], chunk=chunk) if verify else None
    else:
        codes = packing.unpack_np(planes_np, layer.num_bits, chunk=old_chunk)
        planes = packing.pack_np(codes, layer.num_bits, chunk=chunk)
        back = packing.unpack_np(planes, layer.num_bits, chunk=chunk) if verify else None
    if verify and not np.array_equal(back, codes):
        raise AssertionError("repack round-trip is not lossless")
    cfg = new_config or dataclasses.replace(layer.config or KernelConfig(), chunk=chunk)
    dev = layer.scales.device
    return layer.replace(planes=tuple(torch.from_numpy(p).to(dev) for p in planes), config=cfg)
