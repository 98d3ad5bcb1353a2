"""The collective of tensor-parallel blocks: one all-reduce after each
row-parallel projection (``o`` and ``down``), two per block per forward.

``COUNTS["all_reduce"]`` counts the all-reduces run, as
``ops.lut_gemm.LAUNCHES`` counts kernel launches. On a gloo group a CUDA
tensor is reduced through a host copy (gloo reduces host memory), in its
own dtype; the sum reaches every rank with the same bits.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

COUNTS = {"all_reduce": 0}


def all_reduce_(x: torch.Tensor, group: Optional[Any]) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place and return it; with no group, ``x``
    untouched."""
    if group is None:
        return x
    if x.is_cuda and dist.get_backend(group) == "gloo":
        host = x.cpu()
        dist.all_reduce(host, group=group)
        x.copy_(host)
    else:
        dist.all_reduce(x, group=group)
    COUNTS["all_reduce"] += 1
    return x


def all_gather(x: torch.Tensor, group: Any, size: int) -> list[torch.Tensor]:
    """``x`` of each of the ``size`` ranks of ``group``, in rank order (not
    counted: the blocks never gather)."""
    src = x.cpu() if x.is_cuda and dist.get_backend(group) == "gloo" else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    return [p.to(x.device) for p in parts]


def broadcast_(x: torch.Tensor, src: int, group: Any = None) -> torch.Tensor:
    """``x`` of global rank ``src``, written into ``x`` on every rank of
    ``group`` (default: the world) and returned (not counted)."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        host = x.cpu()
        dist.broadcast(host, src, group=group)
        x.copy_(host)
    else:
        dist.broadcast(x, src, group=group)
    return x
