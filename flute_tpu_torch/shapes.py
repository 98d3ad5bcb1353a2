"""GEMM shapes of the supported models, counterpart of
``flute_tpu/shapes.py``: the (N, K) of every projection of Llama-3
8B/70B/405B and Gemma-2 9B/27B, and of their tensor-parallel shards,
derived from the models' widths and TP factors. Plain data; the tuner and
the kernel tests read it."""

from __future__ import annotations

import dataclasses
from typing import Iterator


@dataclasses.dataclass(frozen=True)
class GemmShape:
    model: str
    proj: str
    n: int  # out features (possibly TP-sharded)
    k: int  # in features (possibly TP-sharded)
    tp: int = 1


def _llama_like(name, hidden, inter, heads, kv_heads, head_dim):
    qdim = heads * head_dim
    kvdim = kv_heads * head_dim
    return {
        "q": (qdim, hidden),
        "k": (kvdim, hidden),
        "v": (kvdim, hidden),
        "o": (hidden, qdim),
        "gate": (inter, hidden),
        "up": (inter, hidden),
        "down": (hidden, inter),
    }


MODELS = {
    "llama3-8b": _llama_like("llama3-8b", 4096, 14336, 32, 8, 128),
    "llama3-70b": _llama_like("llama3-70b", 8192, 28672, 64, 8, 128),
    "llama3-405b": _llama_like("llama3-405b", 16384, 53248, 128, 8, 128),
    "gemma2-9b": _llama_like("gemma2-9b", 3584, 14336, 16, 8, 256),
    "gemma2-27b": _llama_like("gemma2-27b", 4608, 36864, 32, 16, 128),
}

# TP factors documented per model.
MODEL_TP = {
    "llama3-8b": (1,),
    "llama3-70b": (1, 2, 4),
    "llama3-405b": (1, 4, 8),
    "gemma2-9b": (1,),
    "gemma2-27b": (1, 2, 4),
}

_COL = ("q", "k", "v", "gate", "up")  # N-sharded under TP


def iter_shapes(models=None, tps=None) -> Iterator[GemmShape]:
    for model, projs in MODELS.items():
        if models is not None and model not in models:
            continue
        for tp in MODEL_TP[model]:
            if tps is not None and tp not in tps:
                continue
            for proj, (n, k) in projs.items():
                if tp > 1:
                    if proj in _COL:
                        n = n // tp
                    else:
                        k = k // tp
                yield GemmShape(model=model, proj=proj, n=n, k=k, tp=tp)


def unique_nk(models=None, tps=None) -> list[tuple[int, int]]:
    seen = []
    for s in iter_shapes(models, tps):
        if (s.n, s.k) not in seen:
            seen.append((s.n, s.k))
    return seen
