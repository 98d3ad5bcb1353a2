"""Pipeline parallelism: contiguous layer stages on successive devices,
counterpart of ``flute_tpu/parallel/pp.py``.

Stage 0 holds the embedding, the last stage the final norm and the
lm_head; the ``[B, T, hidden]`` activation hops from stage to stage. In one
process (:meth:`PipelinedModel.build`) the stages live on a list of torch
devices, which may repeat (on one card every stage shares it) and the
activation moves with ``.to(device)``. Composed with tensor parallelism
(:meth:`PipelinedModel.build_tp`) each stage has a ``parallel.tp.Mesh`` of
its own: a rank holds its slices of the stages whose mesh it belongs to,
runs them with the mesh's tp group, and where two successive stages run on
different ranks the activation is broadcast from the earlier stage's first
rank; the logits reach every rank the same way. Every rank makes the same
calls.

Microbatching (:meth:`PipelinedModel.forward_microbatched`) steps each
microbatch through every stage in turn. Its caches stay resident per
microbatch: :func:`split_cache_microbatches` slices each stage's cache
along the batch once (the slices are views, so the steps write into the
whole cache in place), and no step concatenates a whole cache.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from flute_tpu_torch.interop import move_params
from flute_tpu_torch.models import llama
from flute_tpu_torch.parallel import comm
from flute_tpu_torch.parallel.tp import llama_partition_specs, shard_params


def split_stages(params: dict, num_stages: int) -> list[dict]:
    """Split a Llama-layout params tree into ``num_stages`` stage subtrees,
    layers split contiguously as evenly as possible. Stage 0 carries the
    embedding; the last stage the final norm and lm_head (and the embedding
    for a tied head)."""
    layers = params["layers"]
    base, rem = divmod(len(layers), num_stages)
    sizes = [base + (1 if i < rem else 0) for i in range(num_stages)]
    stages = []
    start = 0
    for i, sz in enumerate(sizes):
        stage: dict = {"layers": layers[start:start + sz]}
        if i == 0:
            stage["embed"] = params["embed"]
        if i == num_stages - 1:
            stage["final_norm"] = params["final_norm"]
            stage["lm_head"] = params.get("lm_head")
            if "embed" not in stage and params.get("lm_head") is None:
                stage["embed"] = params["embed"]  # tied head needs embed
        stages.append(stage)
        start += sz
    return stages


def split_cache_microbatches(caches: list, num_microbatches: int) -> list[list]:
    """Per-stage caches split along the batch into resident per-microbatch
    caches, ``result[stage][mb]``: views of the whole caches, done once at
    setup (each step then writes its microbatch's rows in place)."""
    out = []
    for cache in caches:
        if cache is None:  # a stage this rank does not run
            out.append([None] * num_microbatches)
            continue
        b = cache["k"][0].shape[0]
        if b % num_microbatches:
            raise ValueError(f"batch {b} not divisible by {num_microbatches} microbatches")
        mb = b // num_microbatches
        out.append([{kv: [a[i * mb:(i + 1) * mb] for a in cache[kv]] for kv in ("k", "v")}
                    for i in range(num_microbatches)])
    return out


def merge_cache_microbatches(caches_mb: list[list]) -> list:
    """Inverse of :func:`split_cache_microbatches` (a copy, for hand-back
    to :meth:`PipelinedModel.forward` or checkpointing)."""
    return [None if parts[0] is None else
            {kv: [torch.cat(xs, dim=0) for xs in zip(*(p[kv] for p in parts))]
             for kv in ("k", "v")}
            for parts in caches_mb]


@dataclasses.dataclass
class PipelinedModel:
    """A stage-placed Llama with the ``(tokens, caches, pos)`` step contract
    of ``llama.forward``, ``caches`` a list of per-stage caches.

    ``devices`` holds one torch device per stage or, when ``meshes`` is set,
    the device of each stage's mesh on this rank; a stage this rank does
    not run is None in ``stages`` and in the caches."""

    config: Any
    stages: list
    devices: Sequence[Any]
    meshes: Optional[Sequence[Any]] = None
    stage_specs: Optional[Sequence[Any]] = None

    @staticmethod
    def build(params: dict, config, num_stages: Optional[int] = None,
              devices: Optional[Sequence[Any]] = None) -> "PipelinedModel":
        """Stages on ``devices`` (default: every CUDA device), one each, or
        round-robin where there are more stages than devices."""
        if devices is None:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            if not devices:
                raise RuntimeError("no CUDA device is available; pass devices=['cpu', ...]")
        devices = [torch.device(d) for d in devices]
        num_stages = num_stages or len(devices)
        devices = [devices[i % len(devices)] for i in range(num_stages)]
        stages = [move_params(s, d) for s, d in zip(split_stages(params, num_stages), devices)]
        return PipelinedModel(config=config, stages=stages, devices=devices)

    @staticmethod
    def build_tp(params: dict, config, meshes: Sequence[Any]) -> "PipelinedModel":
        """tp x pp: stage i tensor-parallel over ``meshes[i]`` (fused
        qkv/gate_up permuted rank-major for the meshes' tp first,
        ``parallel.permute_fused_params``). Every rank of the world calls it."""
        stages = split_stages(params, len(meshes))
        specs = [llama_partition_specs(s) for s in stages]
        placed = [shard_params(s, m, sp) if m.is_member else None
                  for s, m, sp in zip(stages, meshes, specs)]
        return PipelinedModel(config=config, stages=placed, devices=[m.device for m in meshes],
                              meshes=list(meshes), stage_specs=specs)

    def init_cache(self, batch: int, max_len: int) -> list:
        """Zeroed per-stage caches (this rank's KV heads under tp)."""
        c = self.config
        out = []
        for i, stage in enumerate(self.stages):
            if stage is None:
                out.append(None)
                continue
            hkv = c.num_kv_heads // (1 if self.meshes is None else self.meshes[i].tp)
            shape = (batch, hkv, max_len, c.head_dim)
            out.append({kv: [torch.zeros(shape, dtype=c.dtype, device=self.devices[i])
                             for _ in stage["layers"]] for kv in ("k", "v")})
        return out

    def _run_stage(self, i: int, x: torch.Tensor, cache: dict, pos, offsets) -> torch.Tensor:
        """Stage ``i`` over ``x`` (token ids at stage 0, else the hidden
        states), its cache written in place: the hidden states, or the f32
        logits at the last stage."""
        c = self.config
        stage = self.stages[i]
        group = None if self.meshes is None else self.meshes[i].reduce_group
        if i == 0:
            x = stage["embed"][x.long()].to(c.dtype)
        pos, _, mask, cos, sin = llama.step_positions(c, x[..., 0], cache, pos, offsets)
        for li, layer in enumerate(stage["layers"]):
            x = llama._block(layer, c, x, cos, sin, cache["k"][li], cache["v"][li], pos, mask,
                             group)
        if i < len(self.stages) - 1:
            return x
        return llama.head_logits(stage, c, x)

    def _hand_over(self, x: Optional[torch.Tensor], i: int, shape, dtype) -> torch.Tensor:
        """The output of stage ``i - 1`` (or the tokens, at ``i`` = 0) where
        stage ``i`` runs (``i`` = len(stages) stands for every rank)."""
        if self.meshes is None:
            return x.to(self.devices[min(i, len(self.devices) - 1)])
        prev = self.meshes[i - 1] if i > 0 else None
        if prev is None:
            return x.to(self.meshes[0].device)
        last = i == len(self.meshes)
        nxt = set(range(dist.get_world_size())) if last else set(self.meshes[i].members)
        dev = prev.device if last else self.meshes[i].device
        if set(prev.members) >= nxt:
            return None if x is None else x.to(dev)  # every rank of stage i has it
        buf = x.to(dev) if prev.is_member else torch.empty(shape, dtype=dtype, device=dev)
        return comm.broadcast_(buf, src=prev.ranks[0][0])

    def _run(self, tokens: torch.Tensor, caches: list, pos, offsets):
        b, t = tokens.shape
        c = self.config
        x = tokens
        for i in range(len(self.stages)):
            x = self._hand_over(x, i, (b, t, c.hidden_size), c.dtype)
            if self.stages[i] is None:
                x = None
                continue
            dev = self.devices[i]
            p = pos.to(dev) if isinstance(pos, torch.Tensor) else pos
            offs = None if offsets is None else offsets.to(dev)
            x = self._run_stage(i, x, caches[i], p, offs)
        return self._hand_over(x, len(self.stages), (b, t, c.vocab_size), torch.float32)

    @torch.inference_mode()
    def forward(self, tokens: torch.Tensor, caches: list, pos,
                position_offsets: Optional[torch.Tensor] = None):
        """Run every stage in turn: f32 logits ``[B, T, V]`` (on every
        rank) and the caches, written in place."""
        return self._run(tokens, caches, pos, position_offsets), caches

    @torch.inference_mode()
    def forward_microbatched(self, tokens: torch.Tensor, caches: list, pos,
                             position_offsets: Optional[torch.Tensor] = None,
                             num_microbatches: int = 2):
        """GPipe-style microbatched forward, the math of :meth:`forward`
        (batch rows are independent): each microbatch steps through every
        stage, and with stages on separate cards a stage's kernels for
        microbatch m queue behind its own work only.

        ``caches``: per-microbatch caches from
        :func:`split_cache_microbatches` (``caches[stage][mb]``), which stay
        resident and are written in place, or whole per-stage caches, split
        into views here. Returns the logits and the caches in the form
        given."""
        b = tokens.shape[0]
        m = min(num_microbatches, b)
        if b % m:
            raise ValueError(f"batch {b} not divisible by {m} microbatches")
        mb = b // m
        microbatched_in = bool(caches) and isinstance(caches[0], (list, tuple))
        caches_mb = caches if microbatched_in else split_cache_microbatches(caches, m)
        if len(caches_mb[0]) != m:
            raise ValueError(f"caches carry {len(caches_mb[0])} microbatches, stepping with {m}")
        pos_vec = isinstance(pos, torch.Tensor) and pos.ndim == 1
        parts = []
        for mi in range(m):
            sl = slice(mi * mb, (mi + 1) * mb)
            parts.append(self._run(
                tokens[sl], [c[mi] for c in caches_mb], pos[sl] if pos_vec else pos,
                None if position_offsets is None else position_offsets[sl]))
        return torch.cat(parts, dim=0), caches
