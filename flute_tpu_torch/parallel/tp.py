"""Tensor-parallel execution of quantized models over a ``torch.distributed``
world; counterpart of ``flute_tpu/parallel/tp.py``.

The pack layout (:mod:`flute_tpu_torch.packing`) is chunked along K and
independent per N column, so

  * N-sharding a packed plane is a slice of its columns (always valid);
  * K-sharding is a slice of whole row chunks (valid when the local K is a
    multiple of the pack chunk).

Megatron-style TP: q/k/v/gate/up (and the fused qkv/gate_up) are
column-parallel, o/down row-parallel with one all-reduce each
(``models.llama._block``, :mod:`.comm`), the KV cache sharded over heads.

Where the JAX package runs one program over a device mesh, here every rank
is a process of a ``torch.distributed`` world (``parallel.launch`` starts
one). A :class:`Mesh` is this process's view of a ``(dp, tp)`` grid of
ranks: its coordinates, its ``tp`` and ``dp`` process groups and its
device. A partition spec is a plain tuple per tensor, naming the mesh axis
of each dimension or None (``(None, "tp")``; ``()`` is replicated).
:func:`shard_params` takes this rank's slice of every sharded tensor, the
counterpart of ``jax.device_put`` with a ``NamedSharding``, and the forward
of :func:`tp_model_forward` runs the model on those slices with the tp
group.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from flute_tpu_torch.device import resolve_device
from flute_tpu_torch.nn import QuantizedLinear
from flute_tpu_torch.packing import DEFAULT_CHUNK
from flute_tpu_torch.parallel import comm

# Column-parallel (shard out-features) vs row-parallel (shard in-features)
# projection names in the Llama/Gemma block layout. The fused projections
# (qkv / gate_up) are column-parallel too, once their columns are reordered
# rank-major (permute_fused_params) so that a contiguous N-shard hands every
# rank its own [q_r | k_r | v_r] slice.
COL_PARALLEL = ("q", "k", "v", "gate", "up", "qkv", "gate_up")
ROW_PARALLEL = ("o", "down")
FUSED_KEYS = ("qkv", "gate_up")


def fused_member_widths(config, key: str) -> tuple[int, ...]:
    """Output-column widths of each member of a fused projection."""
    if key == "qkv":
        d = config.head_dim
        return (config.num_heads * d, config.num_kv_heads * d, config.num_kv_heads * d)
    if key == "gate_up":
        return (config.intermediate_size, config.intermediate_size)
    raise ValueError(f"unknown fused key {key!r}")


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's view of a ``(dp, tp)`` grid of ranks.

    ``ranks[d][t]`` is the global rank at ``(d, t)``; ``tp_group`` holds
    this rank's row (the ranks that shard one model replica), ``dp_group``
    its column (the replicas). A rank outside the grid has no coordinates
    and no groups."""

    ranks: tuple[tuple[int, ...], ...]
    rank: int
    device: torch.device
    tp_group: Any = None
    dp_group: Any = None
    axis_names: tuple[str, str] = ("dp", "tp")

    @property
    def dp(self) -> int:
        return len(self.ranks)

    @property
    def tp(self) -> int:
        return len(self.ranks[0])

    @property
    def members(self) -> tuple[int, ...]:
        return tuple(r for row in self.ranks for r in row)

    @property
    def is_member(self) -> bool:
        return self.rank in self.members

    @property
    def coords(self) -> tuple[int, int]:
        """``(dp_rank, tp_rank)`` of this rank."""
        for d, row in enumerate(self.ranks):
            if self.rank in row:
                return d, row.index(self.rank)
        raise ValueError(f"rank {self.rank} is not in the mesh {self.ranks}")

    @property
    def dp_rank(self) -> int:
        return self.coords[0]

    @property
    def tp_rank(self) -> int:
        return self.coords[1]

    @property
    def reduce_group(self):
        """The group of the blocks' all-reduces: None at tp = 1."""
        return self.tp_group if self.tp > 1 else None


def make_mesh(
    tp: Optional[int] = None,
    dp: int = 1,
    *,
    ranks: Optional[Sequence[int]] = None,
    device=None,
    axis_names: tuple[str, str] = ("dp", "tp"),
) -> Mesh:
    """A ``(dp, tp)`` mesh over ``ranks`` (default: every rank of the
    world, all on the tp axis), rank-major: ``ranks[d * tp + t]`` is at
    ``(d, t)``. Every rank of the world calls it with the same arguments
    (process groups are created collectively), after
    ``torch.distributed.init_process_group``. ``device`` is this rank's
    device: ``cuda`` unless named, the card ``rank % device_count``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group first")
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    if tp is None:
        tp = len(ranks) // dp
    if dp * tp > len(ranks):
        raise ValueError(f"dp={dp} * tp={tp} > {len(ranks)} ranks")
    grid = tuple(tuple(ranks[d * tp:(d + 1) * tp]) for d in range(dp))
    rank = dist.get_rank()
    tp_group = dp_group = None
    for row in grid:  # every rank creates every group, in the same order
        g = dist.new_group(list(row))
        if rank in row:
            tp_group = g
    for t in range(tp):
        col = [row[t] for row in grid]
        g = dist.new_group(col)
        if rank in col:
            dp_group = g
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return Mesh(grid, rank, dev, tp_group, dp_group, axis_names)


def make_hybrid_mesh(
    tp: int,
    dp_dcn: int = 1,
    *,
    device=None,
    axis_names: tuple[str, str] = ("dp", "tp"),
) -> Mesh:
    """A multi-node mesh: tp over the ranks of one node, dp across nodes,
    so that the blocks' all-reduces never leave a node. Nodes hold the
    launcher's ``LOCAL_WORLD_SIZE`` consecutive ranks (default ``tp``); a
    tp row must not straddle two."""
    world = dist.get_world_size()
    n = dp_dcn * tp
    if world < n:
        raise ValueError(f"hybrid mesh needs {n} ranks, have {world}")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", tp))
    if local % tp:
        raise ValueError(f"tp={tp} does not divide the {local} ranks of a node")
    return make_mesh(tp, dp_dcn, ranks=range(n), device=device, axis_names=axis_names)


def local_config(config, tp: int):
    """``config`` with the head counts of one of ``tp`` ranks: the shape of
    a rank's KV cache or pools (the forward keeps the global config; its
    head counts come from the local tensors)."""
    return dataclasses.replace(config, num_heads=config.num_heads // tp,
                               num_kv_heads=config.num_kv_heads // tp)


# ---------------------------------------------------------------------------
# Fused layers
# ---------------------------------------------------------------------------


def permute_fused_linear(
    layer: QuantizedLinear, member_widths: tuple[int, ...], tp: int
) -> QuantizedLinear:
    """Reorder a fused layer's output columns rank-major for ``tp`` ranks.

    Member m owns global columns ``[off_m, off_m + w_m)``; after the
    permutation the column order is ``[m0_r0 | m1_r0 | ... | m0_r1 | ...]``,
    so a contiguous 1/tp slice of N is rank r's members in order. Exact:
    the pack layout is independent per N column."""
    n = layer.out_features
    if sum(member_widths) != n:
        raise ValueError(f"member widths {member_widths} do not sum to N={n}")
    offs = np.concatenate([[0], np.cumsum(member_widths)])
    idx = []
    for r in range(tp):
        for m, w in enumerate(member_widths):
            if w % tp:
                raise ValueError(f"member width {w} not divisible by tp={tp}")
            lw = w // tp
            idx.extend(range(offs[m] + r * lw, offs[m] + (r + 1) * lw))
    idx = np.asarray(idx)
    if np.array_equal(idx, np.arange(n)):
        return layer
    cols = torch.from_numpy(idx).to(layer.scales.device)
    return layer.replace(
        planes=tuple(p[:, cols] for p in layer.planes),
        scales=layer.scales[:, cols],
        bias=None if layer.bias is None else layer.bias[cols],
    )


def permute_fused_params(params: Any, config, tp: int) -> Any:
    """Permute every fused (qkv / gate_up) layer of a Llama/Gemma-2 params
    tree rank-major for ``tp``-way tensor parallelism. The result computes
    correctly only sharded ``tp`` ways (or at tp = 1): the in-block split
    reads each member from the local slice."""
    if tp == 1:
        return params
    out = dict(params)
    out["layers"] = []
    for layer in params["layers"]:
        new_layer = dict(layer)
        for key in FUSED_KEYS:
            if key in new_layer:
                new_layer[key] = permute_fused_linear(
                    new_layer[key], fused_member_widths(config, key), tp)
        out["layers"].append(new_layer)
    return out


# ---------------------------------------------------------------------------
# Specs and sharding
# ---------------------------------------------------------------------------


def _tensor_spec(proj: Optional[str], field: Optional[str], ndim: int, tp_axis: str) -> tuple:
    """The spec of one tensor of projection ``proj`` (None outside the
    blocks' projections); ``field`` is its QuantizedLinear field."""
    if proj is None or field in ("table", "pair_values"):
        return ()
    if proj in COL_PARALLEL:
        if field == "bias":
            return (tp_axis,)
        return (None, tp_axis) if ndim == 2 else ()
    # row-parallel: K, axis 0 of [K, N]-oriented tensors; a bias is added
    # once, after the all-reduce (Llama has none)
    if field == "bias":
        return ()
    return (tp_axis, None) if ndim == 2 else ()


def _linear_specs(layer: QuantizedLinear, proj: Optional[str], tp_axis: str) -> dict:
    specs = {
        "planes": tuple(_tensor_spec(proj, "planes", p.ndim, tp_axis) for p in layer.planes),
        "scales": _tensor_spec(proj, "scales", 2, tp_axis),
        "table": (),
    }
    if layer.pair_values is not None:
        specs["pair_values"] = ()
    if layer.bias is not None:
        specs["bias"] = _tensor_spec(proj, "bias", 1, tp_axis)
    return specs


def llama_partition_specs(params: Any, tp_axis: str = "tp") -> Any:
    """The spec tree of a Llama-layout params tree (dense or quantized
    leaves): the params' structure with a spec tuple for each tensor and,
    for a :class:`QuantizedLinear`, a dict of its tensors' specs.

    Column-parallel projections shard out-features (the last axis) over
    ``tp_axis``; row-parallel ones shard in-features (axis 0, the K-chunk
    rows of packed planes and scales); tables, pair tables, norms,
    embeddings and the lm_head are replicated."""

    def visit(node, proj):
        if isinstance(node, QuantizedLinear):
            return _linear_specs(node, proj, tp_axis)
        if isinstance(node, dict):
            return {k: visit(v, k if k in COL_PARALLEL + ROW_PARALLEL else proj)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(visit(v, proj) for v in node)
        if isinstance(node, torch.Tensor):
            return _tensor_spec(proj, None, node.ndim, tp_axis)
        return None

    return visit(params, None)


def cache_partition_spec(num_layers: int, tp_axis: str = "tp", dp_axis: Optional[str] = "dp"):
    """KV cache: per-layer ``[B, Hkv, S, D]`` tensors, batch over dp, heads
    over tp."""
    leaf = (dp_axis, tp_axis, None, None)
    return {"k": [leaf] * num_layers, "v": [leaf] * num_layers}


def validate_tp(params: Any, config, tp: int, chunk: int = DEFAULT_CHUNK) -> None:
    """Check that a Llama params tree can be sharded ``tp`` ways: head
    counts divide, every fused member splits into 128-column slices, and
    each row-parallel layer's local K is a multiple of its pack chunk,
    holds whole Hadamard groups (HIGGS), and comes without a bias."""
    if config.num_kv_heads % tp != 0:
        raise ValueError(f"num_kv_heads={config.num_kv_heads} not divisible by tp={tp}")
    if config.num_heads % tp != 0:
        raise ValueError(f"num_heads={config.num_heads} not divisible by tp={tp}")
    for layer in params.get("layers", []):
        for key in FUSED_KEYS:
            if key not in layer:
                continue
            for w in fused_member_widths(config, key):
                if w % tp or (w // tp) % 128:
                    raise ValueError(
                        f"{key}: member width {w} must split into "
                        f"128-column-aligned slices across tp={tp}"
                    )
        for proj in ROW_PARALLEL:
            leaf = layer.get(proj)
            if not isinstance(leaf, QuantizedLinear):
                continue
            k = leaf.in_features
            c = leaf.config.chunk if leaf.config is not None else chunk
            if (k // tp) % c != 0:
                raise ValueError(f"{proj}: local K={k}//{tp} not a multiple of pack chunk {c}")
            if leaf.hadamard_size is not None and (k // tp) % leaf.hadamard_size:
                # a rank's rotation groups would straddle the shard boundary
                raise ValueError(
                    f"{proj}: local K={k}//{tp} not a multiple of the Hadamard "
                    f"size {leaf.hadamard_size}"
                )
            if leaf.bias is not None:
                raise ValueError(f"{proj}: bias on a row-parallel layer is unsupported")


def _shard_tensor(t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of ``t`` under ``spec``, on the mesh's device: an
    owned contiguous copy where sharded, ``t`` itself (moved) where
    replicated."""
    tp_axis = mesh.axis_names[1]
    if tp_axis not in spec:
        return t.to(mesh.device)
    axis = spec.index(tp_axis)
    if t.shape[axis] % mesh.tp:
        raise ValueError(f"axis {axis} of {tuple(t.shape)} does not split {mesh.tp} ways")
    n = t.shape[axis] // mesh.tp
    part = t.narrow(axis, mesh.tp_rank * n, n)
    return part.to(mesh.device, copy=True, memory_format=torch.contiguous_format)


def shard_params(params: Any, mesh: Mesh, specs: Any = None) -> Any:
    """This rank's slices of a params tree under ``specs`` (default
    :func:`llama_partition_specs`), on the mesh's device."""
    if specs is None:
        specs = llama_partition_specs(params)

    def visit(node, spec):
        if isinstance(node, QuantizedLinear):
            opt = {f: _shard_tensor(getattr(node, f), spec[f], mesh)
                   for f in ("pair_values", "bias") if getattr(node, f) is not None}
            return node.replace(
                planes=tuple(_shard_tensor(p, s, mesh) for p, s in zip(node.planes, spec["planes"])),
                scales=_shard_tensor(node.scales, spec["scales"], mesh),
                table=_shard_tensor(node.table, spec["table"], mesh),
                **opt,
            )
        if isinstance(node, dict):
            return {k: visit(v, spec[k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(visit(v, s) for v, s in zip(node, spec))
        if isinstance(node, torch.Tensor):
            return _shard_tensor(node, spec, mesh)
        return node

    return visit(params, specs)


# ---------------------------------------------------------------------------
# Forwards
# ---------------------------------------------------------------------------


def tp_model_forward(config, mesh: Mesh, params_specs: Any, *,
                     base_forward: Optional[Callable] = None) -> Callable:
    """A forward with ``llama.forward``'s contract, ``forward(params,
    config, tokens, cache, pos, position_offsets=None)``, that runs
    ``base_forward`` (default ``llama.forward``) with the mesh's tp group:
    ``params`` are this rank's slices (:func:`shard_params` under
    ``params_specs``), the cache holds this rank's KV heads, the batch is
    the whole batch on every rank, and the logits come out whole on every
    rank, with the same bits."""
    from flute_tpu_torch.models import llama

    fwd = base_forward or llama.forward
    group = mesh.reduce_group

    def forward(params, config_, tokens, cache, pos, position_offsets=None):
        return fwd(params, config_, tokens, cache, pos, position_offsets, group=group)

    return forward


def tp_forward_fn(config, mesh: Mesh, params_specs: Any, *,
                  forward: Optional[Callable] = None) -> Callable:
    """A tensor- and data-parallel step ``step(params, tokens, cache, pos,
    offsets) -> (logits, cache)``: every rank passes the whole batch of
    ``tokens`` and ``offsets`` and its own cache (its dp slice of the batch,
    its tp slice of the heads, :func:`cache_partition_spec`), runs its dp
    slice with the tp group, and gets the whole batch's logits, gathered
    over dp."""
    fwd = tp_model_forward(config, mesh, params_specs, base_forward=forward)

    def step(params, tokens, cache, pos, offsets):
        lb = tokens.shape[0] // mesh.dp
        rows = slice(mesh.dp_rank * lb, (mesh.dp_rank + 1) * lb)
        if isinstance(pos, torch.Tensor) and pos.ndim == 1:
            pos = pos[rows]
        logits, cache = fwd(params, config, tokens[rows], cache, pos, offsets[rows])
        if mesh.dp > 1:
            logits = torch.cat(comm.all_gather(logits, mesh.dp_group, mesh.dp))
        return logits, cache

    return step


def tp_engine_setup(params: Any, config, mesh: Mesh, params_specs: Any = None,
                    forward: Optional[Callable] = None):
    """What a serving engine runs under ``mesh``: ``(params, specs,
    forward, cache_config)``, this rank's slices of ``params`` under
    ``params_specs`` (default :func:`llama_partition_specs`), the tp forward
    over ``forward``, and the config to allocate this rank's KV cache or
    pools from (its KV heads). Fused params must already be permuted
    rank-major (:func:`permute_fused_params`); the tree is checked with
    :func:`validate_tp` first."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.tp.Mesh (make_mesh), not {type(mesh).__name__}")
    validate_tp(params, config, mesh.tp)
    specs = params_specs if params_specs is not None else llama_partition_specs(params)
    return (shard_params(params, mesh, specs), specs,
            tp_model_forward(config, mesh, specs, base_forward=forward),
            local_config(config, mesh.tp))
