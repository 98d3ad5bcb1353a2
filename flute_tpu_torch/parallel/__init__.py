"""Tensor and pipeline parallelism over ``torch.distributed`` worlds,
counterpart of ``flute_tpu.parallel``: sharding and the TP forward
(:mod:`.tp`), resharding of packed layers (:mod:`.reshard`), pipeline
stages (:mod:`.pp`) and a launcher of local worlds (:mod:`.launch`)."""

from flute_tpu_torch.parallel.reshard import merge_shards, repack, shard_linear
from flute_tpu_torch.parallel.tp import (
    COL_PARALLEL,
    ROW_PARALLEL,
    cache_partition_spec,
    fused_member_widths,
    llama_partition_specs,
    make_hybrid_mesh,
    make_mesh,
    permute_fused_linear,
    permute_fused_params,
    shard_params,
    tp_forward_fn,
    tp_model_forward,
    validate_tp,
)

__all__ = [
    "COL_PARALLEL",
    "ROW_PARALLEL",
    "cache_partition_spec",
    "fused_member_widths",
    "llama_partition_specs",
    "make_hybrid_mesh",
    "make_mesh",
    "permute_fused_linear",
    "permute_fused_params",
    "shard_params",
    "tp_forward_fn",
    "tp_model_forward",
    "validate_tp",
    "merge_shards",
    "repack",
    "shard_linear",
]
