from flute_tpu_torch.serving.continuous import ContinuousBatchingEngine, SamplingParams
from flute_tpu_torch.serving.engine import (
    Engine,
    greedy_generate,
    greedy_generate_fused,
    sample_logits,
)
from flute_tpu_torch.serving.paged import PagedEngine
from flute_tpu_torch.serving.paged_spec import PagedSpeculativeEngine
from flute_tpu_torch.serving.speculative import SpecStats, SpeculativeEngine, make_accept_fn

__all__ = [
    "Engine",
    "greedy_generate",
    "greedy_generate_fused",
    "sample_logits",
    "ContinuousBatchingEngine",
    "SamplingParams",
    "PagedEngine",
    "PagedSpeculativeEngine",
    "SpeculativeEngine",
    "SpecStats",
    "make_accept_fn",
]
