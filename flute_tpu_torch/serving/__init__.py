from flute_tpu_torch.serving.continuous import SamplingParams  # noqa: F401
from flute_tpu_torch.serving.engine import (  # noqa: F401
    Engine,
    greedy_generate,
    greedy_generate_fused,
    sample_logits,
)
from flute_tpu_torch.serving.paged import PagedEngine  # noqa: F401
