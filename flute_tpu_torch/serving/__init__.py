from flute_tpu_torch.serving.continuous import (  # noqa: F401
    ContinuousBatchingEngine,
    SamplingParams,
)
from flute_tpu_torch.serving.engine import (  # noqa: F401
    Engine,
    greedy_generate,
    greedy_generate_fused,
    sample_logits,
)
from flute_tpu_torch.serving.paged import PagedEngine  # noqa: F401
from flute_tpu_torch.serving.paged_spec import PagedSpeculativeEngine  # noqa: F401
from flute_tpu_torch.serving.speculative import (  # noqa: F401
    SpecStats,
    SpeculativeEngine,
    make_accept_fn,
)
