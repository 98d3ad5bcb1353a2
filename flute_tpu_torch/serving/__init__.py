from flute_tpu_torch.serving.engine import (  # noqa: F401
    Engine,
    greedy_generate,
    greedy_generate_fused,
    sample_logits,
)
