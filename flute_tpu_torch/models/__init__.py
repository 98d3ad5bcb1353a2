from flute_tpu_torch.models import gemma2, llama

__all__ = ["gemma2", "llama"]
