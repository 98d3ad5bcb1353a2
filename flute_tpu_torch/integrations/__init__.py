"""Checkpoint I/O and interop of the port: the quantized-checkpoint format,
HF checkpoints, reference-FLUTE checkpoints and the CLI."""

from flute_tpu_torch.integrations import checkpoint, huggingface  # noqa: F401

__all__ = ["checkpoint", "huggingface"]
