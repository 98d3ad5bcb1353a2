"""Checkpoint I/O of the port: the JAX package's quantized-checkpoint format."""

from flute_tpu_torch.integrations import checkpoint  # noqa: F401

__all__ = ["checkpoint"]
