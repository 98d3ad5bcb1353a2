"""The version recorded in a quantized checkpoint's manifest and sidecar.

A copy of ``flute_tpu/version.py``: the port writes the JAX package's
checkpoint format, so both record the same version string.
"""

__version__ = "0.3.0"
