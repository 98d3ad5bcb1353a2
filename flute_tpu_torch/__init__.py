"""flute_tpu_torch: the PyTorch / CUDA (Hopper) port of flute_tpu.

LUT-quantized LLM inference: NF quantization, the packed weight layouts of
``flute_tpu`` (bit for bit), a fused LUT-dequantize GEMM written by hand for
sm_90a (the sign-symmetric 4-bit "w4sym" layout), a Llama model and a
serving engine. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``, which runs the plain PyTorch versions.
"""

from flute_tpu_torch.nn import QuantizedLinear, quantize_linear  # noqa: F401
from flute_tpu_torch.ops.lut_gemm import qgemm  # noqa: F401
from flute_tpu_torch.packing import pack, reconstruct  # noqa: F401

__all__ = ["pack", "qgemm", "quantize_linear", "QuantizedLinear", "reconstruct"]
