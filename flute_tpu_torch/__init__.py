"""flute_tpu_torch: the PyTorch / CUDA (Hopper) port of flute_tpu.

LUT-quantized LLM inference: NF quantization, the packed weight layouts of
``flute_tpu`` (bit for bit), fused LUT-dequantize GEMMs written by hand for
sm_90a (the sign-symmetric 4-bit "w4sym" layout, the general-table pair
planes at 2/3/4 bits and the wide 3-bit layout), the quantized-checkpoint
format, a Llama model and a serving engine. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``, which runs the plain PyTorch versions.
"""

from flute_tpu_torch.nn import QuantizedLinear, from_codes, quantize_linear  # noqa: F401
from flute_tpu_torch.ops.lut_gemm import qgemm  # noqa: F401
from flute_tpu_torch.packing import pack, reconstruct  # noqa: F401

__all__ = ["from_codes", "pack", "qgemm", "quantize_linear", "QuantizedLinear", "reconstruct"]
