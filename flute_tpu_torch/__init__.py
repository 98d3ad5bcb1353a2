"""flute_tpu_torch: the PyTorch / CUDA (Hopper) port of flute_tpu.

LUT-quantized LLM inference: NF quantization, the packed weight layouts of
``flute_tpu`` (bit for bit), fused LUT-dequantize GEMMs written by hand for
sm_90a (the sign-symmetric 4-bit "w4sym" layout, the general-table pair
planes at 2/3/4 bits and the wide 3-bit layout), the Hadamard rotation, the
quantized-checkpoint format, Llama and Gemma-2 models, the serving engines
with their HTTP server, perplexity, the checkpoint importers (HF, bnb,
reference FLUTE), NFL calibration, the launch tuner and the CLI. Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``, which runs
the plain PyTorch versions.

The public names are the JAX package's (``flute_tpu/__init__.py``).
"""

from flute_tpu_torch.version import __version__
from flute_tpu_torch.ops.kernel_config import (
    KernelConfig,
    fit_config,
    get_candidate_configs,
    get_kernel_config,
    is_config_supported,
)
from flute_tpu_torch.ops.lut_gemm import lut_qgemm, lut_qgemm_reference, qgemm
from flute_tpu_torch.ops.hadamard import hadamard_transform, qgemm_hadamard
from flute_tpu_torch.packing import PackFormat, pack, reconstruct, unpack
from flute_tpu_torch.nn import QuantizedLinear, from_codes, quantize_linear

__all__ = [
    "__version__",
    "KernelConfig",
    "fit_config",
    "get_kernel_config",
    "get_candidate_configs",
    "is_config_supported",
    "lut_qgemm",
    "lut_qgemm_reference",
    "qgemm",
    "hadamard_transform",
    "qgemm_hadamard",
    "PackFormat",
    "pack",
    "unpack",
    "reconstruct",
    "QuantizedLinear",
    "from_codes",
    "quantize_linear",
]
