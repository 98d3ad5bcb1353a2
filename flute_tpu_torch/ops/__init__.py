from flute_tpu_torch.ops.kernel_config import KernelConfig, LaunchConfig
from flute_tpu_torch.ops.lut_gemm import (
    dequantize_codes,
    dequantize_codes_pair,
    lut_qgemm,
    lut_qgemm_reference,
    qgemm,
)
from flute_tpu_torch.ops.hadamard import (
    grouped_hadamard_transform,
    hadamard_transform,
    qgemm_hadamard,
)

__all__ = [
    "KernelConfig",
    "LaunchConfig",
    "dequantize_codes",
    "dequantize_codes_pair",
    "lut_qgemm",
    "lut_qgemm_reference",
    "qgemm",
    "grouped_hadamard_transform",
    "hadamard_transform",
    "qgemm_hadamard",
]
