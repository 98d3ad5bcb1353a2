from flute_tpu_torch.ops.kernel_config import KernelConfig, LaunchConfig  # noqa: F401
from flute_tpu_torch.ops.lut_gemm import (  # noqa: F401
    dequantize_codes,
    dequantize_codes_pair,
    lut_qgemm,
    lut_qgemm_reference,
    qgemm,
)
