from flute_tpu_torch.quantize.nf import (
    QLORA_NF4,
    nf_pivots,
    nf_quantize,
    nf_quantize_fake,
    nf_quantize_symmetric,
    nf_values,
    nf_values_symmetric_exact,
    quantize_with_table,
)

__all__ = [
    "QLORA_NF4",
    "nf_pivots",
    "nf_quantize",
    "nf_quantize_fake",
    "nf_quantize_symmetric",
    "nf_values",
    "nf_values_symmetric_exact",
    "quantize_with_table",
]
