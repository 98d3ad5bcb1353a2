"""The Hopper kernel lab: design experiments on the LUT-GEMM's dequantization,
counterpart of ``scripts/kernel_lab.py``.

:mod:`flute_tpu_torch.lab.ops` holds L1–L6 (plain versions and the Hopper
kernels of ``csrc/kernel_lab.cu``); :mod:`flute_tpu_torch.lab.kernel_lab` is
the entry point that times them on the card
(``python -m flute_tpu_torch.lab.kernel_lab --variants ...``).
"""
