"""Kernels: the least time of the traced decode steps' LUT-GEMM calls at
their real rows (the larger of their operations at 989 TFLOP/s and their
bytes at 3.35 TB/s, ``harness/counts.py``) over the device time of the
kernels named by ``readers.LUT_GEMM_KERNELS`` inside those steps, percent
(the dense engine's chat cell)."""

from harness.readers import decode_steps, lut_roofline


def read(run):
    return lut_roofline(run, decode_steps(run.traced))
