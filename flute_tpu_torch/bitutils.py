"""Bit-level constants of the packed weight format.

Counterpart of ``flute_tpu/bitutils.py``: the word width and the plane
decomposition that every packed layout is built on. Kept as a separate copy
so the PyTorch package never imports the JAX one.
"""

from __future__ import annotations

# Number of bits in a packed word.
WORD_BITS = 32

# A bit-width as a sum of plane widths that each divide 32: 3-bit codes are
# stored as a 2-bit plane (low bits) plus a 1-bit plane (high bit).
PLANE_DECOMPOSITION: dict[int, tuple[int, ...]] = {
    1: (1,),
    2: (2,),
    3: (2, 1),
    4: (4,),
    8: (8,),
}


def planes_for_bits(num_bits: int) -> tuple[int, ...]:
    if num_bits not in PLANE_DECOMPOSITION:
        raise ValueError(f"Unsupported num_bits: {num_bits}")
    return PLANE_DECOMPOSITION[num_bits]
