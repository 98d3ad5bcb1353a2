"""Bit-level packing primitives of the packed weight format.

Counterpart of ``flute_tpu/bitutils.py``: the word width, the plane
decomposition that every packed layout is built on, and the plane and word
primitives on torch tensors (int32 results), with the numpy packer. Kept as
a separate copy so the PyTorch package never imports the JAX one; the bits
are the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

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


def plane_split(codes: torch.Tensor, num_bits: int) -> list[torch.Tensor]:
    """Split b-bit codes into per-plane sub-codes (low planes first)."""
    planes = planes_for_bits(num_bits)
    out = []
    shift = 0
    codes = codes.to(torch.int32)
    for pb in planes:
        out.append((codes >> shift) & ((1 << pb) - 1))
        shift += pb
    return out


def plane_merge(parts: list[torch.Tensor], num_bits: int) -> torch.Tensor:
    """Inverse of :func:`plane_split`. Raises ``ValueError`` unless there is
    one part per plane."""
    planes = planes_for_bits(num_bits)
    if len(parts) != len(planes):
        raise ValueError(f"{num_bits}-bit codes have {len(planes)} planes, got {len(parts)}")
    acc = torch.zeros_like(parts[0], dtype=torch.int32)
    shift = 0
    for pb, part in zip(planes, parts):
        acc = acc | (part.to(torch.int32) << shift)
        shift += pb
    return acc


def pack_plane_words(sub_codes: torch.Tensor, plane_bits: int) -> torch.Tensor:
    """Pack ``[r, Kc, ...]`` sub-codes into ``[Kc, ...]`` int32 words.

    Word ``w[j]`` holds ``sub_codes[i, j]`` in bit-field ``i`` (LSB-first):
    bit-field ``i`` of word ``j`` stores the code whose unpack position is
    ``i * Kc + j``. Each field is shifted as an int32 and wraps there, as
    JAX's int32 shift does (the top field may set the sign bit).
    """
    r = WORD_BITS // plane_bits
    if sub_codes.shape[0] != r:
        raise ValueError(f"Leading dim must be {r}, got {tuple(sub_codes.shape)}")
    acc = torch.zeros(sub_codes.shape[1:], dtype=torch.int64, device=sub_codes.device)
    for i in range(r):
        field = sub_codes[i].to(torch.int32).to(torch.int64) << (plane_bits * i)
        acc = acc | (field & 0xFFFFFFFF)
    return torch.where(acc >= 2**31, acc - 2**32, acc).to(torch.int32)


def unpack_plane_words(words: torch.Tensor, plane_bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_plane_words`: ``[Kc, ...]`` -> ``[r, Kc, ...]``."""
    r = WORD_BITS // plane_bits
    mask = (1 << plane_bits) - 1
    words = words.to(torch.int32)
    return torch.stack([(words >> (plane_bits * i)) & mask for i in range(r)], dim=0)


def np_pack_plane_words(sub_codes: np.ndarray, plane_bits: int) -> np.ndarray:
    """NumPy twin of :func:`pack_plane_words` for host-side offline packing."""
    r = WORD_BITS // plane_bits
    if sub_codes.shape[0] != r:
        raise ValueError(f"Leading dim must be {r}, got {sub_codes.shape}")
    acc = np.zeros(sub_codes.shape[1:], dtype=np.int64)
    for i in range(r):
        acc |= sub_codes[i].astype(np.int64) << (plane_bits * i)
    # Wrap to int32 (the top field of the top plane may set the sign bit).
    return acc.astype(np.uint64).astype(np.uint32).view(np.int32)
