"""Kernel configuration: the persisted config key and the Hopper launch shape.

``KernelConfig`` keeps the key format of ``flute_tpu/ops/kernel_config.py``
so that ``config_key`` strings stored with quantized weights still parse.
Its block sizes describe TPU tiles and the CUDA launch ignores them; its
``chunk`` is part of the packed layout and is honoured. The TPU device
profiles and tuned registry are TPU-calibrated and have no counterpart here.

``LaunchConfig`` is what the Hopper LUT-GEMM kernels K1
(``csrc/lut_gemm_w4sym.cu``), K2 (``csrc/lut_gemm_plane.cu``) and K3
(``csrc/lut_gemm_w3wide.cu``) take: they share one skeleton
(``csrc/lut_gemm_common.cuh``) and so one launch shape. ``mma_plan`` plans
the tensor-core loop (``csrc/lut_gemm_mma.cuh``) that K4
(``csrc/lut_gemm_pair.cu``) runs on: m16 tiles per warp and the split of K.
"""

from __future__ import annotations

import dataclasses
import re
from typing import ClassVar

DEFAULT_CHUNK = 256


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """A persisted kernel config (TPU block shapes + layout chunk)."""

    block_m: int = 16
    block_n: int = 2048
    block_k: int = 1024
    lut_mode: str = "gather8"
    # pack chunk the weight layout was built with
    chunk: int = DEFAULT_CHUNK
    accum: str = "high"

    def key(self) -> str:
        # `_s1` is still emitted so keys match the persisted ones
        base = (
            f"m{self.block_m}n{self.block_n}k{self.block_k}"
            f"_{self.lut_mode}_c{self.chunk}_s1"
        )
        if self.accum != "high":
            base += f"_a{self.accum}"
        return base

    @staticmethod
    def from_key(key: str) -> "KernelConfig":
        m = re.fullmatch(
            r"m(\d+)n(\d+)k(\d+)_([a-z0-9_]+?)_c(\d+)(?:_s\d+)?(?:_a([a-z0-9]+))?",
            key,
        )
        if m is None:
            raise ValueError(f"Bad KernelConfig key: {key}")
        return KernelConfig(
            block_m=int(m.group(1)),
            block_n=int(m.group(2)),
            block_k=int(m.group(3)),
            lut_mode=m.group(4),
            chunk=int(m.group(5)),
            accum=m.group(6) or "high",
        )


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    """Launch shape of the LUT-GEMM kernels K1, K2 and K3.

    ``threads`` (eight warps that split each pack chunk's words: plane word
    rows in K1 and K2, word triples in K3) and ``block_n`` (one output column
    per lane) are fixed for all three in ``csrc/lut_gemm_common.cuh``
    (``kThreads``, ``kBlockN``). ``block_m``, the rows of M per block, is
    chosen per call; each kernel is instantiated for every value of
    ``BLOCK_M_CHOICES``. The pack chunk is not a launch field: it is part of
    the layout and reaches the kernels as an argument."""

    block_m: int = 8
    threads: ClassVar[int] = 256
    block_n: ClassVar[int] = 32


# block_m values the kernel is instantiated for
BLOCK_M_CHOICES = (1, 2, 4, 8)


def launch_config(m: int) -> LaunchConfig:
    """The smallest instantiated ``block_m`` that covers ``m`` rows (8 for
    larger M, tiled over the grid): at decode no FMA is spent on padding."""
    for bm in BLOCK_M_CHOICES:
        if m <= bm:
            return LaunchConfig(block_m=bm)
    return LaunchConfig(block_m=BLOCK_M_CHOICES[-1])


# The tensor-core loop (csrc/lut_gemm_mma.cuh, K4): 128 columns per block,
# m16 tiles per warp instantiated for these counts.
MMA_BLOCK_N = 128
MMA_M_TILES = (1, 2, 4)
# Blocks a launch should have: two per SM of the H100's 132. At decode four
# blocks fit an SM, so up to 528 run in one wave.
MMA_TARGET_BLOCKS = 2 * 132


@dataclasses.dataclass(frozen=True)
class MmaPlan:
    """Launch of the tensor-core LUT-GEMM for one (M, N, K, chunk).

    ``m_tiles`` m16 tiles per warp (``16 * m_tiles`` rows per block);
    ``splits`` divides the K chunks among blocks (blockIdx.y) and, above 1,
    needs an f32 workspace ``[splits, M, N]`` that a second kernel adds in
    split order."""

    m_tiles: int
    splits: int
    grid: tuple[int, int, int]

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    def workspace_shape(self, m: int, n: int) -> tuple[int, int, int] | None:
        return (self.splits, m, n) if self.splits > 1 else None


def mma_plan(m: int, n: int, k: int, chunk: int) -> MmaPlan:
    """The m16 tiles per warp (the fewest that cover M, at most 4) and the
    smallest split of K's chunks that gives :data:`MMA_TARGET_BLOCKS`
    blocks; every chunk its own split if none does."""
    m_tiles = next((mt for mt in MMA_M_TILES if m <= 16 * mt), MMA_M_TILES[-1])
    cols = -(-n // MMA_BLOCK_N)
    rows = max(1, -(-m // (16 * m_tiles)))
    nchunks = k // chunk
    divisors = [s for s in range(1, nchunks + 1) if nchunks % s == 0]
    splits = next((s for s in divisors if cols * rows * s >= MMA_TARGET_BLOCKS), nchunks)
    return MmaPlan(m_tiles=m_tiles, splits=splits, grid=(cols, splits, rows))
