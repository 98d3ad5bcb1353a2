"""Kernel configuration: the persisted config key and the Hopper launch shape.

``KernelConfig`` keeps the key format of ``flute_tpu/ops/kernel_config.py``
so that ``config_key`` strings stored with quantized weights still parse.
Its block sizes describe TPU tiles and the CUDA launch ignores them; its
``chunk`` is part of the packed layout and is honoured. The TPU device
profiles and the JAX package's shipped tuned registry are TPU-calibrated
and have no counterpart here.

The JAX package's four config functions keep their names and roles
(:func:`is_config_supported`, :func:`get_candidate_configs`,
:func:`fit_config`, :func:`get_kernel_config`), retargeted to what a Hopper
launch may vary per call: the tensor-core loop's m16 tiles per warp
(``KernelConfig.m_tiles``) and the SIMT kernel's rows per block
(``KernelConfig.simt_block_m``), 0 meaning the planner's choice. Neither
moves a bit of any row's result; the split of K, which would, stays
:func:`mma_plan`'s. These two fields are never written into a key: a
persisted key means the planner's choice, and the tuner
(``flute_tpu_torch.tune``) keeps its choices in its own registry.

Two launch shapes serve the Hopper LUT-GEMM kernels:

* ``mma_plan`` plans the tensor-core loop (``csrc/lut_gemm_mma.cuh``) with
  its pair decoder (``csrc/lut_gemm_pair_decoder.cuh``), which K1
  (``csrc/lut_gemm_w4sym.cu``) and K2 (``csrc/lut_gemm_plane.cu``) run in
  bf16 and f16 where ``mma_takes_chunk`` holds, and K4
  (``csrc/lut_gemm_pair.cu``) always, or with K3's decoder of the wide
  3-bit triples (``csrc/lut_gemm_w3wide.cu``, bf16 and f16): m16 tiles per
  warp and the split of K, the split a function of N, K and chunk alone.
* ``mma_route`` and ``wide_plan`` send K1-K4 at prefill M (from
  :data:`WIDE_MIN_M` rows) to the wide-M kernel on warpgroup MMA
  (``csrc/lut_gemm_wide_m.cuh``), which sums in the loop's order within
  ``mma_plan``'s split, so a row has the same bits on either route;
  ``mma_route`` and ``mid_plan`` send K1-K4 from :data:`MID_MIN_M` rows
  below that to the same kernel's mid route (row tiles of
  :data:`MID_ROWS`, one of ``mma_plan``'s splits a block, its workspace),
  with the same bits again.
* ``LaunchConfig`` is the SIMT skeleton's (``csrc/lut_gemm_common.cuh``):
  K1, K2 and K3 in f32 or at a chunk the loop does not take.
"""

from __future__ import annotations

import dataclasses
import re
from typing import ClassVar, Iterator

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
    # the Hopper launch a tuner chose (0: the planner's); not in the key
    m_tiles: int = 0
    simt_block_m: int = 0

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
    """Launch shape of the SIMT LUT-GEMM kernels: K1, K2 and K3 off the
    tensor-core loop (f32, or a chunk the loop does not take).

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


# The tensor-core loop (csrc/lut_gemm_mma.cuh; K1, K2 and K3 in bf16/f16, K4):
# 128 columns per block, m16 tiles per warp instantiated for these counts.
MMA_BLOCK_N = 128
MMA_M_TILES = (1, 2, 4)
# Blocks a decode launch (one m16 row of blocks) should have: two per SM of
# the H100's 132. At decode four blocks fit an SM, so up to 528 run in one
# wave.
MMA_TARGET_BLOCKS = 2 * 132
# Shared memory a block may use on the H100 (227 KB) and an SM's (228 KB,
# of which the runtime keeps 1 KB a block), and the largest pair table a
# block keeps beside its x ring (256 entries x 8 copies x 4 bytes)
MAX_SMEM_BYTES = 232448
SM_SMEM_BYTES = 233472
MMA_TABLE_BYTES = 8192


def mma_smem_bytes(m_tiles: int, chunk: int) -> int:
    """The loop's dynamic shared memory: a two-stage ring of ``16 * m_tiles``
    16-bit x rows of one chunk, each padded by 8 halves
    (``csrc/lut_gemm_mma.cuh::mma_smem_bytes``)."""
    return 2 * 16 * m_tiles * (chunk + 8) * 2


def mma_word_rows(num_bits: int, chunk: int, layout: str = "plane") -> int:
    """The loop's word rows per pack chunk (``kc``, each decoder's
    ``word_rows``): first-plane word rows for the pair-plane layouts (4-bit
    sub-codes at 4 bits, 2-bit at 2 and 3; K1's w4sym plane is a 4-bit
    one), word triples (``chunk / 32``) for ``"w3wide"``."""
    if layout == "w3wide":
        return chunk // 32
    pb0 = 4 if num_bits == 4 else 2
    return chunk * pb0 // 32


def mma_fields(num_bits: int, layout: str = "plane") -> int:
    """Pair fields per word row of the loop's decoder (``kFields``): 16
    six-bit fields per triple for ``"w3wide"``, else ``32 / (2 pb0)``."""
    if layout == "w3wide":
        return 16
    return 32 // (2 * (4 if num_bits == 4 else 2))


def mma_takes_chunk(num_bits: int, chunk: int, layout: str = "plane") -> bool:
    """Whether the tensor-core loop takes a pack chunk: the decoder needs a
    multiple of 4 word rows per chunk (a multiple of 32 K rows at 4 bits, of
    64 at 2 and 3; the wide 3-bit layout's chunks, multiples of 256, always
    have one), and a chunk's x ring at the most m16 tiles, with the pair
    table, must fit a block's shared memory (up to 864 K rows). Depends on
    neither M nor the dtype, so a layer takes one path at every batch
    size."""
    fits = mma_smem_bytes(max(MMA_M_TILES), chunk) + MMA_TABLE_BYTES <= MAX_SMEM_BYTES
    if layout == "w3wide" and chunk % 256:
        return False
    return mma_word_rows(num_bits, chunk, layout) % 4 == 0 and fits


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


def mma_plan(m: int, n: int, k: int, chunk: int, m_tiles: int = 0) -> MmaPlan:
    """The m16 tiles per warp (``m_tiles`` where a tuner chose them, else
    the fewest that cover M, at most 4) and the split of K's chunks: the
    smallest that gives one m16 row of blocks (a decode launch)
    :data:`MMA_TARGET_BLOCKS` blocks, every chunk its own split if none
    does.

    The split is a function of N, K and chunk alone, never of M: a row's f32
    partial sums then run in the same order, and are added in the same
    split order, in a batch of any size, so its result has the same bits at
    M = 1 and M = 512 (``PagedEngine``'s prefill of one prompt equals
    ``Engine``'s of eight). At large M this costs an f32 workspace of
    ``splits * M * N`` written and read once more than one pass would."""
    m_tiles = m_tiles or next((mt for mt in MMA_M_TILES if m <= 16 * mt), MMA_M_TILES[-1])
    cols = -(-n // MMA_BLOCK_N)
    rows = max(1, -(-m // (16 * m_tiles)))
    nchunks = k // chunk
    divisors = [s for s in range(1, nchunks + 1) if nchunks % s == 0]
    splits = next((s for s in divisors if cols * s >= MMA_TARGET_BLOCKS), nchunks)
    return MmaPlan(m_tiles=m_tiles, splits=splits, grid=(cols, splits, rows))


# The wide-M kernel (csrc/lut_gemm_wide_m.cuh; K1-K4 in bf16/f16): a block
# of 128 rows of x by 128 columns, two warpgroups of 64 columns.
WIDE_ROWS = 128
WIDE_BLOCK_N = 128
# the layouts it decodes: K1's, K2's and K4's pair planes and K3's triples
WIDE_LAYOUTS = ("w4sym", "plane", "pair", "w3wide")


def wide_ring(num_bits: int, chunk: int, group_size: int, layout: str = "plane",
              rows: int = WIDE_ROWS, blocks: int = 1) -> tuple[int, int, int]:
    """The wide-M kernel's ring (``csrc/lut_gemm_wide_m.cuh::Geometry``):
    ``(q, stage_bytes, stages)``. A stage is ``q`` items of a chunk (4, 2 or
    1 dividing kc / 4: the most that leave room for three stages): their x
    stretches for every field (16 bytes a row, ``rows`` rows: 128, or the
    mid route's row tile), their 4q word rows of each planar word (three
    for K3's triples) and at 3 bits the chunk's 1-bit plane rows (136 words
    a row), then, from a 128-byte boundary, the chunk's scale rows (128
    16-bit values each), rounded up to 128 bytes. ``stages`` fit beside the
    decoder's table (the pair tables ``(2^b)^2 x 8`` words, K4's joint one
    as K2's; K3's 64 x 8) and the mbarriers in an SM's shared memory shared
    by ``blocks`` blocks (1 for the wide route, :func:`mid_blocks` for the
    mid route), at most 4; 0 where two do not, or where a stage's units do
    not pair up (the kernel decodes a unit of at most 4 k16 steps while the
    one before multiplies, in pairs: an item at 4 and 8 fields, half an
    item at K3's 16)."""
    kc0 = mma_word_rows(num_bits, chunk, layout)
    fields = mma_fields(num_bits, layout)
    w3 = layout == "w3wide"
    row_words = 3 if w3 else 1
    kc1 = chunk // 32 if num_bits == 3 and not w3 else 0
    units = fields // 8 if fields > 8 else 1
    srows = -(-chunk // group_size) + 1
    table = 64 * 8 * 4 if w3 else (2**num_bits) ** 2 * 8 * 4
    budget = SM_SMEM_BYTES // blocks - 1024 - table - 64

    def stage_bytes(q):
        words = (row_words * 4 * q + kc1) * (WIDE_BLOCK_N + 8) * 4
        s_off = -(-(fields * q * rows * 16 + words) // 128) * 128
        return -(-(s_off + srows * WIDE_BLOCK_N * 2) // 128) * 128

    q = 4
    while q > 1 and not ((kc0 // 4) % q == 0 and budget // stage_bytes(q) >= 3):
        q //= 2
    n = budget // stage_bytes(q)
    return q, stage_bytes(q), 0 if n < 2 or (q * units) % 2 else min(n, 4)


def wide_takes_chunk(num_bits: int, chunk: int, group_size: int = 64,
                     layout: str = "plane") -> bool:
    """Whether the wide-M kernel takes a layer's pack chunk and group size:
    the loop takes the chunk (:func:`mma_takes_chunk`), two stages of the
    kernel's ring fit shared memory and a stage's units pair up (all but a
    very small group size at a long chunk, or for the pair planes a chunk
    under 64 K rows at 4 bits, 128 at 2 and 3). Depends on neither M nor
    the dtype."""
    return (mma_takes_chunk(num_bits, chunk, layout)
            and wide_ring(num_bits, chunk, group_size, layout)[2] >= 2)


# The wide-M kernel's mid route (csrc/lut_gemm_wide_m.cuh with a row tile
# under 128 and one split of K a block): the row tiles it is built for
# (wgmma's N), the blocks an SM its registers and ring are sized for (but
# K3's with the per-field scale cache: :func:`mid_blocks`), and the layouts
# it decodes (all four).
MID_ROWS = (16, 32, 48, 64)
MID_BLOCKS = 2
MID_LAYOUTS = ("w4sym", "plane", "pair", "w3wide")
# The least M of the mid route and of the wide-M kernel, the loop below
# both: the crossovers of phase 2's sweep in chip_smoke.py (one
# Llama-3.1-8B layer in bf16, M in 8..2047), the same for every layout (K1
# and K2 W4 from 8 rows, K3 and K4 W4 from 16, to 256; K2 W2, K4 W3 and W2
# to 64 or 128).
# The loop wins at one m16 tile a warp (M <= 16), the mid route from 32 to
# 192 rows, the wide-M kernel at 256: from 193 rows the mid route needs
# four tiles of 64 rows, as at 256, and the wide-M kernel two of 128.
MID_MIN_M = 17
WIDE_MIN_M = 193


def mid_blocks(num_bits: int, chunk: int, group_size: int = 64, layout: str = "plane") -> int:
    """Blocks an SM the mid route's instantiation for a layer is built for
    (its decoder's ``kMidBlocks``): :data:`MID_BLOCKS`, a cap of 128
    registers a thread, but 1 for K3 with the per-field scale cache (a
    group size that is not a multiple of 2 kc), whose 48 scale registers
    take a thread past that cap (140-168 registers on the card)."""
    if layout == "w3wide" and group_size % (2 * mma_word_rows(num_bits, chunk, layout)):
        return 1
    return MID_BLOCKS


def mid_rows(m: int) -> int:
    """The mid route's row tile for M rows: the fewest tiles of at most 64
    rows (the decode is paid once a tile), each the smallest of
    :data:`MID_ROWS` that covers M in that many (40 rows: 48; 96: two of
    48; 100: two of 64)."""
    tiles = -(-max(m, 1) // MID_ROWS[-1])
    return next(r for r in MID_ROWS if tiles * r >= m)


def mid_takes_chunk(num_bits: int, chunk: int, group_size: int = 64,
                    layout: str = "plane") -> bool:
    """Whether the mid route takes a layer's pack chunk and group size: a
    layout it decodes (K1-K4), a chunk the loop takes, and two stages of
    the ring at its largest row tile fitting :func:`mid_blocks` blocks an
    SM, a stage's units pairing up. Depends on neither M nor the dtype."""
    return (layout in MID_LAYOUTS and mma_takes_chunk(num_bits, chunk, layout)
            and wide_ring(num_bits, chunk, group_size, layout, MID_ROWS[-1],
                          mid_blocks(num_bits, chunk, group_size, layout))[2] >= 2)


def mma_route(m: int, num_bits: int, chunk: int, layout: str = "plane",
              group_size: int = 64) -> str:
    """Where a call on the tensor cores (:func:`launch_path` ``"mma"``)
    runs: ``"wide"``, the wide-M kernel, for every layout (K1-K4) from
    :data:`WIDE_MIN_M` rows at a chunk and group size it takes; ``"mid"``,
    its mid route, from :data:`MID_MIN_M` rows below ``WIDE_MIN_M`` at a
    chunk and group size that takes (:func:`mid_takes_chunk`); ``"loop"``,
    the decode loop, otherwise. For a layer, a function of M alone; every
    route gives a row the same bits."""
    if (layout in WIDE_LAYOUTS and m >= WIDE_MIN_M
            and wide_takes_chunk(num_bits, chunk, group_size, layout)):
        return "wide"
    if MID_MIN_M <= m < WIDE_MIN_M and mid_takes_chunk(num_bits, chunk, group_size, layout):
        return "mid"
    return "loop"


@dataclasses.dataclass(frozen=True)
class WidePlan:
    """Launch of the wide-M kernel for one (M, N, K, chunk): ``splits``
    is :func:`mma_plan`'s split of the K chunks, which each block runs in
    order (no workspace); the grid is ``(M / 128, N / 128)``."""

    splits: int
    grid: tuple[int, int]

    def workspace_shape(self, m: int, n: int) -> None:
        return None


def wide_plan(m: int, n: int, k: int, chunk: int) -> WidePlan:
    """The wide-M kernel's launch: the decode loop's split (a function of
    N, K and chunk alone, so both routes sum a row in one order) and one
    block a 128 x 128 tile of the output."""
    return WidePlan(splits=mma_plan(1, n, k, chunk).splits,
                    grid=(-(-m // WIDE_ROWS), -(-n // WIDE_BLOCK_N)))


@dataclasses.dataclass(frozen=True)
class MidPlan:
    """Launch of the wide-M kernel's mid route for one (M, N, K, chunk):
    ``rows`` rows a block (:func:`mid_rows`), ``splits`` :func:`mma_plan`'s
    split of the K chunks, one a block (blockIdx.z); above one split an f32
    workspace ``[splits, M, N]`` that the loop's reduction adds in split
    order. The grid is ``(M / rows, N / 128, splits)``."""

    rows: int
    splits: int
    grid: tuple[int, int, int]

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    def workspace_shape(self, m: int, n: int) -> tuple[int, int, int] | None:
        return (self.splits, m, n) if self.splits > 1 else None


def mid_plan(m: int, n: int, k: int, chunk: int) -> MidPlan:
    """The mid route's launch: the decode loop's split (so every route sums
    a row in one order), a block a ``mid_rows(M)`` x 128 tile of one
    split's partial sums."""
    rows = mid_rows(m)
    splits = mma_plan(1, n, k, chunk).splits
    return MidPlan(rows=rows, splits=splits,
                   grid=(-(-m // rows), -(-n // WIDE_BLOCK_N), splits))


# ---------------------------------------------------------------------------
# The JAX package's config functions, for the Hopper launch
# ---------------------------------------------------------------------------

# the kernels' layouts: the pair-plane layout (K2), the wide 3-bit layout
# (K3), w4sym (K1) and the joint pair lookup on pair planes (K4)
KERNEL_LAYOUTS = ("plane", "w3wide", "w4sym", "pair")
GRID_LIMIT = 65535  # blocks along the grid's M dimension


def kernel_layout(num_bits: int, layout: str = "auto") -> str:
    """The kernel layout a call names: ``"auto"`` is what the quantizers
    pack, the wide layout at 3 bits and the pair-plane layout else."""
    if layout == "auto":
        return "w3wide" if num_bits == 3 else "plane"
    if layout not in KERNEL_LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    return layout


def dtype_name(dtype) -> str:
    """``"bfloat16"``, ``"float16"`` or ``"float32"`` for a torch dtype or
    its name; None is bfloat16."""
    if dtype is None:
        return "bfloat16"
    return str(dtype).rsplit(".", 1)[-1]


def launch_path(dtype, num_bits: int, chunk: int, layout: str = "auto") -> str:
    """``"mma"`` where the call runs on the tensor cores (K4 always; K1, K2
    and K3 in bf16 and f16 at a chunk the loop takes), on the route that
    :func:`mma_route` gives its M; ``"simt"`` where it runs the SIMT
    kernel."""
    layout = kernel_layout(num_bits, layout)
    if layout == "pair":
        return "mma"
    if dtype_name(dtype) in ("bfloat16", "float16") and mma_takes_chunk(num_bits, chunk, layout):
        return "mma"
    return "simt"


def _layout_takes(num_bits: int, chunk: int, layout: str) -> bool:
    if layout == "w4sym":
        return num_bits == 4 and chunk % 8 == 0
    if layout == "w3wide":
        return num_bits == 3 and chunk % 256 == 0
    from flute_tpu_torch.packing import PackFormat  # packing imports this module

    try:
        PackFormat(num_bits=num_bits, chunk=chunk)
    except ValueError:
        return False
    return True


def is_config_supported(
    config: KernelConfig,
    m: int,
    n: int,
    k: int,
    num_bits: int,
    group_size: int,
    dtype=None,
    layout: str = "auto",
) -> bool:
    """Whether the kernel of ``layout`` takes ``config`` for a (M, N, K)
    call: the chunk divides K and suits the layout, the group size is even
    and divides K, a tuned ``m_tiles`` is one the loop is built for and the
    call runs the loop, a tuned ``simt_block_m`` likewise for the SIMT
    kernel, and the grid's M dimension fits. (The TPU block fields are not
    read.)"""
    del n
    layout = kernel_layout(num_bits, layout)
    chunk = config.chunk
    if chunk <= 0 or k % chunk or group_size % 2 or k % group_size:
        return False
    if not _layout_takes(num_bits, chunk, layout):
        return False
    if layout == "pair" and (dtype_name(dtype) == "float32"
                             or not mma_takes_chunk(num_bits, chunk)):
        return False
    path = launch_path(dtype, num_bits, chunk, layout)
    if config.m_tiles and (path != "mma" or config.m_tiles not in MMA_M_TILES):
        return False
    if config.simt_block_m and (path != "simt" or config.simt_block_m not in BLOCK_M_CHOICES):
        return False
    m = max(m, 1)
    if path == "mma":
        rows = -(-m // (16 * mma_plan(m, 1, k, chunk, config.m_tiles).m_tiles))
    else:
        rows = -(-m // (config.simt_block_m or launch_config(m).block_m))
    return rows <= GRID_LIMIT


def get_candidate_configs(
    m: int,
    n: int,
    k: int,
    num_bits: int,
    group_size: int,
    dtype=None,
    layout: str = "auto",
    chunk: int = DEFAULT_CHUNK,
) -> Iterator[KernelConfig]:
    """The tuner's search space for a call: each m16 tile count the loop is
    built for (the call runs the loop) or each SIMT ``block_m`` (it runs
    the SIMT kernel), the planner's own choice first. No candidate changes
    the split of K, so every candidate gives each row the same bits."""
    path = launch_path(dtype, num_bits, chunk, layout)
    if path == "mma":
        default = mma_plan(m, n, k, chunk).m_tiles
        choices = (default, *(mt for mt in MMA_M_TILES if mt != default))
        cands = [KernelConfig(chunk=chunk, m_tiles=mt) for mt in choices]
    else:
        default = launch_config(m).block_m
        choices = (default, *(bm for bm in BLOCK_M_CHOICES if bm != default))
        cands = [KernelConfig(chunk=chunk, simt_block_m=bm) for bm in choices]
    for cfg in cands:
        if is_config_supported(cfg, m, n, k, num_bits, group_size, dtype, layout):
            yield cfg


def fit_config(
    config: KernelConfig,
    m: int,
    n: int,
    k: int,
    num_bits: int,
    group_size: int,
) -> KernelConfig:
    """``config`` for an actual (possibly sharded) problem shape: the chunk
    must divide K (it is part of the packed layout, so it cannot be
    changed); a tuned launch whose grid would not fit M falls back to the
    planner's."""
    if k % config.chunk or k % group_size:
        raise ValueError(
            f"K={k} incompatible with chunk={config.chunk} group={group_size} bits={num_bits}"
        )
    m = max(m, 1)
    fitted = config
    if config.m_tiles and -(-m // (16 * config.m_tiles)) > GRID_LIMIT:
        fitted = dataclasses.replace(fitted, m_tiles=0)
    if config.simt_block_m and -(-m // config.simt_block_m) > GRID_LIMIT:
        fitted = dataclasses.replace(fitted, simt_block_m=0)
    return fitted


def get_kernel_config(
    m: int,
    n: int,
    k: int,
    num_bits: int,
    group_size: int,
    dtype=None,
    layout: str = "auto",
) -> KernelConfig:
    """The config of a call: the tuner's registry entry for the shape on
    this card where there is one the kernel takes, else the planner's
    launch (``KernelConfig()``). No registry ships with the port, so
    JAX's ``FLUTE_TPU_NO_TUNED_REGISTRY`` has no counterpart."""
    from flute_tpu_torch import tune

    hit = tune.lookup_packaged(m, n, k, num_bits, group_size, dtype, layout=layout)
    if hit is not None and is_config_supported(hit, m, n, k, num_bits, group_size, dtype, layout):
        return hit
    return KernelConfig()
