// The LUT-GEMM at prefill M on warpgroup MMA (wgmma), for Hopper (sm_90a):
// every LUT-GEMM layout in bf16 and f16 where
// ops/kernel_config.py::mma_route sends a call's M (from WIDE_MIN_M rows):
// K1 (lut_gemm_w4sym.cu), K2 (lut_gemm_plane.cu) and K4 (lut_gemm_pair.cu)
// with the pair decoder of lut_gemm_pair_decoder.cuh, K3
// (lut_gemm_w3wide.cu) with its decoder of the wide 3-bit triples; from
// MID_MIN_M rows below that they take this kernel's mid route (below), and
// under MID_MIN_M the decode loop of lut_gemm_mma.cuh.
//
//   y[M, N] = x[M, K] @ W,  W decoded per K-row pair and column
//
// Replaces: flute_tpu/ops/lut_gemm.py:454 _lut_qgemm_kernel in its
// weight-side branch (:611-615, w = deq * s_exp, then one MXU dot per
// (bm, bk) block), which the TPU kernel takes above group_acc_max_bm
// (:812), with its payload helpers: the w4sym and plane lookups, the joint
// pair table (_lookup_payload_lane :279, :533-538, _table_tile_pair :680)
// and the wide 3-bit unpack (_unpack_wide3_payload :342, :494-506). It
// computes what that branch computes, each weight scaled before its
// product, and sums every output in the decode loop's order, so a row has
// the loop's bits at every M.
//
// What bounds it: operations. One Llama-3.1-8B layer at M = 2047 does
// 2 M N K = 893 GFLOP over ~0.13 GB of planes, scales and x, far above the
// card's ~295 operations a byte. The decode loop ran it at 8.6% of that
// bound: it decoded the weights once per 64 rows, wrote split-K partials of
// splits x M x N f32 and read them back, and fed the tensor cores through
// mma.sync. Here:
//
// * Large tiles, one decode per tile: a block holds 128 rows of x and 128
//   columns of W (two warpgroups of 64 columns), so each weight is decoded
//   once per 128 rows, into registers.
// * wgmma with the weights as A from registers: yT = W xT, the columns are
//   wgmma's M (64 a warpgroup) and the 128 rows of x its N. A decoded pair
//   for (column n, K rows 2p, 2p+1) has the per-lane place of an A register
//   of row n (lane l: rows l/4 and l/4 + 8, k-slots 2(l%4)+{0,1} and +8),
//   so the decoder's output, times its scale in one packed multiply
//   (Pack2<T>::mul, the loop's rounding), feeds the tensor core with no
//   shared-memory round trip. x is B, from shared memory. Both operand
//   orientations give mma.sync's bits on the card (wgmma_probe_kernel
//   below); this one measured faster than a warp-specialized kernel with
//   the weights decoded into shared memory as B.
// * A unit (at most 4 k16 steps: a whole item of 4 word rows at 4 and 8
//   fields, half an item at K3's 16) is decoded into one of two sets of A
//   registers while the unit before it multiplies; a set is rewritten only
//   after the wait that retires its products. Two item-wide sets at 16
//   fields would take 64 registers beside the 128 of the accumulator and
//   the split total: half items keep K3 at 32.
// * The loop's k16 steps in its order. Step (q, s) of a chunk takes field
//   2s of word rows 4q..4q+3 as k-slots 0..7 and field 2s+1 as 8..15
//   (lut_gemm_mma.cuh); those are two 8-row stretches of x, 2 kc K rows
//   apart. x is staged in the no-swizzle K-major layout of 8-row stretches
//   ([field][item][row][8 halves], a core matrix = 8 rows x 16 bytes), so
//   a step's second stretch lies a constant distance after its first: the
//   descriptor's leading-byte offset absorbs the permutation.
// * Scales: where a decoder's kChunkScales says a field's K rows lie in one
//   group for the whole chunk (K3 with g a multiple of 2 kc), a lane takes
//   its 16 fields' scales from the staged scale rows once per chunk, both
//   columns' in one register; else it keeps each field's group and scales
//   and reloads them when the group changes.
// * No workspace. The split of K stays mma_plan's. A block runs its splits
//   one after another: one f32 accumulator for the split it is in, started
//   at 0, added at the split's end to a running total started at 0, in
//   split order (split_reduce_kernel's sum); with one split the accumulator
//   is the result. Rounded once to T. With M/128 x N/128 blocks (768 for
//   Llama's qkv at M = 2047) the card is full without split-K blocks.
// * Staging by TMA into a ring of up to 4 stages (Geometry): x (a box a
//   field's stretches of a stage), the stage's plane word rows (K3: three
//   boxes, one a planar word of its triples) and the chunk's scale rows
//   (128 columns each), all counted on the stage's mbarrier; shapes TMA
//   cannot take (N not a multiple of 8, unaligned operands) stage words and
//   scales by cp.async.
//
// A block: 256 threads, 128 columns x 128 rows; grid (M / 128, N / 128),
// the row tiles of one column tile adjacent, so its plane words are read
// from device memory about once. Ragged M and N are masked (TMA reads past
// an edge as zeros). f32 accumulators, no atomics, no TF32, no fast math.
//
// The mid route (template arguments R < 128 and kOneSplit; K1-K4 from
// MID_MIN_M to WIDE_MIN_M rows, the speculative verify's 40 rows and the
// paged engines' admissions of 17-64 rows among them).
// Replaces the same TPU kernel in its group-accumulating decode branch
// (:590-602, taken at :812 for bm <= group_acc_max_bm = 64,
// flute_tpu/ops/kernel_config.py:32), whose function the loop computes;
// it gives each row the loop's bits. At 16-64 rows a layer moves about
// the bytes of a decode step (one Llama-3.1-8B layer at W4 g64: 109 MB of
// planes and 6.8 MB of scales, ~36 us at 3.35 TB/s, against ~18 us of
// operations at M = 40), so it is bound by bytes, and the card must be
// filled the way the loop fills it at decode. The loop itself ran 17-64
// rows at 4 m16 tiles a warp, 4x its mma.sync and ldmatrix per decoded B
// register, 2 blocks an SM and rows padded to 64; the wide route's grid
// of M/128 x N/128 blocks leaves most of the 132 SMs idle there, and up to
// 192 rows (three tiles of 64) this route stays faster than its two tiles
// of 128 (phase 2's sweep in chip_smoke.py). Here:
//
// * A row tile of R (16, 32, 48 or 64) rows: wgmma m64nRk16, R / 2 f32
//   accumulators a thread and no split total, registers and a ring sized
//   for the decoder's kMidBlocks blocks an SM (2, a cap of 128 registers;
//   K3 with its per-field scale cache 1, whose 48 scale registers do not
//   fit that cap beside the accumulators and two A-register sets); 40 rows
//   take R = 48, not 64 or 128.
// * The loop's split-K grid: blockIdx.z runs one split of mma_plan's
//   chunks and writes its f32 sums to the workspace [splits, M, N], which
//   split_reduce_kernel adds in split order (with one split, the block
//   writes y). Partials of one split are summed in the loop's k16 order,
//   so every row has the loop's bits at every M.
//
// A Decoder for this kernel provides, beside the loop's (lut_gemm_mma.cuh)
// kFields, kChunkScales, word_rows, Table, Words and pair():
//   kRowWords   planar words a word row (1; K3's triples 3): Words w0.. of
//               columns col and col + 8 in .x and .y
//   kPlane1     whether the layout has a 1-bit plane (Words w1)
//   kMidBlocks  blocks an SM the mid route's registers and ring are sized for

#pragma once

#include <cuda.h>

#include "lut_gemm_pair_decoder.cuh"

namespace flute {
namespace wide {

using mma::Args;
using mma::Pack2;
using mma::smem_u32;

constexpr int kThreads = 256;    // two warpgroups
constexpr int kGroupCols = 64;   // W columns a warpgroup: wgmma's M
constexpr int kBlockN = 128;     // W columns a block
constexpr int kRows = 128;       // rows of x a block: wgmma's N (the mid route: R)
constexpr int kPlaneStride = kBlockN + 8;  // words a staged plane row: rows 8 banks apart

// A shared-memory matrix descriptor, no swizzle: start, leading-byte offset
// (between the two core matrices along K), stride-byte offset (between core
// matrices along M or N), all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// this thread's generic-proxy writes to shared memory (stores, cp.async)
// made visible to the async proxy, which wgmma reads through
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving accesses of an accumulator across a
// wgmma's issue and its wait
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r)::"memory"); }
// threadIdx.x, read where it is used: what is computed from it is not
// hoisted out of a loop and held across it
__device__ __forceinline__ int thread_index() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

#define FLUTE_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define FLUTE_D8(i) FLUTE_D4(i), FLUTE_D4(i + 4)
#define FLUTE_D16(i) FLUTE_D8(i), FLUTE_D8(i + 8)
#define FLUTE_D32(i) FLUTE_D16(i), FLUTE_D16(i + 16)
#define FLUTE_D64 FLUTE_D32(0), FLUTE_D32(32)
#define FLUTE_L8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define FLUTE_L16 FLUTE_L8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define FLUTE_L24 FLUTE_L16 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define FLUTE_L32 FLUTE_L24 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define FLUTE_L64                                                                           \
  FLUTE_L32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "  \
            "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define FLUTE_R64 "{" FLUTE_L64 "}, "
// one wgmma of shape m64n<N>k16, A from registers: LIST the accumulators'
// operands, TAIL A's four registers and B's descriptor, PRED scale-d's
// operand, then the accumulators' constraints
#define FLUTE_WGMMA_RS(N, LIST, TAIL, PRED, ...)                                              \
  do {                                                                                       \
    if constexpr (std::is_same_v<T, __half>)                                                 \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " PRED ", 0;\n"                         \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.f16.f16 {" LIST "}, " TAIL  \
                   ", p, 1, 1, 0;\n}\n"                                                       \
                   : __VA_ARGS__                                                             \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d)); \
    else                                                                                     \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " PRED ", 0;\n"                         \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" LIST "}, "     \
                   TAIL ", p, 1, 1, 0;\n}\n"                                                  \
                   : __VA_ARGS__                                                             \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d)); \
  } while (0)

// d[64 x N] (+)= a (64 x 16, registers) * b (16 x N, K-major in shared
// memory), N the row tile (16, 32, 48, 64 or 128); d[4j + r] is row
// 16 warp + l/4 + 8 (r >> 1), column 8j + 2(l%4) + (r & 1)
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  static_assert(N == 16 || N == 32 || N == 48 || N == 64 || N == 128, "no such row tile");
  if constexpr (N == 16)
    FLUTE_WGMMA_RS(16, FLUTE_L8, "{%8, %9, %10, %11}, %12", "%13", FLUTE_D8(0));
  else if constexpr (N == 32)
    FLUTE_WGMMA_RS(32, FLUTE_L16, "{%16, %17, %18, %19}, %20", "%21", FLUTE_D16(0));
  else if constexpr (N == 48)
    FLUTE_WGMMA_RS(48, FLUTE_L24, "{%24, %25, %26, %27}, %28", "%29", FLUTE_D16(0),
                   FLUTE_D8(16));
  else if constexpr (N == 64)
    FLUTE_WGMMA_RS(64, FLUTE_L32, "{%32, %33, %34, %35}, %36", "%37", FLUTE_D32(0));
  else
    FLUTE_WGMMA_RS(128, FLUTE_L64, "{%64, %65, %66, %67}, %68", "%69", FLUTE_D64);
}

// d (+)= a (64 x 16) * b (16 x 128), both K-major in shared memory
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  if constexpr (std::is_same_v<T, __half>) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " FLUTE_R64
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : FLUTE_D64
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FLUTE_R64
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : FLUTE_D64
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
}

#undef FLUTE_D4
#undef FLUTE_D8
#undef FLUTE_D16
#undef FLUTE_D32
#undef FLUTE_D64
#undef FLUTE_L8
#undef FLUTE_L16
#undef FLUTE_L24
#undef FLUTE_L32
#undef FLUTE_L64
#undef FLUTE_R64
#undef FLUTE_WGMMA_RS

// 4 bytes global -> shared, or 4 zero bytes when !pred
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 4 : 0));
}
template <int N>
__device__ __forceinline__ void cp_async_wait_n(int n) {  // n <= N groups left in flight
  if constexpr (N > 0) {
    if (n >= N) {
      mma::cp_async_wait<N>();
      return;
    }
    cp_async_wait_n<N - 1>(n);
  } else {
    mma::cp_async_wait<0>();
  }
}

// mbarrier and TMA (cp.async.bulk.tensor) in PTX
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Waits for the phase of `parity` to complete, the thread suspended in
// try_wait (up to 10 ms a try). (A trap on a long wait here would make
// ptxas serialize every wgmma of the kernel: a wait in a divergent path.)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity), "r"(0x989680)
        : "memory");
  } while (!done);
}
// box {8 columns, 128 rows, Q stretches} of the 3-D map at (0, row m,
// stretch v) into shared memory, its bytes counted on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int m, int v,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(m), "r"(v), "r"(smem_u32(bar))
      : "memory");
}
// box {8 columns, 128 rows} of the 2-D map at (column k, row m) into shared
// memory, its bytes counted on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int k, int m,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(m), "r"(smem_u32(bar))
      : "memory");
}

// The ring's geometry, the same on the host and the card. A stage is Q
// items (word-row quads) of one chunk: the x stretches of those items for
// every field ([field][Q][rows][16 bytes]: step (q, s) reads field 2s
// at (2s Q + q) stretches and field 2s+1 Q stretches later, the
// descriptor's leading-byte offset), their 4Q word rows of each planar
// word (K3: [word][4Q rows]), the chunk's 1-bit plane rows (3 bits) and the
// chunk's scale rows, 128 columns each.
struct Geometry {
  int kc0, kc1, fields, row_words, units, rows, q, per_chunk, srows;
  size_t x_bytes, p0_bytes, p1_bytes, s_off, stage_bytes;

  // kc: word rows a chunk; nfields: fields a word row; rwords: planar words
  // a word row; nrows: rows of x a block. Q: the most items (4, 2 or 1,
  // dividing kc / 4) that leave room for three stages in `budget` bytes,
  // else 1
  __host__ __device__ Geometry(int chunk, int kc, int nfields, int rwords, bool plane1,
                               int group_size, int nrows, size_t budget) {
    kc0 = kc;
    rows = nrows;
    kc1 = plane1 ? chunk / 32 : 0;
    fields = nfields;
    row_words = rwords;
    units = fields > 8 ? fields / 8 : 1;  // A-register units an item (of at most 4 steps)
    srows = (chunk + group_size - 1) / group_size + 1;  // groups a chunk can meet
    for (q = 4; q > 1; q /= 2) {
      set(q);
      if ((kc0 / 4) % q == 0 && budget / stage_bytes >= 3) break;
    }
    set(q);
  }
  __host__ __device__ void set(int items) {
    q = items;
    per_chunk = kc0 / (4 * q);
    x_bytes = static_cast<size_t>(fields) * q * stretch();
    p0_bytes = static_cast<size_t>(row_words * 4 * q) * kPlaneStride * 4;
    p1_bytes = static_cast<size_t>(kc1) * kPlaneStride * 4;
    s_off = (x_bytes + p0_bytes + p1_bytes + 127) / 128 * 128;  // TMA wants 128-byte boxes
    stage_bytes = (s_off + static_cast<size_t>(srows) * kBlockN * 2 + 127) / 128 * 128;
  }
  // one 8-row K stretch of the block's x
  __host__ __device__ int stretch() const { return rows * 16; }
  // stages in `budget` bytes of shared memory, at most 4 (0: the ring needs
  // two and they do not fit, or a stage's units do not pair up)
  __host__ __device__ int stages(size_t budget) const {
    const size_t n = budget / stage_bytes;
    return n < 2 || (q * units) % 2 ? 0 : n > 4 ? 4 : static_cast<int>(n);
  }
};

// The kernel's dynamic shared memory budget beside Decoder's table when
// `blocks` blocks share an SM (the H100's 228 KB, of which the runtime keeps
// 1 KB a block: 227 KB for one).
template <typename Decoder>
__host__ __device__ constexpr size_t smem_budget(int blocks = 1) {
  return 233472 / blocks - 1024 - sizeof(typename Decoder::Table) - 64;  // and the mbarriers
}

// The tensor maps of a launch: x always; the planes and the scales where
// `words` (N a multiple of 8, 16-byte aligned, the chunk's scale rows in one
// box), else those are staged by cp.async.
struct Maps {
  CUtensorMap x, plane0, plane1, scales;
  int words;
};

// The words of staged word row jr (of a stage of Q items, pstride words a
// staged row) for columns col and col + 8, in .x and .y: the first plane's
// row (K3: its triple row's three planar words, 4Q rows apart) and at 3
// bits the 1-bit plane's row j % kc1.
template <typename Decoder>
__device__ __forceinline__ typename Decoder::Words staged_words(const uint32_t* p0,
                                                                const uint32_t* p1, int jr, int j,
                                                                int kc1, int Q, int pstride,
                                                                int col) {
  typename Decoder::Words w;
  w.w0 = make_uint4(p0[jr * pstride + col], p0[jr * pstride + col + 8], 0u, 0u);
  if constexpr (Decoder::kRowWords == 3) {
    const int r1 = (4 * Q + jr) * pstride + col, r2 = (8 * Q + jr) * pstride + col;
    w.w1 = make_uint4(p0[r1], p0[r1 + 8], 0u, 0u);
    w.w2 = make_uint4(p0[r2], p0[r2 + 8], 0u, 0u);
  } else if constexpr (Decoder::kPlane1) {
    const int r1 = (j % kc1) * pstride + col;
    w.w1 = make_uint4(p1[r1], p1[r1 + 8], 0u, 0u);
  } else {
    w.w1 = make_uint4(0u, 0u, 0u, 0u);
  }
  return w;
}

// A field's scale of column col (e 0) or col + 8 (e 1), in both halves:
// from the chunk's scales `cs` (kChunk: col's in the low half, col + 8's in
// the high) or from the per-field cache `sv`.
template <bool kChunk>
__device__ __forceinline__ uint32_t field_scale(uint32_t cs, const uint32_t (&sv)[2], int e) {
  if constexpr (kChunk)
    return __byte_perm(cs, 0u, e ? 0x3232u : 0x1010u);
  else
    return sv[e];
}

// The ring's geometry of Decoder's layout at a launch's chunk and group size,
// for R rows a block with `blocks` blocks an SM.
template <typename Decoder>
__host__ __device__ Geometry geometry_of(int chunk, int group_size, int R = kRows,
                                         int blocks = 1) {
  return Geometry(chunk, Decoder::word_rows(chunk), Decoder::kFields, Decoder::kRowWords,
                  Decoder::kPlane1, group_size, R, smem_budget<Decoder>(blocks));
}

// R: rows of x a block (wgmma's N: 128 for the wide route, 16-64 for the
// mid route); kOneSplit: the mid route's grid, one split of K a block
// (blockIdx.z) written to the workspace [splits, M, N] (or with one split
// to y), Decoder::kMidBlocks blocks an SM; else the block runs every split
// in order.
template <typename T, typename Decoder, int R = kRows, bool kOneSplit = false>
__global__ void __launch_bounds__(kThreads, kOneSplit ? Decoder::kMidBlocks : 1)
    wide_m_kernel(const Args a, const int stages, const __grid_constant__ Maps maps) {
  constexpr int kAcc = R / 2;                    // accumulators a thread
  constexpr int kF = Decoder::kFields;
  constexpr int kRW = Decoder::kRowWords;
  constexpr int kSteps = kF / 2;                 // k16 steps an item
  constexpr int kU = kSteps < 4 ? kSteps : 4;    // steps a unit: one set of A registers
  constexpr int kUnits = kSteps / kU;            // units an item (1, or 2 at 16 fields)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ typename Decoder::Table table;
  const Decoder dec(table, a.table);

  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;  // within its warpgroup
  const int wg = threadIdx.x >> 7;
  const int t = lane & 3;
  const int g = lane >> 2;
  const int m0 = blockIdx.x * R;
  const int nb = blockIdx.y * kBlockN;
  const int col = wg * kGroupCols + warp * 16 + g;  // this lane's columns: col and col + 8
  const Geometry geo =
      geometry_of<Decoder>(a.chunk, a.group_size, R, kOneSplit ? Decoder::kMidBlocks : 1);
  const int Q = geo.q;
  const int nchunks = a.K / a.chunk;
  const int cps = a.chunks_per_split;
  const int splits = nchunks / cps;
  const int per_split = cps * geo.per_chunk;
  // the block's splits and its stages: stage si of the block is stage
  // st0 + si of the layer's K
  const int nsplits = kOneSplit ? 1 : splits;
  const int st0 = kOneSplit ? static_cast<int>(blockIdx.z) * per_split : 0;
  const int nstages = nsplits * per_split;
  // stages in flight ahead of the one computed: with three or four buffers
  // the buffer refilled was read two stages ago, whose products are done;
  // with two it was read by the stage before, drained before the barrier
  const int ahead = stages > 2 ? stages - 2 : 1;
  const uint32_t stretch = static_cast<uint32_t>(geo.stretch());
  const uint32_t lbo = static_cast<uint32_t>(Q) * stretch;
  const uint16_t* scales = static_cast<const uint16_t*>(a.scales);
  const int grows = a.K / a.group_size;

  // a stage's TMA loads land counted on its buffer's mbarrier
  __shared__ __align__(8) uint64_t full[4];
  if (threadIdx.x == 0) {
    for (int b = 0; b < stages; ++b) mbar_init(&full[b], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int pstride = maps.words ? kBlockN : kPlaneStride;  // words a staged plane row
  // the block's stage si (chunk c, quad group gq) into its buffer, by warp
  // 0: x rows m0.. by TMA, a box {8 columns, R rows, Q stretches} a field
  // (rows past M zero-filled); the planes' word rows (each planar word's 4Q
  // rows) and the chunk's scale rows of columns nb.. (columns past N
  // zero-filled) by TMA, or where maps.words is 0 by cp.async from every
  // thread. Always one cp.async group, empty past the block's last stage.
  // Its per-thread offsets are computed anew at each call (thread_index):
  // hoisted out of the loop, they were held across it, up to 26 registers
  // (K3's wide route 255 registers with a spill, 229 without them; its mid
  // route spilled under its cap of 128).
  auto fill = [&](int si) {
    if (si < nstages) {
      const int tx = thread_index();
      const int c = (st0 + si) / geo.per_chunk;
      const int gq = st0 + si - c * geo.per_chunk;
      const int b = si % stages;
      unsigned char* base = smem_raw + static_cast<size_t>(b) * geo.stage_bytes;
      uint32_t* p0 = reinterpret_cast<uint32_t*>(base + geo.x_bytes);
      uint32_t* p1 = p0 + kRW * 4 * Q * pstride;
      uint16_t* sc = reinterpret_cast<uint16_t*>(base + geo.s_off);
      const int gi0 = c * a.chunk / a.group_size;
      // planar word r's first word row of the stage
      auto row0 = [&](int r) { return (c * kRW + r) * geo.kc0 + gq * 4 * Q; };
      if (tx < 32) {
        if (tx == 0) {
          const uint32_t words =
              (kRW * 4 * Q + geo.kc1) * kBlockN * 4 + geo.srows * kBlockN * 2;
          mbar_expect_tx(&full[b], static_cast<uint32_t>(geo.x_bytes) + (maps.words ? words : 0));
          if (maps.words) {
#pragma unroll
            for (int r = 0; r < kRW; ++r)
              tma_load_2d(p0 + r * 4 * Q * kBlockN, &maps.plane0, nb, row0(r), &full[b]);
            if (geo.kc1) tma_load_2d(p1, &maps.plane1, nb, c * geo.kc1, &full[b]);
            tma_load_2d(sc, &maps.scales, nb, gi0, &full[b]);
          }
        }
        __syncwarp();
        if (tx < kF)  // field i's Q stretches: one box
          tma_load_3d(base + static_cast<size_t>(tx) * Q * stretch, &maps.x, m0,
                      c * a.chunk / 8 + tx * (geo.kc0 / 4) + gq * Q, &full[b]);
      }
      if (!maps.words) {
        auto plane = [&](const uint32_t* src, size_t from, int rows, uint32_t* dst) {
          if (a.vec) {
            for (int idx = tx; idx < rows * (kBlockN / 4); idx += kThreads) {
              const int row = idx / (kBlockN / 4);
              const int n = nb + 4 * (idx % (kBlockN / 4));
              const bool ok = n < a.N;
              mma::cp_async16(dst + row * kPlaneStride + (n - nb),
                              ok ? src + (from + row) * a.N + n : src, ok);
            }
          } else {
            for (int idx = tx; idx < rows * kBlockN; idx += kThreads) {
              const int row = idx / kBlockN;
              const int n = nb + idx % kBlockN;
              const bool ok = n < a.N;
              cp_async4(dst + row * kPlaneStride + (n - nb),
                        ok ? src + (from + row) * a.N + n : src, ok);
            }
          }
        };
#pragma unroll
        for (int r = 0; r < kRW; ++r) plane(a.plane0, row0(r), 4 * Q, p0 + r * 4 * Q * kPlaneStride);
        if (geo.kc1) plane(a.plane1, static_cast<size_t>(c) * geo.kc1, geo.kc1, p1);
        // the chunk's scale rows from group (c chunk) / g
        for (int idx = tx; idx < geo.srows * kBlockN; idx += kThreads) {
          const int row = idx / kBlockN;
          const int n = nb + idx % kBlockN;
          const bool ok = n < a.N && gi0 + row < grows;
          sc[row * kBlockN + (n - nb)] =
              ok ? __ldg(scales + static_cast<size_t>(gi0 + row) * a.N + n) : uint16_t(0);
        }
      }
    }
    mma::cp_async_commit();
  };

  // acc: the split in progress; total: the sum of the block's splits before
  // it (kOneSplit: never kept, acc is the block's result)
  float acc[kAcc], total[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    acc[i] = 0.f;
    total[i] = 0.f;
  }
  // !kChunkScales: per field, the first K row of the group of its cached
  // scales and those scales of the lane's 2 columns, each in both halves
  // (kChunkScales: never read, so never kept)
  int sk[kF];
  uint32_t sv[kF][2];
#pragma unroll
  for (int i = 0; i < kF; ++i) sk[i] = -2 * a.group_size;
  // kChunkScales: per field, the chunk's scales of column col (low half)
  // and col + 8 (high half); fpg fields share a group (else never kept)
  uint32_t cs[kF];

  uint32_t af0[kU][4], af1[kU][4];
  for (int si = 0; si < ahead; ++si) fill(si);
  for (int sp = 0, si = 0; sp < nsplits; ++sp) {
  for (int end = si + per_split; si < end; ++si) {
    cp_async_wait_n<2>(ahead - 1);
    __syncthreads();  // stage si's words and scales staged; its buffer's last reader is done
    fill(si + ahead);
    mbar_wait(&full[si % stages], (si / stages) & 1);  // its TMA loads landed
    const int c = (st0 + si) / geo.per_chunk;
    const int gq = st0 + si - c * geo.per_chunk;
    const unsigned char* base = smem_raw + static_cast<size_t>(si % stages) * geo.stage_bytes;
    const uint32_t xs = smem_u32(base);
    const uint32_t* p0 = reinterpret_cast<const uint32_t*>(base + geo.x_bytes);
    const uint32_t* p1 = p0 + kRW * 4 * Q * pstride;
    const uint16_t* sc = reinterpret_cast<const uint16_t*>(base + geo.s_off);
    const int k0 = c * a.chunk - (c * a.chunk / a.group_size) * a.group_size;  // chunk in group
    if (Decoder::kChunkScales && gq == 0) {
      // a new chunk: field i's group is row (k0 / 2 kc + i) / fpg of its
      // scales (fpg computed where it is read, so that no register holds
      // it across the loop)
      const int fpg = a.group_size / (2 * geo.kc0);
      int r = k0 / (2 * geo.kc0), row = 0;
#pragma unroll
      for (int i = 0; i < kF; ++i) {
        if (i == 0 || r == 0)
          cs[i] = static_cast<uint32_t>(sc[row * kBlockN + col]) |
                  (static_cast<uint32_t>(sc[row * kBlockN + col + 8]) << 16);
        else
          cs[i] = cs[i - 1];
        if (++r == fpg) {
          r = 0;
          ++row;
        }
      }
    }
    // unit h (of kUnits) of item ql into A registers: its kU steps' pairs
    // times their scales. h is a constant at every call, and 0 wherever an
    // item is one unit.
    auto decode = [&](int h, int ql, uint32_t (&af)[kU][4]) {
      const int s0 = h * kU;  // the unit's first step in the item
      const int j = 4 * (gq * Q + ql) + t;      // word row of the chunk
      const typename Decoder::Words w =
          staged_words<Decoder>(p0, p1, 4 * ql + t, j, geo.kc1, Q, pstride, col);
      if (!Decoder::kChunkScales) {
#pragma unroll
        for (int ii = 0; ii < 2 * kU; ++ii) {
          const int i = 2 * s0 + ii;
          // K row in the chunk's first group's frame: rows of the staged scales
          const int krow = c * a.chunk + 2 * (i * geo.kc0 + j);
          if (static_cast<unsigned>(krow - sk[i]) >= static_cast<unsigned>(a.group_size)) {
            const int gr = (k0 + 2 * (i * geo.kc0 + j)) / a.group_size;
            sk[i] = krow - (k0 + 2 * (i * geo.kc0 + j)) + gr * a.group_size;
            const uint32_t h0 = sc[gr * kBlockN + col], h1 = sc[gr * kBlockN + col + 8];
            sv[i][0] = h0 | (h0 << 16);
            sv[i][1] = h1 | (h1 << 16);
          }
        }
      }
#pragma unroll
      for (int s = 0; s < kU; ++s) {
        const int f = 2 * (s0 + s);
        constexpr bool kChunk = Decoder::kChunkScales;
        af[s][0] = Pack2<T>::mul(dec.pair(w, 0, f, j, geo.kc1),
                                 field_scale<kChunk>(cs[f], sv[f], 0));
        af[s][1] = Pack2<T>::mul(dec.pair(w, 1, f, j, geo.kc1),
                                 field_scale<kChunk>(cs[f], sv[f], 1));
        af[s][2] = Pack2<T>::mul(dec.pair(w, 0, f + 1, j, geo.kc1),
                                 field_scale<kChunk>(cs[f + 1], sv[f + 1], 0));
        af[s][3] = Pack2<T>::mul(dec.pair(w, 1, f + 1, j, geo.kc1),
                                 field_scale<kChunk>(cs[f + 1], sv[f + 1], 1));
      }
    };
    // unit h of item ql: its kU products, a commit group each; acc is not
    // touched between here and a wait<0>: a read of it while a product is
    // in flight would make ptxas wait on each one
    auto issue = [&](int h, int ql, const uint32_t (&af)[kU][4]) {
      const int s0 = h * kU;
      wg_fence();
#pragma unroll
      for (int s = 0; s < kU; ++s) {
        // k-slots 0..7: field 2s of the item, 8..15: field 2s + 1
        wgmma_rs<T, R>(acc, af[s],
                       smem_desc(xs + static_cast<uint32_t>(2 * (s0 + s) * Q + ql) * stretch,
                                 lbo, 128),
                       1);
        wg_commit();
      }
    };
    // two sets of A registers: a unit is decoded while the unit before it
    // multiplies, into the set whose products the wait has retired. A turn
    // is an item's units, or two items of one unit, an even count, so that
    // every unit's set and place in its item are constants.
    constexpr int kTurnItems = kUnits == 1 ? 2 : 1;
    constexpr int kTurnUnits = kUnits * kTurnItems;
    decode(0, 0, af0);
    for (int q0 = 0; q0 < Q; q0 += kTurnItems) {
#pragma unroll
      for (int v = 0; v < kTurnUnits; ++v) {
        issue(v % kUnits, q0 + v / kUnits, (v & 1) ? af1 : af0);
        wg_wait<kU>();
        if (v + 1 < kTurnUnits)
          decode((v + 1) % kUnits, q0 + (v + 1) / kUnits, (v & 1) ? af0 : af1);
        else if (q0 + kTurnItems < Q)
          decode(0, q0 + kTurnItems, af0);
      }
    }
    if (stages == 2) wg_wait<0>();  // this stage's products done before its buffer refills
  }
  // the split's end: its products done (an unconditional wait, so that
  // ptxas keeps the products in flight within the split), its sum added to
  // the total in split order (split_reduce_kernel's sum from 0), or with one
  // split (or one a block) the result itself
  wg_wait<0>();
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    pin(acc[i]);
    if (!kOneSplit) {
      total[i] = splits > 1 ? total[i] + acc[i] : acc[i];
      acc[i] = 0.f;
    }
  }
  }

  // out[4jj + r]: column col + 8 (r >> 1), row 8 jj + 2t + (r & 1); the mid
  // route's split partials go to the workspace in f32, as the loop's do
  // (its grid's z is the split count, so that no register holds that
  // count across the loop)
  T* y = static_cast<T*>(a.y);
  float* work = kOneSplit && gridDim.z > 1
                    ? a.work + static_cast<size_t>(blockIdx.z) * a.M * a.N
                    : nullptr;
  const int n_a = nb + col, n_b = n_a + 8;
#pragma unroll
  for (int jj = 0; jj < R / 8; ++jj) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = m0 + 8 * jj + 2 * t + (r & 1);
      const int n = (r >> 1) ? n_b : n_a;
      const float v = kOneSplit ? acc[4 * jj + r] : total[4 * jj + r];
      if (m < a.M && n < a.N) {
        const size_t o = static_cast<size_t>(m) * a.N + n;
        if (work != nullptr)
          work[o] = v;
        else
          y[o] = Cvt<T>::from_f(v);
      }
    }
  }
}

// The driver's cuTensorMapEncodeTiled, through the runtime (no link to
// libcuda): null where the driver lacks it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
#endif
      return static_cast<EncodeTiled>(nullptr);
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A row-major [rows, cols] array of `bytes`-byte elements as a 2-D tensor
// map with boxes of box_cols x box_rows, no swizzle; reads past its edges
// give zeros.
inline cudaError_t map_2d(CUtensorMap* map, CUtensorMapDataType type, int bytes, const void* p,
                          int cols, int rows, int box_cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(p), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The launch's maps: x [M, K] of 16-bit T; with 16-byte aligned planes and
// scales, N a multiple of 8 and the chunk's scale rows at most 256, the
// planes in boxes of the block's 128 columns by a stage's word rows and the
// scales by the chunk's scale rows.
template <typename T>
cudaError_t make_maps(Maps* m, const Args& a, const Geometry& geo) {
  const CUtensorMapDataType xt = std::is_same_v<T, __half> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // x as {8 columns, rows, stretches} (strides K * 2 and 16 bytes): one box
  // a field's Q stretches of the block's rows, [stretch][row][8] in shared
  // memory
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {8, static_cast<cuuint64_t>(a.M), static_cast<cuuint64_t>(a.K / 8)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(a.K) * 2, 16};
  const cuuint32_t box[3] = {8, static_cast<cuuint32_t>(geo.rows),
                             static_cast<cuuint32_t>(geo.q)};
  const cuuint32_t elem[3] = {1, 1, 1};
  cudaError_t e = encode(&m->x, xt, 3, const_cast<void*>(a.x), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
                          CUDA_SUCCESS
                      ? cudaSuccess
                      : cudaErrorInvalidValue;
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  m->words = e == cudaSuccess && a.vec && a.N % 8 == 0 && aligned(a.plane0) &&
             (a.plane1 == nullptr || aligned(a.plane1)) && aligned(a.scales) && geo.srows <= 256;
  if (e != cudaSuccess || !m->words) return e;
  e = map_2d(&m->plane0, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, a.plane0, a.N,
             a.K / a.chunk * geo.kc0 * geo.row_words, kBlockN, 4 * geo.q);
  if (e == cudaSuccess && a.plane1 != nullptr)
    e = map_2d(&m->plane1, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, a.plane1, a.N, a.K / 32, kBlockN,
               geo.kc1);
  if (e == cudaSuccess)
    e = map_2d(&m->scales, CU_TENSOR_MAP_DATA_TYPE_UINT16, 2, a.scales, a.N, a.K / a.group_size,
               kBlockN, geo.srows);
  return e;
}

// Launches the kernel for `splits` splits of the K chunks (mma_plan's): the
// wide route (R = 128) on a grid (M / 128, N / 128), no workspace; the mid
// route (kOneSplit) on a grid (M / R, N / 128, splits) and, with more than
// one split, split_reduce_kernel over the workspace a.work. Returns the
// first launch error.
template <typename T, typename Decoder, int R = kRows, bool kOneSplit = false>
cudaError_t launch_wide(Args a, int splits, cudaStream_t stream) {
  auto kernel = wide_m_kernel<T, Decoder, R, kOneSplit>;
  if (!Decoder::kPlane1) a.plane1 = nullptr;
  if (kOneSplit && splits > 1 && a.work == nullptr) return cudaErrorInvalidValue;
  const int blocks = kOneSplit ? Decoder::kMidBlocks : 1;
  const Geometry geo = geometry_of<Decoder>(a.chunk, a.group_size, R, blocks);
  const int stages = geo.stages(smem_budget<Decoder>(blocks));
  if (stages == 0) return cudaErrorInvalidValue;
  const size_t smem = stages * geo.stage_bytes;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  Maps maps;
  e = make_maps<T>(&maps, a, geo);
  if (e != cudaSuccess) return e;
  a.chunks_per_split = a.K / a.chunk / splits;
  const dim3 grid((a.M + R - 1) / R, (a.N + kBlockN - 1) / kBlockN, kOneSplit ? splits : 1);
  kernel<<<grid, kThreads, smem, stream>>>(a, stages, maps);
  e = cudaGetLastError();
  if (e != cudaSuccess || !kOneSplit || splits == 1) return e;
  const size_t mn = static_cast<size_t>(a.M) * a.N;
  mma::split_reduce_kernel<T><<<static_cast<unsigned>((mn + 255) / 256), 256, 0, stream>>>(
      a.work, static_cast<T*>(a.y), mn, splits);
  return cudaGetLastError();
}

// The mid route with `rows` rows a block: 16, 32, 48 or 64, the row tiles
// it is built for (ops/kernel_config.py::MID_ROWS).
template <typename T, typename Decoder>
cudaError_t launch_mid(const Args& a, int rows, int splits, cudaStream_t s) {
  switch (rows) {
    case 16: return launch_wide<T, Decoder, 16, true>(a, splits, s);
    case 32: return launch_wide<T, Decoder, 32, true>(a, splits, s);
    case 48: return launch_wide<T, Decoder, 48, true>(a, splits, s);
    case 64: return launch_wide<T, Decoder, 64, true>(a, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

// The kernel for a C entry's dtype code (1 = float16, 2 = bfloat16; float32
// is refused) with the pair decoder of NB bits and table fill Fill.
template <int NB, typename Fill>
cudaError_t run_pair(const Args& a, int dtype, int splits, cudaStream_t s) {
  switch (dtype) {
    case 1: return launch_wide<__half, mma::PairDecoder<__half, NB, Fill>>(a, splits, s);
    case 2:
      return launch_wide<__nv_bfloat16, mma::PairDecoder<__nv_bfloat16, NB, Fill>>(a, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

// The mid route for a C entry's dtype code (1 = float16, 2 = bfloat16;
// float32 is refused) with the pair decoder of NB bits and table fill Fill.
template <int NB, typename Fill>
cudaError_t run_pair_mid(const Args& a, int dtype, int rows, int splits, cudaStream_t s) {
  switch (dtype) {
    case 1: return launch_mid<__half, mma::PairDecoder<__half, NB, Fill>>(a, rows, splits, s);
    case 2:
      return launch_mid<__nv_bfloat16, mma::PairDecoder<__nv_bfloat16, NB, Fill>>(a, rows,
                                                                                  splits, s);
    default: return cudaErrorInvalidValue;
  }
}

// A C entry's operands as the kernel's Args, `word_rows` the decoder's
// word rows a chunk, `work` the mid route's split-K workspace (null for the
// wide route, and with one split): false where it cannot take them (K not a
// multiple of chunk, word_rows not a multiple of 4, splits not dividing the
// chunks, a group size that does not divide K). A ring that does not fit,
// or a mid launch of several splits without a workspace, is refused at the
// launch.
inline bool wide_args(Args& a, const void* x, const void* plane0, const void* plane1,
                      const void* scales, const void* table, void* y, int M, int N, int K,
                      int group_size, int chunk, int word_rows, int splits, int vec,
                      void* work = nullptr) {
  if (!mma::loop_args(a, x, plane0, plane1, scales, table, y, nullptr, M, N, K, group_size,
                      chunk, word_rows, 1, vec))
    return false;
  a.work = static_cast<float*>(work);
  return splits >= 1 && (K / chunk) % splits == 0 && group_size > 0 && K % group_size == 0;
}

// Registers, static + dynamic shared memory and blocks per SM of `kernel`
// launched with `threads` threads and `dyn` bytes of dynamic shared memory.
template <typename K>
cudaError_t describe(K kernel, int threads, size_t dyn, int* regs, int* smem, int* blocks) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  if (dyn > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dyn));
    if (e != cudaSuccess) return e;
  }
  *regs = attr.numRegs;
  *smem = static_cast<int>(attr.sharedSizeBytes + dyn);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, dyn);
}

// The instantiations that a kernel runs with decoder D in 16-bit type T,
// for the report of phase 1: i = 0..2 the loop at 1, 2 and 4 m16 tiles a
// warp, 3 this kernel's wide route; dynamic shared memory at `chunk` (and
// group size 64).
template <typename T, typename D>
cudaError_t describe_dtype(int i, int chunk, int* regs, int* smem, int* blocks) {
  switch (i) {
    case 0: return describe(mma::lut_mma_kernel<T, 1, D>, mma::kMmaThreads,
                            mma::mma_smem_bytes(1, chunk), regs, smem, blocks);
    case 1: return describe(mma::lut_mma_kernel<T, 2, D>, mma::kMmaThreads,
                            mma::mma_smem_bytes(2, chunk), regs, smem, blocks);
    case 2: return describe(mma::lut_mma_kernel<T, 4, D>, mma::kMmaThreads,
                            mma::mma_smem_bytes(4, chunk), regs, smem, blocks);
    default: {
      const Geometry geo = geometry_of<D>(chunk, 64);
      return describe(wide_m_kernel<T, D>, kThreads,
                      geo.stages(smem_budget<D>()) * geo.stage_bytes, regs, smem, blocks);
    }
  }
}

// Instantiation i of a kernel's decoder in bf16 (DB: i = 0..3) and f16
// (DH: 4..7), as describe_dtype counts them: its name, registers, shared
// memory and blocks per SM.
template <typename DB, typename DH>
cudaError_t describe_decoders(int i, int chunk, const char** name, int* regs, int* smem,
                              int* blocks) {
  static const char* const kNames[8] = {
      "loop MT=1 bfloat16", "loop MT=2 bfloat16", "loop MT=4 bfloat16", "wide bfloat16",
      "loop MT=1 float16",  "loop MT=2 float16",  "loop MT=4 float16",  "wide float16"};
  if (i < 0 || i >= 8) return cudaErrorInvalidValue;
  *name = kNames[i];
  if (i < 4) return describe_dtype<__nv_bfloat16, DB>(i, chunk, regs, smem, blocks);
  return describe_dtype<__half, DH>(i - 4, chunk, regs, smem, blocks);
}

// The same for the pair decoder of NB bits and table fill Fill (K1, K2, K4).
template <int NB, typename Fill>
cudaError_t describe_pair(int i, int chunk, const char** name, int* regs, int* smem,
                          int* blocks) {
  return describe_decoders<mma::PairDecoder<__nv_bfloat16, NB, Fill>,
                           mma::PairDecoder<__half, NB, Fill>>(i, chunk, name, regs, smem, blocks);
}

// The mid route's instantiation of row tile R with decoder D in type T:
// registers, shared memory at `chunk` (group size 64) and blocks per SM.
template <typename T, typename D, int R>
cudaError_t describe_mid_rows(int chunk, int* regs, int* smem, int* blocks) {
  const Geometry geo = geometry_of<D>(chunk, 64, R, D::kMidBlocks);
  return describe(wide_m_kernel<T, D, R, true>, kThreads,
                  geo.stages(smem_budget<D>(D::kMidBlocks)) * geo.stage_bytes, regs, smem,
                  blocks);
}

// Instantiation i of the mid route with decoder DB in bf16 (i = 0..3, its
// row tiles) and DH in f16 (4..7): its name, registers, shared memory and
// blocks per SM.
template <typename DB, typename DH>
cudaError_t describe_mid(int i, int chunk, const char** name, int* regs, int* smem,
                         int* blocks) {
  static const char* const kNames[8] = {"mid R=16 bfloat16", "mid R=32 bfloat16",
                                        "mid R=48 bfloat16", "mid R=64 bfloat16",
                                        "mid R=16 float16",  "mid R=32 float16",
                                        "mid R=48 float16",  "mid R=64 float16"};
  if (i < 0 || i >= 8) return cudaErrorInvalidValue;
  *name = kNames[i];
  switch (i) {
    case 0: return describe_mid_rows<__nv_bfloat16, DB, 16>(chunk, regs, smem, blocks);
    case 1: return describe_mid_rows<__nv_bfloat16, DB, 32>(chunk, regs, smem, blocks);
    case 2: return describe_mid_rows<__nv_bfloat16, DB, 48>(chunk, regs, smem, blocks);
    case 3: return describe_mid_rows<__nv_bfloat16, DB, 64>(chunk, regs, smem, blocks);
    case 4: return describe_mid_rows<__half, DH, 16>(chunk, regs, smem, blocks);
    case 5: return describe_mid_rows<__half, DH, 32>(chunk, regs, smem, blocks);
    case 6: return describe_mid_rows<__half, DH, 48>(chunk, regs, smem, blocks);
    default: return describe_mid_rows<__half, DH, 64>(chunk, regs, smem, blocks);
  }
}

// The same with the pair decoder of NB bits and table fill Fill (K1, K2, K4).
template <int NB, typename Fill>
cudaError_t describe_pair_mid(int i, int chunk, const char** name, int* regs, int* smem,
                              int* blocks) {
  return describe_mid<mma::PairDecoder<__nv_bfloat16, NB, Fill>,
                      mma::PairDecoder<__half, NB, Fill>>(i, chunk, name, regs, smem, blocks);
}

// ---------------------------------------------------------------------------
// The probe of the tensor core's bits: one k16 step, d = c + x w, by
// mma.sync.m16n8k16 (the decode loop's instruction and operand roles), by
// wgmma with x as A and w as B from shared memory (orientation a), and by
// wgmma with w as A from registers and x as B from shared memory
// (orientation b, this kernel's). One block of 128 threads a trial: x
// [128 rows][16], w [128 columns][16] (K-major), c [128][128] f32; outputs
// [3][128 rows][128 columns] f32.
template <typename T>
__global__ void __launch_bounds__(128) wgmma_probe_kernel(const T* __restrict__ x,
                                                          const T* __restrict__ w,
                                                          const float* __restrict__ c,
                                                          float* __restrict__ out) {
  __shared__ __align__(128) T xs[2 * 128 * 8];  // [k half][row][8]
  __shared__ __align__(128) T ws[2 * 128 * 8];  // [k half][column][8]
  const size_t trial = blockIdx.x;
  x += trial * 128 * 16;
  w += trial * 128 * 16;
  c += trial * 128 * 128;
  out += trial * 3 * 128 * 128;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int g = lane >> 2;
  for (int i = threadIdx.x; i < 128 * 16; i += 128) {
    const int r = i / 16, k = i % 16;
    xs[(k / 8) * 128 * 8 + r * 8 + k % 8] = x[i];
    ws[(k / 8) * 128 * 8 + r * 8 + k % 8] = w[i];
  }
  fence_async_smem();
  __syncthreads();
  auto pair_of = [](const T* m, int row, int k) {  // m[row][k..k+1] packed
    return *reinterpret_cast<const uint32_t*>(m + row * 16 + k);
  };
  // mma.sync: warp takes rows 32 warp.. (2 m16 tiles), all 16 n8 tiles
  for (int mt = 0; mt < 2; ++mt) {
    const int r0 = 32 * warp + 16 * mt;
    const uint32_t af[4] = {pair_of(x, r0 + g, 2 * t), pair_of(x, r0 + g + 8, 2 * t),
                            pair_of(x, r0 + g, 2 * t + 8), pair_of(x, r0 + g + 8, 2 * t + 8)};
    for (int nt = 0; nt < 16; ++nt) {
      float d[4];
      for (int i = 0; i < 4; ++i)
        d[i] = c[(r0 + g + 8 * (i >> 1)) * 128 + 8 * nt + 2 * t + (i & 1)];
      mma::mma16816<T>(d, af, pair_of(w, 8 * nt + g, 2 * t), pair_of(w, 8 * nt + g, 2 * t + 8));
      for (int i = 0; i < 4; ++i)
        out[(r0 + g + 8 * (i >> 1)) * 128 + 8 * nt + 2 * t + (i & 1)] = d[i];
    }
  }
  const uint32_t xa = smem_u32(xs), wa = smem_u32(ws);
  for (int h = 0; h < 2; ++h) {
    // (a): rows 64h.. of x as A, all of w as B: d[row][column]
    float d[64];
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        d[4 * jj + r] = c[(64 * h + 16 * warp + g + 8 * (r >> 1)) * 128 + 8 * jj + 2 * t + (r & 1)];
#pragma unroll
    for (int i = 0; i < 64; ++i) pin(d[i]);
    wg_fence();
    wgmma_ss<T>(d, smem_desc(xa + 64 * h * 16, 128 * 16, 128), smem_desc(wa, 128 * 16, 128), 1);
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) pin(d[i]);
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        out[128 * 128 + (64 * h + 16 * warp + g + 8 * (r >> 1)) * 128 + 8 * jj + 2 * t + (r & 1)] =
            d[4 * jj + r];
    // (b): columns 64h.. of w as A from registers, all of x as B: d[column][row]
    const int n0 = 64 * h + 16 * warp + g;
    const uint32_t af[4] = {pair_of(w, n0, 2 * t), pair_of(w, n0 + 8, 2 * t),
                            pair_of(w, n0, 2 * t + 8), pair_of(w, n0 + 8, 2 * t + 8)};
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        d[4 * jj + r] = c[(8 * jj + 2 * t + (r & 1)) * 128 + n0 + 8 * (r >> 1)];
#pragma unroll
    for (int i = 0; i < 64; ++i) pin(d[i]);
    wg_fence();
    wgmma_rs<T, 128>(d, af, smem_desc(xa, 128 * 16, 128), 1);
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) pin(d[i]);
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        out[2 * 128 * 128 + (8 * jj + 2 * t + (r & 1)) * 128 + n0 + 8 * (r >> 1)] = d[4 * jj + r];
  }
}

// The probe on `trials` trials (dtype 1 = float16, 2 = bfloat16).
inline cudaError_t run_probe(const void* x, const void* w, const float* c, float* out, int trials,
                             int dtype, cudaStream_t s) {
  if (dtype == 1)
    wgmma_probe_kernel<__half><<<trials, 128, 0, s>>>(static_cast<const __half*>(x),
                                                       static_cast<const __half*>(w), c, out);
  else if (dtype == 2)
    wgmma_probe_kernel<__nv_bfloat16><<<trials, 128, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), c, out);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace wide
}  // namespace flute
