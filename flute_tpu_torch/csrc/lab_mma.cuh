// The Hopper lab's tensor-core loop (sm_90a): a group-accumulating
// mma.sync LUT-GEMM over the lab's pair planes, shared by L1
// (kernel_lab.cu, flute_lab_floor: scripts/kernel_lab.py:79 run_floor), L2
// (flute_lab_unpack_only: :124 run_unpack), L3 (flute_lab_gather16: :212
// run_gather16), L4 (flute_lab_g8_ablate: :413 run_g8_ablate), L5
// (flute_lab_g8_rs: :501 run_g8_rs), L6 (flute_lab_g8_hoist: :590
// run_g8_hoist), L8 (kernel_lab2.cu, flute_lab2_pfdirect:
// scripts/kernel_lab2.py:135 run_pfdirect), L9 (flute_lab2_sep: :234
// run_sep), L10 (flute_lab2_int4: :290 run_int4), L11
// (flute_lab2_slabstream: :483 run_slabstream) and L12 (flute_lab2_w3wide:
// :585 run_w3wide), each with its own decoder: L4, L6, L9 and L10 hold their
// tables in registers, L3, L5, L8, L11 and L12 in shared memory (L5 and L11
// one decoder, lab_decoders.cuh; L8 the same with its B registers passed
// through a tile in shared memory; L12 a pair table of the wide 3-bit
// layout, 24 word rows a chunk), and L1 and L2 decode no table: L1's words
// are the B registers, so it measures what the staging alone costs, and L2
// spreads a field's two nibbles to the two halves, so it measures what
// unpacking a 4-bit pair field costs on top of that. The served loop
// (lut_gemm_mma.cuh::lut_mma_kernel) is not touched; its helpers are reused.
//
//   y[M, N] = bf16(sum over groups of (x_g @ W_g) * s_g)      (group_acc)
//   y[M, N] = bf16(sum over groups of (x_g @ c_g) * (s_g * delta)
//                                   + (sum_k x_g) * (s_g * zero))   (int4)
//   y[M, N] = bf16(x @ bf16(W * s_tiled))                       (repeat)
//   y[M, N] = bf16(x @ bf16(W * s_grouped))                     (expand)
//   y[M, N] = bf16(x @ W)                                       (none)
//
// What bounds it: bytes. At the lab's shape (M 16, N 28672, K 8192, g 64)
// the plane (or L9's two 2-bit planes) is 117 MB and the rest 8.5 MB, 37.6
// us at 3.35 TB/s (35.4 us for L1, which reads no scales; L12's 3-bit plane
// is 88 MB, 28.8 us); the products at the bf16 tensor rate take 7.6 us
// (15.2 for L9's two products). The SIMT
// skeleton of lut_gemm_common.cuh reached 3-5% of that bound: one 4-byte
// load in flight per lane, x re-staged as f32, f32 FMAs on 16 rows. Here:
//
// * The block (4 warps, 128 columns, 16 rows of x) stages each 256-row pack
//   chunk in a two-slot cp.async ring: x (16-byte copies, rows past M zero)
//   and the chunk's word rows of its columns (32 of a 4-bit plane, 16 KB;
//   24 of the wide 3-bit layout, 12 KB: the decoder's kWordRows; 16 bytes a
//   copy, piece p of word row j stored at p ^ 2(j & 3) so that the warps'
//   16-byte reads below meet no bank conflict). Two 2-bit planes have 16
//   word rows a chunk each: plane A's go to slot rows 0-15, plane B's to
//   16-31, with the same swizzle. The next chunk's copies are issued before
//   the current chunk's products, so 4 blocks an SM keep about 100 KB in
//   flight with no registers spent on it. Slot x column u holds K row
//   256 c + u of chunk c, unless the decoder maps it (kXMap): L1's word row
//   j of chunk cc of K block kb feeds K rows kb bk + 64 cc + 2j + {0, 1} +
//   t bk/4, t = 0..3 (pltpu.repeat tiles the block's words 4 times), so its
//   slot columns 64 i .. 64 i + 63 take the stretch t = i of the block. A
//   stretch is 128 bytes: no 16-byte copy straddles two. (L2 reads the
//   same words in the loop's own K order: no map.)
// * One k16 step lies inside one group. A lane (g = lane / 4, t = lane % 4)
//   reads the slot's word rows 4v + t, v < kWordRows / 4 (8, or 6 for the
//   wide 3-bit layout): the first 8 / planes of them from each plane, so it
//   holds word rows 8q + t and 8q + 4 + t of every plane. Field i of word row j is pair row F i + j, F = 32 (one 4-bit
//   plane: 4 fields of 8 bits a word) or 16 (2-bit planes: 8 fields of 4
//   bits), K rows 2F i + 2j, +1; so the two words hold, in field i, exactly
//   the B fragment of mma.m16n8k16 for K rows 2F i + 16 q .. +15: k-slots
//   2t, 2t+1 from the first, 2t+8, 2t+9 from the second. Taken field by
//   field, q inner (F / 8 steps a field), the 16 steps of a chunk run in K
//   order, so one f32 partial is open at a time, at any group size that is
//   a multiple of 16. A lane's 4 columns of a word row (4 g .. 4 g + 3 of
//   the warp's 32) feed the 4 n8 tiles (tile e's n-slot g is column 4 g + e).
//   The wide 3-bit layout (L12) has this geometry with no x map and one
//   step a field: word rows t, 8 + t, 16 + t are triple t, whose 16 six-bit
//   fields are pair rows 8 j + t, so a step's 6 words a column (kStepWords:
//   rows 4v + t, v < 6, triples t and t + 4) hold its whole B fragment.
// * A decoder turns one field of each plane straight into B registers (two
//   bf16, the even K row in the low half), both registers of a step and
//   column at once, and says how many products a step takes: L9's "sep"
//   issues one mma on plane A's registers and one on plane B's into the
//   same accumulator, "sep1" one on their bf16 sums (__hadd2, RN). Its
//   table lives in registers (byte planes: one prmt looks up 4 codes) or in
//   shared memory at a fixed offset (L5's and L11's pair table, one
//   ld.shared a B register; L3's 16 entries, one ld.shared a code; L12's 64
//   pairs of the 3-bit table), filled by the block before the first
//   barrier. L1's decoder hands the words over as they are, in every field.
// * Or a decoder passes its B registers through shared memory first
//   (kTiled, L8: the TPU kernel builds its operand tile before its
//   products): the warp stores a step's B registers with stmatrix to its
//   tile ([32 columns][16 K rows] bf16, a column's 16-byte units
//   XOR-swizzled by its group of 4, so that the 8 columns of a matrix meet
//   8 bank groups) and reads them back with ldmatrix (the B fragment is an
//   8 x 8 matrix whose rows are columns), __syncwarp between. The products
//   run in the same order into the same partial, so the bits are the
//   register route's. What this costs against the register route is the
//   round trip (two stmatrix.x4 and two ldmatrix.x4 a step and lane) and
//   the tiles' 4 KB a block: 4 blocks an SM need at most 57 344 B each (the
//   runtime keeps 1 KB a block), so the tile is one step, and L8's table 2
//   KB. A field's tile (16 KB a block) left 3 blocks an SM and was slower.
// * The partial of a group: its steps' products in an f32 fragment; when the
//   group ends, acc = acc + part * s (each rounded: __fmul_rn, __fadd_rn),
//   and for int4 part * (s * delta) + xsum * (s * zero), the x sums taken by
//   one more mma against a B of ones (exact products, f32 sums). The C
//   fragment's columns are n-slots 2t, 2t+1 of each tile, i.e. columns
//   8t + e and 8t + 4 + e of the warp: a lane's 8 scales of a group are 8
//   consecutive columns, loaded (load_scales) when the group opens and
//   prefetched into L2 a chunk early.
// * "expand" scales the B register before the mma instead, by s[k // g]
//   with one __hmul2 (bf16(bf16(T[c]) * s), one rounding): a step lies in
//   one group, so both halves take the open group's row. The B fragment's
//   columns are n-slot g of each tile, columns 4g + e: a lane's 4 scales of
//   a group are 4 consecutive columns, one 8-byte load, issued a group
//   ahead. The products go straight into the running f32 sum. "none" reads
//   no scales.
// * "repeat" scales the B register too, but K row r of K block kb takes
//   scale row kb * P + (r mod P), P = bk / g, so the two halves of a
//   register take different rows. The K block's P rows of the block's
//   columns are staged in shared memory (4 KB at bk 1024, g 64) when the K
//   block starts, prefetched into L2 a chunk early.
// * Split-K only at multiples of lcm(chunk, g) K rows, so a group never
//   straddles two splits (L1 and L2 read no scales: their unit is the
//   chunk, any chunk boundary, since L1's x map follows from a chunk's
//   index and bk alone); the splits' f32 sums go to a workspace [splits, M, N] that
//   split_reduce_kernel adds in split order (no atomics: a repeat call gives
//   the same bits). The split is planned from N, K and g
//   (flute_tpu_torch/lab/ops.py::lab_splits).
//
// Numerics contract: 16-bit operands, f32 sums in the tensor core (a k16
// step's products) and in IEEE f32 (partials, epilogue, splits), no flush
// to zero, no atomics. Against the plain versions, which sum in another f32
// order, results agree within the bf16 threshold; with x the identity every
// output is one product, so they agree bit for bit. (L1's operand holds
// subnormal bf16 halves and L2's is all subnormal; the tensor core keeps
// subnormal operands, products and a step's sum of 16 subnormal products:
// the card test test_lab_mma_keeps_subnormals.)
//
// A Decoder provides
//   kPlanes                    planes it reads: 1 (a 4-bit pair plane
//                              [K/8, N], or the wide 3-bit layout
//                              [3K/32, N]) or 2 (two 2-bit pair planes
//                              [K/16, N], Args::plane and Args::plane_b)
//   kFieldBits                 bits of a field, one pair row: 8, 6 or 4
//   kProducts                  mma products a step and column: 1 or 2
//   kTableWords                32-bit words of its table in dynamic shared
//                              memory (after the ring, before the tiles and
//                              "repeat"'s scale rows), or 0 for a table in
//                              registers
//   Decoder(const Args& a)     (kTableWords 0) its tables in registers, from
//                              the f32 tables (or none)
//   Decoder(const Args& a, uint32_t* t)
//                              (kTableWords > 0) fills its table at t with
//                              the block's threads, before the loop's first
//                              barrier
//   void pairs(w, i, b)        field i of a step's words w[kStepWords] of
//                              one column (word rows 8q + t and 8q + 4 + t,
//                              plane by plane; L12: rows 4v + t, v < 6) as
//                              the step's B registers b[kProducts][2],
//                              before any scale.
// and, where they differ from these defaults,
//   kWordRows                  slot word rows a chunk (32; L12 24)
//   kStepWords                 words of a column that a step reads
//                              (2 * kPlanes; L12 6)
//   kTiled                     true where its B registers go through the
//                              warp's tile in shared memory (false, the
//                              register route; L8 true)
// and, only where slot x column u of chunk c is not K row 256 c + u,
//   kXMap                      true
//   static int x_row(c, bk, u) the K row of x that slot column u (a multiple
//                              of 8; 8 columns from it run on in K) of
//                              chunk c holds, at the K block bk (Args::bk)

#pragma once

#include <type_traits>

#include "lut_gemm_mma.cuh"

namespace flute {
namespace labmma {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;                          // 4 warps
constexpr int kBlockN = 128;                           // columns per block, 32 per warp
constexpr int kRows = 16;                              // rows of x per block
constexpr int kChunk = 256;                            // the lab's pack chunk
constexpr int kSteps = kChunk / 16;                    // k16 steps per chunk
constexpr int kXStride = kChunk + 8;                   // halves per staged x row
constexpr int kXBytes = kRows * kXStride * 2;          // 8448
constexpr uint32_t kOnes = 0x3F803F80u;                // bf16 (1, 1)

enum Scaling { kGroupAcc, kAffine, kRepeat, kExpand, kNone };

struct Args {
  const bf16* x;           // [M, K], 16-byte aligned
  const uint32_t* plane;   // [K / 8, N], or plane A [K / 16, N] of two
  const uint32_t* plane_b; // plane B [K / 16, N] of two, or null
  const bf16* scales;      // [K / g, N]
  const float* table;      // the decoder's table, or null
  const float* table_b;    // plane B's table, or null
  bf16* y;                 // [M, N]
  float* work;             // [splits, M, N], or null with one split
  int M, N, K, g, bk, chunks_per_split;
  float zero, delta;       // int4's affine table
  int vec_w;               // 16-byte plane copies (N % 4 == 0, aligned planes)
  int vec_s;               // 8-byte scale loads (N % 4 == 0, aligned scales)
  int vec_s16;             // 16-byte scale-row copies (N % 8 == 0, aligned scales)
};

// 4 bytes global -> shared, or 4 zero bytes when !pred
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(mma::smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ float bf16_bits(uint32_t h) { return __uint_as_float(h << 16); }

// 16-bit value e (0..3) of 4 packed in a uint2
__device__ __forceinline__ uint32_t half_of(const uint2& v, int e) {
  const uint32_t w = e < 2 ? v.x : v.y;
  return (e & 1) ? (w >> 16) : (w & 0xFFFFu);
}

// (lo[e], hi[e]) as one register: value e of two packed rows
__device__ __forceinline__ uint32_t pair_of(const uint2& lo, const uint2& hi, int e) {
  return __byte_perm(e < 2 ? lo.x : lo.y, e < 2 ? hi.x : hi.y, (e & 1) ? 0x7632u : 0x5410u);
}

// Whether a decoder maps slot x columns to K rows of its own (kXMap)
template <typename D, typename = void>
struct MapsX : std::false_type {};
template <typename D>
struct MapsX<D, std::void_t<decltype(D::kXMap)>> : std::bool_constant<D::kXMap> {};

// The K row of x that slot column u of chunk c holds: the chunk's own rows
// in order, unless the decoder maps them
template <typename Decoder>
__device__ __forceinline__ size_t x_row(int c, int bk, int u) {
  if constexpr (MapsX<Decoder>::value)
    return static_cast<size_t>(Decoder::x_row(c, bk, u));
  else
    return static_cast<size_t>(c) * kChunk + u;
}

// A decoder's optional traits, with their defaults: slot word rows a chunk
// (32), words a column that a step reads (two a plane), and whether its B
// registers go through the warp's tile in shared memory (no)
template <typename D, typename = void>
struct WordRowsOf : std::integral_constant<int, kChunk / 8> {};
template <typename D>
struct WordRowsOf<D, std::void_t<decltype(D::kWordRows)>>
    : std::integral_constant<int, D::kWordRows> {};
template <typename D, typename = void>
struct StepWordsOf : std::integral_constant<int, 2 * D::kPlanes> {};
template <typename D>
struct StepWordsOf<D, std::void_t<decltype(D::kStepWords)>>
    : std::integral_constant<int, D::kStepWords> {};
template <typename D, typename = void>
struct TiledOf : std::false_type {};
template <typename D>
struct TiledOf<D, std::void_t<decltype(D::kTiled)>> : std::bool_constant<D::kTiled> {};

// What a decoder's traits make of the ring and the lane's reads
template <typename Decoder>
struct Geometry {
  static constexpr int kWordRows = WordRowsOf<Decoder>::value;    // slot word rows a chunk
  static constexpr int kStepWords = StepWordsOf<Decoder>::value;  // a column's words a step
  static constexpr bool kTiled = TiledOf<Decoder>::value;         // B through the tile
  static constexpr int kReads = kWordRows / 4;  // a lane's 16-byte reads a chunk: rows 4v + t
  static constexpr int kSlotBytes = kXBytes + kWordRows * kBlockN * 4;  // one chunk of the ring
  // the 4 warps' tiles: [32 columns][16 K rows] bf16 each
  static constexpr int kTileBytes = kTiled ? 16 * kBlockN * 2 : 0;
};

// Dynamic shared memory: the ring, then the decoder's table (its
// kTableWords words), then the warps' tiles, then ("repeat") a K block's P
// scale rows. The table sits at a fixed offset, so a lookup's address is
// its index plus a constant.
template <typename Decoder>
inline size_t smem_bytes(int scale_rows) {
  using Geo = Geometry<Decoder>;
  return static_cast<size_t>(2) * Geo::kSlotBytes +
         static_cast<size_t>(Decoder::kTableWords) * 4 + Geo::kTileBytes +
         static_cast<size_t>(scale_rows) * kBlockN * 2;
}

// The 16-byte unit of column n's unit u (K rows 8u .. 8u + 7) in a warp's
// tile ([32 columns][2 units]): the low 3 bits of its index XOR n's group
// (n / 4) mod 8, so that the 8 columns 4 g + e (g = 0..7) of a matrix meet 8
// different bank groups, whether the lanes store (stmatrix) or load
// (ldmatrix) it
__device__ __forceinline__ int tile_unit(int n, int u) { return (2 * n + u) ^ ((n >> 2) & 7); }

// four 8 x 8 b16 matrices from registers into shared memory, as ldmatrix
// reads them back (lane l's row address: matrix l / 8, row l % 8)
__device__ __forceinline__ void stmatrix_x4(void* p, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1,%2,%3,%4};\n" ::"r"(
                   mma::smem_u32(p)),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// The decoder of a block: one that keeps its table in shared memory
// (kTableWords > 0) is given the table's place to fill; the others are
// built from the Args alone.
template <typename Decoder>
__device__ __forceinline__ Decoder make_decoder(const Args& a, uint32_t* table) {
  if constexpr (Decoder::kTableWords > 0)
    return Decoder(a, table);
  else
    return Decoder(a);
}

template <typename Decoder, int SCALING>
__global__ void __launch_bounds__(kThreads, 4) lab_mma_kernel(const Args a) {
  using Geo = Geometry<Decoder>;
  constexpr int kPlanes = Decoder::kPlanes;
  constexpr int kProducts = Decoder::kProducts;
  constexpr int kSlotBytes = Geo::kSlotBytes;
  constexpr int kPlaneRows = Geo::kWordRows / kPlanes;  // a plane's word rows a chunk
  constexpr int kPlaneV = Geo::kReads / kPlanes;        // a plane's 16-byte reads a lane
  constexpr int kPlaneWords = Geo::kStepWords / kPlanes;  // a plane's words a column and step
  constexpr int kQ = kPlaneV / kPlaneWords;             // steps a field
  constexpr int kFields = kSteps / kQ;                  // fields a word
  // scaled per group: on the C fragment (a partial open) or in the B register
  constexpr bool kGrouped = SCALING == kGroupAcc || SCALING == kAffine || SCALING == kExpand;
  // the products go straight into the running sum
  constexpr bool kDirect = SCALING == kRepeat || SCALING == kExpand || SCALING == kNone;
  static_assert(kFields * kQ == kSteps && kQ * kPlaneWords == kPlaneV && kPlaneWords % 2 == 0 &&
                    kPlaneRows == 4 * kPlaneV && kFields * Decoder::kFieldBits == 16 * kPlaneWords,
                "a step's words hold one field of each of its 16 K rows' pairs");
  static_assert(!Geo::kTiled || kProducts == 1, "a tile holds one product's B registers");

  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t = lane & 3;
  const int g = lane >> 2;
  const int nb = blockIdx.x * kBlockN;  // the block's first column
  const int nw = nb + warp * 32;        // the warp's first column
  const int m0 = blockIdx.z * kRows;
  const int c0 = blockIdx.y * a.chunks_per_split;
  const int c_end = c0 + a.chunks_per_split;
  const int P = SCALING == kRepeat ? a.bk / a.g : 1;  // scale rows per K block
  const uint16_t* su = reinterpret_cast<const uint16_t*>(a.scales);
  uint32_t* table = reinterpret_cast<uint32_t*>(smem + 2 * kSlotBytes);  // the decoder's
  unsigned char* tiles = reinterpret_cast<unsigned char*>(table + Decoder::kTableWords);
  bf16* srows = reinterpret_cast<bf16*>(tiles + Geo::kTileBytes);  // "repeat": [P][kBlockN]
  // fills its table in shared memory, if it has one, before the first barrier
  const Decoder dec = make_decoder<Decoder>(a, table);

  // chunk c into ring slot s: x rows m0.., then the planes' words
  auto stage = [&](int c, int s) {
    bf16* xd = reinterpret_cast<bf16*>(smem + s * kSlotBytes);
    for (int idx = tid; idx < kRows * (kChunk / 8); idx += kThreads) {
      const int r = idx / (kChunk / 8);
      const int v = idx - r * (kChunk / 8);
      const bool ok = m0 + r < a.M;
      const bf16* src =
          ok ? a.x + static_cast<size_t>(m0 + r) * a.K + x_row<Decoder>(c, a.bk, 8 * v) : a.x;
      mma::cp_async16(xd + r * kXStride + 8 * v, src, ok);
    }
    uint32_t* wd = reinterpret_cast<uint32_t*>(smem + s * kSlotBytes + kXBytes);
    for (int idx = tid; idx < Geo::kWordRows * (kBlockN / 4); idx += kThreads) {
      const int j = idx / (kBlockN / 4);
      const int p = idx - j * (kBlockN / 4);
      const int n = nb + 4 * p;
      const uint32_t* plane = kPlanes == 2 && j >= kPlaneRows ? a.plane_b : a.plane;
      const int row = kPlanes == 1 ? j : j % kPlaneRows;  // the plane's word row of the chunk
      const uint32_t* src = plane + (static_cast<size_t>(c) * kPlaneRows + row) * a.N + n;
      uint32_t* dst = wd + j * kBlockN + 4 * (p ^ (2 * (j & 3)));
      if (a.vec_w) {
        mma::cp_async16(dst, n < a.N ? src : plane, n < a.N);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) cp_async4(dst + e, n + e < a.N ? src + e : plane, n + e < a.N);
      }
    }
    mma::cp_async_commit();
  };

  // "repeat": scale rows kb * P .. kb * P + P - 1 of the block's columns
  auto stage_rows = [&](int kb) {
    for (int idx = tid; idx < P * (kBlockN / 8); idx += kThreads) {
      const int r = idx / (kBlockN / 8);
      const int p = idx - r * (kBlockN / 8);
      const int n = nb + 8 * p;
      const bf16* src = a.scales + static_cast<size_t>(kb * P + r) * a.N + n;
      bf16* dst = srows + r * kBlockN + 8 * p;
      if (a.vec_s16) {
        mma::cp_async16(dst, n < a.N ? src : a.scales, n < a.N);
      } else {
        for (int e = 0; e < 8; ++e) dst[e] = n + e < a.N ? src[e] : __float2bfloat16_rn(0.f);
      }
    }
    mma::cp_async_commit();
  };

  // rows [r0, r1] of the scales into L2, the block's 128 columns (2 lines a row)
  auto prefetch_rows = [&](int r0, int r1) {
    for (int idx = tid; idx < 2 * (r1 - r0 + 1); idx += kThreads) {
      const int n = nb + 64 * (idx & 1);
      if (n < a.N) prefetch_l2(a.scales + static_cast<size_t>(r0 + (idx >> 1)) * a.N + n);
    }
  };

  float acc[4][4], part[4][4], xsum[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[e][i] = part[e][i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) xsum[i] = 0.f;

  // the open group: its index, its steps left, and this lane's scales of
  // it: 8 on the C fragment (columns nw + 8t + 0..3 and + 4..7), or
  // ("expand") 4 on the B fragment (columns nw + 4g + 0..3) with the next
  // group's 4 loaded a group ahead
  const int steps_per_group = a.g / 16;
  const int gi_end = c_end * (kChunk / 16) / steps_per_group;
  int gi = c0 * (kChunk / 16) / steps_per_group;
  int left = steps_per_group;
  uint2 sg[2], sn;
  uint32_t sb[4];
  if constexpr (SCALING == kGroupAcc || SCALING == kAffine) {
    sg[0] = mma::load_scales(su, gi, nw + 8 * t, a.N, a.vec_s);
    sg[1] = mma::load_scales(su, gi, nw + 8 * t + 4, a.N, a.vec_s);
  }
  if constexpr (SCALING == kExpand) {
    sg[0] = mma::load_scales(su, gi, nw + 4 * g, a.N, a.vec_s);
    sn = gi + 1 < gi_end ? mma::load_scales(su, gi + 1, nw + 4 * g, a.N, a.vec_s) : sg[0];
#pragma unroll
    for (int e = 0; e < 4; ++e) sb[e] = mma::scale2(sg[0], e);
  }

  stage(c0, 0);
  for (int c = c0; c < c_end; ++c) {
    const int s = (c - c0) & 1;
    mma::cp_async_wait<0>();
    __syncthreads();  // chunk c staged; every warp is done with chunk c - 1
    const bool new_block = SCALING == kRepeat && (c == c0 || (c * kChunk) % a.bk == 0);
    if (new_block) stage_rows(c * kChunk / a.bk);
    if (c + 1 < c_end) {
      stage(c + 1, s ^ 1);
      const int k1 = (c + 1) * kChunk;  // the next chunk's first K row
      if constexpr (SCALING == kRepeat) {
        if (k1 % a.bk == 0) prefetch_rows(k1 / a.bk * P, k1 / a.bk * P + P - 1);
      } else if constexpr (SCALING != kNone) {
        prefetch_rows(k1 / a.g, (k1 + kChunk - 1) / a.g);
      }
    }
    if (new_block) {  // the rows are in place before the first product
      if (c + 1 < c_end)
        mma::cp_async_wait<1>();
      else
        mma::cp_async_wait<0>();
      __syncthreads();
    }

    // this lane's words of the chunk: slot word rows 4v + t, plane v / kPlaneV
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(smem + s * kSlotBytes + kXBytes);
    uint4 wv[Geo::kReads];
#pragma unroll
    for (int v = 0; v < Geo::kReads; ++v)
      wv[v] = *reinterpret_cast<const uint4*>(ws + (4 * v + t) * kBlockN +
                                              4 * ((warp * 8 + g) ^ (2 * t)));
    const bf16* xb = reinterpret_cast<const bf16*>(smem + s * kSlotBytes);

#pragma unroll
    for (int i = 0; i < kFields; ++i) {
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int step = c * kSteps + kQ * i + q;  // K rows 16 step .. 16 step + 15
        uint32_t b[4][kProducts][2];
        // column e's words of the step, plane by plane: a plane's
        // kPlaneWords words from its reads kPlaneWords q ..
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t w[Geo::kStepWords];
#pragma unroll
          for (int p = 0; p < kPlanes; ++p) {
#pragma unroll
            for (int u = 0; u < kPlaneWords; u += 2) {
              w[kPlaneWords * p + u] = mma::word_of(wv[kPlaneV * p + kPlaneWords * q + u], e);
              w[kPlaneWords * p + u + 1] =
                  mma::word_of(wv[kPlaneV * p + kPlaneWords * q + u + 1], e);
            }
          }
          dec.pairs(w, i, b[e]);
        }
        if constexpr (Geo::kTiled) {
          // the B registers through the warp's tile: matrix (e, h) of the
          // step is columns 4 g + e (g = 0..7) at unit h, which lane l
          // addresses as matrix l / 8, row l % 8
          unsigned char* tile = tiles + warp * (Geo::kTileBytes / 4);  // this warp's
          const int n = 4 * (lane & 7) + (lane >> 3);
          __syncwarp();  // the warp has read the last step's tile
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t r[4] = {b[0][0][h], b[1][0][h], b[2][0][h], b[3][0][h]};
            stmatrix_x4(tile + 16 * tile_unit(n, h), r);
          }
          __syncwarp();  // the tile is written
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t r[4];
            mma::ldmatrix_x4(r, tile + 16 * tile_unit(n, h));
#pragma unroll
            for (int e = 0; e < 4; ++e) b[e][0][h] = r[e];
          }
        }
        if constexpr (SCALING == kRepeat) {
          // K rows 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1) of the step
          const int r0 = (16 * step + 2 * t) % P;
          const int r8 = (16 * step + 2 * t + 8) % P;
          const int r1 = r0 + 1 == P ? 0 : r0 + 1;
          const int r9 = r8 + 1 == P ? 0 : r8 + 1;
          const bf16* sc = srows + warp * 32 + 4 * g;
          const uint2 s0 = *reinterpret_cast<const uint2*>(sc + r0 * kBlockN);
          const uint2 s1 = *reinterpret_cast<const uint2*>(sc + r1 * kBlockN);
          const uint2 s8 = *reinterpret_cast<const uint2*>(sc + r8 * kBlockN);
          const uint2 s9 = *reinterpret_cast<const uint2*>(sc + r9 * kBlockN);
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int p = 0; p < kProducts; ++p) {
              b[e][p][0] = mma::Pack2<bf16>::mul(b[e][p][0], pair_of(s0, s1, e));
              b[e][p][1] = mma::Pack2<bf16>::mul(b[e][p][1], pair_of(s8, s9, e));
            }
        }
        if constexpr (SCALING == kExpand) {  // the open group's row, both halves
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int p = 0; p < kProducts; ++p) {
              b[e][p][0] = mma::Pack2<bf16>::mul(b[e][p][0], sb[e]);
              b[e][p][1] = mma::Pack2<bf16>::mul(b[e][p][1], sb[e]);
            }
        }
        uint32_t af[4];
        mma::ldmatrix_x4(af, xb + (lane & 15) * kXStride + 16 * (kQ * i + q) + 8 * (lane >> 4));
        if constexpr (kDirect) {
#pragma unroll
          for (int p = 0; p < kProducts; ++p)
#pragma unroll
            for (int e = 0; e < 4; ++e) mma::mma16816<bf16>(acc[e], af, b[e][p][0], b[e][p][1]);
        } else {  // plane A's products, then plane B's, into the open partial
#pragma unroll
          for (int p = 0; p < kProducts; ++p)
#pragma unroll
            for (int e = 0; e < 4; ++e) mma::mma16816<bf16>(part[e], af, b[e][p][0], b[e][p][1]);
          if constexpr (SCALING == kAffine) mma::mma16816<bf16>(xsum, af, kOnes, kOnes);
        }
        if constexpr (kGrouped) {
          if (--left == 0) {  // the group ends
            if constexpr (SCALING == kExpand) {  // the next group's scales, loaded a group ago
              left = steps_per_group;
              ++gi;
              sg[0] = sn;
#pragma unroll
              for (int e = 0; e < 4; ++e) sb[e] = mma::scale2(sg[0], e);
              if (gi + 1 < gi_end) sn = mma::load_scales(su, gi + 1, nw + 4 * g, a.N, a.vec_s);
            } else {  // its partial into the sum
#pragma unroll
              for (int e = 0; e < 4; ++e) {
#pragma unroll
                for (int i2 = 0; i2 < 4; ++i2) {
                  const float sv = bf16_bits(half_of(sg[i2 & 1], e));  // column 8t + 4(i2&1) + e
                  float term;
                  if constexpr (SCALING == kAffine) {
                    term = __fadd_rn(__fmul_rn(part[e][i2], __fmul_rn(sv, a.delta)),
                                     __fmul_rn(xsum[i2 & 2], __fmul_rn(sv, a.zero)));
                  } else {
                    term = __fmul_rn(part[e][i2], sv);
                  }
                  acc[e][i2] = __fadd_rn(acc[e][i2], term);
                  part[e][i2] = 0.f;
                }
              }
#pragma unroll
              for (int i2 = 0; i2 < 4; ++i2) xsum[i2] = 0.f;
              left = steps_per_group;
              if (++gi < gi_end) {  // the next group's scales, used when it ends
                sg[0] = mma::load_scales(su, gi, nw + 8 * t, a.N, a.vec_s);
                sg[1] = mma::load_scales(su, gi, nw + 8 * t + 4, a.N, a.vec_s);
              }
            }
          }
        }
      }
    }
  }

  // c0, c1: row g, n-slots 2t, 2t+1; c2, c3: row g + 8. Tile e's n-slot k
  // is column 4k + e of the warp's 32.
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + g + 8 * (i >> 1);
      const int n = nw + 4 * (2 * t + (i & 1)) + e;
      if (m < a.M && n < a.N) {
        const size_t o = static_cast<size_t>(m) * a.N + n;
        if (a.work != nullptr)
          a.work[static_cast<size_t>(blockIdx.y) * a.M * a.N + o] = acc[e][i];
        else
          a.y[o] = __float2bfloat16_rn(acc[e][i]);
      }
    }
  }
}

// Whether the loop takes group size g: a k16 step lies inside one group
// only where 16 divides g. The C entries run their SIMT kernel otherwise.
inline bool takes(int g) { return g > 0 && g % 16 == 0; }

inline int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// K rows between two possible split points: lcm(chunk, g)
inline int split_unit(int g) { return kChunk / gcd(kChunk, g) * g; }

// A C entry's operands as Args. False where the loop cannot take them: g
// not a multiple of 16, K not a multiple of lcm(chunk, g), splits not
// dividing K's units, more than one split without a workspace, x not
// 16-byte aligned; with a bk ("repeat"), bk not a multiple of the chunk and
// of g or not dividing K.
// plane_b and table_b are plane B's and its table (two planes), or null.
inline bool make_args(Args& a, const void* x, const void* plane, const void* plane_b,
                      const void* scales, const void* table, const void* table_b, void* y,
                      void* work, int M, int N, int K, int g, int bk, int splits, float zero,
                      float delta) {
  if (M <= 0 || N <= 0 || K <= 0 || !takes(g) || K % split_unit(g) || splits < 1 ||
      (K / split_unit(g)) % splits || (splits > 1 && work == nullptr) ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return false;
  if (bk != 0 && (bk < 0 || bk % kChunk || bk % g || K % bk)) return false;
  const uintptr_t pp = reinterpret_cast<uintptr_t>(plane) | reinterpret_cast<uintptr_t>(plane_b);
  const uintptr_t sp = reinterpret_cast<uintptr_t>(scales);
  a = Args{static_cast<const bf16*>(x),
           static_cast<const uint32_t*>(plane),
           static_cast<const uint32_t*>(plane_b),
           static_cast<const bf16*>(scales),
           static_cast<const float*>(table),
           static_cast<const float*>(table_b),
           static_cast<bf16*>(y),
           splits > 1 ? static_cast<float*>(work) : nullptr,
           M, N, K, g, bk, K / kChunk / splits,
           zero, delta,
           N % 4 == 0 && pp % 16 == 0,
           N % 4 == 0 && sp % 8 == 0,
           N % 8 == 0 && sp % 16 == 0};
  return true;
}

// The loop's dynamic shared memory for these Args, with the kernel's
// attributes set to allow it. Returns the first error.
template <typename Decoder, int SCALING>
cudaError_t prepare(int bk, int g, size_t* smem) {
  auto kernel = lab_mma_kernel<Decoder, SCALING>;
  *smem = smem_bytes<Decoder>(SCALING == kRepeat ? bk / g : 0);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(*smem));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Launches the loop on a grid (N / 128, splits, M / 16) and, with more than
// one split, the reduction. Returns the first launch error.
template <typename Decoder, int SCALING>
cudaError_t run(const Args& a, int splits, cudaStream_t stream) {
  size_t smem;
  cudaError_t e = prepare<Decoder, SCALING>(a.bk, a.g, &smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.N + kBlockN - 1) / kBlockN, splits, (a.M + kRows - 1) / kRows);
  lab_mma_kernel<Decoder, SCALING><<<grid, kThreads, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const size_t mn = static_cast<size_t>(a.M) * a.N;
  mma::split_reduce_kernel<bf16><<<static_cast<unsigned>((mn + 255) / 256), 256, 0, stream>>>(
      a.work, a.y, mn, splits);
  return cudaGetLastError();
}

// One instantiation of the loop as the C entries report it: its decoder's
// name (as the ptxas log's mangled name reads), its Scaling, and its blocks
// per SM and dynamic shared memory at a K block bk and group size g.
struct Instance {
  const char* decoder;
  int scaling;
  cudaError_t (*occupancy)(int bk, int g, int* blocks, int* smem);
};

template <typename Decoder, int SCALING>
cudaError_t occupancy(int bk, int g, int* blocks, int* smem) {
  size_t bytes;
  cudaError_t e = prepare<Decoder, SCALING>(bk, g, &bytes);
  if (e != cudaSuccess) return e;
  *smem = static_cast<int>(bytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, lab_mma_kernel<Decoder, SCALING>,
                                                       kThreads, bytes);
}

template <typename Decoder, int SCALING>
constexpr Instance instance(const char* decoder) {
  return Instance{decoder, SCALING, occupancy<Decoder, SCALING>};
}

// Instance i of a C entry's list (n of them): its decoder's name, Scaling,
// blocks per SM and shared-memory bytes at bk and g. Returns the first
// error, cudaErrorInvalidValue for an i out of range.
inline int report(const Instance* list, int n, int i, int bk, int g, const char** decoder,
                  int* scaling, int* blocks, int* smem) {
  if (i < 0 || i >= n || bk <= 0 || g <= 0 || bk % g) return cudaErrorInvalidValue;
  *decoder = list[i].decoder;
  *scaling = list[i].scaling;
  return list[i].occupancy(bk, g, blocks, smem);
}

}  // namespace labmma
}  // namespace flute
