// The second half of the Hopper kernel lab (sm_90a): L7-L12, the six design
// experiments of scripts/kernel_lab2.py, with one C entry per TPU function:
//
//   flute_lab2_vmembw      <- run_vmembw      (pallas_call scripts/kernel_lab2.py:72)
//   flute_lab2_pfdirect    <- run_pfdirect    (:135)
//   flute_lab2_sep         <- run_sep         (:234; one_mm 0 = sep, 1 = sep1)
//   flute_lab2_int4        <- run_int4        (:290)
//   flute_lab2_slabstream  <- run_slabstream  (:483)
//   flute_lab2_w3wide      <- run_w3wide      (:585)
//
// L8-L12: y[M, N] = bf16(sum over groups of (x_g @ W_g) * s_g), bf16 x,
// scales [K/g, N] and y, f32 sums (the TPU's group_acc), W in the plane's
// pair order (pltpu.bitcast of the payload puts the even value on K row 2p,
// the odd on 2p + 1). What each TPU kernel computes was derived by running
// it in the Pallas interpreter with the v5e's mod-8 gather wrap modelled;
// the plain versions in flute_tpu_torch/lab/ops2.py define it:
//
//   pfdirect, slabstream: W = round(T[c]) of one 4-bit plane [K/8, N] (word
//     row c*32 + j, byte i: pair row c*128 + i*32 + j) and 16 entries. The
//     index comes straight from the byte f, with no ce/co split: the even
//     value is entry f & 7 of the half that bit 3 selects, the odd entry
//     (f >> 4) & 7 of the half that bit 7 selects. pfdirect builds the
//     dequantized operand (the payload ge | go) in memory before its
//     products, as the TPU builds the whole tile; slabstream feeds each
//     decoded pair straight into its products, in registers. On the
//     tensor-core loop that second design is the loop itself: each field
//     becomes an mma B register with no tile between, so slabstream runs
//     it with the fastest decoder measured for this function, FLUTE's pair
//     table in shared memory, whose entry f is (T[f & 15], T[f >> 4]): one
//     256-entry lookup from the raw field where the TPU needs two 8-entry
//     gathers and selects. That decoder and its scaling are L5 g8_rs
//     group_acc's (kernel_lab.cu): one instantiation, one source
//     (lab_decoders.cuh), the same bits. pfdirect runs the same pair table
//     (in 2 copies, not 4) and scaling, but a warp stores each step's B
//     registers (16 K rows of its 32 columns) to a tile in shared memory
//     (stmatrix) and reads them back (ldmatrix) before the products
//     (PairTileDecoder): the round trip that a wgmma kernel taking its
//     weight operand from shared memory makes. The products run in
//     slabstream's order, so the bits are slabstream's; the time is its
//     time plus the round trip, at 4 blocks an SM as slabstream.
//   sep: T[c] = A[c & 3] + B[c >> 2] over two 2-bit planes [K/16, N] (fields
//     ce | co << 2, 8 per word, word row c*16 + j, field i: pair row
//     c*128 + i*16 + j) and two 4-entry tables held in registers. sep: the
//     two products summed in f32; sep1: one product on round(A + B), the sum
//     rounded to bf16 as the TPU's bf16 add rounds it.
//   int4: no table, W = float(c), exact. Per group (x_g @ c_g) * (s * delta)
//     + (sum of x_g) * (s * zero), each product rounded on its own (no
//     contraction into an FMA).
//   w3wide: W = round(T3[c]) from the wide 3-bit layout (K3's field decode,
//     csrc/lut_gemm_w3wide.cu: straddling fields read from one 64-bit value)
//     and 8 entries: the even value T3[f & 7] of the raw 6-bit field (the
//     v5e wraps the gather index), the odd T3[f >> 3]. On the tensor-core
//     loop (W3PairDecoder) a chunk stages 24 word rows where the 4-bit
//     plane has 32, and each B register is one funnel shift, one and-or and
//     one ld.shared of a 64-entry pair table.
//
// L7, vmembw: v <- v ^ (v >> 1) (arithmetic shift) nops times on int32, one
// thread per element; nops is a run-time argument, so the chain cannot fold.
//
// Numerics: the SIMT kernels take IEEE f32 FMAs, no flush to zero (never
// --use_fast_math). Per pair acc += (x_2p * W_2p + x_2p+1 * W_2p+1) * s: the
// TPU's (x_g @ W_g) * s_g in another f32 order. pfdirect, sep, int4,
// slabstream and w3wide on the tensor-core loop sum each k16 step in the
// tensor core's f32 and scale a group's partial once (lab_mma.cuh); sep adds plane A's and plane B's
// products into the partial by two mma, as the TPU adds its two dots, where
// the plain version sums A + B first. With x the identity every output is
// one product (sep: A + B, exact in f32 for the lab's tables), so the
// kernels give the plain versions bit for bit (the sign of a zero aside).
//
// What bounds them: bytes. At the lab's shape (M 16, N 28672, K 8192) the
// planes are 117 MB (88 MB for w3wide) and the rest 8.5 MB, about 37.6 us
// (28.8 us) at 3.35 TB/s; 2*M*N*K at the bf16 tensor rate is 7.6 us (sep's
// two products 15.2). L7's 4.2 MB stay in the 50 MB L2, so it measures the
// launch and the ALU chain.
//
// Two designs. pfdirect, sep, int4, slabstream and w3wide, at a group size
// that is a multiple of 16, run the lab's tensor-core loop (lab_mma.cuh,
// with the decoders below or PairTableDecoder<4> of lab_decoders.cuh): plane
// words and x staged per chunk in a cp.async ring (sep's two 2-bit planes
// in one slot, plane A's 16 word rows then plane B's; w3wide's 24 word
// rows), each field turned into mma.sync B registers (int4: two exact bf16
// codes by the magic exponent, 0x4300 | c is 128 + c, minus 128 exact in
// bf16; sep: one prmt a register from its 4-entry table; slabstream and
// pfdirect: one ld.shared a register from the pair table, pfdirect's
// through a tile in shared memory; w3wide: a funnel shift and one
// ld.shared), the group's products (and int4's x sums, one more mma
// against a B of ones) in f32 partials scaled on the C fragment when the
// group ends; split-K at multiples of lcm(256, g), reduced in split order.
// What bounds the loop is its staging (L1 floor, kernel_lab.cu, measures
// it) plus its decode instructions a B register, not the bytes alone.
// vmembw, and the five at any other (even) group size, run the SIMT
// kernel below on K1's first skeleton (csrc/lut_gemm_common.cuh), as L1-L6 do: one lane per
// output column (32 columns per block), eight warps splitting each pack
// chunk's words, the block's 16 rows of x for one chunk staged in shared
// memory as f32, fixed-order warp sums, no atomics. No result depends on the
// TPU's block_k, so x is staged per 256-row chunk (16 KB) and each warp
// loads all of its words of a chunk (3 or 4) before it decodes any; int4's x
// sums are formed once per block, chunk and group in shared memory, not
// once per column.

#include "lab_decoders.cuh"
#include "lab_mma.cuh"
#include "lut_gemm_common.cuh"

namespace {

using namespace flute;
using bf16 = __nv_bfloat16;

constexpr int kBM = 16;                  // rows of M per block
constexpr int kChunk = 256;              // the lab's pack chunk
constexpr int kChunkPairs = kChunk / 2;  // pair rows per chunk
constexpr int kMaxGroups = kChunk / 2 + 1;  // groups a chunk can touch (g >= 2)

enum Mode { kPfdirect, kSlabstream, kSep, kSep1, kInt4, kW3wide };

// L11's pair table: 4 copies beside group_acc, as L5 g8_rs group_acc takes
using SlabstreamDecoder = labmma::PairTableDecoder<4>;

// L8 on the tensor-core loop: L11's pair table and scaling, with the
// operand built in shared memory first, as the TPU kernel builds its tile.
// Each step's B registers (16 K rows of the warp's 32 columns) are stored
// to the warp's 1 KB tile by stmatrix and read back by ldmatrix before its
// products, which run in L11's order into L11's partial: the same bits.
// What holds it is shared memory: 4 blocks an SM need at most 57 344 B (the
// runtime keeps 1 KB a block), and the ring takes 49 664, so the table
// keeps 2 copies (L5 repeat's, 2 KB) and the tiles 4 KB. A field's tile
// (16 KB a block) left 3 blocks an SM and was slower.
struct PairTileDecoder : labmma::PairTableDecoder<2> {
  static constexpr bool kTiled = true;

  __device__ PairTileDecoder(const labmma::Args& a, uint32_t* t)
      : labmma::PairTableDecoder<2>(a, t) {}
};

// L12 on the tensor-core loop: the wide 3-bit layout (pack_w3_wide, which the
// served K3 decodes: csrc/lut_gemm_w3wide.cu). A chunk has 24 word rows, 8
// triples stored planar: rows t, 8 + t and 16 + t are triple t, 16 six-bit
// fields ce | co << 3 read as one 96-bit number, field j being pair row
// 8 j + t, K rows 16 j + 2t and 16 j + 2t + 1. So step j of a chunk is field
// j of triples t (k-slots 2t, 2t + 1) and t + 4 (2t + 8, 2t + 9): a lane
// reads slot rows 4v + t, v < 6 (w[v]: triple t's words at v = 0, 2, 4,
// triple t + 4's at 1, 3, 5), and the 6 words are a step's whole B
// fragment, 16 steps a chunk with no x map. A field is one funnel shift of
// two words (fields 5 and 10 cross a word boundary) and an and-or, then
// one ld.shared of a 64-entry pair table, entry f = (bf16(T3[f & 7]),
// bf16(T3[f >> 3])) (the v5e wraps the raw even index mod 8), in 8
// bank-interleaved copies (2 KB: the ring is 41.5 KB, so 4 blocks an SM).
struct W3PairDecoder {
  static constexpr int kPlanes = 1, kFieldBits = 6, kProducts = 1;
  static constexpr int kWordRows = 24;  // 8 triples of words a chunk
  static constexpr int kStepWords = 6;  // triples t and t + 4
  static constexpr int kCopies = 8;
  static constexpr int kTableWords = 64 * kCopies;
  static constexpr int kShift = 5;  // log2(4 kCopies): entry f at byte f << kShift
  const unsigned char* tab;  // the table
  uint32_t copy;             // this lane's copy, in bytes

  __device__ W3PairDecoder(const labmma::Args& a, uint32_t* t)
      : tab(reinterpret_cast<const unsigned char*>(t)), copy(4u * (threadIdx.x % kCopies)) {
    for (int idx = threadIdx.x; idx < kTableWords; idx += labmma::kThreads) {
      const int f = idx / kCopies;
      t[idx] = labmma::table_bits(a.table, f & 7) | (labmma::table_bits(a.table, f >> 3) << 16);
    }
  }

  // the entry of field i (bits 6i .. 6i + 5) of the triple (w0, w1, w2): the
  // field shifted to bits kShift .. kShift + 5 (i is a constant once the
  // loop is unrolled, so every shift is too)
  __device__ __forceinline__ uint32_t lookup(uint32_t w0, uint32_t w1, uint32_t w2, int i) const {
    const int p = 6 * i - kShift;  // the triple's bit that lands on bit 0
    const uint32_t words[4] = {w0, w1, w2, 0u};
    const uint32_t v = p < 0 ? w0 << -p : __funnelshift_r(words[p / 32], words[p / 32 + 1], p % 32);
    return *reinterpret_cast<const uint32_t*>(tab + ((v & (63u << kShift)) | copy));
  }

  __device__ __forceinline__ void pairs(const uint32_t (&w)[6], int i,
                                        uint32_t (&b)[1][2]) const {
    b[0][0] = lookup(w[0], w[2], w[4], i);
    b[0][1] = lookup(w[1], w[3], w[5], i);
  }
};

__device__ __forceinline__ float rnd(float v) { return Cvt<bf16>::round(v); }

// L10 on the tensor-core loop: a field ce | co << 4 as (bf16(ce), bf16(co)),
// exact, with no table: 0x4300 | c is the bf16 128 + c, and 128 + c - 128
// rounds to c exactly.
struct Int4Decoder {
  static constexpr int kPlanes = 1, kFieldBits = 8, kProducts = 1;
  static constexpr int kTableWords = 0;  // no table

  __device__ explicit Int4Decoder(const labmma::Args&) {}

  static __device__ __forceinline__ uint32_t pair(uint32_t w, int i) {
    const uint32_t f = w >> (8 * i);
    const uint32_t v = (f & 0xFu) | ((f << 12) & 0xF0000u) | 0x43004300u;
    const __nv_bfloat162 c = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                     __floats2bfloat162_rn(128.f, 128.f));
    return *reinterpret_cast<const uint32_t*>(&c);
  }

  // byte i of w[0] and of w[1] (ce | co << 4 each) as (bf16(ce), bf16(co))
  __device__ __forceinline__ void pairs(const uint32_t (&w)[2], int i,
                                        uint32_t (&b)[1][2]) const {
    b[0][0] = pair(w[0], i);
    b[0][1] = pair(w[1], i);
  }
};

// L9 on the tensor-core loop: two 2-bit planes, each field a nibble
// ce | co << 2, and two 4-entry tables, each rounded to bf16 and held in two
// registers (entry c in bytes 2c, 2c + 1), so one prmt looks up both values
// of a B register. The selector of a nibble f: v = ce | co << 8 is
// (f | f << 6) & 0x303, and v * 0x22 + 0x1010 has the nibbles 2ce, 2ce + 1,
// 2co, 2co + 1. The nibbles of two words are taken together, one in each
// half of a register: about 4 instructions a B register. ONE: "sep1", one
// product on the bf16 sum A + B (__hadd2, RN, the TPU's bf16 add); else
// "sep", plane A's and plane B's products, two mma into one partial.
template <bool ONE>
struct SepDecoder {
  static constexpr int kPlanes = 2, kFieldBits = 4, kProducts = ONE ? 1 : 2;
  static constexpr int kTableWords = 0;  // the tables in registers
  uint32_t ta[2], tb[2];  // A's and B's bf16 entries (0, 1) and (2, 3)

  static __device__ uint32_t entries(const float* t, int c) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(__ldg(t + c)))) |
           static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(__ldg(t + c + 1))))
               << 16;
  }

  __device__ explicit SepDecoder(const labmma::Args& a) {
    ta[0] = entries(a.table, 0);
    ta[1] = entries(a.table, 2);
    tb[0] = entries(a.table_b, 0);
    tb[1] = entries(a.table_b, 2);
  }

  // nibble i of wa and of wb as (T[ce], T[co]) each, T in t
  static __device__ __forceinline__ void lookup(uint32_t wa, uint32_t wb, int i,
                                                const uint32_t (&t)[2], uint32_t& ra,
                                                uint32_t& rb) {
    // the byte holding nibble i of wa in bits 0-7, of wb in bits 16-23
    uint32_t x = __byte_perm(wa, wb, (i >> 1) | ((4 + (i >> 1)) << 8));
    if (i & 1) x >>= 4;
    const uint32_t v = ((x & 0x000F000Fu) * 0x41u) & 0x03030303u;  // ce | co << 8, per half
    const uint32_t sel = v * 0x22u + 0x10101010u;
    ra = __byte_perm(t[0], t[1], sel);
    rb = __byte_perm(t[0], t[1], sel >> 16);
  }

  // nibble i of plane A's words w[0], w[1] and plane B's w[2], w[3]
  __device__ __forceinline__ void pairs(const uint32_t (&w)[4], int i,
                                        uint32_t (&b)[kProducts][2]) const {
    uint32_t a0, a1, b0, b1;
    lookup(w[0], w[1], i, ta, a0, a1);
    lookup(w[2], w[3], i, tb, b0, b1);
    if constexpr (ONE) {
      b[0][0] = add(a0, b0);
      b[0][1] = add(a1, b1);
    } else {
      b[0][0] = a0;
      b[0][1] = a1;
      b[1][0] = b0;
      b[1][1] = b1;
    }
  }

  static __device__ __forceinline__ uint32_t add(uint32_t p, uint32_t q) {
    const __nv_bfloat162 v = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&p),
                                     *reinterpret_cast<const __nv_bfloat162*>(&q));
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

__device__ __forceinline__ float scale_at(const bf16* __restrict__ s, long long row, int N, int n) {
  return __bfloat162float(s[row * N + n]);
}

// acc[r] += (x[r, k0] * we + x[r, k0 + 1] * wo) * s, all in f32 (k0 even:
// an aligned float2 of the staged chunk)
__device__ __forceinline__ void fma_pair_scaled(float (&acc)[kBM], const float* xs, int k0,
                                                float we, float wo, float s) {
#pragma unroll
  for (int r = 0; r < kBM; ++r) {
    const float2 xv = *reinterpret_cast<const float2*>(xs + r * kChunk + k0);
    acc[r] = fmaf(fmaf(xv.y, wo, xv.x * we), s, acc[r]);
  }
}

// L8/L11's lookup from the raw byte f: each half of the table chosen by a
// high bit of its field, the entry by the low three bits
__device__ __forceinline__ void lookup_raw(const float* tab, uint32_t f, float& we, float& wo) {
  const float* he = (f & 8u) ? tab + 8 : tab;
  const float* ho = (f & 128u) ? tab + 8 : tab;
  we = he[f & 7u];
  wo = ho[(f >> 4) & 7u];
}

// entry c (0..3) of a 4-entry table held in registers
__device__ __forceinline__ float pick4(uint32_t c, const float (&v)[4]) {
  return (c & 2u) ? ((c & 1u) ? v[3] : v[2]) : ((c & 1u) ? v[1] : v[0]);
}

// int4: xsum[r * kMaxGroups + gl] = the sum of x[r, k] over the staged
// chunk's K rows of its gl-th group, in a fixed order
__device__ __forceinline__ void group_sums(float* xsum, const float* xs, long long kbase, int g) {
  const long long first = kbase / g;
  const int ngl = static_cast<int>((kbase + kChunk - 1) / g - first) + 1;
  for (int t = threadIdx.x; t < kBM * ngl; t += kThreads) {
    const int r = t / ngl;
    const int gl = t - r * ngl;
    const long long start = (first + gl) * g - kbase, end = (first + gl + 1) * g - kbase;
    const int lo = start > 0 ? static_cast<int>(start) : 0;
    const int hi = end < kChunk ? static_cast<int>(end) : kChunk;
    float sum = 0.f;
    for (int k = lo; k < hi; ++k) sum = __fadd_rn(sum, xs[r * kChunk + k]);
    xsum[r * kMaxGroups + gl] = sum;
  }
}

// Dynamic shared memory of a block: the staged x chunk (the warps' partial
// sums reuse it at the end), then L8's payload tile or int4's group sums.
constexpr size_t smem_bytes(int mode) {
  return sizeof(float) * (kBM * kChunk + (mode == kPfdirect ? kChunkPairs * kBlockN
                                          : mode == kInt4  ? kBM * kMaxGroups
                                                           : 0));
}
static_assert(kBM * kChunk >= kWarps * kBM * kBlockN, "the reduction must fit the x tile");

template <int MODE>
__global__ void __launch_bounds__(kThreads)
lab2_kernel(const bf16* __restrict__ x, const uint32_t* __restrict__ plane,
            const uint32_t* __restrict__ plane_b, const bf16* __restrict__ scales,
            const float* __restrict__ table, const float* __restrict__ table_b,
            bf16* __restrict__ y, int M, int N, int K, int g, float zero, float delta) {
  extern __shared__ float smem[];
  __shared__ float tab[16];
  float* extra = smem + kBM * kChunk;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kBlockN + lane;
  const int m0 = blockIdx.y * kBM;
  const bool col_ok = n < N;
  constexpr int kEntries = (MODE == kPfdirect || MODE == kSlabstream) ? 16
                           : MODE == kW3wide                          ? 8
                                                                      : 0;
  if (static_cast<int>(threadIdx.x) < kEntries) tab[threadIdx.x] = rnd(table[threadIdx.x]);
  float ta[4], tb[4];  // sep's A and B, rounded, in registers
  if (MODE == kSep || MODE == kSep1) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ta[e] = rnd(table[e]);
      tb[e] = rnd(table_b[e]);
    }
  }

  float acc[kBM];
#pragma unroll
  for (int r = 0; r < kBM; ++r) acc[r] = 0.f;

  for (int c = 0; c < K / kChunk; ++c) {
    __syncthreads();  // the previous chunk's tiles are no longer read
    const long long kbase = static_cast<long long>(c) * kChunk;
    stage_x<bf16, kBM>(smem, x, M, K, m0, kbase, kChunk);
    if (MODE == kInt4) {
      __syncthreads();
      group_sums(extra, smem, kbase, g);
    }
    __syncthreads();

    if (MODE == kW3wide) {
      if (!col_ok) continue;
      // one word triple per warp: triple t = warp of the chunk's 8
      const uint32_t* words = plane + c * 24LL * N + n;
      const uint64_t lo =
          static_cast<uint64_t>(__ldg(words + static_cast<long long>(warp) * N)) |
          static_cast<uint64_t>(__ldg(words + static_cast<long long>(8 + warp) * N)) << 32;
      const uint64_t hi = __ldg(words + static_cast<long long>(16 + warp) * N);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int bit = 6 * j;
        uint32_t f;
        if (bit + 6 <= 64) {
          f = static_cast<uint32_t>(lo >> bit) & 0x3Fu;
        } else if (bit >= 64) {
          f = static_cast<uint32_t>(hi >> (bit - 64)) & 0x3Fu;
        } else {  // field 10: four bits from the second word, two from the third
          f = static_cast<uint32_t>((lo >> bit) | (hi << (64 - bit))) & 0x3Fu;
        }
        const int k0 = 2 * (j * 8 + warp);
        fma_pair_scaled(acc, smem, k0, tab[f & 7u], tab[f >> 3],
                        scale_at(scales, (kbase + k0) / g, N, n));
      }
    } else if (MODE == kSep || MODE == kSep1) {
      if (!col_ok) continue;
      // word rows warp and warp + 8 of both 2-bit planes
      uint32_t wa[2], wb[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const long long row = c * 16LL + warp + kWarps * u;
        wa[u] = __ldg(plane + row * N + n);
        wb[u] = __ldg(plane_b + row * N + n);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const uint32_t fa = (wa[u] >> (4 * i)) & 15u;
          const uint32_t fb = (wb[u] >> (4 * i)) & 15u;
          const float ae = pick4(fa & 3u, ta), ao = pick4(fa >> 2, ta);
          const float be = pick4(fb & 3u, tb), bo = pick4(fb >> 2, tb);
          const int k0 = 2 * (i * 16 + warp + kWarps * u);
          const float s = scale_at(scales, (kbase + k0) / g, N, n);
          if (MODE == kSep1) {
            fma_pair_scaled(acc, smem, k0, rnd(__fadd_rn(ae, be)), rnd(__fadd_rn(ao, bo)), s);
          } else {
#pragma unroll
            for (int r = 0; r < kBM; ++r) {  // the two products' terms, then the scale
              const float2 xv = *reinterpret_cast<const float2*>(smem + r * kChunk + k0);
              const float part = fmaf(xv.y, bo, fmaf(xv.x, be, fmaf(xv.y, ao, xv.x * ae)));
              acc[r] = fmaf(part, s, acc[r]);
            }
          }
        }
      }
    } else {
      // one 4-bit plane: word rows warp + 8u of the chunk's 32, all four
      // loaded before any is decoded
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (col_ok) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          w[u] = __ldg(plane + (c * 32LL + warp + kWarps * u) * N + n);
      }
      if (MODE == kPfdirect) {
        // the chunk's operand as payload words (even | odd << 16) in shared
        // memory, [pair row][column], before any product
        uint32_t* deq = reinterpret_cast<uint32_t*>(extra);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float we, wo;
            lookup_raw(tab, (w[u] >> (8 * i)) & 0xFFu, we, wo);
            deq[(i * 32 + warp + kWarps * u) * kBlockN + lane] =
                (__float_as_uint(we) >> 16) | (__float_as_uint(wo) & 0xFFFF0000u);
          }
        }
        __syncthreads();
        if (!col_ok) continue;
        for (int q = 0; q < kChunkPairs / kWarps; ++q) {  // warp w: pair rows 16w..16w+15
          const int p = warp * (kChunkPairs / kWarps) + q;
          const uint32_t pay = deq[p * kBlockN + lane];
          fma_pair_scaled(acc, smem, 2 * p, __uint_as_float(pay << 16),
                          __uint_as_float(pay & 0xFFFF0000u),
                          scale_at(scales, (kbase + 2 * p) / g, N, n));
        }
      } else if (MODE == kSlabstream) {
        if (!col_ok) continue;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float we, wo;
            lookup_raw(tab, (w[u] >> (8 * i)) & 0xFFu, we, wo);
            const int k0 = 2 * (i * 32 + warp + kWarps * u);
            fma_pair_scaled(acc, smem, k0, we, wo, scale_at(scales, (kbase + k0) / g, N, n));
          }
        }
      } else {  // kInt4
        if (!col_ok) continue;
        // p = x_g @ c_g over this warp's pairs of a group, then one rounded
        // product with s * delta each time the group changes
        float part[kBM];
#pragma unroll
        for (int r = 0; r < kBM; ++r) part[r] = 0.f;
        long long cur = kbase / g;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const uint32_t f = (w[u] >> (8 * i)) & 0xFFu;
            const int k0 = 2 * (i * 32 + warp + kWarps * u);
            const long long grp = (kbase + k0) / g;
            if (grp != cur) {
              const float sd = __fmul_rn(scale_at(scales, cur, N, n), delta);
#pragma unroll
              for (int r = 0; r < kBM; ++r) {
                acc[r] = __fadd_rn(acc[r], __fmul_rn(part[r], sd));
                part[r] = 0.f;
              }
              cur = grp;
            }
            const float ce = static_cast<float>(f & 15u), co = static_cast<float>(f >> 4);
#pragma unroll
            for (int r = 0; r < kBM; ++r) {
              const float2 xv = *reinterpret_cast<const float2*>(smem + r * kChunk + k0);
              part[r] = fmaf(xv.y, co, fmaf(xv.x, ce, part[r]));
            }
          }
        }
        const float sd = __fmul_rn(scale_at(scales, cur, N, n), delta);
#pragma unroll
        for (int r = 0; r < kBM; ++r) acc[r] = __fadd_rn(acc[r], __fmul_rn(part[r], sd));
        // (sum of x_g) * (s * zero): the chunk's groups split among the warps
        const long long first = kbase / g;
        const int ngl = static_cast<int>((kbase + kChunk - 1) / g - first) + 1;
        for (int gl = warp; gl < ngl; gl += kWarps) {
          const float sz = __fmul_rn(scale_at(scales, first + gl, N, n), zero);
#pragma unroll
          for (int r = 0; r < kBM; ++r)
            acc[r] = __fadd_rn(acc[r], __fmul_rn(extra[r * kMaxGroups + gl], sz));
        }
      }
    }
  }

  reduce_store<bf16, kBM>(smem, acc, y, M, N, m0);
}

template <int MODE>
int launch(const void* x, const void* plane, const void* plane_b, const void* scales,
           const void* table, const void* table_b, void* y, int M, int N, int K, int g,
           float zero, float delta, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % kChunk || g <= 0 || g % 2 || K % g)
    return cudaErrorInvalidValue;
  const dim3 grid((N + kBlockN - 1) / kBlockN, (M + kBM - 1) / kBM);
  lab2_kernel<MODE><<<grid, kThreads, smem_bytes(MODE), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const uint32_t*>(plane),
      static_cast<const uint32_t*>(plane_b), static_cast<const bf16*>(scales),
      static_cast<const float*>(table), static_cast<const float*>(table_b),
      static_cast<bf16*>(y), M, N, K, g, zero, delta);
  return cudaGetLastError();
}

// One plane and one table on the tensor-core loop with Decoder where 16
// divides g (`splits` splits of K at multiples of lcm(256, g), `work` an
// f32 [splits, M, N] workspace, or null with one split), else the SIMT
// kernel MODE (one split, no workspace).
template <typename Decoder, int MODE>
int table_gemm(const void* x, const void* plane, const void* scales, const void* table, void* y,
               void* work, int M, int N, int K, int g, int splits, void* stream) {
  if (!labmma::takes(g)) {
    if (splits != 1) return cudaErrorInvalidValue;
    return launch<MODE>(x, plane, nullptr, scales, table, nullptr, y, M, N, K, g, 0.f, 0.f,
                        stream);
  }
  labmma::Args a;
  if (!labmma::make_args(a, x, plane, nullptr, scales, table, nullptr, y, work, M, N, K, g, 0,
                         splits, 0.f, 0.f))
    return cudaErrorInvalidValue;
  return labmma::run<Decoder, labmma::kGroupAcc>(a, splits, static_cast<cudaStream_t>(stream));
}

__global__ void __launch_bounds__(kThreads)
vmembw_kernel(const int* __restrict__ w, int* __restrict__ out, int n, int nops) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  int v = w[i];
  for (int t = 0; t < nops; ++t) v = v ^ (v >> 1);  // a dependent chain, 2 ops a step
  out[i] = v;
}

}  // namespace

// All pointers are device pointers: x [M, K], scales [K/g, N] and y [M, N]
// bf16; planes int32 (4-bit [K/8, N], 2-bit [K/16, N], wide 3-bit
// [3K/32, N]); tables float32 (16, 4 + 4 or 8 entries). Each kernel runs on
// `stream` and is not synchronised. Returns the cudaError_t of the launch.
extern "C" int flute_lab2_vmembw(const void* w, void* out, int n, int nops, void* stream) {
  if (n < 0 || nops < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  vmembw_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(w), static_cast<int*>(out), n, nops);
  return cudaGetLastError();
}

// A g that is a multiple of 16 runs the tensor-core loop (L11's pair table,
// the operand through shared memory a step at a time; `splits` splits of K
// at multiples of lcm(256, g), `work` an f32 [splits, M, N] workspace, or
// null with one split); any other g the SIMT kernel (one split, no
// workspace).
extern "C" int flute_lab2_pfdirect(const void* x, const void* plane, const void* scales,
                                   const void* table, void* y, void* work, int M, int N, int K,
                                   int g, int splits, void* stream) {
  return table_gemm<PairTileDecoder, kPfdirect>(x, plane, scales, table, y, work, M, N, K, g,
                                                splits, stream);
}

// A g that is a multiple of 16 runs the tensor-core loop (the pair table of
// L5 g8_rs group_acc, `splits` splits of K at multiples of lcm(256, g),
// `work` an f32 [splits, M, N] workspace, or null with one split); any
// other g the SIMT kernel (one split, no workspace).
extern "C" int flute_lab2_slabstream(const void* x, const void* plane, const void* scales,
                                     const void* table, void* y, void* work, int M, int N, int K,
                                     int g, int splits, void* stream) {
  return table_gemm<SlabstreamDecoder, kSlabstream>(x, plane, scales, table, y, work, M, N, K, g,
                                                    splits, stream);
}

// one_mm: 0 = sep (two products), 1 = sep1 (one product on the bf16 sum).
// A g that is a multiple of 16 runs the tensor-core loop (SepDecoder,
// `splits` splits of K at multiples of lcm(256, g), `work` an f32
// [splits, M, N] workspace, or null with one split); any other g the SIMT
// kernel (one split, no workspace).
extern "C" int flute_lab2_sep(const void* x, const void* plane_a, const void* plane_b,
                              const void* scales, const void* table_a, const void* table_b,
                              void* y, void* work, int M, int N, int K, int g, int one_mm,
                              int splits, void* stream) {
  if (!labmma::takes(g)) {
    if (splits != 1) return cudaErrorInvalidValue;
    return one_mm ? launch<kSep1>(x, plane_a, plane_b, scales, table_a, table_b, y, M, N, K, g,
                                  0.f, 0.f, stream)
                  : launch<kSep>(x, plane_a, plane_b, scales, table_a, table_b, y, M, N, K, g,
                                 0.f, 0.f, stream);
  }
  labmma::Args a;
  if (!labmma::make_args(a, x, plane_a, plane_b, scales, table_a, table_b, y, work, M, N, K, g,
                         0, splits, 0.f, 0.f))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return one_mm ? labmma::run<SepDecoder<true>, labmma::kGroupAcc>(a, splits, s)
                : labmma::run<SepDecoder<false>, labmma::kGroupAcc>(a, splits, s);
}

// A g that is a multiple of 16 runs the tensor-core loop (`splits` splits
// of K at multiples of lcm(256, g), `work` an f32 [splits, M, N] workspace,
// or null with one split); any other g the SIMT kernel (one split, no
// workspace).
extern "C" int flute_lab2_int4(const void* x, const void* plane, const void* scales, void* y,
                               void* work, int M, int N, int K, int g, float zero, float delta,
                               int splits, void* stream) {
  if (!labmma::takes(g)) {
    if (splits != 1) return cudaErrorInvalidValue;
    return launch<kInt4>(x, plane, nullptr, scales, nullptr, nullptr, y, M, N, K, g, zero, delta,
                         stream);
  }
  labmma::Args a;
  if (!labmma::make_args(a, x, plane, nullptr, scales, nullptr, nullptr, y, work, M, N, K, g, 0,
                         splits, zero, delta))
    return cudaErrorInvalidValue;
  return labmma::run<Int4Decoder, labmma::kAffine>(a, splits, static_cast<cudaStream_t>(stream));
}

namespace {

// every instantiation of the loop in this library
const labmma::Instance kLoops[] = {
    labmma::instance<SepDecoder<false>, labmma::kGroupAcc>("SepDecoder<false>"),
    labmma::instance<SepDecoder<true>, labmma::kGroupAcc>("SepDecoder<true>"),
    labmma::instance<Int4Decoder, labmma::kAffine>("Int4Decoder"),
    labmma::instance<SlabstreamDecoder, labmma::kGroupAcc>("PairTableDecoder<4>"),
    labmma::instance<PairTileDecoder, labmma::kGroupAcc>("PairTileDecoder"),
    labmma::instance<W3PairDecoder, labmma::kGroupAcc>("W3PairDecoder"),
};

}  // namespace

// The loop's instantiations in this library, as kernel_lab.cu's
// flute_lab_loop_count and flute_lab_loop_instance report them.
extern "C" int flute_lab2_loop_count() { return sizeof(kLoops) / sizeof(kLoops[0]); }

extern "C" int flute_lab2_loop_instance(int i, int bk, int g, const char** decoder,
                                        int* scaling, int* blocks, int* smem) {
  return labmma::report(kLoops, flute_lab2_loop_count(), i, bk, g, decoder, scaling, blocks,
                        smem);
}

// A g that is a multiple of 16 runs the tensor-core loop (W3PairDecoder;
// `splits` splits of K at multiples of lcm(256, g), `work` an f32
// [splits, M, N] workspace, or null with one split); any other g the SIMT
// kernel (one split, no workspace).
extern "C" int flute_lab2_w3wide(const void* x, const void* plane, const void* scales,
                                 const void* table, void* y, void* work, int M, int N, int K,
                                 int g, int splits, void* stream) {
  return table_gemm<W3PairDecoder, kW3wide>(x, plane, scales, table, y, work, M, N, K, g, splits,
                                            stream);
}
