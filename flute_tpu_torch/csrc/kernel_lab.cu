// The Hopper kernel lab (sm_90a): L1-L6, the six design experiments of
// scripts/kernel_lab.py, with one C entry per TPU function:
//
//   flute_lab_floor        <- run_floor        (pallas_call scripts/kernel_lab.py:79)
//   flute_lab_unpack_only  <- run_unpack       (:124)
//   flute_lab_gather16     <- run_gather16     (:212)
//   flute_lab_g8_ablate    <- run_g8_ablate    (:413; flags chain, scale)
//   flute_lab_g8_rs        <- run_g8_rs        (:501; scale mode)
//   flute_lab_g8_hoist     <- run_g8_hoist     (:590; scale mode)
//
//   y[M, N] = x[M, K] @ W[K, N]   (bf16 x, scales and y; f32 sums; one rounding)
//
// Every function reads one 4-bit pair plane [K/8, N] int32 packed at chunk
// 256 (flute_tpu_torch/packing.py::pack_np): word row c*32 + j of a chunk,
// byte i is pair row p = c*128 + i*32 + j, low nibble ce (K row 2p), high
// nibble co (K row 2p + 1). W is what each TPU kernel computes, derived by
// running it in the Pallas interpreter (the plain versions in
// flute_tpu_torch/lab/ops.py define it):
//
//   floor:       pltpu.repeat tiles the K block's bk/8 word rows four times
//                and pltpu.bitcast makes int32 row i bf16 rows 2i (low half)
//                and 2i+1 (high half): K row r of the block is half r % 2 of
//                word row (r/2) mod (bk/8), as a bf16 bit pattern. So each
//                word feeds K rows 2(wr + t*bk/8) + {0, 1}, t = 0..3: the
//                word is an mma B register as it stands.
//   unpack_only: the codes as bf16 bit patterns, W = bits(ce), bits(co): the
//                subnormals c * 2^-133.
//   gather16:    round(round(T[c]) * s[k/g]), the reference dequantization.
//   g8_ablate:   round(T[c]) with chain, else round(T[c & 7]); times s[k/g]
//                (rounded) with scale. The TPU's wrap flag passes the
//                unmasked index to a gather that the v5e reads mod 8: the
//                same entries as the mask, so the wrapper maps it onto this.
//   g8_rs:       "repeat": round(round(T[c]) * s[kb*bk/g + (r mod bk/g)]) for
//                K row r of K block kb (pltpu.repeat tiles the block's scale
//                rows); "group_acc": per pair (x_2p*W_2p + x_2p+1*W_2p+1),
//                W = round(T[c]), times s[k/g] in f32, which sums to the
//                TPU's (x_g @ W_g) * s_g in another f32 order.
//   g8_hoist:    g8_rs's function; the TPU kernel moved its select out of
//                the gather loop, so here every code reads both 8-entry
//                halves of the table and selects on c >= 8, where g8_ablate
//                and g8_rs read T[c] once. On the tensor-core loop the
//                designs differ in where the table lives: g8_hoist and
//                g8_ablate hold bf16(T) in registers (HoistDecoder,
//                HalfDecoder), g8_rs FLUTE's pair table in shared memory
//                (PairTableDecoder, lab_decoders.cuh, which L11 slabstream
//                runs too), gather16 the 16 entries in shared memory
//                (Gather16Decoder).
//
// Numerics: the SIMT kernel takes IEEE f32 FMAs with no flush to zero, and
// so does the tensor-core loop: unpack_only's operand is subnormal, and
// about one in 128 of floor's finite halves is, so the build must never add
// --use_fast_math or -ftz=true. The loop sums each k16 step in the tensor
// core's f32, which keeps subnormal bf16 operands, f32 subnormal products
// and a step's sum of 16 subnormal products (the card test
// test_lab_mma_keeps_subnormals, with flute_lab_mma_probe below), and
// scales a group's partial once, or rounds bf16(T[c]) * s once in the B
// register (lab_mma.cuh). With x the identity every output is one product,
// so both give W bit for bit.
//
// What bounds them: bytes. At the lab's shape (M 16, N 28672, K 8192) the
// planes are 117 MB and the rest 8.5 MB, about 37.6 us at 3.35 TB/s; the
// FMAs (2*M*N*K) are 0.11 ms at the f32 rate, far above the bytes, so a
// simple design is bound by how many loads it keeps in flight.
//
// Two designs. floor and unpack_only, at every group size (they read no
// scales), and gather16, g8_ablate, g8_rs and g8_hoist, at a group size
// that is a multiple of 16, run the lab's tensor-core loop (lab_mma.cuh,
// with the decoders below): plane words and x staged per chunk in a
// cp.async ring, each field decoded straight into an mma.sync B register
// (floor: the word itself, with the chunk's x taken from the four stretches
// of the K block that its words feed; unpack_only: the field's two nibbles
// spread to the two halves); group_acc's partials per group in f32 scaled
// on the C fragment; "repeat"'s scales applied in the B register from the K
// block's scale rows staged in shared memory; gather16's and g8_ablate's
// scale applied in the B register from the open group's row ("expand"), or
// none read; split-K at multiples of lcm(256, g) (floor and unpack_only: of
// the chunk), reduced in split order. The four that read scales, at any
// other (even) group size, run the SIMT kernel below, on K1's first
// skeleton (csrc/lut_gemm_common.cuh): one lane per output column (32
// columns per block), eight warps splitting each K block's word rows, the
// block's 16 rows of x for one K block staged in shared memory as f32 (read
// as float2 broadcasts), the 16-entry table rounded to bf16 in shared
// memory, fixed-order warp sums, no atomics.

#include "lab_decoders.cuh"
#include "lab_mma.cuh"
#include "lut_gemm_common.cuh"

namespace {

using namespace flute;
using bf16 = __nv_bfloat16;
using labmma::PairTableDecoder;
using labmma::table_bits;

constexpr int kBM = 16;                   // rows of M per block
constexpr int kChunk = 256;               // the lab's pack chunk
constexpr int kChunkWords = kChunk / 8;   // word rows per chunk
constexpr int kChunkPairs = kChunk / 2;   // pair rows per chunk

enum Mode { kGather16, kAblate, kRs, kHoist };

// copies of L5's pair table (PairTableDecoder) beside each scaling: as many
// as leave four blocks an SM
constexpr int kGroupAccCopies = 4;
constexpr int kRepeatCopies = 2;

__device__ __forceinline__ float rnd(float v) { return Cvt<bf16>::round(v); }

// L1 on the tensor-core loop: floor dequantizes nothing. A plane word is
// two bf16 bit patterns, the even K row in the low half, so it is a B
// register as it stands, and every field of it is the whole word: no
// instruction a B register. Word row j of chunk cc of a K block feeds K rows
// 64 cc + 2j + {0, 1} + t bk/4 of the block, t = 0..3 (pltpu.repeat tiles
// the block's bk/8 word rows 4 times), so field i takes the stretch t = i:
// slot x columns 64 i .. 64 i + 63 of the chunk hold K rows
// kb bk + 64 cc + i bk/4 + 0..63 (kXMap). At bk 256 that is the identity.
struct WordDecoder {
  static constexpr int kPlanes = 1, kFieldBits = 8, kProducts = 1;
  static constexpr int kTableWords = 0;  // no table
  static constexpr bool kXMap = true;

  __device__ explicit WordDecoder(const labmma::Args&) {}

  static __device__ __forceinline__ int x_row(int c, int bk, int u) {
    const int chunks = bk / kChunk;  // chunks per K block
    const int kb = c / chunks;
    return kb * bk + kChunk / 4 * (c - kb * chunks) + bk / 4 * (u / 64) + u % 64;
  }

  __device__ __forceinline__ void pairs(const uint32_t (&w)[2], int,
                                        uint32_t (&b)[1][2]) const {
    b[0][0] = w[0];
    b[0][1] = w[1];
  }
};

// L2 on the tensor-core loop: the codes themselves as bf16 bit patterns, no
// table and no scales. Field i of word row j is pair row 32 i + j, the
// loop's own K order (no x map), and a field's byte f = ce | co << 4 becomes
// the B register ce | co << 16 (the even K row in the low half, as
// pltpu.bitcast lays it out). A word's nibbles are split once for its four
// fields (lo: every byte's ce, hi: every byte's co); then one prmt a field
// takes byte i of each, and fills the bytes between with the sign of a byte
// below 0x80 (prmt's sign mode, selector bit 3): zero. 4 source instructions
// a B register, 3 of them the word's, the same in each of its 4 fields. It
// holds the split nibbles of a chunk's words (116 registers, no spill), and
// on the H100 it ran 4 us faster at the lab's shape than two forms of 3
// instructions a register that ptxas shares less of (prmt of w and w >> 4
// then a mask; the byte zero-extended, f | f << 12, a mask).
struct UnpackDecoder {
  static constexpr int kPlanes = 1, kFieldBits = 8, kProducts = 1;
  static constexpr int kTableWords = 0;  // no table

  __device__ explicit UnpackDecoder(const labmma::Args&) {}

  __device__ __forceinline__ void pairs(const uint32_t (&w)[2], int i,
                                        uint32_t (&b)[1][2]) const {
    // bytes: lo's i, the sign of lo's i (0), hi's i, the sign of hi's i (0)
    const uint32_t sel = i | (8 + i) << 4 | (4 + i) << 8 | (12 + i) << 12;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t lo = w[r] & 0x0F0F0F0Fu, hi = (w[r] >> 4) & 0x0F0F0F0Fu;
      asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(b[0][r]) : "r"(lo), "r"(hi), "r"(sel));
    }
  }
};

// L6 (and L4 with chain) on the tensor-core loop: the 16 entries of bf16(T)
// held in registers as two byte planes (low and high bytes, 4 entries a
// register). One prmt looks up 4 codes in an 8-entry half of a plane, so
// the codes of both B registers of a step and column (word rows 8q + t and
// 8q + 4 + t) go together: every code reads both 8-entry halves (c & 7 in
// entries 0..7 and in 8..15), then a prmt selects each byte on c >= 8, as
// the TPU kernel hoists the select out of its gathers; 12 instructions for
// two registers.
struct HoistDecoder {
  static constexpr int kPlanes = 1, kFieldBits = 8, kProducts = 1;
  static constexpr int kTableWords = 0;  // the table in registers
  uint32_t lo[4], hi[4];  // byte planes: register k holds entries 4k .. 4k + 3

  __device__ explicit HoistDecoder(const labmma::Args& a) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      lo[k] = hi[k] = 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(__ldg(a.table + 4 * k + b)));
        lo[k] |= (h & 0xFFu) << (8 * b);
        hi[k] |= (h >> 8) << (8 * b);
      }
    }
  }

  // byte i of w[0] and of w[1] (ce | co << 4 each) as (bf16(T[ce]), bf16(T[co]))
  __device__ __forceinline__ void pairs(const uint32_t (&w)[2], int i,
                                        uint32_t (&b)[1][2]) const {
    const uint32_t codes = __byte_perm(w[0], w[1], i | ((4 + i) << 4));  // nibbles ce, co of each
    const uint32_t idx = codes & 0x7777u;  // entry c & 7 of a half (prmt's sign bit clear)
    const uint32_t lo0 = __byte_perm(lo[0], lo[1], idx);  // entries 0..7
    const uint32_t hi0 = __byte_perm(hi[0], hi[1], idx);
    const uint32_t lo1 = __byte_perm(lo[2], lo[3], idx);  // entries 8..15
    const uint32_t hi1 = __byte_perm(hi[2], hi[3], idx);
    const uint32_t pick = 0x3210u | ((codes >> 1) & 0x4444u);  // byte k from 8..15 if c_k >= 8
    const uint32_t l = __byte_perm(lo0, lo1, pick);
    const uint32_t h = __byte_perm(hi0, hi1, pick);
    b[0][0] = __byte_perm(l, h, 0x5140u);
    b[0][1] = __byte_perm(l, h, 0x7362u);
  }
};

// L4 without chain: bf16(T[c & 7]), the low 8-entry half only (the TPU's
// single gather with no group select): HoistDecoder's lookup of half 0 and
// its two interleaves, 6 instructions for two registers.
struct HalfDecoder : HoistDecoder {
  __device__ explicit HalfDecoder(const labmma::Args& a) : HoistDecoder(a) {}

  __device__ __forceinline__ void pairs(const uint32_t (&w)[2], int i,
                                        uint32_t (&b)[1][2]) const {
    const uint32_t codes = __byte_perm(w[0], w[1], i | ((4 + i) << 4));
    const uint32_t idx = codes & 0x7777u;
    const uint32_t l = __byte_perm(lo[0], lo[1], idx);
    const uint32_t h = __byte_perm(hi[0], hi[1], idx);
    b[0][0] = __byte_perm(l, h, 0x5140u);
    b[0][1] = __byte_perm(l, h, 0x7362u);
  }
};

// L3 on the tensor-core loop: the direct-value gather. The 16 entries of
// bf16(T) sit in shared memory one to a 32-bit word, 16 words in 16 banks,
// so lanes that read one entry share a broadcast and any 32 lookups are
// free of conflicts. Each code is one ld.shared; one prmt joins a B
// register's two values (the even K row low), with no OR-merge of bit
// patterns and no select. The loop's "expand" then rounds
// bf16(bf16(T[c]) * s[k // g]) once, L3's function.
struct Gather16Decoder {
  static constexpr int kPlanes = 1, kFieldBits = 8, kProducts = 1;
  static constexpr int kTableWords = 16;
  const unsigned char* tab;

  __device__ Gather16Decoder(const labmma::Args& a, uint32_t* t)
      : tab(reinterpret_cast<const unsigned char*>(t)) {
    if (threadIdx.x < kTableWords) t[threadIdx.x] = table_bits(a.table, threadIdx.x);
  }

  // the entry of the 4-bit code at bits sh .. sh + 3 of w
  __device__ __forceinline__ uint32_t value(uint32_t w, int sh) const {
    const uint32_t off = (sh >= 2 ? w >> (sh - 2) : w << (2 - sh)) & 0x3Cu;
    return *reinterpret_cast<const uint32_t*>(tab + off);
  }

  __device__ __forceinline__ void pairs(const uint32_t (&w)[2], int i,
                                        uint32_t (&b)[1][2]) const {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      b[0][r] = __byte_perm(value(w[r], 8 * i), value(w[r], 8 * i + 4), 0x5410u);
  }
};

__device__ __forceinline__ float scale_at(const bf16* __restrict__ s, int row, int N, int n) {
  return __bfloat162float(s[static_cast<size_t>(row) * N + n]);
}

// acc[r] += x[r, k0] * we + x[r, k0 + 1] * wo (k0 even: an aligned float2)
__device__ __forceinline__ void fma_pair(float (&acc)[kBM], const float* xs, int bk, int k0,
                                         float we, float wo) {
#pragma unroll
  for (int r = 0; r < kBM; ++r) {
    const float2 xv = *reinterpret_cast<const float2*>(xs + r * bk + k0);
    acc[r] = fmaf(xv.x, we, acc[r]);
    acc[r] = fmaf(xv.y, wo, acc[r]);
  }
}

// group_acc: acc[r] += (x[r, k0] * we + x[r, k0 + 1] * wo) * s, all in f32
__device__ __forceinline__ void fma_pair_scaled(float (&acc)[kBM], const float* xs, int bk,
                                                int k0, float we, float wo, float s) {
#pragma unroll
  for (int r = 0; r < kBM; ++r) {
    const float2 xv = *reinterpret_cast<const float2*>(xs + r * bk + k0);
    acc[r] = fmaf(fmaf(xv.y, wo, xv.x * we), s, acc[r]);
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
lab_kernel(const bf16* __restrict__ x, const uint32_t* __restrict__ plane,
           const bf16* __restrict__ scales, const float* __restrict__ table,
           bf16* __restrict__ y, int M, int N, int K, int bk, int g, int chain, int scale,
           int group_acc) {
  // x tile [kBM][bk] while walking K; afterwards the per-warp partial sums
  // [kWarps][kBM][kBlockN]
  extern __shared__ float smem[];
  __shared__ float tab[16];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kBlockN + lane;
  const int m0 = blockIdx.y * kBM;
  if (threadIdx.x < 16) tab[threadIdx.x] = rnd(table[threadIdx.x]);

  float acc[kBM];
#pragma unroll
  for (int r = 0; r < kBM; ++r) acc[r] = 0.f;

  const int nwr = bk / 8;  // word rows per K block
  const bool col_ok = n < N;
  for (int kb = 0; kb < K / bk; ++kb) {
    __syncthreads();  // previous block's x tile is no longer read
    const size_t kbase = static_cast<size_t>(kb) * bk;
    stage_x<bf16, kBM>(smem, x, M, K, m0, kbase, bk);
    __syncthreads();
    if (!col_ok) continue;
    for (int wr = warp; wr < nwr; wr += kWarps) {
      const uint32_t w = __ldg(plane + (static_cast<size_t>(kb) * nwr + wr) * N + n);
      const int c = wr / kChunkWords;
      const int j = wr - c * kChunkWords;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t f = (w >> (8 * i)) & 0xFFu;
        const uint32_t ce = f & 15u;
        const uint32_t co = f >> 4;
        const int k0 = 2 * (c * kChunkPairs + i * kChunkWords + j);  // even K row in the block
        const int group = static_cast<int>((kbase + k0) / g);       // its scale row
        float we, wo;
        if (MODE == kGather16) {
          const float s = scale_at(scales, group, N, n);
          we = rnd(tab[ce] * s);
          wo = rnd(tab[co] * s);
        } else if (MODE == kAblate) {
          we = tab[chain ? ce : (ce & 7u)];
          wo = tab[chain ? co : (co & 7u)];
          if (scale) {
            const float s = scale_at(scales, group, N, n);
            we = rnd(we * s);
            wo = rnd(wo * s);
          }
        } else {
          if (MODE == kRs) {
            we = tab[ce];
            wo = tab[co];
          } else {  // kHoist: both halves for every code, then the select
            const float e0 = tab[ce & 7u], e1 = tab[8u + (ce & 7u)];
            const float o0 = tab[co & 7u], o1 = tab[8u + (co & 7u)];
            we = ce >= 8u ? e1 : e0;
            wo = co >= 8u ? o1 : o0;
          }
          if (group_acc) {
            fma_pair_scaled(acc, smem, bk, k0, we, wo, scale_at(scales, group, N, n));
            continue;
          }
          // "repeat": the block's scale rows tiled, row r takes r mod (bk/g)
          const int per_block = bk / g;
          const int base = kb * per_block;
          we = rnd(we * scale_at(scales, base + k0 % per_block, N, n));
          wo = rnd(wo * scale_at(scales, base + (k0 + 1) % per_block, N, n));
        }
        fma_pair(acc, smem, bk, k0, we, wo);
      }
    }
  }

  reduce_store<bf16, kBM>(smem, acc, y, M, N, m0);
}

template <int MODE>
int launch(const void* x, const void* plane, const void* scales, const void* table, void* y,
           int M, int N, int K, int bk, int g, int chain, int scale, int group_acc,
           void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bk <= 0 || K % bk || bk % kChunk || g <= 0 || g % 2 ||
      bk % g)
    return cudaErrorInvalidValue;
  return launch_grid<kBM>(lab_kernel<MODE>, M, N, bk, static_cast<cudaStream_t>(stream),
                          static_cast<const bf16*>(x), static_cast<const uint32_t*>(plane),
                          static_cast<const bf16*>(scales), static_cast<const float*>(table),
                          static_cast<bf16*>(y), M, N, K, bk, g, chain, scale, group_acc);
}

}  // namespace

// All pointers are device pointers: x [M, K], scales [K/g, N] and y [M, N]
// bf16, plane [K/8, N] int32, table [16] float32, work f32. Each kernel
// runs on `stream` and is not synchronised. Returns the cudaError_t of the
// launch. floor and unpack_only read neither scales nor table.

// The operands of a loop call that the lab's checks make (bk a multiple of
// the chunk and of g, dividing K) as Args; false where the loop cannot
// take them. bk_rows: the K block whose scale rows "repeat" tiles, or
// whose words floor's x map follows, else 0.
static bool loop_args(labmma::Args& a, const void* x, const void* plane, const void* scales,
                      const void* table, void* y, void* work, int M, int N, int K, int bk, int g,
                      int bk_rows, int splits) {
  return bk > 0 && bk % kChunk == 0 && K % bk == 0 && bk % g == 0 &&
         labmma::make_args(a, x, plane, nullptr, scales, table, nullptr, y, work, M, N, K, g,
                           bk_rows, splits, 0.f, 0.f);
}

// floor runs the tensor-core loop at every call (WordDecoder, no scales;
// `splits` splits of K at chunk boundaries, `work` an f32 [splits, M, N]
// workspace, or null with one split): it takes no g.
extern "C" int flute_lab_floor(const void* x, const void* plane, void* y, void* work, int M,
                               int N, int K, int bk, int splits, void* stream) {
  labmma::Args a;
  // its split unit is the chunk (make_args' g) and its x map follows bk
  if (!loop_args(a, x, plane, nullptr, nullptr, y, work, M, N, K, bk, kChunk, bk, splits))
    return cudaErrorInvalidValue;
  return labmma::run<WordDecoder, labmma::kNone>(a, splits, static_cast<cudaStream_t>(stream));
}

// unpack_only runs the tensor-core loop at every call too (UnpackDecoder,
// no scales, no table; `splits` and `work` as floor's): it takes no g, and
// its K order is the loop's own, so bk only checks the tiling.
extern "C" int flute_lab_unpack_only(const void* x, const void* plane, void* y, void* work,
                                     int M, int N, int K, int bk, int splits, void* stream) {
  labmma::Args a;
  if (!loop_args(a, x, plane, nullptr, nullptr, y, work, M, N, K, bk, kChunk, 0, splits))
    return cudaErrorInvalidValue;
  return labmma::run<UnpackDecoder, labmma::kNone>(a, splits, static_cast<cudaStream_t>(stream));
}

// A g that is a multiple of 16 runs the tensor-core loop (Gather16Decoder,
// each B register times s[k // g]; `splits` splits of K at multiples of
// lcm(256, g), `work` an f32 [splits, M, N] workspace, or null with one
// split); any other g the SIMT kernel (one split, no workspace).
extern "C" int flute_lab_gather16(const void* x, const void* plane, const void* scales,
                                  const void* table, void* y, void* work, int M, int N, int K,
                                  int bk, int g, int splits, void* stream) {
  if (!labmma::takes(g)) {
    if (splits != 1) return cudaErrorInvalidValue;
    return launch<kGather16>(x, plane, scales, table, y, M, N, K, bk, g, 0, 0, 0, stream);
  }
  labmma::Args a;
  if (!loop_args(a, x, plane, scales, table, y, work, M, N, K, bk, g, 0, splits))
    return cudaErrorInvalidValue;
  return labmma::run<Gather16Decoder, labmma::kExpand>(a, splits,
                                                        static_cast<cudaStream_t>(stream));
}

// A g that is a multiple of 16 runs the tensor-core loop (chain: HoistDecoder,
// else HalfDecoder; scale: each B register times s[k // g], else no scale
// read; `splits` splits of K at multiples of lcm(256, g), `work` an f32
// [splits, M, N] workspace, or null with one split); any other g the SIMT
// kernel (one split, no workspace).
extern "C" int flute_lab_g8_ablate(const void* x, const void* plane, const void* scales,
                                   const void* table, void* y, void* work, int M, int N, int K,
                                   int bk, int g, int chain, int scale, int splits,
                                   void* stream) {
  if (!labmma::takes(g)) {
    if (splits != 1) return cudaErrorInvalidValue;
    return launch<kAblate>(x, plane, scales, table, y, M, N, K, bk, g, chain, scale, 0, stream);
  }
  labmma::Args a;
  if (!loop_args(a, x, plane, scales, table, y, work, M, N, K, bk, g, 0, splits))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chain)
    return scale ? labmma::run<HoistDecoder, labmma::kExpand>(a, splits, s)
                 : labmma::run<HoistDecoder, labmma::kNone>(a, splits, s);
  return scale ? labmma::run<HalfDecoder, labmma::kExpand>(a, splits, s)
               : labmma::run<HalfDecoder, labmma::kNone>(a, splits, s);
}

// group_acc: 0 = "repeat", 1 = "group_acc". A g that is a multiple of 16
// runs the tensor-core loop with the pair table in shared memory
// (PairTableDecoder: 4 copies with group_acc, 2 with "repeat"; `splits`
// and `work` as g8_ablate's); any other g the SIMT kernel (one split, no
// workspace).
extern "C" int flute_lab_g8_rs(const void* x, const void* plane, const void* scales,
                               const void* table, void* y, void* work, int M, int N, int K,
                               int bk, int g, int group_acc, int splits, void* stream) {
  if (!labmma::takes(g)) {
    if (splits != 1) return cudaErrorInvalidValue;
    return launch<kRs>(x, plane, scales, table, y, M, N, K, bk, g, 0, 0, group_acc, stream);
  }
  labmma::Args a;
  if (!loop_args(a, x, plane, scales, table, y, work, M, N, K, bk, g, group_acc ? 0 : bk,
                 splits))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using GroupAcc = PairTableDecoder<kGroupAccCopies>;
  using Repeat = PairTableDecoder<kRepeatCopies>;
  return group_acc ? labmma::run<GroupAcc, labmma::kGroupAcc>(a, splits, s)
                   : labmma::run<Repeat, labmma::kRepeat>(a, splits, s);
}

// group_acc as g8_rs. A g that is a multiple of 16 runs the tensor-core
// loop (`splits` splits of K at multiples of lcm(256, g), `work` an f32
// [splits, M, N] workspace, or null with one split); any other g the SIMT
// kernel (one split, no workspace).
extern "C" int flute_lab_g8_hoist(const void* x, const void* plane, const void* scales,
                                  const void* table, void* y, void* work, int M, int N, int K,
                                  int bk, int g, int group_acc, int splits, void* stream) {
  if (!labmma::takes(g)) {
    if (splits != 1) return cudaErrorInvalidValue;
    return launch<kHoist>(x, plane, scales, table, y, M, N, K, bk, g, 0, 0, group_acc, stream);
  }
  labmma::Args a;
  if (!loop_args(a, x, plane, scales, table, y, work, M, N, K, bk, g, group_acc ? 0 : bk,
                 splits))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return group_acc ? labmma::run<HoistDecoder, labmma::kGroupAcc>(a, splits, s)
                   : labmma::run<HoistDecoder, labmma::kRepeat>(a, splits, s);
}

namespace {

// every instantiation of the loop in this library
const labmma::Instance kLoops[] = {
    labmma::instance<WordDecoder, labmma::kNone>("WordDecoder"),
    labmma::instance<UnpackDecoder, labmma::kNone>("UnpackDecoder"),
    labmma::instance<HoistDecoder, labmma::kExpand>("HoistDecoder"),
    labmma::instance<HoistDecoder, labmma::kNone>("HoistDecoder"),
    labmma::instance<HalfDecoder, labmma::kExpand>("HalfDecoder"),
    labmma::instance<HalfDecoder, labmma::kNone>("HalfDecoder"),
    labmma::instance<HoistDecoder, labmma::kGroupAcc>("HoistDecoder"),
    labmma::instance<HoistDecoder, labmma::kRepeat>("HoistDecoder"),
    labmma::instance<PairTableDecoder<kGroupAccCopies>, labmma::kGroupAcc>("PairTableDecoder<4>"),
    labmma::instance<PairTableDecoder<kRepeatCopies>, labmma::kRepeat>("PairTableDecoder<2>"),
    labmma::instance<Gather16Decoder, labmma::kExpand>("Gather16Decoder"),
};

// One mma.sync.m16n8k16 (bf16 in, f32 sums from +0) of one warp: d[16][8] =
// a[16][16] (row-major) times b (given as bt[8][16], column n's 16 K rows
// in a row), fragments loaded as the PTX ISA lays them out.
__global__ void mma_probe_kernel(const uint16_t* __restrict__ a, const uint16_t* __restrict__ bt,
                                 float* __restrict__ d) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  auto pair = [](const uint16_t* p) {
    return static_cast<uint32_t>(p[0]) | static_cast<uint32_t>(p[1]) << 16;
  };
  const uint32_t af[4] = {pair(a + g * 16 + 2 * t), pair(a + (g + 8) * 16 + 2 * t),
                          pair(a + g * 16 + 2 * t + 8), pair(a + (g + 8) * 16 + 2 * t + 8)};
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  mma::mma16816<bf16>(acc, af, pair(bt + g * 16 + 2 * t), pair(bt + g * 16 + 2 * t + 8));
  d[g * 8 + 2 * t] = acc[0];
  d[g * 8 + 2 * t + 1] = acc[1];
  d[(g + 8) * 8 + 2 * t] = acc[2];
  d[(g + 8) * 8 + 2 * t + 1] = acc[3];
}

}  // namespace

// What the tensor core does with subnormal bf16 operands and f32 products,
// which floor's operand holds: one mma of a [16, 16] (bf16, row-major) and
// bt [8, 16] (bf16, B transposed) into d [16, 8] f32, one warp on `stream`.
// It replaces no TPU kernel. Returns the cudaError_t of the launch.
extern "C" int flute_lab_mma_probe(const void* a, const void* bt, void* d, void* stream) {
  mma_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(a), static_cast<const uint16_t*>(bt), static_cast<float*>(d));
  return cudaGetLastError();
}

// The loop's instantiations in this library: their number, and instance i's
// decoder (as ptxas's mangled name reads), Scaling (lab_mma.cuh's order),
// blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and dynamic
// shared memory in bytes at a K block bk and group size g. Returns the
// cudaError_t of the query.
extern "C" int flute_lab_loop_count() { return sizeof(kLoops) / sizeof(kLoops[0]); }

extern "C" int flute_lab_loop_instance(int i, int bk, int g, const char** decoder, int* scaling,
                                       int* blocks, int* smem) {
  return labmma::report(kLoops, flute_lab_loop_count(), i, bk, g, decoder, scaling, blocks,
                        smem);
}
