// The LUT-GEMM loop on tensor cores, for Hopper (sm_90a): a weight decoded
// from packed pair planes straight into mma.sync B fragments, x staged in
// shared memory as 16-bit A fragments, split-K with a fixed-order reduction.
// K1 (lut_gemm_w4sym.cu) and K2 (lut_gemm_plane.cu) in bf16 and f16, and K4
// (lut_gemm_pair.cu), run on it with the pair decoder of
// lut_gemm_pair_decoder.cuh, each with its own table fill; K3
// (lut_gemm_w3wide.cu) in bf16 and f16 with its own decoder of the wide
// 3-bit triples. A kernel adopts it by writing a Decoder (below) for its
// layout. K1-K4 at prefill M run lut_gemm_wide_m.cuh instead, with the
// same decoders and this loop's sums.
//
//   y[M, N] = x[M, K] @ W,  W decoded per K-row pair and column
//
// Why this shape. At decode (M <= 16) the function reads the planes once and
// little else: it is bound by bytes. The skeleton of lut_gemm_common.cuh
// reaches a few percent of that bound (one 4-byte load in flight per lane,
// x re-staged as f32 between barriers, 2 f32 FMAs per weight and row, 128
// blocks for N = 4096 on 132 SMs). Here:
//
// * One K-row pair of one column is one 32-bit B-fragment register of
//   mma.sync.m16n8k16 (lane l holds k = 2(l%4)+{0,1} and +8 at n = l/4), so
//   a decoded pair goes into the tensor core as it is, with f32 accumulators.
// * Loads are 16 bytes per lane: lane l reads 4 consecutive columns of plane
//   word row 4q + l%4; the 4 columns go to 4 n8 tiles (tile e's n-slot g is
//   column 4g + e), so a warp's load covers 32 columns x 4 word rows, each
//   128-byte segment used whole. Words are prefetched DEPTH items ahead in a
//   register ring, bypassing L1, with a 256-byte L2 fetch.
// * K is permuted on the x side, not in the weight: field i of word row j is
//   pair-row i * kc + j of its chunk (the packed format), so mma step
//   (q, s) takes field 2s of word rows 4q..4q+3 as k-slots 0..7 and field
//   2s+1 as k-slots 8..15. Those are 8 consecutive K rows each, so
//   ldmatrix.x4 reads the A fragment from the staged x tile (row stride
//   padded by 16 bytes: no bank conflicts). A sum over K does not depend on
//   the order of K, so the function is the same.
// * Scales are loaded once per group and column: a lane keeps, per field,
//   the group index and the 4 scales of its columns (8 bytes), and reloads
//   only when the group changes, all fields' loads before the item's
//   products; a chunk's first scales are prefetched into L2 one chunk early.
// * Split-K: blockIdx.y takes chunks_per_split consecutive chunks and
//   writes f32 partial sums to a workspace [splits, M, N] that a second
//   kernel adds in split order (no atomics, so a repeat call gives the same
//   bits); with one split the block writes y itself. A Python planner
//   (ops/kernel_config.py::mma_plan) picks the split and the m16 tiles per
//   warp, the split from N, K and chunk alone: a row's sums then run in one
//   order in a batch of any size, so its result does not depend on M.
// * M > 16: each warp runs MT m16 tiles on the same decoded B fragments.
//
// x is staged per pack chunk in a two-stage cp.async ring (16-byte copies,
// rows past M zero-filled), so a chunk's copy overlaps the previous chunk's
// products. Block: 4 warps, 32 columns each (128 columns), 16 * MT rows.
//
// A Decoder for 16-bit type T provides
//   kFields                pair fields per word row: field i of word row j of
//                          a chunk is pair-row i * kc + j
//   word_rows(chunk)       kc, the word rows of a chunk (a multiple of 4)
//   kChunkScales           false: each field keeps its own scales, reloaded
//                          when its group changes (any group size); true: the
//                          group size is a multiple of 2 kc, so a field's
//                          group is fixed for the chunk and its scales are
//                          loaded once per chunk (fewer registers at 16 fields)
//   kDepth                 items of words prefetched per lane
//   struct Table           its shared-memory table
//   Decoder(Table&, const float* table_src)   fills the table (all threads; the
//                          loop's first barrier orders it before use)
//   Words load(plane0, plane1, c, j, kc0, kc1, n0, N, vec)
//                          a lane's words of word row j of chunk c (via load_cols;
//                          kc0 = word_rows(chunk), kc1 = chunk / 32)
//   uint32_t pair(const Words&, int e, int i, int j, int kc1)
//                          the 16-bit pair (low half the even K row) of field i
//                          of column e, before the scale.

#pragma once

#include <type_traits>

#include "lut_gemm_common.cuh"

namespace flute {
namespace mma {

constexpr int kMmaThreads = 128;
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kWarpN = 32;                   // columns per warp: 4 n8 tiles
constexpr int kMmaBlockN = kMmaWarps * kWarpN;  // 128 columns per block
constexpr int kXPad = 8;                     // halves of padding per staged x row

struct Args {
  const void* x;           // [M, K] 16-bit
  const uint32_t* plane0;  // [K * pb0 / 32, N] (the wide 3-bit plane: [3K / 32, N])
  const uint32_t* plane1;  // [K / 32, N] (the 1-bit plane at 3 bits) or null
  const void* scales;      // [K / group_size, N] in x's type
  const float* table;      // the decoder's table
  void* y;                 // [M, N] in x's type
  float* work;             // [splits, M, N] f32, or null with one split
  int M, N, K, group_size, chunk, chunks_per_split;
  int vec;                 // N % 4 == 0 and 16-byte-aligned planes: uint4 loads
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !pred (nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), f32 accumulators
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (std::is_same_v<T, __half>) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// Two 16-bit values in one register, low half first.
template <typename T>
struct Pack2;

template <>
struct Pack2<__half> {
  static __device__ __forceinline__ uint32_t from_f(float lo, float hi) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  // (a.lo * b.lo, a.hi * b.hi), each product rounded once
  static __device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
    const __half2 v = __hmul2(*reinterpret_cast<const __half2*>(&a),
                              *reinterpret_cast<const __half2*>(&b));
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

template <>
struct Pack2<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t from_f(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  static __device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
    const __nv_bfloat162 v = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                     *reinterpret_cast<const __nv_bfloat162*>(&b));
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

// 16 bytes of a read-only stream: not kept in L1, and L2 fetches the
// 256-byte line around them (the neighbouring columns' blocks read it next)
__device__ __forceinline__ uint4 ld_stream16(const void* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

// 4 consecutive 32-bit words of row `row` from column n0 (a multiple of 4);
// columns past N read as 0.
__device__ __forceinline__ uint4 load_cols(const uint32_t* __restrict__ p, size_t row, int n0,
                                           int N, bool vec) {
  const uint32_t* q = p + row * N + n0;
  if (vec) return n0 < N ? ld_stream16(q) : make_uint4(0, 0, 0, 0);
  uint4 w;
  w.x = n0 < N ? __ldg(q) : 0u;
  w.y = n0 + 1 < N ? __ldg(q + 1) : 0u;
  w.z = n0 + 2 < N ? __ldg(q + 2) : 0u;
  w.w = n0 + 3 < N ? __ldg(q + 3) : 0u;
  return w;
}

__device__ __forceinline__ uint32_t word_of(const uint4& w, int e) {
  return e == 0 ? w.x : e == 1 ? w.y : e == 2 ? w.z : w.w;
}

// The 4 16-bit scales of columns n0..n0+3 in group row gi (columns past N: 0).
__device__ __forceinline__ uint2 load_scales(const uint16_t* __restrict__ s, int gi, int n0, int N,
                                             bool vec) {
  const uint16_t* q = s + static_cast<size_t>(gi) * N + n0;
  if (vec) return n0 < N ? __ldg(reinterpret_cast<const uint2*>(q)) : make_uint2(0, 0);
  const uint32_t a = n0 < N ? __ldg(q) : 0u;
  const uint32_t b = n0 + 1 < N ? __ldg(q + 1) : 0u;
  const uint32_t c = n0 + 2 < N ? __ldg(q + 2) : 0u;
  const uint32_t d = n0 + 3 < N ? __ldg(q + 3) : 0u;
  return make_uint2(a | (b << 16), c | (d << 16));
}

// Scale of column e, duplicated into both halves.
__device__ __forceinline__ uint32_t scale2(const uint2& s, int e) {
  const uint32_t w = e < 2 ? s.x : s.y;
  const uint32_t h = (e & 1) ? (w >> 16) : (w & 0xFFFFu);
  return h | (h << 16);
}

// At one m16 tile per warp (decode) four blocks share an SM (at most 128
// registers a thread), so a launch of up to 528 blocks runs in one wave.
template <typename T, int MT, typename Decoder>
__global__ void __launch_bounds__(kMmaThreads, MT == 1 ? 4 : 1) lut_mma_kernel(const Args a) {
  constexpr int kRows = 16 * MT;
  constexpr int kF = Decoder::kFields;
  constexpr int DEPTH = Decoder::kDepth;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ typename Decoder::Table table;
  const Decoder dec(table, a.table);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int g = lane >> 2;
  const int n0 = blockIdx.x * kMmaBlockN + warp * kWarpN + 4 * g;  // this lane's 4 columns
  const int m0 = blockIdx.z * kRows;
  const int kc0 = Decoder::word_rows(a.chunk);          // (first-plane) word rows per chunk
  const int kc1 = a.chunk / 32;                         // 1-bit plane word rows per chunk
  const int groups = kc0 / 4;                           // items per chunk
  const int c0 = blockIdx.y * a.chunks_per_split;
  const int n_items = a.chunks_per_split * groups;
  const int xstride = a.chunk + kXPad;  // halves
  const bool vec = a.vec != 0;
  T* xs = reinterpret_cast<T*>(smem_raw);  // [2][kRows][xstride]
  const T* x = static_cast<const T*>(a.x);
  const uint16_t* scales = static_cast<const uint16_t*>(a.scales);

  // x rows m0.. of chunk c into ring slot `buf`, 16 bytes per copy
  auto stage = [&](int c, int buf) {
    const int per_row = a.chunk / 8;
    T* dst = xs + buf * kRows * xstride;
    for (int idx = threadIdx.x; idx < kRows * per_row; idx += kMmaThreads) {
      const int r = idx / per_row;
      const int v = idx - r * per_row;
      const bool ok = m0 + r < a.M;
      const T* src =
          ok ? x + static_cast<size_t>(m0 + r) * a.K + static_cast<size_t>(c) * a.chunk + 8 * v : x;
      cp_async16(dst + r * xstride + 8 * v, src, ok);
    }
    cp_async_commit();
  };

  int load_ci = 0, load_q = 0;  // the next item to load (chunk within the split, group)
  auto load_next = [&]() {
    const auto w = dec.load(a.plane0, a.plane1, c0 + load_ci, 4 * load_q + t, kc0, kc1, n0, a.N,
                            vec);
    if (++load_q == groups) {
      load_q = 0;
      ++load_ci;
    }
    return w;
  };

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][e][i] = 0.f;
  // !kChunkScales: per field, the first K row of the group of its cached
  // scales and those scales of the lane's 4 columns, each in both halves
  int sk[kF];
  uint32_t sv[kF][4];
#pragma unroll
  for (int i = 0; i < kF; ++i) sk[i] = -2 * a.group_size;  // nothing cached
  // kChunkScales: per field, the 4 columns' scales for the whole chunk; field
  // u = c * kF + i of the K dimension (2 kc rows) lies in group u / fpg
  uint2 cs[kF];
  const int fpg = Decoder::kChunkScales ? a.group_size / (2 * kc0) : 1;

  typename Decoder::Words ring[DEPTH];
  stage(c0, 0);
#pragma unroll
  for (int d = 0; d < DEPTH; ++d)
    if (d < n_items) ring[d] = load_next();

  int ci = 0, q = 0;  // the item computed: chunk within the split, group
  for (int it0 = 0; it0 < n_items; it0 += DEPTH) {
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      const int it = it0 + d;
      if (it < n_items) {  // the same for every thread of the block
        const int c = c0 + ci;
        const int j = 4 * q + t;
        if (q == 0) {
          cp_async_wait<0>();
          __syncthreads();  // chunk ci staged; every warp is done with chunk ci - 1
          if (ci + 1 < a.chunks_per_split) {
            stage(c + 1, (ci + 1) & 1);
            if (n0 < a.N) {  // the next chunk's first scales into L2
              if constexpr (Decoder::kChunkScales) {  // each of its groups once
                for (int gi = (c + 1) * kF / fpg; gi <= ((c + 2) * kF - 1) / fpg; ++gi)
                  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
                      scales + static_cast<size_t>(gi) * a.N + n0));
              } else {
#pragma unroll
                for (int i = 0; i < kF; ++i) {
                  const int gi = ((c + 1) * a.chunk + 2 * (i * kc0 + t)) / a.group_size;
                  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
                      scales + static_cast<size_t>(gi) * a.N + n0));
                }
              }
            }
          }
        }
        const typename Decoder::Words w = ring[d];
        if (it + DEPTH < n_items) ring[d] = load_next();
        if constexpr (Decoder::kChunkScales) {
          if (q == 0) {  // the chunk's scales, one load per group
            int gi = c * kF / fpg;
            int r = c * kF - gi * fpg;
#pragma unroll
            for (int i = 0; i < kF; ++i) {
              if (i == 0 || r == 0)
                cs[i] = load_scales(scales, gi, n0, a.N, vec);
              else
                cs[i] = cs[i - 1];
              if (++r == fpg) {
                r = 0;
                ++gi;
              }
            }
          }
        } else {
          // every field's scales before the first product, so that the loads
          // of a new group are in flight together; a division only on a reload
#pragma unroll
          for (int i = 0; i < kF; ++i) {
            const int krow = c * a.chunk + 2 * (i * kc0 + j);
            if (static_cast<unsigned>(krow - sk[i]) >= static_cast<unsigned>(a.group_size)) {
              const int gi = krow / a.group_size;
              sk[i] = gi * a.group_size;
              const uint2 s4 = load_scales(scales, gi, n0, a.N, vec);
#pragma unroll
              for (int e = 0; e < 4; ++e) sv[i][e] = scale2(s4, e);
            }
          }
        }
        const T* xb = xs + (ci & 1) * kRows * xstride;
#pragma unroll
        for (int s = 0; s < kF / 2; ++s) {
          uint32_t b[4][2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 2 * s + h;
#pragma unroll
            for (int e = 0; e < 4; ++e)
              b[e][h] = Pack2<T>::mul(dec.pair(w, e, i, j, kc1),
                                      Decoder::kChunkScales ? scale2(cs[i], e) : sv[i][e]);
          }
          // k-slots 0..7: K rows 2 (2s kc0 + 4q) + 0..7; 8..15: field 2s + 1
          const int kcol = 2 * ((2 * s + (lane >> 4)) * kc0 + 4 * q);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t af[4];
            ldmatrix_x4(af, xb + (mt * 16 + (lane & 15)) * xstride + kcol);
#pragma unroll
            for (int e = 0; e < 4; ++e) mma16816<T>(acc[mt][e], af, b[e][0], b[e][1]);
          }
        }
        if (++q == groups) {
          q = 0;
          ++ci;
        }
      }
    }
  }

  // c0, c1: row g, n-slots 2t, 2t+1; c2, c3: row g + 8. Tile e's n-slot k is
  // column 4k + e of the warp's 32.
  const int nw = blockIdx.x * kMmaBlockN + warp * kWarpN;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + mt * 16 + g + 8 * (i >> 1);
        const int n = nw + 4 * (2 * t + (i & 1)) + e;
        if (m < a.M && n < a.N) {
          const size_t o = static_cast<size_t>(m) * a.N + n;
          if (a.work != nullptr)
            a.work[static_cast<size_t>(blockIdx.y) * a.M * a.N + o] = acc[mt][e][i];
          else
            static_cast<T*>(a.y)[o] = Cvt<T>::from_f(acc[mt][e][i]);
        }
      }
    }
  }
}

// y = sum over splits of work[s], in split order, rounded once.
template <typename T>
__global__ void __launch_bounds__(256) split_reduce_kernel(const float* __restrict__ work,
                                                           T* __restrict__ y, size_t mn,
                                                           int splits) {
  const size_t i = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= mn) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += work[s * mn + i];
  y[i] = Cvt<T>::from_f(sum);
}

inline size_t mma_smem_bytes(int mt, int chunk) {
  return static_cast<size_t>(2) * 16 * mt * (chunk + kXPad) * 2;
}

// Launches the loop on a grid (N / 128, splits, M / (16 MT)) and, with more
// than one split, the reduction. Returns the first launch error.
template <typename T, int MT, typename Decoder>
cudaError_t launch_mma(const Args& a, int splits, cudaStream_t stream) {
  auto kernel = lut_mma_kernel<T, MT, Decoder>;
  const size_t smem = mma_smem_bytes(MT, a.chunk);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.N + kMmaBlockN - 1) / kMmaBlockN, splits, (a.M + 16 * MT - 1) / (16 * MT));
  kernel<<<grid, kMmaThreads, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const size_t mn = static_cast<size_t>(a.M) * a.N;
  split_reduce_kernel<T><<<static_cast<unsigned>((mn + 255) / 256), 256, 0, stream>>>(
      a.work, static_cast<T*>(a.y), mn, splits);
  return cudaGetLastError();
}

// The loop for m_tiles (1, 2 or 4) m16 tiles per warp.
template <typename T, typename Decoder>
cudaError_t run_tiles(const Args& a, int m_tiles, int splits, cudaStream_t s) {
  switch (m_tiles) {
    case 1: return launch_mma<T, 1, Decoder>(a, splits, s);
    case 2: return launch_mma<T, 2, Decoder>(a, splits, s);
    case 4: return launch_mma<T, 4, Decoder>(a, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

// A C entry's operands as the loop's Args. False where the loop cannot take
// them: K not a multiple of chunk, word_rows (the decoder's word rows per
// chunk) not a multiple of 4, splits not dividing the chunks, or more than
// one split without a workspace.
inline bool loop_args(Args& a, const void* x, const void* plane0, const void* plane1,
                      const void* scales, const void* table, void* y, void* work, int M, int N,
                      int K, int group_size, int chunk, int word_rows, int splits, int vec) {
  const int nchunks = chunk > 0 ? K / chunk : 0;
  if (chunk <= 0 || K % chunk || word_rows % 4 || splits < 1 || nchunks % splits ||
      (splits > 1 && work == nullptr))
    return false;
  a = Args{x,      static_cast<const uint32_t*>(plane0), static_cast<const uint32_t*>(plane1),
           scales, static_cast<const float*>(table),     y,
           splits > 1 ? static_cast<float*>(work) : nullptr,
           M,      N, K, group_size, chunk, nchunks / splits, vec};
  return true;
}

}  // namespace mma
}  // namespace flute
