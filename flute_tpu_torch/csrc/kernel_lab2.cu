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
//     (f >> 4) & 7 of the half that bit 7 selects. pfdirect writes a chunk's
//     dequantized operand (the payload ge | go) to shared memory before its
//     products, as the TPU builds the whole tile; slabstream feeds each
//     decoded pair straight into its products, in registers.
//   sep: T[c] = A[c & 3] + B[c >> 2] over two 2-bit planes [K/16, N] (fields
//     ce | co << 2, 8 per word, word row c*16 + j, field i: pair row
//     c*128 + i*16 + j) and two 4-entry tables held in registers. sep: the
//     two products summed in f32; sep1: one product on round(A + B), the sum
//     rounded to bf16 as the TPU's bf16 add rounds it.
//   int4: no table, W = float(c), exact. Per group (x_g @ c_g) * (s * delta)
//     + (sum of x_g) * (s * zero), each product rounded on its own (no
//     contraction into an FMA): the x sums are formed once per block, chunk
//     and group in shared memory, not once per column.
//   w3wide: W = round(T3[c]) from the wide 3-bit layout (K3's field decode,
//     csrc/lut_gemm_w3wide.cu: straddling fields read from one 64-bit value)
//     and 8 entries.
//
// L7, vmembw: v <- v ^ (v >> 1) (arithmetic shift) nops times on int32, one
// thread per element; nops is a run-time argument, so the chain cannot fold.
//
// Numerics: IEEE f32 FMAs, no flush to zero (never --use_fast_math). Per pair
// acc += (x_2p * W_2p + x_2p+1 * W_2p+1) * s: the TPU's (x_g @ W_g) * s_g in
// another f32 order. With x the identity every output is one product, so the
// kernels give the plain versions bit for bit (the sign of a zero aside).
//
// What bounds them: bytes. At the lab's shape (M 16, N 28672, K 8192) the
// planes are 117 MB (88 MB for w3wide) and the rest 8.5 MB, about 37.6 us
// (28.8 us) at 3.35 TB/s; 2*M*N*K at the bf16 tensor rate is 7.6 us. L7's
// 4.2 MB stay in the 50 MB L2, so it measures the launch and the ALU chain.
// Design: K1's skeleton (csrc/lut_gemm_common.cuh), as L1-L6: one lane per
// output column (32 columns per block), eight warps splitting each pack
// chunk's words, the block's 16 rows of x for one chunk staged in shared
// memory as f32, fixed-order warp sums, no atomics. No result depends on the
// TPU's block_k, so x is staged per 256-row chunk (16 KB) and each warp
// loads all of its words of a chunk (3 or 4) before it decodes any.

#include "lut_gemm_common.cuh"

namespace {

using namespace flute;
using bf16 = __nv_bfloat16;

constexpr int kBM = 16;                  // rows of M per block
constexpr int kChunk = 256;              // the lab's pack chunk
constexpr int kChunkPairs = kChunk / 2;  // pair rows per chunk
constexpr int kMaxGroups = kChunk / 2 + 1;  // groups a chunk can touch (g >= 2)

enum Mode { kPfdirect, kSlabstream, kSep, kSep1, kInt4, kW3wide };

__device__ __forceinline__ float rnd(float v) { return Cvt<bf16>::round(v); }

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

extern "C" int flute_lab2_pfdirect(const void* x, const void* plane, const void* scales,
                                   const void* table, void* y, int M, int N, int K, int g,
                                   void* stream) {
  return launch<kPfdirect>(x, plane, nullptr, scales, table, nullptr, y, M, N, K, g, 0.f, 0.f,
                           stream);
}

extern "C" int flute_lab2_slabstream(const void* x, const void* plane, const void* scales,
                                     const void* table, void* y, int M, int N, int K, int g,
                                     void* stream) {
  return launch<kSlabstream>(x, plane, nullptr, scales, table, nullptr, y, M, N, K, g, 0.f,
                             0.f, stream);
}

// one_mm: 0 = sep (two products), 1 = sep1 (one product on the bf16 sum)
extern "C" int flute_lab2_sep(const void* x, const void* plane_a, const void* plane_b,
                              const void* scales, const void* table_a, const void* table_b,
                              void* y, int M, int N, int K, int g, int one_mm, void* stream) {
  return one_mm ? launch<kSep1>(x, plane_a, plane_b, scales, table_a, table_b, y, M, N, K, g,
                                0.f, 0.f, stream)
                : launch<kSep>(x, plane_a, plane_b, scales, table_a, table_b, y, M, N, K, g,
                               0.f, 0.f, stream);
}

extern "C" int flute_lab2_int4(const void* x, const void* plane, const void* scales, void* y,
                               int M, int N, int K, int g, float zero, float delta,
                               void* stream) {
  return launch<kInt4>(x, plane, nullptr, scales, nullptr, nullptr, y, M, N, K, g, zero, delta,
                       stream);
}

extern "C" int flute_lab2_w3wide(const void* x, const void* plane, const void* scales,
                                 const void* table, void* y, int M, int N, int K, int g,
                                 void* stream) {
  return launch<kW3wide>(x, plane, nullptr, scales, table, nullptr, y, M, N, K, g, 0.f, 0.f,
                         stream);
}
