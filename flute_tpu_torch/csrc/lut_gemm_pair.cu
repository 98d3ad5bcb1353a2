// Fused joint-pair-lookup dequantize + GEMM (HIGGS vector dequantization)
// for the pair-plane layout at 2, 3 and 4 bits, for Hopper (sm_90a).
//
//   y[M, N] = x[M, K] @ W,  (W[2j, n], W[2j+1, n]) = pv[c[2j, n], c[2j+1, n]] * scale
//
// Replaces: flute_tpu/ops/lut_gemm.py::_lut_qgemm_kernel with
// lut_mode="pair_lut" (reached through _lut_qgemm_2d's pl.pallas_call), with
// its helpers _lookup_payload_lane and _table_tile_pair. The pair table pv is
// float32 [2^b, 2^b, 2] indexed [ce, co]: any values, one 2-vector per pair
// of sub-codes (a HIGGS grid, quantize/higgs.py).
//
// Layout decoded: the pair planes of lut_gemm_plane.cu (see there): pair
// field ce | co << pb, fields LSB first, field i of word row c * kc + j is
// pair-row c * chunk / 2 + i * kc + j; 3 bits are a 2-bit plane plus a 1-bit
// plane paired 2 + 1 as in lut_gemm_plane.cu.
//
// The joint table: entry pc = ce | co << b holds (pv[ce, co, 0],
// pv[ce, co, 1]), each rounded to the compute type, in shared memory as two
// floats (at 4 bits 256 entries, 2 KB). Its index is derived from the oracle
// (lut_gemm.dequantize_codes_pair indexes pv[ce, co]), not from the TPU tile
// (which stores the transposed payload, lut_gemm.py:690).
//
// Numerics: each weight is pv[ce, co, i] rounded to the compute type, times
// its scale, rounded once to the compute type (the oracle's order); products
// with x are accumulated in f32 with IEEE FMAs and the warps' partial sums are
// added in a fixed order, so an identity x is bit-exact. Like the JAX
// package's pair_lut mode it runs in 16-bit compute only (bf16, f16): the C
// entry refuses dtype 0 (f32).
//
// What bounds it: bytes, as K2 (b / 8 byte of plane and 2 / g byte of scale
// per weight at decode). Design: K2's skeleton (lut_gemm_common.cuh) with the
// 2^b scalar table replaced by the joint table; one shared-memory read of a
// float2 per weight pair instead of two scalar reads. A warp's 32 lanes read
// 32 arbitrary entries, so the table reads may conflict on banks; simple and
// correct first, no pipelining across chunks, no wgmma or TMA.

#include "lut_gemm_common.cuh"

namespace {

using namespace flute;

template <typename T, int BM, int NB>
__global__ void __launch_bounds__(kThreads)
lut_qgemm_pair_kernel(const T* __restrict__ x, const uint32_t* __restrict__ plane0,
                      const uint32_t* __restrict__ plane1, const T* __restrict__ scales,
                      const float* __restrict__ pv, T* __restrict__ y, int M, int N, int K,
                      int group_size, int chunk) {
  constexpr int kE = 1 << NB;                    // sub-code values
  constexpr int kPB0 = NB == 4 ? 4 : 2;          // bits of the first plane
  constexpr int kFB0 = 2 * kPB0;                 // bits of its pair field
  constexpr int kR0 = 32 / kFB0;                 // pair fields per word
  constexpr uint32_t kFieldMask = (1u << kFB0) - 1;
  constexpr uint32_t kSubMask = (1u << kPB0) - 1;

  // x tile [BM][chunk] while walking K; afterwards the per-warp partial sums
  extern __shared__ float smem[];
  __shared__ float2 tab[kE * kE];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kBlockN + lane;
  const int m0 = blockIdx.y * BM;
  for (int pc = threadIdx.x; pc < kE * kE; pc += kThreads) {
    const int ce = pc & (kE - 1);
    const int co = pc >> NB;
    const float* v = pv + 2 * (ce * kE + co);  // pv[ce, co, :]
    tab[pc] = make_float2(Cvt<T>::round(v[0]), Cvt<T>::round(v[1]));
  }

  float acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0.f;

  const int kc0 = chunk * kPB0 / 32;  // first-plane word rows per chunk
  const int kc1 = chunk / 32;         // 1-bit plane word rows per chunk (3-bit)
  const int nchunks = K / chunk;
  const bool col_ok = n < N;
  for (int c = 0; c < nchunks; ++c) {
    __syncthreads();  // previous chunk's x tile is no longer read (and tab is written)
    const size_t kbase = static_cast<size_t>(c) * chunk;
    stage_x<T, BM>(smem, x, M, K, m0, kbase, chunk);
    __syncthreads();
    if (col_ok) {
      for (int j = warp; j < kc0; j += kWarps) {
        const uint32_t w0 = __ldg(plane0 + (static_cast<size_t>(c) * kc0 + j) * N + n);
        uint32_t w1 = 0;
        int hi = 0;  // which half of the 1-bit word's fields this word pairs with
        if constexpr (NB == 3) {
          w1 = __ldg(plane1 + (static_cast<size_t>(c) * kc1 + j % kc1) * N + n);
          hi = j / kc1;
        }
#pragma unroll
        for (int i = 0; i < kR0; ++i) {
          const uint32_t f = (w0 >> (kFB0 * i)) & kFieldMask;
          uint32_t ce = f & kSubMask;
          uint32_t co = f >> kPB0;
          if constexpr (NB == 3) {
            const uint32_t h = (w1 >> (2 * (2 * i + hi))) & 3u;
            ce |= (h & 1u) << 2;
            co |= (h >> 1) << 2;
          }
          const float2 v = tab[ce | (co << NB)];
          const int k0 = 2 * (i * kc0 + j);  // even K row in the chunk
          const float s = Cvt<T>::to_f(
              scales[static_cast<size_t>((kbase + k0) / group_size) * N + n]);
          const float we = Cvt<T>::round(v.x * s);
          const float wo = Cvt<T>::round(v.y * s);
          const float* xr = smem + k0;
#pragma unroll
          for (int r = 0; r < BM; ++r) {
            acc[r] = fmaf(xr[r * chunk], we, acc[r]);
            acc[r] = fmaf(xr[r * chunk + 1], wo, acc[r]);
          }
        }
      }
    }
  }

  reduce_store<T, BM>(smem, acc, y, M, N, m0);
}

struct Launcher {
  const void* x;
  const void* plane0;
  const void* plane1;
  const void* scales;
  const void* pv;
  void* y;
  int M, N, K, group_size, chunk, num_bits;
  cudaStream_t stream;

  template <typename T, int BM, int NB>
  cudaError_t run_bits() const {
    return launch_grid<BM>(lut_qgemm_pair_kernel<T, BM, NB>, M, N, chunk, stream,
                           static_cast<const T*>(x), static_cast<const uint32_t*>(plane0),
                           static_cast<const uint32_t*>(plane1),
                           static_cast<const T*>(scales), static_cast<const float*>(pv),
                           static_cast<T*>(y), M, N, K, group_size, chunk);
  }

  template <typename T, int BM>
  cudaError_t run() const {
    switch (num_bits) {
      case 2: return run_bits<T, BM, 2>();
      case 3: return run_bits<T, BM, 3>();
      case 4: return run_bits<T, BM, 4>();
      default: return cudaErrorInvalidValue;
    }
  }
};

}  // namespace

// num_bits: 2, 3 or 4; plane1 is the 1-bit plane at 3 bits and is ignored
// otherwise. pv: float32 [2^num_bits, 2^num_bits, 2]. dtype: 1 = float16,
// 2 = bfloat16 (x, scales and y share it); 0 (float32) is refused. All
// pointers are device pointers; the kernel runs on `stream` and is not
// synchronised. Returns the cudaError_t of the launch.
extern "C" int flute_lut_qgemm_pair(const void* x, const void* plane0, const void* plane1,
                                    const void* scales, const void* pv, void* y, int M, int N,
                                    int K, int group_size, int chunk, int num_bits, int dtype,
                                    int block_m, void* stream) {
  const Launcher l{x,     plane0, plane1, scales, pv, y, M, N, K, group_size,
                   chunk, num_bits, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 1: return dispatch_bm<__half>(block_m, l);
    case 2: return dispatch_bm<__nv_bfloat16>(block_m, l);
    default: return cudaErrorInvalidValue;
  }
}
