// The SIMT skeleton of the LUT-GEMM kernels, and the compute-type
// conversions every LUT-GEMM shares: the block shape, staging of x in
// shared memory, the fixed-order reduction of the warps' partial sums, and
// the dispatch from the C entry's run-time dtype and block_m to a template
// instance.
//
// K3 (lut_gemm_w3wide.cu) runs on it always; K1 (lut_gemm_w4sym.cu) and K2
// (lut_gemm_plane.cu) run on it in f32 and at a pack chunk the tensor-core
// loop does not take, and on that loop (lut_gemm_mma.cuh, with
// lut_gemm_pair_decoder.cuh) in bf16 and f16, as K4 does.
//
// The skeleton: one lane per output column (kBlockN = 32 columns per
// block), eight warps splitting each pack chunk's words, the block's BM rows
// of x for one chunk staged in shared memory as f32, and one f32
// accumulator per row in each lane (IEEE FMAs, no tensor cores), summed
// across the warps at the end in a fixed order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace flute {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockN = 32;  // one output column per lane

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float from_f(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Cvt<__half> {
  static __device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
  static __device__ __forceinline__ __half from_f(float v) { return __float2half_rn(v); }
  static __device__ __forceinline__ float round(float v) {
    return __half2float(__float2half_rn(v));
  }
};

template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// smem[r * chunk + k] = x[m0 + r, kbase + k] as f32 for the block's BM rows
// (0 for rows past M). The caller brackets it with __syncthreads().
template <typename T, int BM>
__device__ __forceinline__ void stage_x(float* smem, const T* __restrict__ x, int M, int K,
                                        int m0, size_t kbase, int chunk) {
  for (int idx = threadIdx.x; idx < BM * chunk; idx += kThreads) {
    const int r = idx / chunk;
    const int k = idx - r * chunk;
    const int m = m0 + r;
    smem[idx] = m < M ? Cvt<T>::to_f(x[static_cast<size_t>(m) * K + kbase + k]) : 0.f;
  }
}

// Sums the eight warps' partial sums in shared memory in a fixed order (no
// atomics: the result does not depend on scheduling) and writes the block's
// [BM, kBlockN] tile of y, masking rows past M and columns past N.
template <typename T, int BM>
__device__ __forceinline__ void reduce_store(float* smem, const float (&acc)[BM],
                                             T* __restrict__ y, int M, int N, int m0) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < BM; ++r) smem[(warp * BM + r) * kBlockN + lane] = acc[r];
  __syncthreads();
  for (int t = threadIdx.x; t < BM * kBlockN; t += kThreads) {
    const int r = t / kBlockN;
    const int l = t - r * kBlockN;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += smem[(w * BM + r) * kBlockN + l];
    const int m = m0 + r;
    const int nn = blockIdx.x * kBlockN + l;
    if (m < M && nn < N) y[static_cast<size_t>(m) * N + nn] = Cvt<T>::from_f(sum);
  }
}

// Dynamic shared memory of a block: the x tile, or the reduction, whichever
// is larger.
inline size_t smem_bytes(int block_m, int chunk) {
  const int tile = block_m * chunk > kWarps * block_m * kBlockN ? block_m * chunk
                                                                : kWarps * block_m * kBlockN;
  return static_cast<size_t>(tile) * sizeof(float);
}

// Launches `kernel` on a grid of (N / kBlockN, M / BM) blocks, raising the
// dynamic shared-memory limit first where the tile needs more than 48 KB.
// Returns the launch's error.
template <int BM, typename Kernel, typename... Args>
cudaError_t launch_grid(Kernel kernel, int M, int N, int chunk, cudaStream_t stream,
                        Args... args) {
  const size_t smem = smem_bytes(BM, chunk);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((N + kBlockN - 1) / kBlockN, (M + BM - 1) / BM);
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T, typename Launcher>
cudaError_t dispatch_bm(int block_m, const Launcher& l) {
  switch (block_m) {
    case 1: return l.template run<T, 1>();
    case 2: return l.template run<T, 2>();
    case 4: return l.template run<T, 4>();
    case 8: return l.template run<T, 8>();
    default: return cudaErrorInvalidValue;
  }
}

// l.run<T, BM>() for the C entry's dtype code (0 = float32, 1 = float16,
// 2 = bfloat16) and block_m (1, 2, 4 or 8).
template <typename Launcher>
cudaError_t dispatch(int dtype, int block_m, const Launcher& l) {
  switch (dtype) {
    case 0: return dispatch_bm<float>(block_m, l);
    case 1: return dispatch_bm<__half>(block_m, l);
    case 2: return dispatch_bm<__nv_bfloat16>(block_m, l);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace flute

// Each kernel library exports this beside its entry point.
extern "C" const char* flute_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
