// Fused LUT-dequantize + GEMM for the sign-symmetric 4-bit ("w4sym") layout,
// for Hopper (sm_90a).
//
//   y[M, N] = x[M, K] @ (table[c[K, N]] * scales[K / g, N])
//
// Replaces: flute_tpu/ops/lut_gemm.py::_lut_qgemm_kernel with layout="w4sym"
// (reached through _lut_qgemm_2d's pl.pallas_call), together with its helpers
// _unpack_w4sym_payload and _table_tile_w4sym.
//
// Layout decoded (flute_tpu_torch/packing.py::pack_w4_sym_np): plane int32
// [K/8, N], row-major, so adjacent n are adjacent words. With cp = chunk/2
// and kc = cp/4, word row c*kc + j, byte i holds pair-row p = c*cp + i*kc + j,
// i.e. K rows 2p and 2p+1: the four bytes of a word lie kc pairs apart inside
// the chunk. Byte f = m_e | m_o << 3 | s_e << 6 | s_o << 7 and code c = 8s + m;
// the value is table[m] rounded to the compute type with its sign bit XOR-ed
// by s (table[c + 8] == -table[c], magnitudes of either sign).
//
// Numerics: each weight is dequantized exactly as the oracle
// (lut_gemm.dequantize_codes) does it: value * scale, rounded once to the
// compute type. For bf16/f16 the product of two 16-bit values is exact in
// f32, so the single rounding matches. Products with x are accumulated in f32
// with IEEE FMAs (no tensor cores, no TF32), so an identity x is bit-exact in
// bf16, f16 and f32, and the plain PyTorch version differs only in the order
// of the f32 sums. The K split across the block's warps is reduced in shared
// memory in a fixed order: deterministic, no atomics, no split-K across blocks.
//
// What bounds it: bytes. At decode (M <= 8) every weight costs 0.5 byte of
// plane plus 2/g byte of scale, and x and y are small, so the least time is
// those bytes over HBM bandwidth (3.35 TB/s on an H100 SXM). Design: one lane
// per output column (a warp reads 128 contiguous plane bytes per word row),
// eight warps per block splitting each chunk's word rows, the block's x rows
// for one chunk staged in shared memory as f32 (warp-uniform reads are
// broadcasts), the 8-entry magnitude table in shared memory. block_m rows of
// M per block (1, 2, 4 or 8) so that decode spends no FMA on padding rows.
// This is the simple, correct kernel; it does not pipeline loads across
// chunks, use wgmma or TMA.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

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

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
lut_qgemm_w4sym_kernel(const T* __restrict__ x, const uint32_t* __restrict__ plane,
                       const T* __restrict__ scales, const float* __restrict__ table,
                       T* __restrict__ y, int M, int N, int K, int group_size,
                       int chunk) {
  // x tile [BM][chunk] while walking K; afterwards the per-warp partial sums
  // [kWarps][BM][kBlockN]
  extern __shared__ float smem[];
  __shared__ float mag[8];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kBlockN + lane;
  const int m0 = blockIdx.y * BM;
  if (threadIdx.x < 8) mag[threadIdx.x] = Cvt<T>::round(table[threadIdx.x]);

  float acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0.f;

  const int kc = chunk / 8;  // word rows per chunk
  const int nchunks = K / chunk;
  const bool col_ok = n < N;
  for (int c = 0; c < nchunks; ++c) {
    __syncthreads();  // previous chunk's x tile is no longer read
    const size_t kbase = static_cast<size_t>(c) * chunk;
    for (int idx = threadIdx.x; idx < BM * chunk; idx += kThreads) {
      const int r = idx / chunk;
      const int k = idx - r * chunk;
      const int m = m0 + r;
      smem[idx] = m < M ? Cvt<T>::to_f(x[static_cast<size_t>(m) * K + kbase + k]) : 0.f;
    }
    __syncthreads();
    if (col_ok) {
      for (int j = warp; j < kc; j += kWarps) {
        const uint32_t w = __ldg(plane + (static_cast<size_t>(c) * kc + j) * N + n);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t f = (w >> (8 * i)) & 0xFFu;  // unsigned: no sign drag
          const int k0 = 2 * (i * kc + j);              // even K row in the chunk
          const float s = Cvt<T>::to_f(
              scales[static_cast<size_t>((kbase + k0) / group_size) * N + n]);
          const float ve =
              __uint_as_float(__float_as_uint(mag[f & 7u]) ^ (((f >> 6) & 1u) << 31));
          const float vo =
              __uint_as_float(__float_as_uint(mag[(f >> 3) & 7u]) ^ ((f >> 7) << 31));
          const float we = Cvt<T>::round(ve * s);
          const float wo = Cvt<T>::round(vo * s);
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

template <typename T, int BM>
cudaError_t launch(const void* x, const void* plane, const void* scales,
                   const void* table, void* y, int M, int N, int K, int group_size,
                   int chunk, cudaStream_t stream) {
  const int tile = BM * chunk > kWarps * BM * kBlockN ? BM * chunk : kWarps * BM * kBlockN;
  const size_t smem = static_cast<size_t>(tile) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lut_qgemm_w4sym_kernel<T, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((N + kBlockN - 1) / kBlockN, (M + BM - 1) / BM);
  lut_qgemm_w4sym_kernel<T, BM><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint32_t*>(plane),
      static_cast<const T*>(scales), static_cast<const float*>(table), static_cast<T*>(y),
      M, N, K, group_size, chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bm(int block_m, const void* x, const void* plane, const void* scales,
                        const void* table, void* y, int M, int N, int K, int group_size,
                        int chunk, cudaStream_t stream) {
  switch (block_m) {
    case 1: return launch<T, 1>(x, plane, scales, table, y, M, N, K, group_size, chunk, stream);
    case 2: return launch<T, 2>(x, plane, scales, table, y, M, N, K, group_size, chunk, stream);
    case 4: return launch<T, 4>(x, plane, scales, table, y, M, N, K, group_size, chunk, stream);
    case 8: return launch<T, 8>(x, plane, scales, table, y, M, N, K, group_size, chunk, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (x, scales and y share it;
// table is float32 [16]). All pointers are device pointers; the kernel runs
// on `stream` and is not synchronised. Returns the cudaError_t of the launch.
extern "C" int flute_lut_qgemm_w4sym(const void* x, const void* plane, const void* scales,
                                     const void* table, void* y, int M, int N, int K,
                                     int group_size, int chunk, int dtype, int block_m,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_bm<float>(block_m, x, plane, scales, table, y, M, N, K, group_size,
                                chunk, s);
    case 1:
      return dispatch_bm<__half>(block_m, x, plane, scales, table, y, M, N, K, group_size,
                                 chunk, s);
    case 2:
      return dispatch_bm<__nv_bfloat16>(block_m, x, plane, scales, table, y, M, N, K,
                                        group_size, chunk, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* flute_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
