// Fused LUT-dequantize + GEMM for the wide 3-bit single-plane ("w3wide")
// layout, for Hopper (sm_90a).
//
//   y[M, N] = x[M, K] @ (table[c[K, N]] * scales[K / g, N])
//
// Replaces: flute_tpu/ops/lut_gemm.py::_lut_qgemm_kernel with
// layout="w3wide" (reached through _lut_qgemm_2d's pl.pallas_call), together
// with its helper _unpack_wide3_payload. The table is any 8 float32 values.
//
// Layout decoded (flute_tpu_torch/packing.py::pack_w3_wide_np): one plane,
// int32 [3K/32, N], row-major. Per chunk (a multiple of 256 K rows) there
// are ntrip = chunk / 32 triples of words, stored planar: word rows
// c * 3 ntrip + t, + ntrip + t and + 2 ntrip + t are the three words of
// triple t. Read as one 96-bit number (first word lowest), the triple holds
// 16 six-bit pair fields ce | co << 3 at bits 6 j; field j of triple t is
// pair-row p = c * chunk / 2 + j * ntrip + t (K rows 2p and 2p + 1). Fields 5
// (bits 30-35) and 10 (bits 60-65) straddle a word boundary.
//
// Numerics: as lut_gemm_w4sym.cu. Each weight is table[c] rounded to the
// compute type, times its scale, rounded once to the compute type; products
// with x are accumulated in f32 with IEEE FMAs (no tensor cores, no TF32) and
// the warps' partial sums are added in a fixed order, so an identity x is
// bit-exact in bf16, f16 and f32.
//
// What bounds it: bytes. At decode (M <= 8) every weight costs 3/8 byte of
// plane plus 2 / g byte of scale, so the least time is those bytes over HBM
// bandwidth (3.35 TB/s on an H100 SXM). Design: K1's skeleton
// (lut_gemm_common.cuh): one lane per output column, so a warp reads 128
// contiguous bytes of each word row; eight warps split each chunk's triples
// (one triple each at chunk 256); a lane joins its triple's words into two
// unsigned 64-bit halves, so every field, the straddling two included, is a
// shift and a mask with no sign drag; x staged in shared memory as f32; the
// 8-entry table in shared memory. This is the simple, correct kernel: no
// pipelining across chunks, no wgmma or TMA.

#include "lut_gemm_common.cuh"

namespace {

using namespace flute;

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
lut_qgemm_w3wide_kernel(const T* __restrict__ x, const uint32_t* __restrict__ plane,
                        const T* __restrict__ scales, const float* __restrict__ table,
                        T* __restrict__ y, int M, int N, int K, int group_size, int chunk) {
  // x tile [BM][chunk] while walking K; afterwards the per-warp partial sums
  extern __shared__ float smem[];
  __shared__ float tab[8];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kBlockN + lane;
  const int m0 = blockIdx.y * BM;
  if (threadIdx.x < 8) tab[threadIdx.x] = Cvt<T>::round(table[threadIdx.x]);

  float acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0.f;

  const int ntrip = chunk / 32;  // word triples per chunk
  const int nchunks = K / chunk;
  const bool col_ok = n < N;
  for (int c = 0; c < nchunks; ++c) {
    __syncthreads();  // previous chunk's x tile is no longer read
    const size_t kbase = static_cast<size_t>(c) * chunk;
    stage_x<T, BM>(smem, x, M, K, m0, kbase, chunk);
    __syncthreads();
    if (col_ok) {
      const uint32_t* words = plane + static_cast<size_t>(c) * 3 * ntrip * N + n;
      for (int t = warp; t < ntrip; t += kWarps) {
        const uint64_t lo = static_cast<uint64_t>(__ldg(words + static_cast<size_t>(t) * N)) |
                            static_cast<uint64_t>(__ldg(words + static_cast<size_t>(ntrip + t) * N))
                                << 32;
        const uint64_t hi = __ldg(words + static_cast<size_t>(2 * ntrip + t) * N);
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
          const int k0 = 2 * (j * ntrip + t);  // even K row in the chunk
          const float s = Cvt<T>::to_f(
              scales[static_cast<size_t>((kbase + k0) / group_size) * N + n]);
          const float we = Cvt<T>::round(tab[f & 7u] * s);
          const float wo = Cvt<T>::round(tab[f >> 3] * s);
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
  const void* plane;
  const void* scales;
  const void* table;
  void* y;
  int M, N, K, group_size, chunk;
  cudaStream_t stream;

  template <typename T, int BM>
  cudaError_t run() const {
    return launch_grid<BM>(lut_qgemm_w3wide_kernel<T, BM>, M, N, chunk, stream,
                           static_cast<const T*>(x), static_cast<const uint32_t*>(plane),
                           static_cast<const T*>(scales), static_cast<const float*>(table),
                           static_cast<T*>(y), M, N, K, group_size, chunk);
  }
};

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (x, scales and y share it;
// table is float32 [8]). All pointers are device pointers; the kernel runs on
// `stream` and is not synchronised. Returns the cudaError_t of the launch.
extern "C" int flute_lut_qgemm_w3wide(const void* x, const void* plane, const void* scales,
                                      const void* table, void* y, int M, int N, int K,
                                      int group_size, int chunk, int dtype, int block_m,
                                      void* stream) {
  const Launcher l{x, plane, scales, table, y, M, N, K, group_size, chunk,
                   static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, block_m, l);
}
