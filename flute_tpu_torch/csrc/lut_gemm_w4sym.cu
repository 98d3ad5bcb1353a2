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

#include "lut_gemm_common.cuh"

namespace {

using namespace flute;

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
    stage_x<T, BM>(smem, x, M, K, m0, kbase, chunk);
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
    return launch_grid<BM>(lut_qgemm_w4sym_kernel<T, BM>, M, N, chunk, stream,
                           static_cast<const T*>(x), static_cast<const uint32_t*>(plane),
                           static_cast<const T*>(scales), static_cast<const float*>(table),
                           static_cast<T*>(y), M, N, K, group_size, chunk);
  }
};

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (x, scales and y share it;
// table is float32 [16]). All pointers are device pointers; the kernel runs
// on `stream` and is not synchronised. Returns the cudaError_t of the launch.
extern "C" int flute_lut_qgemm_w4sym(const void* x, const void* plane, const void* scales,
                                     const void* table, void* y, int M, int N, int K,
                                     int group_size, int chunk, int dtype, int block_m,
                                     void* stream) {
  const Launcher l{x, plane, scales, table, y, M, N, K, group_size, chunk,
                   static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, block_m, l);
}
