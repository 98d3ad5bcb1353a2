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
// Three paths, chosen by the caller (ops/lut_gemm.py) before the launch:
//
// * bf16 and f16 at a chunk the loop takes (a multiple of 32 whose x ring
//   fits shared memory: ops/kernel_config.py::mma_takes_chunk): the
//   tensor-core loop of lut_gemm_mma.cuh with the pair decoder of
//   lut_gemm_pair_decoder.cuh.
//   The plane has K4's 4-bit geometry, so the byte is the index of a
//   256-entry table of 16-bit pairs (W4SymFill below, built by each block
//   from the 8 magnitudes): one lookup is one mma.sync B register. Each
//   weight is the pair value times its scale in one packed 16-bit multiply
//   (the oracle lut_gemm.dequantize_codes: value * scale rounded once),
//   products accumulate in f32 on mma.sync, and a split-K's partial sums
//   are added in split order. The split is a function of N, K and chunk
//   alone (ops/kernel_config.py::mma_plan), so a row's result does not
//   depend on M: the same bits in a batch of 1 or 512.
// * bf16 and f16 from ops/kernel_config.py::WIDE_MIN_M rows at a chunk
//   the wide-M kernel takes (ops/kernel_config.py::mma_route): that kernel
//   (lut_gemm_wide_m.cuh, wgmma, the same pair table), with the loop's
//   bits; C entry flute_lut_qgemm_w4sym_wide. From MID_MIN_M to WIDE_MIN_M
//   rows its mid route (row tiles of 16-64 rows, one split of K a block,
//   the loop's workspace and reduction): flute_lut_qgemm_w4sym_mid.
// * f32, or a chunk the loop cannot take: the SIMT kernel below, on the
//   skeleton of lut_gemm_common.cuh (IEEE FMAs, no TF32).
//
// Both are bit-exact with an identity x (a product of two 16-bit values is
// exact in f32) and give the same bits on a repeat call; the plain PyTorch
// version differs only in the order of the f32 sums.
//
// What bounds it: bytes at decode (0.5 byte of plane plus 2/g byte of scale
// per weight; 3.35 TB/s on an H100 SXM), operations at prefill. The loop's
// design answers the bytes (16-byte plane loads four items ahead, scales
// once per group, x in shared memory as 16-bit A fragments); at decode its
// per-pair instructions (field, lookup, scale multiply) take the time.

#include "lut_gemm_common.cuh"
#include "lut_gemm_pair_decoder.cuh"
#include "lut_gemm_wide_m.cuh"

namespace {

using namespace flute;

// The SIMT kernel (f32, and chunks the loop cannot take): one lane per
// output column, eight warps splitting each chunk's word rows, the block's
// x rows staged in shared memory as f32, the 8 magnitudes in shared memory.
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

// The tensor-core loop's table: index f, the w4sym byte, names
// (table[m_e] ^ s_e, table[m_o] ^ s_o), each magnitude rounded to T and the
// sign applied to the 16-bit value's sign bit (bit 15 of the low half, bit
// 31 of the high half) as the JAX kernel's payload XOR applies it.
struct W4SymFill {
  template <typename T>
  static __device__ uint32_t entry(int f, const float* table) {
    const uint32_t u = static_cast<uint32_t>(f);
    const uint32_t p = mma::Pack2<T>::from_f(table[u & 7u], table[(u >> 3) & 7u]);
    return p ^ (((u >> 6) & 1u) << 15) ^ ((u >> 7) << 31);
  }
};

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (x, scales and y share it;
// table is float32 [16], of which the 8 magnitudes are read). m_tiles 0 runs
// the SIMT kernel with block_m (1, 2, 4 or 8) rows per block, in any dtype;
// m_tiles 1, 2 or 4 runs the tensor-core loop (bf16/f16, chunk a multiple of
// 32, x 16-byte aligned) with that many m16 tiles per warp and `splits`
// splits of K / chunk; with more than one split `work` is a float32
// [splits, M, N] workspace (else null), and the entry launches the loop and
// its split reduction. vec: N % 4 == 0 with the plane 16-byte and scales
// 8-byte aligned. All pointers are device pointers; the kernels run on
// `stream` and are not synchronised. Returns the cudaError_t of the launches.
extern "C" int flute_lut_qgemm_w4sym(const void* x, const void* plane, const void* scales,
                                     const void* table, void* y, void* work, int M, int N, int K,
                                     int group_size, int chunk, int dtype, int block_m,
                                     int m_tiles, int splits, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m_tiles == 0) {
    const Launcher l{x, plane, scales, table, y, M, N, K, group_size, chunk, s};
    return dispatch(dtype, block_m, l);
  }
  mma::Args a;
  if (!mma::pair_args(a, x, plane, nullptr, scales, table, y, work, M, N, K, group_size, chunk,
                      4, splits, vec))
    return cudaErrorInvalidValue;
  return mma::run_pair<4, W4SymFill>(a, dtype, m_tiles, splits, s);
}

// The wide-M kernel (lut_gemm_wide_m.cuh) for bf16/f16: the operands as
// above, no workspace, `splits` splits of K / chunk run in order inside each
// block. Returns the cudaError_t of the launch.
extern "C" int flute_lut_qgemm_w4sym_wide(const void* x, const void* plane, const void* scales,
                                          const void* table, void* y, int M, int N, int K,
                                          int group_size, int chunk, int dtype, int splits,
                                          int vec, void* stream) {
  mma::Args a;
  if (!wide::wide_args(a, x, plane, nullptr, scales, table, y, M, N, K, group_size, chunk,
                       chunk / 8, splits, vec))
    return cudaErrorInvalidValue;
  return wide::run_pair<4, W4SymFill>(a, dtype, splits, static_cast<cudaStream_t>(stream));
}

// The mid route of the wide-M kernel (lut_gemm_wide_m.cuh, from MID_MIN_M to
// WIDE_MIN_M rows) for bf16/f16: the operands as above, `rows` rows a block (16, 32, 48 or 64),
// one of `splits` splits of K / chunk a block; with more than one split
// `work` is a float32 [splits, M, N] workspace (else null), and the entry
// launches the kernel and the loop's split reduction. Returns the
// cudaError_t of the launches.
extern "C" int flute_lut_qgemm_w4sym_mid(const void* x, const void* plane, const void* scales,
                                         const void* table, void* y, void* work, int M, int N,
                                         int K, int group_size, int chunk, int dtype, int rows,
                                         int splits, int vec, void* stream) {
  mma::Args a;
  if (!wide::wide_args(a, x, plane, nullptr, scales, table, y, M, N, K, group_size, chunk,
                       chunk / 8, splits, vec, work))
    return cudaErrorInvalidValue;
  return wide::run_pair_mid<4, W4SymFill>(a, dtype, rows, splits,
                                          static_cast<cudaStream_t>(stream));
}

// Instantiation i (0..7) of K1's tensor-core kernels: its name, registers,
// shared memory (static and dynamic at `chunk`) and blocks per SM.
extern "C" int flute_lut_qgemm_w4sym_instance(int i, int chunk, const char** name, int* regs,
                                              int* smem, int* blocks) {
  return wide::describe_pair<4, W4SymFill>(i, chunk, name, regs, smem, blocks);
}

// Instantiation i (0..7) of K1's mid route (lut_gemm_wide_m.cuh::
// describe_pair_mid), as above.
extern "C" int flute_lut_qgemm_w4sym_mid_instance(int i, int chunk, const char** name, int* regs,
                                                  int* smem, int* blocks) {
  return wide::describe_pair_mid<4, W4SymFill>(i, chunk, name, regs, smem, blocks);
}

// The tensor core's bits on one k16 step by mma.sync and by wgmma in both
// operand orientations (lut_gemm_wide_m.cuh::wgmma_probe_kernel): x and w
// [trials, 128, 16] in the dtype (1 = float16, 2 = bfloat16), c [trials,
// 128, 128] f32, out [trials, 3, 128, 128] f32.
extern "C" int flute_wgmma_probe(const void* x, const void* w, const void* c, void* out,
                                 int trials, int dtype, void* stream) {
  return wide::run_probe(x, w, static_cast<const float*>(c), static_cast<float*>(out), trials,
                         dtype, static_cast<cudaStream_t>(stream));
}

