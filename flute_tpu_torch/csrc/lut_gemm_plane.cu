// Fused LUT-dequantize + GEMM for the general-table pair-plane ("plane")
// layout at 2, 3 and 4 bits, for Hopper (sm_90a).
//
//   y[M, N] = x[M, K] @ (table[c[K, N]] * scales[K / g, N])
//
// Replaces: flute_tpu/ops/lut_gemm.py::_lut_qgemm_kernel with layout="plane"
// and lut_mode "gather8" or "select" (reached through _lut_qgemm_2d's
// pl.pallas_call), together with its helpers _unpack_pair_fields,
// _lookup_bits_sublane, _select_values and _table_tile_scalar. The table may
// be any 2^b float32 values; nothing about its order or signs is assumed.
//
// Layout decoded (flute_tpu_torch/packing.py::pack_np): a plane of pb bits is
// int32 [K * pb / 32, N], row-major. It holds pair fields ce | co << pb (the
// pb-bit sub-codes of K rows 2p and 2p+1), r = 32 / (2 pb) fields per word,
// LSB first. With kc = chunk * pb / 32 words per chunk, field i of word row
// c * kc + j is pair-row p = c * chunk / 2 + i * kc + j. 2-bit and 4-bit codes
// are one plane (pb = 2: 8 fields of 4 bits; pb = 4: 4 fields of 8 bits).
// A 3-bit code is low2 | high1 << 2 over two planes: the 2-bit plane (kc0 =
// chunk / 16) and the 1-bit plane (kc1 = chunk / 32 = kc0 / 2, 16 fields of
// 2 bits). Pair-row p = i * kc0 + j of the 2-bit plane lies in the 1-bit
// plane at word p % kc1 = j % kc1, field p / kc1 = 2 i + j / kc1.
//
// Three paths, chosen by the caller (ops/lut_gemm.py) before the launch, as
// in lut_gemm_w4sym.cu:
//
// * bf16 and f16 at a chunk the loop takes (a multiple of 32 at 4 bits, of
//   64 at 2 and 3, whose x ring fits shared memory:
//   ops/kernel_config.py::mma_takes_chunk): the tensor-core loop of
//   lut_gemm_mma.cuh with the pair decoder of lut_gemm_pair_decoder.cuh. The planes have K4's geometry, 2+1 planes
//   included, so a field (with its 1-bit bits at 3 bits) is the index
//   ce | co << b of a table of 16-bit pairs (table[ce], table[co]) built by
//   each block from the 2^b values (ScalarFill below): 16, 64 or 256
//   entries. Numerics are K1's: value times scale in one packed 16-bit
//   multiply (the oracle lut_gemm.dequantize_codes), f32 sums on mma.sync,
//   splits added in order, the split independent of M.
// * bf16 and f16 from ops/kernel_config.py::WIDE_MIN_M rows at a chunk
//   the wide-M kernel takes (ops/kernel_config.py::mma_route): that kernel
//   (lut_gemm_wide_m.cuh, wgmma, the same pair table), with the loop's
//   bits; C entry flute_lut_qgemm_plane_wide. From MID_MIN_M to WIDE_MIN_M
//   rows its mid route (row tiles of 16-64 rows, one split of K a block,
//   the loop's workspace and reduction): flute_lut_qgemm_plane_mid.
// * f32, or a chunk the loop cannot take: the SIMT kernel below, on the
//   skeleton of lut_gemm_common.cuh (IEEE FMAs, no TF32; the 2^b-entry
//   table in shared memory; at 3 bits a lane also loads the 1-bit plane's
//   word for its 2-bit word).
//
// Both are bit-exact with an identity x and give the same bits on a repeat
// call; the plain PyTorch version differs only in the order of the f32 sums.
//
// What bounds it: bytes at decode (b / 8 byte of plane plus 2 / g byte of
// scale per weight; 3.35 TB/s on an H100 SXM), operations at prefill; on
// the loop at decode, its per-pair instructions take the time.

#include "lut_gemm_common.cuh"
#include "lut_gemm_pair_decoder.cuh"
#include "lut_gemm_wide_m.cuh"

namespace {

using namespace flute;

// The SIMT kernel (f32, and chunks the loop cannot take); NB: bits per code
// (2, 3 or 4). plane1 is read only at 3 bits.
template <typename T, int BM, int NB>
__global__ void __launch_bounds__(kThreads)
lut_qgemm_plane_kernel(const T* __restrict__ x, const uint32_t* __restrict__ plane0,
                       const uint32_t* __restrict__ plane1, const T* __restrict__ scales,
                       const float* __restrict__ table, T* __restrict__ y, int M, int N,
                       int K, int group_size, int chunk) {
  constexpr int kPB0 = NB == 4 ? 4 : 2;          // bits of the first plane
  constexpr int kFB0 = 2 * kPB0;                 // bits of its pair field
  constexpr int kR0 = 32 / kFB0;                 // pair fields per word
  constexpr uint32_t kFieldMask = (1u << kFB0) - 1;
  constexpr uint32_t kSubMask = (1u << kPB0) - 1;

  // x tile [BM][chunk] while walking K; afterwards the per-warp partial sums
  extern __shared__ float smem[];
  __shared__ float tab[1 << NB];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kBlockN + lane;
  const int m0 = blockIdx.y * BM;
  if (threadIdx.x < (1 << NB)) tab[threadIdx.x] = Cvt<T>::round(table[threadIdx.x]);

  float acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0.f;

  const int kc0 = chunk * kPB0 / 32;  // first-plane word rows per chunk
  const int kc1 = chunk / 32;         // 1-bit plane word rows per chunk (3-bit)
  const int nchunks = K / chunk;
  const bool col_ok = n < N;
  for (int c = 0; c < nchunks; ++c) {
    __syncthreads();  // previous chunk's x tile is no longer read
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
          // fields are read from unsigned words: bit 31 drags nothing in
          const uint32_t f = (w0 >> (kFB0 * i)) & kFieldMask;
          uint32_t ce = f & kSubMask;
          uint32_t co = f >> kPB0;
          if constexpr (NB == 3) {
            const uint32_t h = (w1 >> (2 * (2 * i + hi))) & 3u;
            ce |= (h & 1u) << 2;
            co |= (h >> 1) << 2;
          }
          const int k0 = 2 * (i * kc0 + j);  // even K row in the chunk
          const float s = Cvt<T>::to_f(
              scales[static_cast<size_t>((kbase + k0) / group_size) * N + n]);
          const float we = Cvt<T>::round(tab[ce] * s);
          const float wo = Cvt<T>::round(tab[co] * s);
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
  const void* table;
  void* y;
  int M, N, K, group_size, chunk, num_bits;
  cudaStream_t stream;

  template <typename T, int BM, int NB>
  cudaError_t run_bits() const {
    return launch_grid<BM>(lut_qgemm_plane_kernel<T, BM, NB>, M, N, chunk, stream,
                           static_cast<const T*>(x), static_cast<const uint32_t*>(plane0),
                           static_cast<const uint32_t*>(plane1),
                           static_cast<const T*>(scales), static_cast<const float*>(table),
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

// The tensor-core loop's table: index pc = ce | co << NB names
// (table[ce], table[co]), each rounded to T.
template <int NB>
struct ScalarFill {
  template <typename T>
  static __device__ uint32_t entry(int pc, const float* table) {
    return mma::Pack2<T>::from_f(table[pc & ((1 << NB) - 1)], table[pc >> NB]);
  }
};

}  // namespace

// num_bits: 2, 3 or 4; plane1 is the 1-bit plane at 3 bits and is ignored
// otherwise. dtype: 0 = float32, 1 = float16, 2 = bfloat16 (x, scales and y
// share it; table is float32 [2^num_bits]). m_tiles 0 runs the SIMT kernel
// with block_m (1, 2, 4 or 8) rows per block, in any dtype; m_tiles 1, 2 or
// 4 runs the tensor-core loop (bf16/f16, the first plane's word rows per
// chunk a multiple of 4, x 16-byte aligned) with that many m16 tiles per
// warp and `splits` splits of K / chunk; with more than one split `work` is
// a float32 [splits, M, N] workspace (else null), and the entry launches
// the loop and its split reduction. vec: N % 4 == 0 with planes 16-byte and
// scales 8-byte aligned. All pointers are device pointers; the kernels run
// on `stream` and are not synchronised. Returns the cudaError_t of the
// launches.
extern "C" int flute_lut_qgemm_plane(const void* x, const void* plane0, const void* plane1,
                                     const void* scales, const void* table, void* y, void* work,
                                     int M, int N, int K, int group_size, int chunk, int num_bits,
                                     int dtype, int block_m, int m_tiles, int splits, int vec,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m_tiles == 0) {
    const Launcher l{x, plane0, plane1, scales, table, y, M, N, K, group_size, chunk, num_bits, s};
    return dispatch(dtype, block_m, l);
  }
  mma::Args a;
  if (!mma::pair_args(a, x, plane0, plane1, scales, table, y, work, M, N, K, group_size, chunk,
                      num_bits == 4 ? 4 : 2, splits, vec))
    return cudaErrorInvalidValue;
  switch (num_bits) {
    case 2: return mma::run_pair<2, ScalarFill<2>>(a, dtype, m_tiles, splits, s);
    case 3: return mma::run_pair<3, ScalarFill<3>>(a, dtype, m_tiles, splits, s);
    case 4: return mma::run_pair<4, ScalarFill<4>>(a, dtype, m_tiles, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

// The wide-M kernel (lut_gemm_wide_m.cuh) for bf16/f16: the operands as
// above, no workspace, `splits` splits of K / chunk run in order inside each
// block. Returns the cudaError_t of the launch.
extern "C" int flute_lut_qgemm_plane_wide(const void* x, const void* plane0, const void* plane1,
                                          const void* scales, const void* table, void* y, int M,
                                          int N, int K, int group_size, int chunk, int num_bits,
                                          int dtype, int splits, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  mma::Args a;
  if (!wide::wide_args(a, x, plane0, num_bits == 3 ? plane1 : nullptr, scales, table, y, M, N, K,
                       group_size, chunk, chunk * (num_bits == 4 ? 4 : 2) / 32, splits, vec))
    return cudaErrorInvalidValue;
  switch (num_bits) {
    case 2: return wide::run_pair<2, ScalarFill<2>>(a, dtype, splits, s);
    case 3: return wide::run_pair<3, ScalarFill<3>>(a, dtype, splits, s);
    case 4: return wide::run_pair<4, ScalarFill<4>>(a, dtype, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

// The mid route of the wide-M kernel (lut_gemm_wide_m.cuh, from MID_MIN_M to
// WIDE_MIN_M rows) for bf16/f16: the operands as above, `rows` rows a block (16, 32, 48 or 64),
// one of `splits` splits of K / chunk a block; with more than one split
// `work` is a float32 [splits, M, N] workspace (else null), and the entry
// launches the kernel and the loop's split reduction. Returns the
// cudaError_t of the launches.
extern "C" int flute_lut_qgemm_plane_mid(const void* x, const void* plane0, const void* plane1,
                                         const void* scales, const void* table, void* y,
                                         void* work, int M, int N, int K, int group_size,
                                         int chunk, int num_bits, int dtype, int rows, int splits,
                                         int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  mma::Args a;
  if (!wide::wide_args(a, x, plane0, num_bits == 3 ? plane1 : nullptr, scales, table, y, M, N, K,
                       group_size, chunk, chunk * (num_bits == 4 ? 4 : 2) / 32, splits, vec, work))
    return cudaErrorInvalidValue;
  switch (num_bits) {
    case 2: return wide::run_pair_mid<2, ScalarFill<2>>(a, dtype, rows, splits, s);
    case 3: return wide::run_pair_mid<3, ScalarFill<3>>(a, dtype, rows, splits, s);
    case 4: return wide::run_pair_mid<4, ScalarFill<4>>(a, dtype, rows, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

// Instantiation i of K2's tensor-core kernels, 8 a bit width (2, 3, 4 in
// that order; lut_gemm_wide_m.cuh::describe_pair): its name, registers,
// shared memory (static and dynamic at `chunk`) and blocks per SM.
extern "C" int flute_lut_qgemm_plane_instance(int i, int chunk, const char** name, int* regs,
                                              int* smem, int* blocks) {
  switch (i / 8) {
    case 0: return wide::describe_pair<2, ScalarFill<2>>(i % 8, chunk, name, regs, smem, blocks);
    case 1: return wide::describe_pair<3, ScalarFill<3>>(i % 8, chunk, name, regs, smem, blocks);
    case 2: return wide::describe_pair<4, ScalarFill<4>>(i % 8, chunk, name, regs, smem, blocks);
    default: return cudaErrorInvalidValue;
  }
}

// Instantiation i of K2's mid route, 8 a bit width (2, 3, 4 in that order;
// lut_gemm_wide_m.cuh::describe_pair_mid), as above.
extern "C" int flute_lut_qgemm_plane_mid_instance(int i, int chunk, const char** name, int* regs,
                                                  int* smem, int* blocks) {
  switch (i / 8) {
    case 0: return wide::describe_pair_mid<2, ScalarFill<2>>(i % 8, chunk, name, regs, smem,
                                                             blocks);
    case 1: return wide::describe_pair_mid<3, ScalarFill<3>>(i % 8, chunk, name, regs, smem,
                                                             blocks);
    case 2: return wide::describe_pair_mid<4, ScalarFill<4>>(i % 8, chunk, name, regs, smem,
                                                             blocks);
    default: return cudaErrorInvalidValue;
  }
}
