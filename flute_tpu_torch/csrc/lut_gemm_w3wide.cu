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
// Four kernels and routes, chosen by the caller (ops/lut_gemm.py::lut_path,
// then ops/kernel_config.py::mma_route by M alone) before the launch, as in
// lut_gemm_w4sym.cu:
//
// * bf16 and f16 at a chunk the loop takes (a multiple of 256 whose x ring
//   fits shared memory: ops/kernel_config.py::mma_takes_chunk): the
//   tensor-core loop of lut_gemm_mma.cuh with W3WideDecoder below. The
//   layout already has the loop's geometry: a triple row is a word row of
//   kc = ntrip rows per chunk with 16 fields, field j of triple row t being
//   pair-row j * kc + t, and the 6-bit field is itself the index of a
//   64-entry table of 16-bit pairs (table[ce], table[co]) that each block
//   fills from the 8 values (K2's 3-bit fill, without the second plane's
//   bits). A lane loads the 3 words of its triple row (3 x 16 bytes, 4
//   columns) two items ahead; the straddling fields take their bits from
//   two words with logical shifts. With 16 fields a per-field scale cache
//   (K1's and K2's) costs 80 registers, so where the group size is a
//   multiple of 2 kc (a field's K rows then lie in one group for the whole
//   chunk: g 32, 64 and 128 at chunk 256 and 512) the lane loads its 16
//   fields' scales once per chunk (32 registers); other group sizes keep
//   the per-field cache. Numerics are K1's: value times scale in one packed
//   16-bit multiply (lut_gemm.dequantize_codes), f32 sums on mma.sync,
//   splits added in order, the split from N, K and chunk alone, so a row's
//   result does not depend on M.
// * bf16 and f16 from WIDE_MIN_M rows (prefill): the wide-M kernel of
//   lut_gemm_wide_m.cuh with the same decoder, the loop's bits; C entry
//   flute_lut_qgemm_w3wide_wide. It replaces the TPU kernel's weight-side
//   branch (flute_tpu/ops/lut_gemm.py:454, :611-615, taken above
//   group_acc_max_bm at :812, with _unpack_wide3_payload :342, :494-506)
//   and is bound by operations. Its shape follows from 16 fields a triple
//   row: a stage holds one item (4 triple rows: 32 KB of x, 16 fields of
//   2 KB, and the three planar words' 4 rows, one TMA box each), so four
//   stages fit; the item's 8 k16 steps are decoded in two halves of 4,
//   one half's A registers (16) filled while the other's products run,
//   because two item-wide sets (64) would not fit beside the 128
//   accumulator and split-total registers; and where g is a multiple of
//   2 kc a lane reads its 16 fields' scales from the staged scale rows
//   once per chunk, both columns' in one register (16 registers, not the
//   48 of a per-field cache).
// * bf16 and f16 from MID_MIN_M to WIDE_MIN_M rows (the paged engines'
//   admissions of a short prompt): the wide-M kernel's mid route, the
//   loop's bits again; C entry flute_lut_qgemm_w3wide_mid. It replaces the
//   TPU kernel's group-accumulating branch (lut_gemm.py:590-602, taken at
//   :812 for bm <= group_acc_max_bm) and, like a decode step, is bound by
//   bytes: a row tile of 16-64 rows, one of the loop's splits a block
//   written to the loop's workspace, the wide route's stage of one item
//   (two at 16 rows) and its two half-item A-register sets. Two blocks an
//   SM (a cap of 128 registers) with a chunk's scales (g a multiple of
//   2 kc, 16 registers: 103-126 in all, no spill). The per-field cache
//   takes 48 (its scales and each field's group; 140-168 in all): that
//   instantiation runs one block an SM with a ring sized for the whole SM
//   (W3WideDecoder::kMidBlocks).
// * f32, or a chunk the loop cannot take: the SIMT kernel below, on the
//   skeleton of lut_gemm_common.cuh: one lane per output column, eight warps
//   splitting each chunk's triples, a lane joining its triple's words into
//   two unsigned 64-bit halves (every field a shift and a mask), x staged in
//   shared memory as f32, the 8-entry table in shared memory; IEEE FMAs, no
//   TF32.
//
// The routes' bounds are ops/kernel_config.py's MID_MIN_M and WIDE_MIN_M.
// All are bit-exact with an identity x and give the same bits on a repeat call; the
// plain PyTorch version differs only in the order of the f32 sums.
//
// What bounds it: bytes at decode (3/8 byte of plane plus 2 / g byte of
// scale per weight; 3.35 TB/s on an H100 SXM), operations at prefill; on
// the loop at decode its per-pair instructions (field, lookup, scale
// multiply) take the time, as in K1, K2 and K4.

#include "lut_gemm_common.cuh"
#include "lut_gemm_mma.cuh"
#include "lut_gemm_wide_m.cuh"

namespace {

using namespace flute;

// The SIMT kernel (f32, and chunks the loop cannot take).
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

// The tensor-core loop's decoder of the w3wide plane (see the note at the
// top). CHUNK_GROUPS: the group size is a multiple of 2 kc, so the loop loads
// a chunk's scales once per field (lut_gemm_mma.cuh, kChunkScales).
template <typename T, bool CHUNK_GROUPS>
struct W3WideDecoder {
  static constexpr int kFields = 16;  // six-bit fields per triple row
  static constexpr bool kChunkScales = CHUNK_GROUPS;
  // Items prefetched per lane: two. An item is 12 registers of words, 4x
  // the pairs of a 4-bit item, so two keep more bytes in flight than K1's
  // four.
  static constexpr int kDepth = 2;
  static constexpr int kCopies = 8;  // bank-interleaved copies, as PairDecoder's
  static constexpr int kRowWords = 3;  // the wide-M kernel stages each planar word's rows
  static constexpr bool kPlane1 = false;
  // The mid route's blocks an SM: 2 with a chunk's scales (16 registers);
  // with the per-field cache's 48 a thread needs more than 2 blocks' 128
  static constexpr int kMidBlocks = CHUNK_GROUPS ? 2 : 1;
  static __host__ __device__ int word_rows(int chunk) { return chunk / 32; }

  struct Table {
    uint32_t v[64 * kCopies];
  };
  struct Words {
    uint4 w0, w1, w2;  // the triple's three words, 4 columns each
  };

  const uint32_t* tab;

  // entry ce | co << 3 names (table[ce], table[co]), each rounded to T
  __device__ W3WideDecoder(Table& t, const float* src) : tab(t.v + (threadIdx.x & (kCopies - 1))) {
    for (int idx = threadIdx.x; idx < 64 * kCopies; idx += blockDim.x) {
      const int pc = idx / kCopies;
      t.v[idx] = mma::Pack2<T>::from_f(src[pc & 7], src[pc >> 3]);
    }
  }

  // triple row j of chunk c: word rows c * 3 kc + j, + kc and + 2 kc
  __device__ __forceinline__ Words load(const uint32_t* __restrict__ p0, const uint32_t*, int c,
                                        int j, int kc, int, int n0, int N, bool vec) const {
    const size_t row = static_cast<size_t>(c) * 3 * kc + j;
    Words w;
    w.w0 = mma::load_cols(p0, row, n0, N, vec);
    w.w1 = mma::load_cols(p0, row + kc, n0, N, vec);
    w.w2 = mma::load_cols(p0, row + 2 * kc, n0, N, vec);
    return w;
  }

  // field i (bits 6i..6i+5 of the 96-bit triple) of column e; i is a
  // constant once the loop is unrolled, so every shift is too
  __device__ __forceinline__ uint32_t pair(const Words& w, int e, int i, int, int) const {
    const uint32_t a = mma::word_of(w.w0, e);
    const uint32_t b = mma::word_of(w.w1, e);
    const uint32_t c = mma::word_of(w.w2, e);
    uint32_t f;
    if (i < 5)
      f = a >> (6 * i);
    else if (i == 5)
      f = (a >> 30) | (b << 2);  // bits 30-31 of the first word, 0-3 of the second
    else if (i < 10)
      f = b >> (6 * i - 32);
    else if (i == 10)
      f = (b >> 28) | (c << 4);  // bits 28-31 of the second word, 0-1 of the third
    else
      f = c >> (6 * i - 64);
    return tab[(f & 63u) * kCopies];
  }
};

template <typename T>
cudaError_t run_loop(const mma::Args& a, int m_tiles, int splits, cudaStream_t s) {
  if (a.group_size % (2 * W3WideDecoder<T, true>::word_rows(a.chunk)) == 0)
    return mma::run_tiles<T, W3WideDecoder<T, true>>(a, m_tiles, splits, s);
  return mma::run_tiles<T, W3WideDecoder<T, false>>(a, m_tiles, splits, s);
}

template <typename T>
cudaError_t run_wide(const mma::Args& a, int splits, cudaStream_t s) {
  if (a.group_size % (2 * W3WideDecoder<T, true>::word_rows(a.chunk)) == 0)
    return wide::launch_wide<T, W3WideDecoder<T, true>>(a, splits, s);
  return wide::launch_wide<T, W3WideDecoder<T, false>>(a, splits, s);
}

template <typename T>
cudaError_t run_mid(const mma::Args& a, int rows, int splits, cudaStream_t s) {
  if (a.group_size % (2 * W3WideDecoder<T, true>::word_rows(a.chunk)) == 0)
    return wide::launch_mid<T, W3WideDecoder<T, true>>(a, rows, splits, s);
  return wide::launch_mid<T, W3WideDecoder<T, false>>(a, rows, splits, s);
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (x, scales and y share it;
// table is float32 [8]). m_tiles 0 runs the SIMT kernel with block_m (1, 2,
// 4 or 8) rows per block, in any dtype; m_tiles 1, 2 or 4 runs the
// tensor-core loop (bf16/f16, chunk a multiple of 256, x 16-byte aligned)
// with that many m16 tiles per warp and `splits` splits of K / chunk; with
// more than one split `work` is a float32 [splits, M, N] workspace (else
// null), and the entry launches the loop and its split reduction. vec: N %
// 4 == 0 with the plane 16-byte and scales 8-byte aligned. All pointers are
// device pointers; the kernels run on `stream` and are not synchronised.
// Returns the cudaError_t of the launches.
extern "C" int flute_lut_qgemm_w3wide(const void* x, const void* plane, const void* scales,
                                      const void* table, void* y, void* work, int M, int N,
                                      int K, int group_size, int chunk, int dtype, int block_m,
                                      int m_tiles, int splits, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m_tiles == 0) {
    const Launcher l{x, plane, scales, table, y, M, N, K, group_size, chunk, s};
    return dispatch(dtype, block_m, l);
  }
  mma::Args a;
  if (chunk % 256 || !mma::loop_args(a, x, plane, nullptr, scales, table, y, work, M, N, K,
                                     group_size, chunk, chunk / 32, splits, vec))
    return cudaErrorInvalidValue;
  switch (dtype) {
    case 1: return run_loop<__half>(a, m_tiles, splits, s);
    case 2: return run_loop<__nv_bfloat16>(a, m_tiles, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

// The wide-M kernel (lut_gemm_wide_m.cuh) for bf16/f16: the operands as
// above, no workspace, `splits` splits of K / chunk run in order inside each
// block; f32 (dtype 0) is refused (its callers run the SIMT kernel). Returns
// the cudaError_t of the launch.
extern "C" int flute_lut_qgemm_w3wide_wide(const void* x, const void* plane, const void* scales,
                                           const void* table, void* y, int M, int N, int K,
                                           int group_size, int chunk, int dtype, int splits,
                                           int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  mma::Args a;
  if (chunk % 256 || !wide::wide_args(a, x, plane, nullptr, scales, table, y, M, N, K,
                                      group_size, chunk, chunk / 32, splits, vec))
    return cudaErrorInvalidValue;
  switch (dtype) {
    case 1: return run_wide<__half>(a, splits, s);
    case 2: return run_wide<__nv_bfloat16>(a, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

// The mid route of the wide-M kernel (lut_gemm_wide_m.cuh, from MID_MIN_M to
// WIDE_MIN_M rows) for bf16/f16: the operands as above, `rows`
// rows a block (16, 32, 48 or 64), one of `splits` splits of K / chunk a
// block; with more than one split `work` is a float32 [splits, M, N]
// workspace (else null), and the entry launches the kernel and the loop's
// split reduction; f32 (dtype 0) is refused. Returns the cudaError_t of the
// launches.
extern "C" int flute_lut_qgemm_w3wide_mid(const void* x, const void* plane, const void* scales,
                                          const void* table, void* y, void* work, int M, int N,
                                          int K, int group_size, int chunk, int dtype, int rows,
                                          int splits, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  mma::Args a;
  if (chunk % 256 || !wide::wide_args(a, x, plane, nullptr, scales, table, y, M, N, K,
                                      group_size, chunk, chunk / 32, splits, vec, work))
    return cudaErrorInvalidValue;
  switch (dtype) {
    case 1: return run_mid<__half>(a, rows, splits, s);
    case 2: return run_mid<__nv_bfloat16>(a, rows, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

// Instantiation i of K3's tensor-core kernels (lut_gemm_wide_m.cuh::
// describe_decoders): 0..7 with a chunk's scales once per field (g a
// multiple of 2 kc), 8..15 with the per-field cache; its name, registers,
// shared memory (static and dynamic at `chunk`) and blocks per SM.
extern "C" int flute_lut_qgemm_w3wide_instance(int i, int chunk, const char** name, int* regs,
                                               int* smem, int* blocks) {
  switch (i / 8) {
    case 0:
      return wide::describe_decoders<W3WideDecoder<__nv_bfloat16, true>,
                                     W3WideDecoder<__half, true>>(i % 8, chunk, name, regs, smem,
                                                                  blocks);
    case 1:
      return wide::describe_decoders<W3WideDecoder<__nv_bfloat16, false>,
                                     W3WideDecoder<__half, false>>(i % 8, chunk, name, regs,
                                                                   smem, blocks);
    default: return cudaErrorInvalidValue;
  }
}

// Instantiation i of K3's mid route (lut_gemm_wide_m.cuh::describe_mid): 0..7
// with a chunk's scales once per field, 8..15 with the per-field cache; its
// name, registers, shared memory and blocks per SM, as above.
extern "C" int flute_lut_qgemm_w3wide_mid_instance(int i, int chunk, const char** name, int* regs,
                                                   int* smem, int* blocks) {
  switch (i / 8) {
    case 0:
      return wide::describe_mid<W3WideDecoder<__nv_bfloat16, true>, W3WideDecoder<__half, true>>(
          i % 8, chunk, name, regs, smem, blocks);
    case 1:
      return wide::describe_mid<W3WideDecoder<__nv_bfloat16, false>,
                                W3WideDecoder<__half, false>>(i % 8, chunk, name, regs, smem,
                                                              blocks);
    default: return cudaErrorInvalidValue;
  }
}
