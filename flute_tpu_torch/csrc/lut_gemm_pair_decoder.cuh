// The pair decoder of the pair-plane layouts on the tensor-core loop
// (lut_gemm_mma.cuh) and the wide-M kernel (lut_gemm_wide_m.cuh), shared by
// K1 (lut_gemm_w4sym.cu), K2 (lut_gemm_plane.cu) and K4 (lut_gemm_pair.cu).
//
// The three layouts have one geometry: a first plane of 4-bit (K1, K2 and
// K4 at 4 bits) or 2-bit sub-codes (2 and 3 bits), pair fields of twice
// that, LSB first, field i of word row c * kc + j holding pair-row
// c * chunk / 2 + i * kc + j; at 3 bits a 1-bit plane paired 2 + 1
// (pair-row i * kc0 + j takes bits 2(2i + j / kc1) of 1-bit word row
// j % kc1). A field, with its 1-bit bits at 3 bits, is an index into a table
// of 16-bit pairs: one lookup is one mma.sync B register. The kernels differ
// only in what an index names, so only the table fill (a Fill) differs:
//
//   K4  JointFill   index ce | co << b   (pv[ce, co, 0], pv[ce, co, 1])
//   K2  ScalarFill  index ce | co << b   (t[ce], t[co])
//   K1  W4SymFill   the w4sym byte       (t[m_e] ^ s_e, t[m_o] ^ s_o) in sign bits
//
// each value rounded to the compute type T. The block fills the table in
// shared memory from the f32 table the C entry is given (8 bank-interleaved
// copies, 8 KB at 4 bits), before the loop's first barrier.
//
// A Fill provides
//   template <typename T> static uint32_t entry(int index, const float* src)
//                          the packed pair (low half the even K row) of an index

#pragma once

#include "lut_gemm_mma.cuh"

namespace flute {
namespace mma {

template <typename T, int NB, typename Fill>
struct PairDecoder {
  static constexpr int kPlaneBits0 = NB == 4 ? 4 : 2;  // bits of the first plane's sub-codes
  static constexpr int kFields = 32 / (2 * kPlaneBits0);
  static constexpr bool kChunkScales = false;
  static constexpr int kRowWords = 1;        // the wide-M kernel's planar words a word row
  static constexpr bool kPlane1 = NB == 3;   // the 1-bit plane (Words w1) at 3 bits
  static constexpr int kMidBlocks = 2;       // the wide-M kernel's mid route: blocks an SM
  // Items of words prefetched per lane: four (a deeper ring ran slower on
  // the H100, and sixteen spilled); four blocks of 128 threads per SM then
  // keep 32 KB of plane words in flight.
  static constexpr int kDepth = 4;
  static __host__ __device__ int word_rows(int chunk) { return chunk * kPlaneBits0 / 32; }
  static constexpr int kE = 1 << NB;
  static constexpr uint32_t kFieldMask = (1u << (2 * kPlaneBits0)) - 1;
  // copies of the table, entry pc of copy c at word pc * kCopies + c: lane l
  // reads copy l % kCopies, so the 4 lanes that share a copy meet in 4 of
  // its banks and 32 random lookups conflict about 2-way, not 3.5-way
  static constexpr int kCopies = 8;

  struct Table {
    uint32_t v[kE * kE * kCopies];
  };
  struct Words {
    uint4 w0;  // first plane: 4 columns of one word row
    uint4 w1;  // the 1-bit plane's word row at 3 bits
  };

  const uint32_t* tab;

  __device__ PairDecoder(Table& t, const float* src) : tab(t.v + (threadIdx.x & (kCopies - 1))) {
    for (int idx = threadIdx.x; idx < kE * kE * kCopies; idx += blockDim.x)
      t.v[idx] = Fill::template entry<T>(idx / kCopies, src);
  }

  __device__ __forceinline__ Words load(const uint32_t* __restrict__ p0,
                                        const uint32_t* __restrict__ p1, int c, int j, int kc0,
                                        int kc1, int n0, int N, bool vec) const {
    Words w;
    w.w0 = load_cols(p0, static_cast<size_t>(c) * kc0 + j, n0, N, vec);
    if constexpr (NB == 3)
      w.w1 = load_cols(p1, static_cast<size_t>(c) * kc1 + j % kc1, n0, N, vec);
    else
      w.w1 = make_uint4(0, 0, 0, 0);
    return w;
  }

  __device__ __forceinline__ uint32_t pair(const Words& w, int e, int i, int j, int kc1) const {
    const uint32_t f = (word_of(w.w0, e) >> (2 * kPlaneBits0 * i)) & kFieldMask;
    if constexpr (NB == 3) {
      const uint32_t h = (word_of(w.w1, e) >> (2 * (2 * i + j / kc1))) & 3u;
      const uint32_t ce = (f & 3u) | ((h & 1u) << 2);
      const uint32_t co = (f >> 2) | ((h >> 1) << 2);
      return tab[(ce | (co << 3)) * kCopies];
    } else {
      return tab[f * kCopies];  // the field is the index
    }
  }
};

// The loop for a C entry's dtype code (1 = float16, 2 = bfloat16; float32 has
// no tensor-core path here: refused).
template <int NB, typename Fill>
cudaError_t run_pair(const Args& a, int dtype, int m_tiles, int splits, cudaStream_t s) {
  switch (dtype) {
    case 1: return run_tiles<__half, PairDecoder<__half, NB, Fill>>(a, m_tiles, splits, s);
    case 2:
      return run_tiles<__nv_bfloat16, PairDecoder<__nv_bfloat16, NB, Fill>>(a, m_tiles, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

// A C entry's operands as the loop's Args (lut_gemm_mma.cuh::loop_args)
// for a first plane of pb0-bit sub-codes.
inline bool pair_args(Args& a, const void* x, const void* plane0, const void* plane1,
                      const void* scales, const void* table, void* y, void* work, int M, int N,
                      int K, int group_size, int chunk, int pb0, int splits, int vec) {
  return loop_args(a, x, plane0, plane1, scales, table, y, work, M, N, K, group_size, chunk,
                   chunk * pb0 / 32, splits, vec);
}

}  // namespace mma
}  // namespace flute
