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
// plane paired 2 + 1 (pair-row i * kc0 + j takes bits 2(2i + j / kc1) of
// 1-bit word row j % kc1).
//
// The joint table: entry pc = ce | co << b holds (pv[ce, co, 0],
// pv[ce, co, 1]), each rounded to the compute type, packed in one 32-bit
// word in shared memory (8 copies, 8 KB at 4 bits, against bank conflicts):
// one lookup is one mma.sync B register. Its index is derived from the oracle
// (lut_gemm.dequantize_codes_pair indexes pv[ce, co]), not from the TPU tile
// (which stores the transposed payload, lut_gemm.py:690).
//
// Numerics: each weight is pv[ce, co, i] rounded to the compute type, times
// its scale with one packed 16-bit multiply (a single rounding of the exact
// product: the oracle's round(v * s)); products with x are accumulated in
// f32 on the tensor cores and a split-K's partial sums are added in split
// order, so an identity x is bit-exact and a repeat call gives the same
// bits. Like the JAX package's pair_lut mode it runs in 16-bit compute only
// (bf16, f16): the C entry refuses dtype 0 (f32).
//
// What bounds it: bytes at decode (b / 8 byte of plane and 2 / g byte of
// scale per weight), operations at prefill. Design: the tensor-core loop of
// lut_gemm_mma.cuh (16-byte plane loads, a register ring of prefetched
// words, scales once per group, K permuted on the x side, split-K with a
// second pass that adds the splits in order). With more than one split this
// entry launches two kernels: the loop and lut_gemm_mma.cuh's
// split_reduce_kernel.

#include "lut_gemm_mma.cuh"

namespace {

using namespace flute;
using namespace flute::mma;

template <typename T, int NB>
struct PairDecoder {
  static constexpr int kPlaneBits0 = NB == 4 ? 4 : 2;
  static constexpr int kFields = 32 / (2 * kPlaneBits0);
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

  __device__ PairDecoder(Table& t, const float* pv) : tab(t.v + (threadIdx.x & (kCopies - 1))) {
    for (int idx = threadIdx.x; idx < kE * kE * kCopies; idx += blockDim.x) {
      const int pc = idx / kCopies;
      const int ce = pc & (kE - 1);
      const int co = pc >> NB;
      const float* v = pv + 2 * (ce * kE + co);  // pv[ce, co, :]
      t.v[idx] = Pack2<T>::from_f(v[0], v[1]);
    }
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
      return tab[f * kCopies];  // f = ce | co << NB
    }
  }
};

// Items of words prefetched per lane: four (a deeper ring ran slower on the
// H100, and sixteen spilled); four blocks of 128 threads per SM then keep
// 32 KB of plane words in flight.
template <typename T, int NB>
cudaError_t run_bits(const Args& a, int m_tiles, int splits, cudaStream_t s) {
  constexpr int kDepth = 4;
  switch (m_tiles) {
    case 1: return launch_mma<T, 1, kDepth, PairDecoder<T, NB>>(a, splits, s);
    case 2: return launch_mma<T, 2, kDepth, PairDecoder<T, NB>>(a, splits, s);
    case 4: return launch_mma<T, 4, kDepth, PairDecoder<T, NB>>(a, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t run(const Args& a, int num_bits, int m_tiles, int splits, cudaStream_t s) {
  switch (num_bits) {
    case 2: return run_bits<T, 2>(a, m_tiles, splits, s);
    case 3: return run_bits<T, 3>(a, m_tiles, splits, s);
    case 4: return run_bits<T, 4>(a, m_tiles, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// num_bits: 2, 3 or 4; plane1 is the 1-bit plane at 3 bits and is ignored
// otherwise. pv: float32 [2^num_bits, 2^num_bits, 2]. dtype: 1 = float16,
// 2 = bfloat16 (x, scales and y share it); 0 (float32) is refused. m_tiles
// (1, 2 or 4) m16 tiles per warp; splits divides K / chunk, and with more
// than one split `work` is a float32 [splits, M, N] workspace (else null).
// vec: N % 4 == 0 with planes 16-byte and scales 8-byte aligned. The first
// plane's word rows per chunk must be a multiple of 4, and x 16-byte
// aligned. All pointers are device pointers; the kernels run on `stream`
// and are not synchronised. Returns the cudaError_t of the launches.
extern "C" int flute_lut_qgemm_pair(const void* x, const void* plane0, const void* plane1,
                                    const void* scales, const void* pv, void* y, void* work,
                                    int M, int N, int K, int group_size, int chunk, int num_bits,
                                    int dtype, int m_tiles, int splits, int vec, void* stream) {
  const int pb0 = num_bits == 4 ? 4 : 2;
  const int nchunks = chunk > 0 ? K / chunk : 0;
  if (chunk <= 0 || K % chunk || (chunk * pb0 / 32) % 4 || splits < 1 || nchunks % splits ||
      (splits > 1 && work == nullptr))
    return cudaErrorInvalidValue;
  const Args a{x,  static_cast<const uint32_t*>(plane0), static_cast<const uint32_t*>(plane1),
               scales, static_cast<const float*>(pv), y, splits > 1 ? static_cast<float*>(work)
                                                                   : nullptr,
               M, N, K, group_size, chunk, nchunks / splits, vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return run<__half>(a, num_bits, m_tiles, splits, s);
    case 2: return run<__nv_bfloat16>(a, num_bits, m_tiles, splits, s);
    default: return cudaErrorInvalidValue;
  }
}
