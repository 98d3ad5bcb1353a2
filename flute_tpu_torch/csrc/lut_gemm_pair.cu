// Fused joint-pair-lookup dequantize + GEMM (HIGGS vector dequantization)
// for the pair-plane layout at 2, 3 and 4 bits, for Hopper (sm_90a).
//
//   y[M, N] = x[M, K] @ W,  (W[2j, n], W[2j+1, n]) = pv[c[2j, n], c[2j+1, n]] * scale
//
// Replaces: flute_tpu/ops/lut_gemm.py::_lut_qgemm_kernel with
// lut_mode="pair_lut" (both of its branches; reached through _lut_qgemm_2d's
// pl.pallas_call), with its helpers _lookup_payload_lane and
// _table_tile_pair. The pair table pv is
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
// scale per weight), operations at prefill. Design: the pair decoder of
// lut_gemm_pair_decoder.cuh (with the joint table's fill below) on three
// routes, chosen by M alone (ops/kernel_config.py::mma_route), with the
// same bits:
//
// * below MID_MIN_M rows (decode): the tensor-core loop of
//   lut_gemm_mma.cuh (16-byte plane loads, a register ring of prefetched
//   words, scales once per group, K permuted on the x side, split-K with a
//   second pass that adds the splits in order; the split a function of N,
//   K and chunk alone, so that a row's result does not depend on M:
//   ops/kernel_config.py::mma_plan). With more than one split this entry
//   launches two kernels: the loop and lut_gemm_mma.cuh's
//   split_reduce_kernel.
// * from WIDE_MIN_M rows (prefill), where the wide-M kernel's ring
//   takes the chunk: that kernel (lut_gemm_wide_m.cuh: the TPU kernel's
//   weight-side branch, lut_gemm.py:611-615, taken at :812; wgmma with the
//   decoded pairs as A, 128 x 128 tiles, the loop's split run in order in
//   each block, no workspace); C entry flute_lut_qgemm_pair_wide. The
//   joint table has K2's size, (2^b)^2 x 8 copies of a 32-bit pair, so the
//   ring is K2's. It is bound by operations there.
// * from MID_MIN_M rows below that (the paged engines' admissions of a
//   short prompt): the same kernel's mid route (the TPU kernel's
//   group-accumulating branch, lut_gemm.py:590-602, taken at :812 for
//   bm <= group_acc_max_bm; row tiles of 16-64 rows, one of the loop's
//   splits a block, the loop's workspace and reduction, 2 blocks an SM, K2's
//   ring again); C entry flute_lut_qgemm_pair_mid. It is bound by bytes
//   there, as at decode.
// The routes' bounds are ops/kernel_config.py's MID_MIN_M and WIDE_MIN_M.

#include "lut_gemm_pair_decoder.cuh"
#include "lut_gemm_wide_m.cuh"

namespace {

using namespace flute::mma;

// The joint table: index pc = ce | co << NB names (pv[ce, co, 0], pv[ce, co, 1]).
template <int NB>
struct JointFill {
  template <typename T>
  static __device__ uint32_t entry(int pc, const float* pv) {
    const int ce = pc & ((1 << NB) - 1);
    const int co = pc >> NB;
    const float* v = pv + 2 * (ce * (1 << NB) + co);  // pv[ce, co, :]
    return Pack2<T>::from_f(v[0], v[1]);
  }
};

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
  Args a;
  if (!pair_args(a, x, plane0, plane1, scales, pv, y, work, M, N, K, group_size, chunk,
                 num_bits == 4 ? 4 : 2, splits, vec))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (num_bits) {
    case 2: return run_pair<2, JointFill<2>>(a, dtype, m_tiles, splits, s);
    case 3: return run_pair<3, JointFill<3>>(a, dtype, m_tiles, splits, s);
    case 4: return run_pair<4, JointFill<4>>(a, dtype, m_tiles, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

// The wide-M kernel (lut_gemm_wide_m.cuh) for bf16/f16: the operands as
// above, no workspace, `splits` splits of K / chunk run in order inside each
// block; f32 (dtype 0) is refused. Returns the cudaError_t of the launch.
extern "C" int flute_lut_qgemm_pair_wide(const void* x, const void* plane0, const void* plane1,
                                         const void* scales, const void* pv, void* y, int M,
                                         int N, int K, int group_size, int chunk, int num_bits,
                                         int dtype, int splits, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a;
  if (!flute::wide::wide_args(a, x, plane0, num_bits == 3 ? plane1 : nullptr, scales, pv, y, M,
                              N, K, group_size, chunk, chunk * (num_bits == 4 ? 4 : 2) / 32,
                              splits, vec))
    return cudaErrorInvalidValue;
  switch (num_bits) {
    case 2: return flute::wide::run_pair<2, JointFill<2>>(a, dtype, splits, s);
    case 3: return flute::wide::run_pair<3, JointFill<3>>(a, dtype, splits, s);
    case 4: return flute::wide::run_pair<4, JointFill<4>>(a, dtype, splits, s);
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
extern "C" int flute_lut_qgemm_pair_mid(const void* x, const void* plane0, const void* plane1,
                                        const void* scales, const void* pv, void* y, void* work,
                                        int M, int N, int K, int group_size, int chunk,
                                        int num_bits, int dtype, int rows, int splits, int vec,
                                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a;
  if (!flute::wide::wide_args(a, x, plane0, num_bits == 3 ? plane1 : nullptr, scales, pv, y, M,
                              N, K, group_size, chunk, chunk * (num_bits == 4 ? 4 : 2) / 32,
                              splits, vec, work))
    return cudaErrorInvalidValue;
  switch (num_bits) {
    case 2: return flute::wide::run_pair_mid<2, JointFill<2>>(a, dtype, rows, splits, s);
    case 3: return flute::wide::run_pair_mid<3, JointFill<3>>(a, dtype, rows, splits, s);
    case 4: return flute::wide::run_pair_mid<4, JointFill<4>>(a, dtype, rows, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

// Instantiation i of K4's tensor-core kernels, 8 a bit width (2, 3, 4 in
// that order; lut_gemm_wide_m.cuh::describe_pair): its name, registers,
// shared memory (static and dynamic at `chunk`) and blocks per SM.
extern "C" int flute_lut_qgemm_pair_instance(int i, int chunk, const char** name, int* regs,
                                             int* smem, int* blocks) {
  switch (i / 8) {
    case 0: return flute::wide::describe_pair<2, JointFill<2>>(i % 8, chunk, name, regs, smem,
                                                                blocks);
    case 1: return flute::wide::describe_pair<3, JointFill<3>>(i % 8, chunk, name, regs, smem,
                                                                blocks);
    case 2: return flute::wide::describe_pair<4, JointFill<4>>(i % 8, chunk, name, regs, smem,
                                                                blocks);
    default: return cudaErrorInvalidValue;
  }
}

// Instantiation i of K4's mid route, 8 a bit width (2, 3, 4 in that order;
// lut_gemm_wide_m.cuh::describe_pair_mid), as above.
extern "C" int flute_lut_qgemm_pair_mid_instance(int i, int chunk, const char** name, int* regs,
                                                 int* smem, int* blocks) {
  switch (i / 8) {
    case 0: return flute::wide::describe_pair_mid<2, JointFill<2>>(i % 8, chunk, name, regs,
                                                                    smem, blocks);
    case 1: return flute::wide::describe_pair_mid<3, JointFill<3>>(i % 8, chunk, name, regs,
                                                                    smem, blocks);
    case 2: return flute::wide::describe_pair_mid<4, JointFill<4>>(i % 8, chunk, name, regs,
                                                                    smem, blocks);
    default: return cudaErrorInvalidValue;
  }
}
