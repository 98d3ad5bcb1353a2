// Decoders of the lab's tensor-core loop (lab_mma.cuh) that both lab
// libraries run: L5 g8_rs (kernel_lab.cu, flute_lab_g8_rs) and L11
// slabstream (kernel_lab2.cu, flute_lab2_slabstream) compute one function,
// bf16(T[f & 15]), bf16(T[f >> 4]) from the raw pair field f, then
// group_acc, and share FLUTE's pair table below. The decoder contract is in
// lab_mma.cuh's header.

#pragma once

#include "lab_mma.cuh"

namespace flute {
namespace labmma {

// bf16(T[k]) as a 16-bit pattern, rounded once from the f32 table
__device__ __forceinline__ uint32_t table_bits(const float* table, int k) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(__ldg(table + k)));
}

// FLUTE's pair table in shared memory (the served loop's PairDecoder with
// ScalarFill<4>, csrc/lut_gemm_pair_decoder.cuh), T[c] read once with no
// select. Entry f = ce | co << 4, the field itself, holds (bf16(T[ce]),
// bf16(T[co])), so one ld.shared is one B register. kCopies
// bank-interleaved copies (entry f of copy c at word f * kCopies + c; lane
// l reads copy l % kCopies), as many as leave four blocks an SM (the ring is
// 48.5 KB a block): 4 copies (4 KB) with group_acc, 2 (2 KB) beside
// "repeat"'s 4 KB of scale rows. The table sits at a fixed offset of
// dynamic shared memory, so a lookup's address is one shift and one and-or
// of the word plus a constant.
template <int kCopies>
struct PairTableDecoder {
  static constexpr int kPlanes = 1, kFieldBits = 8, kProducts = 1;
  static constexpr int kTableWords = 256 * kCopies;
  static constexpr int kShift = kCopies == 4 ? 4 : kCopies == 2 ? 3 : 2;  // log2(4 kCopies)
  static_assert(4 * kCopies == 1 << kShift, "a power-of-two number of copies, at most 4");
  const unsigned char* tab;  // the table
  uint32_t copy;             // this lane's copy, in bytes

  __device__ PairTableDecoder(const Args& a, uint32_t* t)
      : tab(reinterpret_cast<const unsigned char*>(t)), copy(4u * (threadIdx.x % kCopies)) {
    for (int idx = threadIdx.x; idx < kTableWords; idx += kThreads) {
      const int f = idx / kCopies;
      t[idx] = table_bits(a.table, f & 15) | (table_bits(a.table, f >> 4) << 16);
    }
  }

  // entry (byte i of w) of this lane's copy
  __device__ __forceinline__ uint32_t lookup(uint32_t w, int i) const {
    const uint32_t f = 8 * i >= kShift ? w >> (8 * i - kShift) : w << (kShift - 8 * i);
    return *reinterpret_cast<const uint32_t*>(tab + ((f & (0xFFu << kShift)) | copy));
  }

  __device__ __forceinline__ void pairs(const uint32_t (&w)[2], int i,
                                        uint32_t (&b)[1][2]) const {
    b[0][0] = lookup(w[0], i);
    b[0][1] = lookup(w[1], i);
  }
};

}  // namespace labmma
}  // namespace flute
