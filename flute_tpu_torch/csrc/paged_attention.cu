// Paged GQA attention over a block-pool KV cache, for Hopper (sm_90a): the
// T = 1 decode kernel (K5) and the T-query verify / pool-prefill kernel (K6),
// one template, two C entries.
//
//   out[b, t, h] = softmax_j(q[b, t, h] . k[b, j] * scale) @ v[b, j]
//
// over the positions j a row may attend; position j of sequence b lives in
// pool row tables[b, j / BS] at offset j % BS of k_pool / v_pool
// [NB, Hkv, BS, D]. Decode: row (b, h) attends j < lengths[b]. Verify: query
// t attends j < lengths[b] + t + 1 (its own K/V already written). Options:
// Gemma-2's logit softcap, s = tanh(s / cap) * cap, applied before the mask,
// and a sliding window, j >= attendable - window.
//
// Replaces: flute_tpu/ops/paged_attention.py::paged_decode_attention (its
// pl.pallas_call of _kernel) and ::paged_verify_attention (its
// pl.pallas_call of _verify_kernel).
//
// Design of paged_attention_kernel. One block of 8 warps per (sequence, KV
// head, tile of ROWS query rows); a row is a (query t, head of the KV head's
// group) pair, so the rep = H / Hkv heads that share a KV head read each pool
// block once, and in the f32 verify kernel the T queries of a tile do too. The q tile is staged in
// shared memory as f32. Each warp walks its own share of the sequence's
// logical blocks (j = warp, warp + 8, ...), reading the block table itself
// and skipping blocks that no row of the tile may attend (past the longest
// row's end, or wholly before the window), and keeps its own flash state per
// row in registers: running max, sum of exponentials and the numerator of
// its lane's columns. For the scores each lane takes one position of the
// block and a 32/BS-th of the head dimension (16-byte loads of K, four in
// flight), the lanes of a position add their parts with shuffles; the row
// max and sum are shuffle reductions over positions; for the numerator each
// lane owns D/32 columns of V (eight positions' loads in flight) and
// receives each position's probability by shuffle. No barrier inside the
// walk. At the end the 8 warps' states are merged in
// shared memory (max of the maxima, sums and numerators rescaled to it),
// and the output is the numerator over max(sum, 1e-30), in q's dtype.
//
// Masks, as the TPU kernels have them (both kernels). Decode uses -inf:
// every block it visits holds a position each row may attend, and a slot of length 0
// (parked on the trash block) visits none and returns 0 / 1e-30 = 0.
// Verify uses the finite -1e30: its rows have different ranges, so a
// visited block may hold nothing a row may attend, and -inf there would
// give exp(-inf - -inf) = NaN. With -1e30 such a row gathers exp(0) junk,
// which the first block it may attend erases (alpha = exp(-1e30 - m) = 0;
// across warps the merge's factor exp(-1e30 - M) = 0 does the same); every
// row may attend at least its own position.
//
// What bounds it: bytes (the live K/V blocks, read once per KV head and
// tile) at decode, far below the operations bound. Simple: no split of a
// sequence across blocks (a decode launch has B * Hkv blocks), no
// cp.async/TMA staging. K5 in f32 and K6 in f32 run this kernel.
//
// K5 in bf16 and f16 runs decode_span_kernel and decode_merge_kernel
// (below). Decode is bound by bytes: each live K/V position is read once per
// KV head. One block per (sequence, KV head) gave B * Hkv = 64 blocks at
// Llama's 8 KV heads and batch 8, under half of the 132 SMs, with each
// block's loads serialised behind its own arithmetic. So each sequence's
// positions are cut into fixed spans of `span` positions (a whole number of
// 64-position stages; a constant of the caller, never a function of B or of
// other sequences' lengths), and each (span, sequence, KV head, tile of 16
// query heads) is one block of 4 warps; a span past the sequence's end or
// wholly before its window exits at once (where the table holds one span,
// after writing the zeros of a sequence with nothing to attend). The block reads its span's
// block-table entries once and stages the span's K and V in 64-position
// stages, double-buffered, with 16-byte cp.async (positions outside the
// range it attends zero-filled). Warp w takes positions 16w..16w+15 of each
// stage: S = Q K^T on mma.sync.m16n8k16 with the rep query heads of the KV
// head as rows of the m16 tile (rows past rep repeat the last and are not
// stored), scale, softcap, the -inf mask, an online softmax per row in f32,
// P rounded to the input type as the A operand of PV (V through
// ldmatrix.trans), as verify_mma_kernel does. A piece the warp computes
// holds a position that every row attends (the rows share one range), so
// the running max is finite after it and exp(-inf - m) = 0 needs no guard.
// The 4 warps' states are merged in shared memory in warp order. With one
// span in the table the block writes the output; else it writes the
// span's max, sum and numerator (f32) to a workspace, and the merge kernel
// adds the live spans in span order, skipping dead ones (no -inf - -inf).
// No atomics: a repeat call gives the same bits, and a sequence's output
// has the same bits alone, in a batch and with a wider table.
//
// K6 in bf16 and f16 runs verify_mma_kernel (below): at prefill the
// operations bound it, so it runs both products on tensor cores.
// A block owns 64 query rows of one (sequence, KV head): 16 queries x rep 4
// heads at Llama's 32/8, so every K/V position the tile may attend is read
// from the pool once per block, and each of its 4 warps owns 16 rows. The
// block reads its block-table row itself and gathers the positions
// [window start of its first row, end of its last row) into a shared-memory
// ring of 64 positions, double-buffered, with 16-byte cp.async (positions
// outside that range are zero-filled). Each warp keeps its Q rows in
// registers as mma A fragments; per 16 positions it computes S = Q K^T with
// mma.sync.m16n8k16 (K fragments through ldmatrix), applies scale, softcap,
// the window and the -1e30 mask to the f32 accumulators, updates an online
// softmax per row (max and sum reduced over the 4 lanes of a quad), rounds P
// to the input type as the A operand of the second mma.sync and takes V
// through ldmatrix.trans. A warp skips 16 positions that none of its rows
// may attend (exact: they would add exp(-1e30 - m) = 0). The end divides by
// max(l, 1e-30) and stores in q's type. No atomics, no split of the
// sequence: a repeat call gives the same bits. Rounding P to 16 bits before
// PV is its one rounding that the f32 kernel does not make.

#include "lut_gemm_mma.cuh"  // Cvt<T>, mma.sync / ldmatrix / cp.async helpers

#include <math.h>

namespace {

using flute::Cvt;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Params {
  const void* q;       // [B, T, H, D]
  const void* k_pool;  // [NB, Hkv, BS, D]
  const void* v_pool;
  const int* tables;   // [B, MB], in [0, NB)
  const int* lengths;  // [B]
  void* out;           // [B, T, H, D]
  int B, T, H, Hkv, D, NB, BS, MB;
  float scale;
  int has_softcap;
  float softcap;
  int has_window;
  int window;
};

// out[i] = p[i] as f32 for N consecutive elements, in 16-byte (or 8- or
// 4-byte) loads for the 16-bit types; p is aligned to the load.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, float (&out)[N]) {
  if constexpr (sizeof(T) == 2 && N % 8 == 0) {
#pragma unroll
    for (int c = 0; c < N / 8; ++c) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + c);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < 8; ++i) out[8 * c + i] = Cvt<T>::to_f(e[i]);
    }
  } else if constexpr (sizeof(T) == 2 && N == 4) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = Cvt<T>::to_f(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = Cvt<T>::to_f(p[i]);
  }
}

// DPL = D / 32 columns of the head dimension per lane.
template <typename T, int ROWS, int DPL, bool VERIFY>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(const Params p) {
  const float kMask = VERIFY ? -1e30f : -INFINITY;
  constexpr int D = 32 * DPL;
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int rep = p.H / p.Hkv;
  const int R = p.T * rep;  // query rows of this (sequence, KV head)
  const int r0 = blockIdx.z * ROWS;
  const int BS = p.BS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int P = 32 / BS;      // lanes per position
  const int s = lane / P;     // this lane's position within a block
  const int dpp = D / P;      // its part of the head dimension (a multiple of 32)
  const int d_part = (lane - s * P) * dpp;

  extern __shared__ float sm[];
  float* qs = sm;                        // [ROWS][D]
  float* m_s = qs + ROWS * D;            // [kWarps][ROWS]
  float* l_s = m_s + kWarps * ROWS;      // [kWarps][ROWS]
  float* acc_s = l_s + kWarps * ROWS;    // [kWarps][ROWS][D]

  const T* q = static_cast<const T*>(p.q);
  const T* kpool = static_cast<const T*>(p.k_pool);
  const T* vpool = static_cast<const T*>(p.v_pool);
  const int length = p.lengths[b];

  // rows past R repeat the tile's last real row and are never stored
  for (int idx = threadIdx.x; idx < ROWS * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int rr = min(r0 + r, R - 1);
    const int t = rr / rep;
    const int h = kvh * rep + rr % rep;
    qs[idx] = Cvt<T>::to_f(q[(static_cast<size_t>(b) * p.T + t) * p.H * D +
                             static_cast<size_t>(h) * D + d]);
  }
  int att[ROWS];  // positions each row may attend: [att - window, att)
#pragma unroll
  for (int r = 0; r < ROWS; ++r) att[r] = length + (VERIFY ? min(r0 + r, R - 1) / rep + 1 : 0);
  const int att_lo = att[0];
  const int att_hi = length + (VERIFY ? (min(r0 + ROWS, R) - 1) / rep + 1 : 0);
  __syncthreads();

  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = kMask;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  for (int j = warp; j < p.MB; j += kWarps) {
    const int base = j * BS;
    bool live = base < att_hi;
    if (p.has_window) live = live && base + BS > att_lo - p.window;
    if (!live) continue;  // the same for every lane of the warp
    const size_t blk = (static_cast<size_t>(p.tables[b * p.MB + j]) * p.Hkv + kvh) * BS * D;

    // scores: this lane's part of q . k for its position, then the parts added
    float sc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) sc[r] = 0.f;
    const T* krow = kpool + blk + static_cast<size_t>(s) * D + d_part;
    for (int d0 = 0; d0 < dpp; d0 += 32) {
      float kv[4][8];  // four loads in flight before the first use
#pragma unroll
      for (int c = 0; c < 4; ++c) load_f32<T, 8>(krow + d0 + 8 * c, kv[c]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float* qr = qs + r * D + d_part + d0;
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int i = 0; i < 8; ++i) sc[r] = fmaf(qr[8 * c + i], kv[c][i], sc[r]);
      }
    }
    const int pos = base + s;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      for (int off = P / 2; off > 0; off >>= 1) sc[r] += __shfl_xor_sync(0xffffffffu, sc[r], off);
      float v = sc[r] * p.scale;
      if (p.has_softcap) v = tanhf(v / p.softcap) * p.softcap;
      bool valid = pos < att[r];
      if (p.has_window) valid = valid && pos >= att[r] - p.window;
      v = valid ? v : kMask;
      // max and sum over the block's positions (lanes of one part)
      float bmax = v;
      for (int off = P; off < 32; off <<= 1)
        bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, off));
      const float m_new = fmaxf(m[r], bmax);
      const float alpha = m[r] == m_new ? 1.f : expf(m[r] - m_new);
      float pr = expf(v - m_new);
      if (!VERIFY && m_new == -INFINITY) pr = 0.f;  // nothing to attend yet
      float sum = pr;
      for (int off = P; off < 32; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = alpha * l[r] + sum;
      m[r] = m_new;
      sc[r] = pr;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
    }

    // numerator: this lane's DPL columns of every position's V row
    const T* vcol = vpool + blk + lane * DPL;
    for (int p0 = 0; p0 < BS; p0 += 8) {
      float vv[8][DPL];  // eight positions' loads in flight before the first use
#pragma unroll
      for (int c = 0; c < 8; ++c) load_f32<T, DPL>(vcol + static_cast<size_t>(p0 + c) * D, vv[c]);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float pr = __shfl_sync(0xffffffffu, sc[r], (p0 + c) * P);
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(pr, vv[c][i], acc[r][i]);
        }
      }
    }
  }

  // merge the warps' states
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (lane == 0) {
      m_s[warp * ROWS + r] = m[r];
      l_s[warp * ROWS + r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc_s[(warp * ROWS + r) * D + lane * DPL + i] = acc[r][i];
  }
  __syncthreads();
  T* out = static_cast<T*>(p.out);
  for (int idx = threadIdx.x; idx < ROWS * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int rr = r0 + r;
    if (rr >= R) continue;
    float mx = kMask;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * ROWS + r]);
    float num = 0.f, den = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float mw = m_s[w * ROWS + r];
      const float f = mw == -INFINITY ? 0.f : expf(mw - mx);
      num = fmaf(f, acc_s[(w * ROWS + r) * D + d], num);
      den = fmaf(f, l_s[w * ROWS + r], den);
    }
    const int t = rr / rep;
    const int h = kvh * rep + rr % rep;
    out[(static_cast<size_t>(b) * p.T + t) * p.H * D + static_cast<size_t>(h) * D + d] =
        Cvt<T>::from_f(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int ROWS, int DPL, bool VERIFY>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(ROWS) * p.D * (1 + kWarps) + 2 * kWarps * ROWS) * sizeof(float);
  auto kernel = paged_attention_kernel<T, ROWS, DPL, VERIFY>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int rows = p.T * (p.H / p.Hkv);
  const dim3 grid(p.B, p.Hkv, (rows + ROWS - 1) / ROWS);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The tile is 4 rows when a (sequence, KV head) has at most 4 (decode at
// GQA ratios up to 4), else 8. D = 32 * DPL with DPL 2, 4 or 8; BS is 8,
// 16 or 32 and D * BS a multiple of 1024 (the wrapper checks both).
template <typename T, int DPL, bool VERIFY>
cudaError_t dispatch_rows(const Params& p, cudaStream_t stream) {
  return p.T * (p.H / p.Hkv) <= 4 ? launch<T, 4, DPL, VERIFY>(p, stream)
                                  : launch<T, 8, DPL, VERIFY>(p, stream);
}

template <typename T, bool VERIFY>
cudaError_t dispatch_shape(const Params& p, cudaStream_t stream) {
  if (p.BS % 8 != 0 || 32 % p.BS != 0 || (p.D * p.BS) % 1024 != 0) return cudaErrorInvalidValue;
  switch (p.D) {
    case 64: return dispatch_rows<T, 2, VERIFY>(p, stream);
    case 128: return dispatch_rows<T, 4, VERIFY>(p, stream);
    case 256: return dispatch_rows<T, 8, VERIFY>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

constexpr int kTileRows = 64;  // query rows per block of the verify kernel: 4 warps x 16
constexpr int kStagePos = 64;  // K/V positions per shared-memory stage
constexpr int kVerifyThreads = 128;

// K6 on tensor cores (bf16 / f16); see the note at the top.
template <typename T, int D>
__global__ void __launch_bounds__(kVerifyThreads) verify_mma_kernel(const Params p) {
  using flute::mma::ldmatrix_x4;
  using flute::mma::ldmatrix_x4_trans;
  using flute::mma::mma16816;
  using flute::mma::Pack2;
  constexpr int kStride = D + 8;  // halves per staged K/V row: 16 bytes of padding
  constexpr int kKS = D / 16;     // k16 steps of Q K^T
  constexpr int kNT = D / 8;      // n8 tiles of the output
  constexpr float kMask = -1e30f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [2][kStagePos][kStride]
  T* vs = ks + 2 * kStagePos * kStride;

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int rep = p.H / p.Hkv;
  const int R = p.T * rep;
  const int r0 = blockIdx.z * kTileRows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int length = p.lengths[b];
  const T* q = static_cast<const T*>(p.q);
  const T* kpool = static_cast<const T*>(p.k_pool);
  const T* vpool = static_cast<const T*>(p.v_pool);
  const int* table = p.tables + static_cast<size_t>(b) * p.MB;

  // attendable end of row r of this block (rows past R repeat the last)
  auto att_of = [&](int r) { return length + min(r0 + r, R - 1) / rep + 1; };
  // this lane's rows g and g + 8 of the warp's 16
  int att[2];
  size_t qoff[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rr = min(r0 + warp * 16 + g + 8 * i, R - 1);
    const int h = kvh * rep + rr % rep;
    att[i] = length + rr / rep + 1;
    qoff[i] = ((static_cast<size_t>(b) * p.T + rr / rep) * p.H + h) * D;
  }
  uint32_t qf[kKS][4];
#pragma unroll
  for (int k = 0; k < kKS; ++k) {
    const int d = 16 * k + 2 * t;
    qf[k][0] = *reinterpret_cast<const uint32_t*>(q + qoff[0] + d);
    qf[k][1] = *reinterpret_cast<const uint32_t*>(q + qoff[1] + d);
    qf[k][2] = *reinterpret_cast<const uint32_t*>(q + qoff[0] + d + 8);
    qf[k][3] = *reinterpret_cast<const uint32_t*>(q + qoff[1] + d + 8);
  }

  // positions the block may need, and those its warp may need
  const int hi = att_of(kTileRows - 1);
  const int lo = p.has_window ? max(0, att_of(0) - p.window) : 0;
  const int w_hi = att_of(warp * 16 + 15);
  const int w_lo = p.has_window ? att_of(warp * 16) - p.window : 0;
  const int s0 = lo / kStagePos * kStagePos;
  const int n_stages = (hi - s0 + kStagePos - 1) / kStagePos;

  auto stage = [&](int st) {
    constexpr int kVecs = D / 8;  // 16-byte pieces per position
    const int base = s0 + st * kStagePos;
    T* kd = ks + (st & 1) * kStagePos * kStride;
    T* vd = vs + (st & 1) * kStagePos * kStride;
    for (int idx = threadIdx.x; idx < kStagePos * kVecs; idx += kVerifyThreads) {
      const int i = idx / kVecs;
      const int v = idx - i * kVecs;
      const int pos = base + i;
      const int j = pos / p.BS;
      const bool ok = pos >= lo && pos < hi && j < p.MB;
      size_t off = 0;
      if (ok)
        off = ((static_cast<size_t>(table[j]) * p.Hkv + kvh) * p.BS + pos % p.BS) * D + 8 * v;
      flute::mma::cp_async16(kd + i * kStride + 8 * v, kpool + off, ok);
      flute::mma::cp_async16(vd + i * kStride + 8 * v, vpool + off, ok);
    }
    flute::mma::cp_async_commit();
  };

  float o[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float m[2] = {kMask, kMask};
  float l[2] = {0.f, 0.f};  // this lane's part of each row's sum

  if (n_stages > 0) stage(0);
  for (int st = 0; st < n_stages; ++st) {
    if (st + 1 < n_stages) {
      stage(st + 1);
      flute::mma::cp_async_wait<1>();
    } else {
      flute::mma::cp_async_wait<0>();
    }
    __syncthreads();
    const T* kb = ks + (st & 1) * kStagePos * kStride;
    const T* vb = vs + (st & 1) * kStagePos * kStride;
#pragma unroll 1
    for (int pc = 0; pc < kStagePos / 16; ++pc) {
      const int pp = s0 + st * kStagePos + 16 * pc;
      if (pp >= w_hi || (p.has_window && pp + 16 <= w_lo)) continue;  // the same for the warp
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const T* krow = kb + (16 * pc + (lane & 7) + ((lane >> 4) << 3)) * kStride +
                      ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int k = 0; k < kKS; ++k) {
        uint32_t kf[4];
        ldmatrix_x4(kf, krow + 16 * k);
        mma16816<T>(sc[0], qf[k], kf[0], kf[1]);
        mma16816<T>(sc[1], qf[k], kf[2], kf[3]);
      }
      // c0, c1: row g, positions 2t, 2t + 1 of the n8 tile; c2, c3: row g + 8
      float mx[2] = {kMask, kMask};
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          const int pos = pp + 8 * n + 2 * t + (i & 1);
          float v = sc[n][i] * p.scale;
          if (p.has_softcap) v = tanhf(v / p.softcap) * p.softcap;
          bool valid = pos < att[r];
          if (p.has_window) valid = valid && pos >= att[r] - p.window;
          v = valid ? v : kMask;
          sc[n][i] = v;
          mx[r] = fmaxf(mx[r], v);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = __expf(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pr = __expf(sc[n][i] - m[i >> 1]);
          l[i >> 1] += pr;
          sc[n][i] = pr;
        }
      }
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
      // P as the A operand: k = the 16 positions
      const uint32_t pa[4] = {Pack2<T>::from_f(sc[0][0], sc[0][1]),
                              Pack2<T>::from_f(sc[0][2], sc[0][3]),
                              Pack2<T>::from_f(sc[1][0], sc[1][1]),
                              Pack2<T>::from_f(sc[1][2], sc[1][3])};
      const T* vrow = vb + (16 * pc + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride +
                      (lane >> 4) * 8;
#pragma unroll
      for (int dn = 0; dn < kNT / 2; ++dn) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vrow + 16 * dn);
        mma16816<T>(o[2 * dn], pa, vf[0], vf[1]);
        mma16816<T>(o[2 * dn + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage's buffer
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    if (r0 + warp * 16 + g + 8 * r >= R) continue;
    T* dst = out + qoff[r] + 2 * t;
#pragma unroll
    for (int n = 0; n < kNT; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n) =
          Pack2<T>::from_f(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

template <typename T, int D>
cudaError_t launch_verify_mma(const Params& p, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(2) * 2 * kStagePos * (D + 8) * sizeof(T);
  auto kernel = verify_mma_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(p.B, p.Hkv, (p.T * (p.H / p.Hkv) + kTileRows - 1) / kTileRows);
  kernel<<<grid, kVerifyThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_verify_mma(const Params& p, cudaStream_t stream) {
  if (p.BS % 8 != 0 || 32 % p.BS != 0 || (p.D * p.BS) % 1024 != 0) return cudaErrorInvalidValue;
  switch (p.D) {
    case 64: return launch_verify_mma<T, 64>(p, stream);
    case 128: return launch_verify_mma<T, 128>(p, stream);
    case 256: return launch_verify_mma<T, 256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

constexpr int kDecodeStage = 64;  // positions per shared-memory stage: 16 per warp
constexpr int kDecodeThreads = 128;

// Sequence b attends positions [decode_start, decode_end); span sp attends
// their intersection with [sp * span, (sp + 1) * span), and is live where it
// is not empty. Both decode kernels derive the live spans from these alone.
__device__ __forceinline__ int decode_end(const Params& p, int b) {
  return min(p.lengths[b], p.MB * p.BS);  // positions past the table are not read
}
__device__ __forceinline__ int decode_start(const Params& p, int end) {
  return p.has_window ? max(0, end - p.window) : 0;
}

// K5 in bf16 / f16, one block per (span of `span` positions, sequence, KV
// head, tile of 16 query heads); see the note at the top. With `work` null
// (one span in the table) it writes out; else the span's unnormalised state
// (numerator [D], max, sum) to work[b, h, sp] for decode_merge_kernel.
template <typename T, int D>
__global__ void __launch_bounds__(kDecodeThreads)
    decode_span_kernel(const Params p, float* __restrict__ work, int span, int n_spans) {
  using flute::mma::ldmatrix_x4;
  using flute::mma::ldmatrix_x4_trans;
  using flute::mma::mma16816;
  using flute::mma::Pack2;
  constexpr int kStride = D + 8;  // halves per staged K/V row: 16 bytes of padding
  constexpr int kKS = D / 16;     // k16 steps of Q K^T
  constexpr int kNT = D / 8;      // n8 tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [2][kDecodeStage][kStride]
  T* vs = ks + 2 * kDecodeStage * kStride;
  int* rows = reinterpret_cast<int*>(vs + 2 * kDecodeStage * kStride);  // [span / BS]

  const int sp = blockIdx.x;
  const int b = blockIdx.y;
  const int rep = p.H / p.Hkv;
  const int tiles = (rep + 15) / 16;
  const int kvh = blockIdx.z / tiles;
  const int r0 = (blockIdx.z - kvh * tiles) * 16;
  const int end = decode_end(p, b);
  const int start = sp * span;
  const int lo = max(start, decode_start(p, end));
  const int hi = min(start + span, end);
  if (lo >= hi) {  // the same for every thread of the block
    if (work == nullptr) {  // the table's one span: a sequence with nothing to attend gets 0
      const int n_rows = min(16, rep - r0);
      for (int idx = threadIdx.x; idx < n_rows * D; idx += kDecodeThreads)
        static_cast<T*>(p.out)[(static_cast<size_t>(b) * p.H + kvh * rep + r0 + idx / D) * D +
                               idx % D] = Cvt<T>::from_f(0.f);
    }
    return;
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const T* q = static_cast<const T*>(p.q);
  const T* kpool = static_cast<const T*>(p.k_pool);
  const T* vpool = static_cast<const T*>(p.v_pool);

  // the span's pool rows, read once
  for (int i = threadIdx.x; i < span / p.BS; i += kDecodeThreads) {
    const int j = start / p.BS + i;
    rows[i] = j < p.MB ? p.tables[static_cast<size_t>(b) * p.MB + j] : 0;
  }
  // this lane's rows g and g + 8 of the tile's 16 (rows past rep repeat the
  // last and are never stored), as mma A fragments
  uint32_t qf[kKS][4];
  {
    size_t qoff[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      qoff[i] = (static_cast<size_t>(b) * p.H + kvh * rep + min(r0 + g + 8 * i, rep - 1)) * D;
#pragma unroll
    for (int k = 0; k < kKS; ++k) {
      const int d = 16 * k + 2 * t;
      qf[k][0] = *reinterpret_cast<const uint32_t*>(q + qoff[0] + d);
      qf[k][1] = *reinterpret_cast<const uint32_t*>(q + qoff[1] + d);
      qf[k][2] = *reinterpret_cast<const uint32_t*>(q + qoff[0] + d + 8);
      qf[k][3] = *reinterpret_cast<const uint32_t*>(q + qoff[1] + d + 8);
    }
  }
  __syncthreads();  // rows[] written

  const int s0 = start + (lo - start) / kDecodeStage * kDecodeStage;
  const int n_stages = (hi - s0 + kDecodeStage - 1) / kDecodeStage;
  auto stage = [&](int st) {
    constexpr int kVecs = D / 8;  // 16-byte pieces per position
    const int base = s0 + st * kDecodeStage;
    T* kd = ks + (st & 1) * kDecodeStage * kStride;
    T* vd = vs + (st & 1) * kDecodeStage * kStride;
    for (int idx = threadIdx.x; idx < kDecodeStage * kVecs; idx += kDecodeThreads) {
      const int i = idx / kVecs;
      const int v = idx - i * kVecs;
      const int pos = base + i;
      const bool ok = pos >= lo && pos < hi;
      size_t off = 0;
      if (ok)
        off = ((static_cast<size_t>(rows[(pos - start) / p.BS]) * p.Hkv + kvh) * p.BS +
               pos % p.BS) * D + 8 * v;
      flute::mma::cp_async16(kd + i * kStride + 8 * v, kpool + off, ok);
      flute::mma::cp_async16(vd + i * kStride + 8 * v, vpool + off, ok);
    }
    flute::mma::cp_async_commit();
  };

  float o[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's part of each row's sum

  stage(0);
  for (int st = 0; st < n_stages; ++st) {
    if (st + 1 < n_stages) {
      stage(st + 1);
      flute::mma::cp_async_wait<1>();
    } else {
      flute::mma::cp_async_wait<0>();
    }
    __syncthreads();
    // this warp's 16 positions of the stage; a piece with a position the
    // rows attend holds one for every row (they share one range), so the
    // running max is finite after it and -inf masks need no guard
    const int pp = s0 + st * kDecodeStage + 16 * warp;
    if (pp < hi && pp + 16 > lo) {  // the same for the warp
      const T* kb = ks + (st & 1) * kDecodeStage * kStride + 16 * warp * kStride;
      const T* vb = vs + (st & 1) * kDecodeStage * kStride + 16 * warp * kStride;
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const T* krow = kb + ((lane & 7) + ((lane >> 4) << 3)) * kStride + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int k = 0; k < kKS; ++k) {
        uint32_t kf[4];
        ldmatrix_x4(kf, krow + 16 * k);
        mma16816<T>(sc[0], qf[k], kf[0], kf[1]);
        mma16816<T>(sc[1], qf[k], kf[2], kf[3]);
      }
      // c0, c1: row g, positions 2t, 2t + 1 of the n8 tile; c2, c3: row g + 8
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int pos = pp + 8 * n + 2 * t + (i & 1);
          float v = sc[n][i] * p.scale;
          if (p.has_softcap) v = tanhf(v / p.softcap) * p.softcap;
          v = pos >= lo && pos < hi ? v : -INFINITY;
          sc[n][i] = v;
          mx[i >> 1] = fmaxf(mx[i >> 1], v);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = expf(m[r] - m_new);  // 0 at the warp's first piece
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pr = expf(sc[n][i] - m[i >> 1]);
          l[i >> 1] += pr;
          sc[n][i] = pr;
        }
      }
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
      // P as the A operand: k = the 16 positions
      const uint32_t pa[4] = {Pack2<T>::from_f(sc[0][0], sc[0][1]),
                              Pack2<T>::from_f(sc[0][2], sc[0][3]),
                              Pack2<T>::from_f(sc[1][0], sc[1][1]),
                              Pack2<T>::from_f(sc[1][2], sc[1][3])};
      const T* vrow = vb + ((lane & 7) + ((lane >> 3) & 1) * 8) * kStride + (lane >> 4) * 8;
#pragma unroll
      for (int dn = 0; dn < kNT / 2; ++dn) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vrow + 16 * dn);
        mma16816<T>(o[2 * dn], pa, vf[0], vf[1]);
        mma16816<T>(o[2 * dn + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage's buffer
  }

  // merge the 4 warps' states in warp order, in shared memory (the ring is
  // free: every copy has landed and every warp has passed the last barrier)
  float* ms = reinterpret_cast<float*>(smem_raw);  // [4][16]
  float* ls = ms + 4 * 16;                          // [4][16]
  float* os = ls + 4 * 16;                          // [4][16][D]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = warp * 16 + g + 8 * r;
    if (t == 0) {
      ms[row] = m[r];
      ls[row] = l[r];
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      os[row * D + 8 * n + 2 * t] = o[n][2 * r];
      os[row * D + 8 * n + 2 * t + 1] = o[n][2 * r + 1];
    }
  }
  __syncthreads();
  const int n_rows = min(16, rep - r0);
  for (int idx = threadIdx.x; idx < n_rows * D; idx += kDecodeThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < 4; ++w) mx = fmaxf(mx, ms[w * 16 + r]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float mw = ms[w * 16 + r];
      const float f = mw == -INFINITY ? 0.f : expf(mw - mx);
      num = fmaf(f, os[(w * 16 + r) * D + d], num);
      den = fmaf(f, ls[w * 16 + r], den);
    }
    const size_t bh = static_cast<size_t>(b) * p.H + kvh * rep + r0 + r;
    if (work == nullptr) {
      static_cast<T*>(p.out)[bh * D + d] = Cvt<T>::from_f(num / fmaxf(den, 1e-30f));
    } else {
      float* wr = work + (bh * n_spans + sp) * (D + 2);
      wr[d] = num;
      if (d == 0) {
        wr[D] = mx;
        wr[D + 1] = den;
      }
    }
  }
}

// out[b, h] from the live spans' states, added in span order: the spans a
// sequence attends follow from its length and the window alone, so a
// sequence gets the same bits in any batch and with any table width. A
// sequence with no live span (length 0) gets 0. With one live span this is
// the span kernel's own division (its weight is exp(0) = 1), so a table of
// one span, written directly, gives the same bits.
template <typename T>
__global__ void __launch_bounds__(256)
    decode_merge_kernel(const Params p, const float* __restrict__ work, int span, int n_spans) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int D = p.D;
  const int end = decode_end(p, b);
  const int s_lo = decode_start(p, end) / span;
  const int s_hi = min((end + span - 1) / span, n_spans);
  const float* w = work + (static_cast<size_t>(b) * p.H + h) * n_spans * (D + 2);
  float mx = -INFINITY;
  for (int s = s_lo; s < s_hi; ++s) mx = fmaxf(mx, w[s * (D + 2) + D]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float num = 0.f, den = 0.f;
    for (int s = s_lo; s < s_hi; ++s) {
      const float* ws = w + s * (D + 2);
      const float f = ws[D] == -INFINITY ? 0.f : expf(ws[D] - mx);
      if (s == s_lo) {  // a product, not a sum with 0: -0 stays -0, as in one span
        num = f * ws[d];
        den = f * ws[D + 1];
      } else {
        num = fmaf(f, ws[d], num);
        den = fmaf(f, ws[D + 1], den);
      }
    }
    static_cast<T*>(p.out)[(static_cast<size_t>(b) * p.H + h) * D + d] =
        Cvt<T>::from_f(num / fmaxf(den, 1e-30f));
  }
}

inline int decode_spans(const Params& p, int span) { return (p.MB * p.BS + span - 1) / span; }

template <typename T, int D>
cudaError_t launch_decode_span(const Params& p, float* work, int span, cudaStream_t stream) {
  const int n_spans = decode_spans(p, span);
  const size_t smem = static_cast<size_t>(2) * 2 * kDecodeStage * (D + 8) * sizeof(T) +
                      static_cast<size_t>(span / p.BS) * sizeof(int);
  auto kernel = decode_span_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int rep = p.H / p.Hkv;
  const dim3 grid(n_spans, p.B, p.Hkv * ((rep + 15) / 16));
  kernel<<<grid, kDecodeThreads, smem, stream>>>(p, n_spans > 1 ? work : nullptr, span, n_spans);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_spans == 1) return e;
  decode_merge_kernel<T><<<dim3(p.B, p.H), D, 0, stream>>>(p, work, span, n_spans);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_decode_span(const Params& p, float* work, int span, cudaStream_t stream) {
  if (p.BS % 8 != 0 || 32 % p.BS != 0 || (p.D * p.BS) % 1024 != 0 || span <= 0 ||
      span % kDecodeStage != 0 || (decode_spans(p, span) > 1 && work == nullptr))
    return cudaErrorInvalidValue;
  switch (p.D) {
    case 64: return launch_decode_span<T, 64>(p, work, span, stream);
    case 128: return launch_decode_span<T, 128>(p, work, span, stream);
    case 256: return launch_decode_span<T, 256>(p, work, span, stream);
    default: return cudaErrorInvalidValue;
  }
}

// K5: bf16 and f16 on the span kernels, f32 on paged_attention_kernel.
int run_decode(const Params& p, float* work, int span, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_shape<float, false>(p, s);
    case 1: return dispatch_decode_span<__half>(p, work, span, s);
    case 2: return dispatch_decode_span<__nv_bfloat16>(p, work, span, s);
    default: return cudaErrorInvalidValue;
  }
}

// K6: bf16 and f16 on verify_mma_kernel, f32 on paged_attention_kernel.
int run_verify(const Params& p, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_shape<float, true>(p, s);
    case 1: return dispatch_verify_mma<__half>(p, s);
    case 2: return dispatch_verify_mma<__nv_bfloat16>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared arguments: q, k_pool, v_pool and out in one dtype (0 = float32,
// 1 = float16, 2 = bfloat16); tables int32 [B, MB] with entries in [0, NB);
// lengths int32 [B]; D is 64, 128 or 256, BS is 8, 16 or 32 and D * BS a
// multiple of 1024; has_softcap / has_window switch the options.
// All pointers are device pointers; the kernel runs on `stream` and is not
// synchronised. Each entry returns the cudaError_t of its launch.

// K5: q and out [B, H, D]; row (b, h) attends positions < lengths[b]. span
// (a multiple of 64, and so of BS): positions per block in bf16/f16; where
// the table holds more than one span (MB * BS > span), work is a float32
// [B, H, ceil(MB * BS / span), D + 2] workspace (else null, and ignored in
// f32), and the entry launches the span kernel and the merge kernel.
extern "C" int flute_paged_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                                            const int* tables, const int* lengths, void* out,
                                            void* work, int B, int H, int Hkv, int D, int NB,
                                            int BS, int MB, int span, float scale,
                                            int has_softcap, float softcap, int has_window,
                                            int window, int dtype, void* stream) {
  const Params p{q,  k_pool, v_pool, tables, lengths, out,        B,           1,
                 H,  Hkv,    D,      NB,     BS,      MB,         scale,       has_softcap,
                 softcap, has_window, window};
  return run_decode(p, static_cast<float*>(work), span, dtype, stream);
}

// K6: q and out [B, T, H, D]; query t attends positions < lengths[b] + t + 1.
extern "C" int flute_paged_verify_attention(const void* q, const void* k_pool, const void* v_pool,
                                            const int* tables, const int* lengths, void* out,
                                            int B, int T, int H, int Hkv, int D, int NB, int BS,
                                            int MB, float scale, int has_softcap, float softcap,
                                            int has_window, int window, int dtype, void* stream) {
  const Params p{q,  k_pool, v_pool, tables, lengths, out,        B,           T,
                 H,  Hkv,    D,      NB,     BS,      MB,         scale,       has_softcap,
                 softcap, has_window, window};
  return run_verify(p, dtype, stream);
}
