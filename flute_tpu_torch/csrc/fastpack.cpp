// Fast native weight packer of the PyTorch port (a copy of the JAX package's
// flute_tpu/csrc/fastpack.cpp: the port builds and loads its own).
//
// Role: the host-native runtime piece of the framework (the reference's
// native host layer is flute/csrc/qgemm.cpp — a torch op binding; ours is
// the offline packing hot loop, which for a 70B checkpoint processes
// ~140 GB of code tensors and is worth real native throughput).
//
// Implements the pack layout contract of flute_tpu_torch/packing.py (the
// layouts of flute_tpu/packing.py):
//   * codes [K, N] int32 of b-bit values, split into planes (low bits
//     first: 3-bit = 2+1);
//   * per plane p (pb bits): pair field f[t, n] = ce | co << pb where
//     ce = subcode(codes[2t, n]), co = subcode(codes[2t+1, n]);
//   * fields chunked along K-pairs (chunk_pairs per chunk); within a
//     chunk, word w[j, n] holds field (i*kc + j) in LSB-first slot i,
//     kc = chunk_pairs / r, r = 32 / (2*pb).
//
// Exposed as a minimal C ABI consumed via ctypes (no pybind11 in the
// image). Threaded over chunk rows with std::thread.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

struct PlaneDims {
  int64_t K, N;
  int shift;      // subcode bit offset within the full code
  int pb;         // plane bits
  int64_t chunk;  // K rows per chunk (pairs per chunk = chunk / 2)
};

inline int threads_for(int64_t work_items) {
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 4;
  return static_cast<int>(std::min<int64_t>(hw, std::max<int64_t>(1, work_items)));
}

template <typename F>
void parallel_for(int64_t n, F&& body) {
  int nt = threads_for(n);
  if (nt <= 1) {
    for (int64_t i = 0; i < n; ++i) body(i);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(nt);
  for (int t = 0; t < nt; ++t) {
    ts.emplace_back([&, t] {
      for (int64_t i = t; i < n; i += nt) body(i);
    });
  }
  for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// Pack one plane: codes [K, N] int32 -> words [K*pb/32, N] int32.
// Returns 0 on success, nonzero on invalid dims.
int flute_pack_plane(const int32_t* codes, int32_t* words, int64_t K,
                     int64_t N, int shift, int pb, int64_t chunk) {
  const int fb = 2 * pb;
  const int r = 32 / fb;
  if (K % chunk != 0 || (chunk / 2) % r != 0) return 1;
  const int64_t chunk_pairs = chunk / 2;
  const int64_t kc = chunk_pairs / r;
  const int64_t nchunks = K / chunk;
  const uint32_t mask = (1u << pb) - 1u;

  parallel_for(nchunks * kc, [&](int64_t row) {
    const int64_t c = row / kc;
    const int64_t j = row % kc;
    uint32_t* dst = reinterpret_cast<uint32_t*>(words) + row * N;
    std::memset(dst, 0, sizeof(uint32_t) * N);
    for (int i = 0; i < r; ++i) {
      const int64_t pair_row = c * chunk_pairs + i * kc + j;
      const int32_t* even = codes + (2 * pair_row) * N;
      const int32_t* odd = codes + (2 * pair_row + 1) * N;
      const int sh = fb * i;
      for (int64_t n = 0; n < N; ++n) {
        const uint32_t ce = (static_cast<uint32_t>(even[n]) >> shift) & mask;
        const uint32_t co = (static_cast<uint32_t>(odd[n]) >> shift) & mask;
        dst[n] |= (ce | (co << pb)) << sh;
      }
    }
  });
  return 0;
}

// Unpack one plane: words [K*pb/32, N] -> subcodes [K, N] int32 (values in
// [0, 2^pb)); caller ORs planes together at their shifts.
int flute_unpack_plane(const int32_t* words, int32_t* codes, int64_t K,
                       int64_t N, int pb, int64_t chunk) {
  const int fb = 2 * pb;
  const int r = 32 / fb;
  if (K % chunk != 0 || (chunk / 2) % r != 0) return 1;
  const int64_t chunk_pairs = chunk / 2;
  const int64_t kc = chunk_pairs / r;
  const int64_t nchunks = K / chunk;
  const uint32_t mask = (1u << pb) - 1u;

  parallel_for(nchunks * kc, [&](int64_t row) {
    const int64_t c = row / kc;
    const int64_t j = row % kc;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(words) + row * N;
    for (int i = 0; i < r; ++i) {
      const int64_t pair_row = c * chunk_pairs + i * kc + j;
      int32_t* even = codes + (2 * pair_row) * N;
      int32_t* odd = codes + (2 * pair_row + 1) * N;
      const int sh = fb * i;
      for (int64_t n = 0; n < N; ++n) {
        const uint32_t f = (src[n] >> sh);
        even[n] = static_cast<int32_t>(f & mask);
        odd[n] = static_cast<int32_t>((f >> pb) & mask);
      }
    }
  });
  return 0;
}

// Wide 3-bit layout (packing.py pack_w3_wide_np): 16 six-bit pair fields
// (ce | co << 3) per three int32 words, planar per chunk — rows
// [c*3 + w]*ntrip + t for word w of triple t, field j at bit 6*j of the
// 96-bit group (two fields straddle a word boundary). codes [K, N] int32
// of 3-bit values -> words [3K/32, N] int32.
int flute_pack_w3_wide(const int32_t* codes, int32_t* words, int64_t K,
                       int64_t N, int64_t chunk) {
  if (chunk % 256 != 0 || K % chunk != 0) return 1;
  const int64_t cp = chunk / 2;  // pairs per chunk
  const int64_t ntrip = cp / 16;
  const int64_t nch = K / chunk;

  parallel_for(nch * ntrip, [&](int64_t idx) {
    const int64_t c = idx / ntrip;
    const int64_t t = idx % ntrip;
    uint32_t* w[3];
    for (int a = 0; a < 3; ++a) {
      w[a] = reinterpret_cast<uint32_t*>(words) + ((c * 3 + a) * ntrip + t) * N;
      std::memset(w[a], 0, sizeof(uint32_t) * N);
    }
    for (int j = 0; j < 16; ++j) {
      const int64_t pr = c * cp + j * ntrip + t;
      const int32_t* even = codes + (2 * pr) * N;
      const int32_t* odd = codes + (2 * pr + 1) * N;
      const int bit = 6 * j;
      const int wa = bit / 32;
      const int off = bit % 32;
      uint32_t* lo = w[wa];
      uint32_t* hi = (off + 6 > 32) ? w[wa + 1] : nullptr;
      for (int64_t n = 0; n < N; ++n) {
        const uint32_t f = (static_cast<uint32_t>(even[n]) & 7u) |
                           ((static_cast<uint32_t>(odd[n]) & 7u) << 3);
        lo[n] |= f << off;  // uint32 shift truncates the straddle high part
        if (hi) hi[n] |= f >> (32 - off);
      }
    }
  });
  return 0;
}

// Inverse: words [3K/32, N] int32 -> codes [K, N] int32 (values in [0, 8)).
int flute_unpack_w3_wide(const int32_t* words, int32_t* codes, int64_t K,
                         int64_t N, int64_t chunk) {
  if (chunk % 256 != 0 || K % chunk != 0) return 1;
  const int64_t cp = chunk / 2;
  const int64_t ntrip = cp / 16;
  const int64_t nch = K / chunk;

  parallel_for(nch * ntrip, [&](int64_t idx) {
    const int64_t c = idx / ntrip;
    const int64_t t = idx % ntrip;
    const uint32_t* w[3];
    for (int a = 0; a < 3; ++a) {
      w[a] = reinterpret_cast<const uint32_t*>(words) +
             ((c * 3 + a) * ntrip + t) * N;
    }
    for (int j = 0; j < 16; ++j) {
      const int64_t pr = c * cp + j * ntrip + t;
      int32_t* even = codes + (2 * pr) * N;
      int32_t* odd = codes + (2 * pr + 1) * N;
      const int bit = 6 * j;
      const int wa = bit / 32;
      const int off = bit % 32;
      const uint32_t* lo = w[wa];
      const uint32_t* hi = (off + 6 > 32) ? w[wa + 1] : nullptr;
      for (int64_t n = 0; n < N; ++n) {
        uint32_t f = lo[n] >> off;
        if (hi) f |= hi[n] << (32 - off);
        f &= 0x3Fu;
        even[n] = static_cast<int32_t>(f & 7u);
        odd[n] = static_cast<int32_t>(f >> 3);
      }
    }
  });
  return 0;
}

// Sign-symmetric 4-bit layout (packing.py pack_w4_sym_np): byte pair
// fields f = m_e | m_o << 3 | s_e << 6 | s_o << 7 for sign-magnitude codes
// c = s*8 + m, four fields per int32 word in the standard chunked
// pair-plane arrangement (field i of word j = pair i*kc + j, kc =
// chunk_pairs / 4). codes [K, N] int32 in [0, 16) -> words [K/8, N] int32.
int flute_pack_w4_sym(const int32_t* codes, int32_t* words, int64_t K,
                      int64_t N, int64_t chunk) {
  if (K % chunk != 0 || (chunk / 2) % 4 != 0) return 1;
  const int64_t chunk_pairs = chunk / 2;
  const int64_t kc = chunk_pairs / 4;
  const int64_t nchunks = K / chunk;

  parallel_for(nchunks * kc, [&](int64_t row) {
    const int64_t c = row / kc;
    const int64_t j = row % kc;
    uint32_t* dst = reinterpret_cast<uint32_t*>(words) + row * N;
    std::memset(dst, 0, sizeof(uint32_t) * N);
    for (int i = 0; i < 4; ++i) {
      const int64_t pair_row = c * chunk_pairs + i * kc + j;
      const int32_t* even = codes + (2 * pair_row) * N;
      const int32_t* odd = codes + (2 * pair_row + 1) * N;
      const int sh = 8 * i;
      for (int64_t n = 0; n < N; ++n) {
        const uint32_t ce = static_cast<uint32_t>(even[n]) & 15u;
        const uint32_t co = static_cast<uint32_t>(odd[n]) & 15u;
        const uint32_t f = (ce & 7u) | ((co & 7u) << 3) |
                           ((ce >> 3) << 6) | ((co >> 3) << 7);
        dst[n] |= f << sh;
      }
    }
  });
  return 0;
}

// Inverse: words [K/8, N] int32 -> codes [K, N] int32 (values in [0, 16)).
int flute_unpack_w4_sym(const int32_t* words, int32_t* codes, int64_t K,
                        int64_t N, int64_t chunk) {
  if (K % chunk != 0 || (chunk / 2) % 4 != 0) return 1;
  const int64_t chunk_pairs = chunk / 2;
  const int64_t kc = chunk_pairs / 4;
  const int64_t nchunks = K / chunk;

  parallel_for(nchunks * kc, [&](int64_t row) {
    const int64_t c = row / kc;
    const int64_t j = row % kc;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(words) + row * N;
    for (int i = 0; i < 4; ++i) {
      const int64_t pair_row = c * chunk_pairs + i * kc + j;
      int32_t* even = codes + (2 * pair_row) * N;
      int32_t* odd = codes + (2 * pair_row + 1) * N;
      const int sh = 8 * i;
      for (int64_t n = 0; n < N; ++n) {
        const uint32_t f = (src[n] >> sh) & 0xFFu;
        even[n] = static_cast<int32_t>((f & 7u) | (((f >> 6) & 1u) << 3));
        odd[n] = static_cast<int32_t>(((f >> 3) & 7u) | ((f >> 7) << 3));
      }
    }
  });
  return 0;
}

}  // extern "C"
