// Shared step body of the TAP kernels: one thread owns one CAM row.
//
// A row's digits sit column-major in shared memory (`row[col * stride]`), so
// the dynamic column index of every compare and write is a shared-memory
// address and never a register array that would spill to local memory.
// Neighbouring threads own neighbouring rows, so a warp reading one column
// touches 32 consecutive bytes: no bank conflicts.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tap {

constexpr int kHistBins = 8;      // mismatch histogram, top bin saturates
constexpr int8_t kDontCare = -1;  // a stored -1 matches any key digit

// Tag of schedule slot `s` for one row: OR over the slot's valid keys of
// "every valid compare column matches".  A slot with no valid key is an
// unconditional write.  With kStats and `hist_on`, adds min(mismatches,
// kHistBins - 1) of every valid key to `hist`.  Duplicate compare columns
// count one mismatch per position.  A column outside [0, cols) -- the -1
// padding, or a column the host did not check -- is skipped.
template <bool kStats>
__device__ __forceinline__ bool slot_tag(
    const int8_t* row, int stride, int cols, int s, int K, int C,
    const int32_t* cmp_cols, const int8_t* keys, const uint8_t* key_valid,
    bool hist_on, int (&hist)[kHistBins]) {
  const int32_t* cc = cmp_cols + static_cast<size_t>(s) * C;
  const int8_t* ks = keys + static_cast<size_t>(s) * K * C;
  const uint8_t* kv = key_valid + static_cast<size_t>(s) * K;
  bool any_key = false;
  bool tag = false;
  for (int k = 0; k < K; ++k) {
    if (!kv[k]) continue;
    any_key = true;
    int mm = 0;
    for (int c = 0; c < C; ++c) {
      const int col = cc[c];
      if (static_cast<unsigned>(col) >= static_cast<unsigned>(cols)) continue;
      const int8_t v = row[col * stride];
      mm += (v != ks[k * C + c]) & (v != kDontCare);
    }
    tag |= (mm == 0);
    if (!kStats && tag) break;      // no histogram to fill: first match wins
    if (kStats && hist_on) {
      const int bin = mm < kHistBins - 1 ? mm : kHistBins - 1;
#pragma unroll
      for (int b = 0; b < kHistBins; ++b) hist[b] += (bin == b);
    }
  }
  return tag || !any_key;
}

// Writes of slot `s` on a tagged row, in column order: a changed digit is
// one SET, plus one RESET unless the old cell was don't-care.  Duplicate
// write columns apply one after another and each change is charged.  A
// column outside [0, cols) is skipped.
template <bool kStats>
__device__ __forceinline__ void slot_write(
    int8_t* row, int stride, int cols, int s, int W, const int32_t* wr_cols,
    const int8_t* wr_vals, int& sets, int& resets) {
  const int32_t* wc = wr_cols + static_cast<size_t>(s) * W;
  const int8_t* wv = wr_vals + static_cast<size_t>(s) * W;
  for (int w = 0; w < W; ++w) {
    const int col = wc[w];
    if (static_cast<unsigned>(col) >= static_cast<unsigned>(cols)) continue;
    const int8_t v = wv[w];
    const int8_t old = row[col * stride];
    if (old != v) {
      row[col * stride] = v;
      if (kStats) {
        sets += 1;
        resets += (old != kDontCare);
      }
    }
  }
}

// Copy `n_rows` rows of `cols` bytes (row-major, contiguous in global
// memory) into the column-major tile, and back.  Coalesced on the global
// side.
__device__ __forceinline__ void load_tile(int8_t* tile, const int8_t* src,
                                          int n_rows, int cols, int stride) {
  const int n = n_rows * cols;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / cols;
    tile[(i - r * cols) * stride + r] = src[i];
  }
}

__device__ __forceinline__ void store_tile(int8_t* dst, const int8_t* tile,
                                           int n_rows, int cols, int stride) {
  const int n = n_rows * cols;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / cols;
    dst[i] = tile[(i - r * cols) * stride + r];
  }
}

}  // namespace tap
