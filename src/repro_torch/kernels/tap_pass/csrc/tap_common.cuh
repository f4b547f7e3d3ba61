// Shared parts of the TAP kernels.
//
// The scalar step body (slot_tag, slot_write, load_tile, store_tile) is the
// short-schedule kernel's (tap_schedule.cu): one thread owns one CAM row,
// whose digits sit column-major in shared memory (`row[col * stride]`), so
// the dynamic column index of every compare and write is a shared-memory
// address and never a register array that would spill to local memory.
// Neighbouring threads own neighbouring rows, so a warp reading one column
// touches 32 consecutive bytes: no bank conflicts.
//
// The byte-lane helpers at the end are the program kernel's
// (tap_program.cu): there one 32-bit word of a column-major tile is four
// rows of one column, and each helper works on the four bytes at once with
// no carry crossing from one byte into the next.
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

// ---------------------------------------------------------------------------
// Four rows per 32-bit word.  A result "80" holds its flag in bit 7 of each
// byte, 0 elsewhere.
// ---------------------------------------------------------------------------

constexpr uint32_t kLow7 = 0x7f7f7f7fu;
constexpr uint32_t kHigh = 0x80808080u;
constexpr uint32_t kOnes = 0x01010101u;

// bit 7 set in each byte of `a` that is not zero: the low seven bits plus
// 0x7f carry into bit 7 unless they are all zero, and a's own bit 7 is or-ed
// in; the sum of two values below 0x80 never carries out of the byte
__device__ __forceinline__ uint32_t nonzero80(uint32_t a) {
  return (((a & kLow7) + kLow7) | a) & kHigh;
}

// rows where the stored digit differs from the key digit and is not
// don't-care (-1, byte 0xff)
__device__ __forceinline__ uint32_t mismatch80(uint32_t v, uint32_t key4) {
  return nonzero80(v ^ key4) & nonzero80(~v);
}

// rows whose byte is zero, for bytes below 0x80
__device__ __forceinline__ uint32_t zero80(uint32_t small) {
  return ~(small + kLow7) & kHigh;
}

// rows whose byte is at least b (1 <= b <= 0x80), for bytes below 0x80
__device__ __forceinline__ uint32_t at_least80(uint32_t small, uint32_t b) {
  return (small + (0x80u - b) * kOnes) & kHigh;
}

// 0xff in each byte whose bit 7 is set: PRMT with sign-replicating
// selectors (bit 3 of each selector nibble; `__byte_perm` masks it off)
__device__ __forceinline__ uint32_t bytes_of80(uint32_t f80) {
  uint32_t d;
  asm("prmt.b32 %0, %1, 0, 0xba98;\n" : "=r"(d) : "r"(f80));
  return d;
}

// acc plus the bit-7 flags of f80 as one count per byte: f80 >> 7 taken as
// the high word of f80 * 2^25, which the multiply-add pipe computes, not
// the integer ALU the compares keep busy
__device__ __forceinline__ uint32_t add_flags(uint32_t acc, uint32_t f80) {
  return acc + __umulhi(f80, 1u << 25);
}

// the sum of the four bytes of a
__device__ __forceinline__ int byte_sum(uint32_t a) {
  const uint32_t pairs = (a & 0x00ff00ffu) + ((a >> 8) & 0x00ff00ffu);
  return static_cast<int>((pairs & 0xffffu) + (pairs >> 16));
}

}  // namespace tap
