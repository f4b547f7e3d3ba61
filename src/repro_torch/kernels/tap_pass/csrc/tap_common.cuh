// Shared parts of the TAP kernels (tap_program.cu, tap_schedule.cu).
//
// Both stage their rows column-major in shared memory, so one 32-bit word
// of a tile is four rows of one column, and run a schedule's slots on the
// four bytes at once with no carry crossing from one byte into the next.
// A slot comes as a record (kernels/tap_pass/records.py): the *wide* record
// of the unrolled slot `fast_slot` (one key, kCF compare columns, kWF
// distinct write columns) or the packed record of the general slot
// (`general_tag`, `general_writes`: any K, C, W, serial writes).  A column
// outside [0, cols) is encoded as the dummy column `cols`, an extra tile
// column of don't-care digits: a compare there always matches and a write
// of -1 there changes nothing.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tap {

constexpr int kHistBins = 8;      // mismatch histogram, top bin saturates
constexpr int kWideWords = 16;    // an unrolled slot's record
constexpr int kSatEvery = 120;    // general slot: saturate mm this often

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

// ---------------------------------------------------------------------------
// Staging
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy n_rows rows of `cols` bytes (row-major in device memory) into the
// column-major tile of `rows` bytes per column, and back.  Coalesced on the
// device side; the row and column of each byte advance by a fixed step.
__device__ __forceinline__ void copy_rows(uint8_t* tile, int8_t* dev,
                                          int n_rows, int cols, int rows,
                                          bool to_tile) {
  const int n = n_rows * cols;
  int r = threadIdx.x / cols;
  int c = threadIdx.x % cols;
  const int dr = blockDim.x / cols;
  const int dc = blockDim.x % cols;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (to_tile)
      tile[c * rows + r] = static_cast<uint8_t>(dev[i]);
    else
      dev[i] = static_cast<int8_t>(tile[c * rows + r]);
    c += dc;
    r += dr;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

// ---------------------------------------------------------------------------
// Counters (the program kernel's; kStats = false leaves them untouched)
// ---------------------------------------------------------------------------

// Per-thread counters: sets, resets and ge[b] = #(row, key) with at least b
// mismatches, b = 1..7.
struct Counts {
  int sets = 0;
  int resets = 0;
  int ge[8] = {0, 0, 0, 0, 0, 0, 0, 0};
};

// The unrolled slots' counters within one chunk of records, one count per
// row in each byte, added into Counts at the end of the chunk, before a
// byte can reach 256 (a slot adds at most 3 sets and 4 mismatches).  With
// mm <= 4 mismatches, #(mm >= b) for b = 1..4 follows from four sums:
// any = #(mm >= 1), bit1 = #(mm in {2, 3}), bit2 = #(mm == 4) and
// sum = the sum of mm = the sum of the four thresholds.
struct LaneCounts {
  uint32_t sets = 0, resets = 0;
  uint32_t any = 0, bit1 = 0, bit2 = 0, sum = 0;

  __device__ __forceinline__ void flush(Counts& n) {
    const int t1 = byte_sum(any), t4 = byte_sum(bit2);
    const int t2 = byte_sum(bit1) + t4;
    n.sets += byte_sum(sets);
    n.resets += byte_sum(resets);
    n.ge[1] += t1;
    n.ge[2] += t2;
    n.ge[3] += byte_sum(sum) - t1 - t2 - t4;
    n.ge[4] += t4;
    *this = LaneCounts();
  }
};

// ---------------------------------------------------------------------------
// Slots.  `tile` is the thread's column-0 word, `ts` words per column;
// valid80 marks the thread's rows that may be written (and counted).
// ---------------------------------------------------------------------------

// One unrolled slot: the wide record r (kCF compare columns, one key, kWF
// distinct write columns).  Every cell is loaded before any is written, and
// no branch depends on the slot: padded cells go to the dummy column, and
// the record's last word carries the no-key and histogram flags as byte
// masks.
template <int kCF, int kWF, bool kStats>
__device__ __forceinline__ void fast_slot(const uint32_t (&r)[kWideWords],
                                          uint32_t* tile, int ts,
                                          uint32_t valid80, LaneCounts& n) {
  constexpr int kKeys = 1 + kCF;
  constexpr int kWCols = kKeys + kCF;
  constexpr int kWVals = kWCols + kWF;
  static_assert(kWVals + kWF <= kWideWords, "a 16-word record");
  uint32_t v[kCF], old[kWF];
#pragma unroll
  for (int j = 0; j < kCF; ++j) v[j] = tile[r[1 + j] * ts];
#pragma unroll
  for (int j = 0; j < kWF; ++j) old[j] = tile[r[kWCols + j] * ts];
  uint32_t mm = 0;                      // mismatches per row, at most kCF
#pragma unroll
  for (int j = 0; j < kCF; ++j)
    mm = add_flags(mm, mismatch80(v[j], r[kKeys + j]));
  const uint32_t match80 = zero80(mm);
  // the last word: bit 7 of each byte set for a slot with no key (every
  // row tagged), bit 6 for a histogram slot
  const uint32_t flags = r[kWideWords - 1];
  const uint32_t tag80 = (match80 | flags) & valid80;
  if (kStats) {
    const uint32_t hist80 = (flags << 1) & valid80;
    const uint32_t hist = bytes_of80(hist80);
    n.any = add_flags(n.any, hist80 & ~match80);
    n.bit1 += __umulhi(mm & 0x02020202u & hist, 1u << 31);
    if (kCF > 3) n.bit2 += __umulhi(mm & 0x04040404u & hist, 1u << 30);
    n.sum += mm & hist;
  }
  const uint32_t tag_bytes = bytes_of80(tag80);
#pragma unroll
  for (int j = 0; j < kWF; ++j) {
    const uint32_t val4 = r[kWVals + j];
    if (kStats) {
      const uint32_t changed = nonzero80(old[j] ^ val4) & tag80;
      n.sets = add_flags(n.sets, changed);
      n.resets = add_flags(n.resets, changed & nonzero80(~old[j]));
    }
    tile[r[kWCols + j] * ts] = (old[j] & ~tag_bytes) | (val4 & tag_bytes);
  }
}

// n unrolled slots from the wide records at `recs` (16-byte aligned, with
// one record more readable past the last: the next record is read ahead of
// use, unconditionally).
template <int kCF, int kWF, bool kStats>
__device__ __forceinline__ void fast_slots(const uint32_t* recs, int n,
                                           uint32_t* tile, int ts,
                                           uint32_t valid80,
                                           LaneCounts& lanes) {
  const uint4* r4 = reinterpret_cast<const uint4*>(recs);
  uint4 q[4] = {r4[0], r4[1], r4[2], r4[3]};
#pragma unroll 2
  for (int s = 0; s < n; ++s) {
    uint32_t r[kWideWords];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      r[4 * i] = q[i].x;
      r[4 * i + 1] = q[i].y;
      r[4 * i + 2] = q[i].z;
      r[4 * i + 3] = q[i].w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = r4[4 * s + 4 + i];
    fast_slot<kCF, kWF, kStats>(r, tile, ts, valid80, lanes);
  }
}

// The tag of one general slot (any K, C), with its histogram thresholds.
template <bool kStats>
__device__ uint32_t general_tag(const uint32_t* rec, const uint32_t* tile,
                                int ts, int C, uint32_t valid80,
                                Counts& n) {
  const int nk = static_cast<int>(rec[0] & 0xffffu);
  if (nk == 0) return valid80;           // no key: an unconditional write
  const bool hist = kStats && (rec[0] >> 16 & 1u);
  const uint16_t* cc = reinterpret_cast<const uint16_t*>(rec + 1);
  const uint8_t* keys =
      reinterpret_cast<const uint8_t*>(rec + 1 + (C + 1) / 2);
  uint32_t tag = 0;
  for (int k = 0; k < nk; ++k) {
    uint32_t mm = 0;
    for (int c = 0; c < C; ++c) {
      const uint32_t v = tile[cc[c] * ts];
      mm += mismatch80(v, keys[k * C + c] * kOnes) >> 7;
      if (c % kSatEvery == kSatEvery - 1) {   // keep every byte below 0x80
        const uint32_t big = bytes_of80(at_least80(mm, 8));
        mm = (mm & ~big) | (0x07070707u & big);
      }
    }
    tag |= zero80(mm);
    if (hist) {
#pragma unroll
      for (int b = 1; b < 8; ++b)
        n.ge[b] += __popc(at_least80(mm, b) & valid80);
    } else if ((tag & valid80) == valid80) {
      break;                             // no histogram: every row tagged
    }
  }
  return tag & valid80;
}

// The writes of one general slot on the rows of tag80, in order: duplicate
// write columns apply one after another, each change charged.
template <bool kStats>
__device__ void general_writes(const uint32_t* rec, uint32_t* tile, int ts,
                               int K, int C, int W, uint32_t tag80,
                               Counts& n) {
  const int wc = 1 + (C + 1) / 2 + (K * C + 3) / 4;
  const uint16_t* cols = reinterpret_cast<const uint16_t*>(rec + wc);
  const uint8_t* vals =
      reinterpret_cast<const uint8_t*>(rec + wc + (W + 1) / 2);
  const uint32_t tag_bytes = bytes_of80(tag80);
  for (int w = 0; w < W; ++w) {
    uint32_t* cell = tile + cols[w] * ts;
    const uint32_t old = *cell;
    const uint32_t val4 = vals[w] * kOnes;
    if (kStats) {
      const uint32_t changed = nonzero80(old ^ val4) & tag80;
      n.sets += __popc(changed);
      n.resets += __popc(changed & nonzero80(~old));
    }
    *cell = (old & ~tag_bytes) | (val4 & tag_bytes);
  }
}

}  // namespace tap
