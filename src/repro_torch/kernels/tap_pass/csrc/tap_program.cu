// Whole-program TAP kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_tap_program_kernel` (entry `tap_run_program`)
// of src/repro/kernels/tap_pass/kernel.py: replay a compiled AP program over
// [rows, cols] int8 digits, with per-block set/reset/mismatch-histogram
// counters.
//
// What bounds it.  Every step of the program is a dependent read-modify-
// write of a few cells of each row.  Where there are many rows (2^20) the
// integer ALU's issue bounds it; where there are few (the AP matmul's 12288
// rows of 650 columns: one SM's shared memory holds only 357 of them, and
// 93 rows per SM spread the work over the card) one warp per SM runs the
// whole schedule, and the length of one step's instruction stream, branches
// included, bounds it.  The first design -- one thread per row, the six
// dense schedule tensors read from device memory at every step, K, C and W
// runtime loop bounds -- spent about 66 SM-cycles per warp per step at
// 2^20 rows and 404 at 12288 (PERF.md; scripts/tap_variants.py found no
// single part that held most of it).
//
// Design.
// - Four rows per thread.  A CTA stages its rows column-major in shared
//   memory, so one 32-bit word is four rows of one column and a warp's word
//   reads are 128 consecutive bytes; a column holds an odd number of words,
//   so the byte copies in and out hit distinct banks.  Compares, the
//   mismatch count, the tag, the histogram and the writes work on the four
//   bytes at once (tap_common.cuh's byte-lane helpers and slot bodies,
//   which the schedule kernel, tap_schedule.cu, shares).
// - Slot records.  The host encodes the schedule once per program into one
//   fixed-size record per slot (kernels/tap_pass/records.py).  A column
//   outside [0, cols) is encoded as the dummy column `cols`, an extra tile
//   column of don't-care digits: a compare there always matches and a write
//   of -1 there changes nothing.  The records are staged chunk by chunk
//   into shared memory with `cp.async`, double-buffered (one barrier per
//   chunk), and the next slot's record is read while this one computes.
// - Unrolled kernels.  Programs with at most one key, four compare columns
//   and three distinct write columns per slot and no packing -- every
//   program on the main paths -- run on instantiations whose slot has no
//   loop and no branch: a wide record (every column a word, every digit
//   spread to four bytes, the no-key and histogram flags as byte masks),
//   all cells loaded before any is written, padded cells on the dummy
//   column, counters summed per row in byte lanes with the shift on the
//   multiply-add pipe and added up once per chunk.  Any other program runs
//   on the general instantiation: runtime K, C, W, serial writes, groups of
//   `pack`, popcounts.
// - Histogram without bins.  hist[b] = #(mm >= b) - #(mm >= b + 1), with
//   #(mm >= 0) known on the host (valid rows x keys of the histogram
//   slots); the unrolled kernels get #(mm >= b), b = 1..4, from four sums
//   (rows with a mismatch, bit 1 of mm, bit 2 of mm, and mm itself).
// - Grid.  A CTA's rows are chosen by the host so the grid gives each SM
//   at least two CTAs where the rows allow it: 44 rows per CTA for the AP
//   matmul's 12288 rows (279 CTAs), 1024 for 2^20 rows; at least four warps
//   per CTA share the copies in and out.
//
// Counters.  A CTA never spans two `block_rows` blocks (grid = (n_blocks,
// ceil(block_rows / cta_rows))), so each CTA reduces its counters with warp
// reductions and one atomicAdd per warp per counter into the block's row of
// a zeroed (n_blocks, 2 + 8) int32 tensor.  Integer atomics are
// order-independent: the counts are exact.
//
// Groups.  Slots run in groups of `pack`: every slot of a group takes its
// tag against the pre-group row, then the slots' writes land in order.
// `pack == 1` is the flat serial schedule (duplicate write columns apply one
// after another, each change charged).
#include "tap_common.cuh"

namespace {

using tap::copy_rows;
using tap::Counts;
using tap::cp_async16;
using tap::cp_async_commit;
using tap::cp_async_wait_all;
using tap::general_tag;
using tap::general_writes;
using tap::LaneCounts;

constexpr int kMaxThreads = 256;
constexpr int kMaxPack = 32;

struct Args {
  const int8_t* in;
  int8_t* out;
  int cols;
  int block_rows;
  long long n_valid;
  const int32_t* block_valid;     // null, or valid rows of each block
  const uint4* records;
  int n_slots;
  int rec_words;
  int chunk_slots;
  int pack;
  int K, C, W;                    // the record layout
  int n_hist_keys;
  int32_t* counts;
  int cta_rows;
};

// kCF > 0: an unrolled kernel (one key, kCF compare columns, kWF distinct
// write columns, pack 1); kCF == 0: the general kernel.
template <int kCF, int kWF, bool kStats>
__global__ void __launch_bounds__(kMaxThreads) tap_program_kernel(Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int chunk_words = a.chunk_slots * a.rec_words;
  // [2][chunk_words] and one record more, which the read ahead of the
  // last slot of the second buffer reaches
  uint32_t* rec_buf = smem;
  const int sw = a.cta_rows / 4;                     // rows / 4
  const int ts = sw | 1;     // words per column: odd, so the byte copies
                             // of consecutive columns hit distinct banks
  uint32_t* tile = smem + 2 * chunk_words + a.rec_words;  // [cols + 1][ts]
  const int local0 = blockIdx.y * a.cta_rows;        // first row in block
  const int n_rows = min(a.cta_rows, a.block_rows - local0);
  const long long row0 =
      static_cast<long long>(blockIdx.x) * a.block_rows + local0;
  const int t = threadIdx.x;

  const auto stage = [&](int chunk) {
    const uint4* src =
        a.records + static_cast<long long>(chunk) * (chunk_words / 4);
    uint4* dst = reinterpret_cast<uint4*>(rec_buf +
                                          (chunk & 1) * chunk_words);
    for (int i = t; i < chunk_words / 4; i += blockDim.x)
      cp_async16(dst + i, src + i);
  };
  const int n_chunks = (a.n_slots + a.chunk_slots - 1) / a.chunk_slots;
  if (n_chunks > 0) stage(0);
  cp_async_commit();
  copy_rows(reinterpret_cast<uint8_t*>(tile),
            const_cast<int8_t*>(a.in) + row0 * a.cols, n_rows, a.cols,
            4 * ts, true);
  for (int q = t; q < sw; q += blockDim.x)
    tile[a.cols * ts + q] = 0xffffffffu;             // the dummy column

  // padding rows get no writes and no counts: rows at or past n_valid, or,
  // with block_valid, rows at or past block_valid[b] within block b
  const long long limit =
      a.block_valid ? static_cast<long long>(blockIdx.x) * a.block_rows +
                          a.block_valid[blockIdx.x]
                    : a.n_valid;
  uint32_t valid80 = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (4 * t + i < n_rows && row0 + 4 * t + i < limit)
      valid80 |= 0x80u << (8 * i);
  const bool active = t < sw && valid80 != 0;
  uint32_t* my = tile + t;
  Counts n;
  LaneCounts lanes;

  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_async_wait_all();
    __syncthreads();            // chunk ch staged, chunk ch - 1 consumed
    if (ch + 1 < n_chunks) stage(ch + 1);
    cp_async_commit();
    if (!active) continue;
    const uint32_t* rb = rec_buf + (ch & 1) * chunk_words;
    const int n_here = min(a.chunk_slots, a.n_slots - ch * a.chunk_slots);
    if constexpr (kCF > 0) {
      tap::fast_slots<kCF, kWF, kStats>(rb, n_here, my, ts, valid80,
                                        lanes);
      if (kStats) lanes.flush(n);
    } else {
      for (int g = 0; g < n_here; g += a.pack) {
        uint32_t tags[kMaxPack];
        for (int p = 0; p < a.pack; ++p)
          tags[p] = general_tag<kStats>(rb + (g + p) * a.rec_words, my, ts,
                                        a.C, valid80, n);
        for (int p = 0; p < a.pack; ++p)
          if (tags[p])
            general_writes<kStats>(rb + (g + p) * a.rec_words, my, ts, a.K,
                                   a.C, a.W, tags[p], n);
      }
    }
  }
  __syncthreads();
  copy_rows(reinterpret_cast<uint8_t*>(tile), a.out + row0 * a.cols, n_rows,
            a.cols, 4 * ts, false);

  if (kStats) {
    int32_t* dst = a.counts + static_cast<size_t>(blockIdx.x) *
                                  (2 + tap::kHistBins);
    int vals[2 + tap::kHistBins];
    vals[0] = n.sets;
    vals[1] = n.resets;
    // bin 0 from every counted (row, key): the valid rows times the keys
    // of the histogram slots
    vals[2] = (active ? __popc(valid80) * a.n_hist_keys : 0) - n.ge[1];
#pragma unroll
    for (int b = 1; b < 7; ++b) vals[2 + b] = n.ge[b] - n.ge[b + 1];
    vals[2 + 7] = n.ge[7];
#pragma unroll
    for (int j = 0; j < 2 + tap::kHistBins; ++j) {
      const int v = __reduce_add_sync(0xffffffffu, vals[j]);
      if ((t & 31) == 0 && v != 0) atomicAdd(dst + j, v);
    }
  }
}

template <int kCF, int kWF, bool kStats>
cudaError_t launch(dim3 grid, int threads, size_t smem, cudaStream_t stream,
                   const Args& a) {
  auto* kernel = tap_program_kernel<kCF, kWF, kStats>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kStats>
cudaError_t launch_kind(int kind, dim3 grid, int threads, size_t smem,
                        cudaStream_t stream, const Args& a) {
  switch (kind) {
    case 0: return launch<0, 0, kStats>(grid, threads, smem, stream, a);
    case 1: return launch<3, 3, kStats>(grid, threads, smem, stream, a);
    case 2: return launch<4, 3, kStats>(grid, threads, smem, stream, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface, loaded with ctypes.  `rows` is a multiple of `block_rows`;
// `records` holds n_slots records of `rec_words` int32 (a multiple of 4),
// padded to whole chunks of `chunk_slots` (a multiple of `pack`, at most
// 32), in the layout (K, C, W) of kernel `kind` (0 general, 1 and 2 the
// unrolled (1, 3, 3) and (1, 4, 3)); `n_hist_keys` is the sum over the
// histogram slots of their valid keys; `counts` is a zeroed
// (rows / block_rows, 10) int32 tensor, or null to skip the counters;
// `cta_rows` (a multiple of 4, at most 4 * threads) are the rows of one CTA;
// `block_valid` is null (rows at or past `n_valid` are padding) or
// rows / block_rows int32 counts (rows of block b at or past block_valid[b]
// are padding, and `n_valid` is not read).
// Returns cudaGetLastError() after the launch.
extern "C" int tap_run_program_launch(
    const void* in, void* out, long long rows, int cols, int block_rows,
    long long n_valid, const void* block_valid, const void* records,
    int n_slots, int rec_words,
    int chunk_slots, int pack, int kind, int K, int C, int W,
    int n_hist_keys, void* counts, int cta_rows, int threads, void* stream) {
  if (cta_rows % 4 || cta_rows > 4 * threads || threads > kMaxThreads ||
      rec_words % 4 || pack < 1 || pack > kMaxPack || chunk_slots % pack ||
      (kind != 0 && (pack != 1 || rec_words != tap::kWideWords ||
                     chunk_slots * 4 > 255)))     // LaneCounts' bytes
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int8_t*>(in), static_cast<int8_t*>(out),
               cols, block_rows, n_valid,
               static_cast<const int32_t*>(block_valid),
               static_cast<const uint4*>(records), n_slots, rec_words,
               chunk_slots, pack, K, C, W, n_hist_keys,
               static_cast<int32_t*>(counts), cta_rows};
  const dim3 grid(static_cast<unsigned>(rows / block_rows),
                  static_cast<unsigned>((block_rows + cta_rows - 1) /
                                        cta_rows));
  const size_t smem =
      4 * static_cast<size_t>(2 * chunk_slots + 1) * rec_words +
      4 * static_cast<size_t>(cols + 1) * (cta_rows / 4 | 1);
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      counts ? launch_kind<true>(kind, grid, threads, smem, s, a)
             : launch_kind<false>(kind, grid, threads, smem, s, a);
  return static_cast<int>(err);
}
