// Short-schedule TAP kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_tap_kernel` (entry `tap_apply_schedule`) of
// src/repro/kernels/tap_pass/kernel.py: apply a short LUT schedule (at most
// UNROLL_STEP_LIMIT = 64 steps in the callers: one LUT application or a
// narrow ripple add) to [rows, cols] int8 digits.  Same compare and write
// semantics as the program kernel, with no counters and no row mask: a
// stored -1 matches any key, -1-padded compare columns are ignored, a step
// with no valid key tags every row, writes apply serially in column order.
//
// What bounds it.  Each digit is read and written once, 2 * rows * cols
// bytes: at 2^20 rows of the width-3 ripple add (7 columns) 0.0044 ms at
// 3.35 TB/s.  In practice the time is the step's instruction stream per
// row: every step is a dependent read-modify-write of a few cells of each
// row, and the first design (one row per thread, runtime K, C and W loops,
// a break per key, the schedule staged byte by byte) spent 0.270 ms there.
//
// Design: the program kernel's (tap_program.cu), without counters.
// - Four rows per thread.  A CTA stages its rows column-major in shared
//   memory, one 32-bit word holding four rows of one column, and runs the
//   byte-lane slots of tap_common.cuh on the four rows at once.  Rows past
//   `rows` in the last CTA drop out through the byte mask.
// - Slot records, staged once.  The host encodes the step tuple once per
//   (schedule, column count, device) into slot records
//   (kernels/tap_pass/records.py, pack 1).  A short schedule is at most a
//   few KB, so each CTA copies all of it into shared memory with cp.async
//   beside its rows, under one barrier: no chunk loop, no double buffer.
// - Unrolled slots.  A schedule with at most one key, four compare columns
//   and three distinct write columns per step (the non-blocked ripple add
//   and LUT applications) runs the branch-free unrolled slot; any other
//   (a blocked LUT: several keys per step) runs the general slot.
// - Grid.  The host picks rows per CTA (kernel.schedule_shape) so that the
//   grid gives each SM at least two CTAs where the rows allow it: 8 rows
//   per CTA at 4096 rows (512 CTAs), 1024 at 2^20; at least four warps per
//   CTA share the copies in and out.
#include "tap_common.cuh"

namespace {

constexpr int kMaxThreads = 256;

struct Args {
  const int8_t* in;
  int8_t* out;
  long long rows;
  int cols;
  const uint4* records;
  int n_slots;
  int rec_words;
  int K, C, W;                    // the record layout
  int cta_rows;
};

// kCF > 0: the unrolled slot (one key, kCF compare columns, kWF distinct
// write columns); kCF == 0: the general slot.
template <int kCF, int kWF>
__global__ void __launch_bounds__(kMaxThreads) tap_schedule_kernel(Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  // n_slots records and one more, which the read ahead of the last unrolled
  // slot reaches; then the [cols + 1][ts] tile
  uint32_t* recs = smem;
  const int sw = a.cta_rows / 4;
  const int ts = sw | 1;     // words per column: odd, so the byte copies
                             // of consecutive columns hit distinct banks
  uint32_t* tile = smem + (a.n_slots + 1) * a.rec_words;
  const long long row0 = static_cast<long long>(blockIdx.x) * a.cta_rows;
  const int n_rows = static_cast<int>(
      min(static_cast<long long>(a.cta_rows), a.rows - row0));
  const int t = threadIdx.x;

  uint4* dst = reinterpret_cast<uint4*>(recs);
  for (int i = t; i < a.n_slots * a.rec_words / 4; i += blockDim.x)
    tap::cp_async16(dst + i, a.records + i);
  tap::cp_async_commit();
  tap::copy_rows(reinterpret_cast<uint8_t*>(tile),
                 const_cast<int8_t*>(a.in) + row0 * a.cols, n_rows, a.cols,
                 4 * ts, true);
  for (int q = t; q < sw; q += blockDim.x)
    tile[a.cols * ts + q] = 0xffffffffu;             // the dummy column
  uint32_t valid80 = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (4 * t + i < n_rows) valid80 |= 0x80u << (8 * i);
  tap::cp_async_wait_all();
  __syncthreads();

  if (t < sw && valid80 != 0) {
    uint32_t* my = tile + t;
    if constexpr (kCF > 0) {
      tap::LaneCounts unused;
      tap::fast_slots<kCF, kWF, false>(recs, a.n_slots, my, ts, valid80,
                                       unused);
    } else {
      tap::Counts unused;
      for (int s = 0; s < a.n_slots; ++s) {
        const uint32_t* rec = recs + s * a.rec_words;
        const uint32_t tag =
            tap::general_tag<false>(rec, my, ts, a.C, valid80, unused);
        if (tag)
          tap::general_writes<false>(rec, my, ts, a.K, a.C, a.W, tag,
                                     unused);
      }
    }
  }
  __syncthreads();
  tap::copy_rows(reinterpret_cast<uint8_t*>(tile), a.out + row0 * a.cols,
                 n_rows, a.cols, 4 * ts, false);
}

template <int kCF, int kWF>
cudaError_t launch(dim3 grid, int threads, size_t smem, cudaStream_t stream,
                   const Args& a) {
  auto* kernel = tap_schedule_kernel<kCF, kWF>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  `records` holds n_slots records of
// `rec_words` int32 (a multiple of 4) in the layout (K, C, W) of kernel
// `kind` (0 general, 1 and 2 the unrolled (1, 3, 3) and (1, 4, 3); pack 1);
// `cta_rows` (a multiple of 4, at most 4 * threads) are the rows of one
// CTA.  Returns cudaGetLastError() after the launch.
extern "C" int tap_apply_schedule_launch(
    const void* in, void* out, long long rows, int cols, const void* records,
    int n_slots, int rec_words, int kind, int K, int C, int W, int cta_rows,
    int threads, void* stream) {
  if (cta_rows % 4 || cta_rows > 4 * threads || threads > kMaxThreads ||
      rec_words % 4 || (kind != 0 && rec_words != tap::kWideWords))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int8_t*>(in), static_cast<int8_t*>(out),
               rows, cols, static_cast<const uint4*>(records), n_slots,
               rec_words, K, C, W, cta_rows};
  const dim3 grid(static_cast<unsigned>((rows + cta_rows - 1) / cta_rows));
  const size_t smem =
      4 * static_cast<size_t>(n_slots + 1) * rec_words +
      4 * static_cast<size_t>(cols + 1) * (cta_rows / 4 | 1);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return static_cast<int>(launch<0, 0>(grid, threads, smem, s, a));
    case 1: return static_cast<int>(launch<3, 3>(grid, threads, smem, s, a));
    case 2: return static_cast<int>(launch<4, 3>(grid, threads, smem, s, a));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
