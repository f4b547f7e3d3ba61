// Whole-program TAP kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_tap_program_kernel` (entry `tap_run_program`)
// of src/repro/kernels/tap_pass/kernel.py: replay a compiled AP program --
// six dense schedule tensors -- over [rows, cols] int8 digits, with
// per-block set/reset/mismatch-histogram counters.
//
// Design.  CAM rows are independent, so one thread owns one row for the
// whole schedule and the step loop has no barrier.  A CTA stages its rows
// in shared memory column-major (tap_common.cuh) and writes them back once:
// the kernel moves 2 * rows * cols bytes of device memory.  The schedule
// (up to ~1 MB for a 3x20 multiply) does not fit on chip, so it is read
// from global memory; every thread of a warp reads the same address, which
// L1 serves as a broadcast.
//
// Bound.  Each row does roughly sum_s (K_s * C_s + W_s) integer compares
// and writes, against two bytes of traffic per cell: far above the byte
// bound, so the kernel is bound by integer issue.
//
// Counters.  A CTA never spans two `block_rows` blocks (grid = (n_blocks,
// ceil(block_rows / threads))), so each CTA reduces its counters with warp
// reductions and one atomicAdd per warp per counter into the block's row
// of a zeroed (n_blocks, 2 + 8) int32 tensor.  Integer atomics are
// order-independent: the counts are exact.
//
// Groups.  Slots run in groups of `pack`: every slot of a group takes its
// tag against the pre-group row, then the slots' writes land in order.
// `pack == 1` is the flat serial schedule; for `pack > 1` the packer
// guarantees the slots of a group share no written column, so this equals
// the one-hot blend of the reference.
#include "tap_common.cuh"

namespace {

template <bool kStats>
__global__ void tap_program_kernel(
    const int8_t* __restrict__ in, int8_t* __restrict__ out, int cols,
    int block_rows, long long n_valid, const int32_t* __restrict__ cmp_cols,
    const int8_t* __restrict__ keys, const uint8_t* __restrict__ key_valid,
    const uint8_t* __restrict__ hist_flag,
    const int32_t* __restrict__ wr_cols, const int8_t* __restrict__ wr_vals,
    int n_groups, int pack, int K, int C, int W, int32_t* counts) {
  extern __shared__ int8_t tile[];                 // [cols][blockDim.x]
  const int stride = blockDim.x;
  const int local0 = blockIdx.y * stride;          // first row in the block
  const int n_rows = min(stride, block_rows - local0);
  const long long row0 =
      static_cast<long long>(blockIdx.x) * block_rows + local0;
  tap::load_tile(tile, in + row0 * cols, n_rows, cols, stride);
  __syncthreads();

  int sets = 0, resets = 0;
  int hist[tap::kHistBins] = {0};
  const int t = threadIdx.x;
  // rows past n_valid are padding: no writes and no counts
  if (t < n_rows && row0 + t < n_valid) {
    int8_t* row = tile + t;
    for (int g = 0; g < n_groups; ++g) {
      unsigned tags = 0;
      for (int p = 0; p < pack; ++p) {
        const int s = g * pack + p;
        const bool hist_on = kStats && hist_flag[s];
        if (tap::slot_tag<kStats>(row, stride, cols, s, K, C, cmp_cols,
                                  keys, key_valid, hist_on, hist))
          tags |= 1u << p;
      }
      for (int p = 0; p < pack; ++p)
        if (tags >> p & 1u)
          tap::slot_write<kStats>(row, stride, cols, g * pack + p, W,
                                  wr_cols, wr_vals, sets, resets);
    }
  }
  __syncthreads();
  tap::store_tile(out + row0 * cols, tile, n_rows, cols, stride);

  if (kStats) {
    int32_t* dst = counts + static_cast<size_t>(blockIdx.x) *
                                (2 + tap::kHistBins);
    int vals[2 + tap::kHistBins];
    vals[0] = sets;
    vals[1] = resets;
#pragma unroll
    for (int b = 0; b < tap::kHistBins; ++b) vals[2 + b] = hist[b];
#pragma unroll
    for (int j = 0; j < 2 + tap::kHistBins; ++j) {
      const int v = __reduce_add_sync(0xffffffffu, vals[j]);
      if ((t & 31) == 0 && v != 0) atomicAdd(dst + j, v);
    }
  }
}

template <bool kStats>
cudaError_t launch(dim3 grid, int threads, size_t smem, cudaStream_t stream,
                   const int8_t* in, int8_t* out, int cols, int block_rows,
                   long long n_valid, const int32_t* cmp_cols,
                   const int8_t* keys, const uint8_t* key_valid,
                   const uint8_t* hist_flag, const int32_t* wr_cols,
                   const int8_t* wr_vals, int n_groups, int pack, int K,
                   int C, int W, int32_t* counts) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tap_program_kernel<kStats>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  tap_program_kernel<kStats><<<grid, threads, smem, stream>>>(
      in, out, cols, block_rows, n_valid, cmp_cols, keys, key_valid,
      hist_flag, wr_cols, wr_vals, n_groups, pack, K, C, W, counts);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  `rows` is a multiple of `block_rows`;
// the schedule holds n_groups * pack slots; `counts` is a zeroed
// (rows / block_rows, 10) int32 tensor, or null to skip the counters.
// Returns cudaGetLastError() after the launch.
extern "C" int tap_run_program_launch(
    const void* in, void* out, long long rows, int cols, int block_rows,
    long long n_valid, const void* cmp_cols, const void* keys,
    const void* key_valid, const void* hist_flag, const void* wr_cols,
    const void* wr_vals, int n_groups, int pack, int K, int C, int W,
    void* counts, int threads, void* stream) {
  const dim3 grid(static_cast<unsigned>(rows / block_rows),
                  static_cast<unsigned>((block_rows + threads - 1) / threads));
  const size_t smem = static_cast<size_t>(cols) * threads;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto args = [&](auto launcher) {
    return launcher(
        grid, threads, smem, s, static_cast<const int8_t*>(in),
        static_cast<int8_t*>(out), cols, block_rows, n_valid,
        static_cast<const int32_t*>(cmp_cols),
        static_cast<const int8_t*>(keys),
        static_cast<const uint8_t*>(key_valid),
        static_cast<const uint8_t*>(hist_flag),
        static_cast<const int32_t*>(wr_cols),
        static_cast<const int8_t*>(wr_vals), n_groups, pack, K, C, W,
        static_cast<int32_t*>(counts));
  };
  const cudaError_t err = counts ? args(launch<true>) : args(launch<false>);
  return static_cast<int>(err);
}
