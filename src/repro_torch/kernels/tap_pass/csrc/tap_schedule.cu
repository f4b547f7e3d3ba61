// Short-schedule TAP kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_tap_kernel` (entry `tap_apply_schedule`) of
// src/repro/kernels/tap_pass/kernel.py: apply a short LUT schedule (at most
// a few dozen steps, one LUT application or a narrow ripple add) to
// [rows, cols] int8 digits.  Same compare/write semantics as the program
// kernel, with no counters and no row mask.
//
// Design.  The schedule is small, so each CTA stages all of it in shared
// memory once, beside its rows (column-major, one thread per row, as in
// tap_common.cuh); the step loop then reads nothing but shared memory.
//
// Bound.  As for the program kernel: 2 * rows * cols bytes of device
// traffic against sum_s (K_s * C_s + W_s) integer operations per row, so
// integer issue bounds it.
#include "tap_common.cuh"

namespace {

__device__ __forceinline__ void stage(unsigned char* dst, const void* src,
                                      int n) {
  const unsigned char* s = static_cast<const unsigned char*>(src);
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = s[i];
}

__global__ void tap_schedule_kernel(
    const int8_t* __restrict__ in, int8_t* __restrict__ out, long long rows,
    int cols, const int32_t* __restrict__ cmp_cols,
    const int8_t* __restrict__ keys, const uint8_t* __restrict__ key_valid,
    const int32_t* __restrict__ wr_cols, const int8_t* __restrict__ wr_vals,
    int S, int K, int C, int W, int sched_bytes) {
  // shared layout: cmp_cols | wr_cols (int32) | keys | key_valid | wr_vals
  // (bytes), padded to sched_bytes, then the [cols][blockDim.x] row tile
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* s_cmp = reinterpret_cast<int32_t*>(smem);
  int32_t* s_wc = s_cmp + S * C;
  int8_t* s_keys = reinterpret_cast<int8_t*>(s_wc + S * W);
  uint8_t* s_kv = reinterpret_cast<uint8_t*>(s_keys + S * K * C);
  int8_t* s_wv = reinterpret_cast<int8_t*>(s_kv + S * K);
  int8_t* tile = reinterpret_cast<int8_t*>(smem + sched_bytes);
  stage(reinterpret_cast<unsigned char*>(s_cmp), cmp_cols, 4 * S * C);
  stage(reinterpret_cast<unsigned char*>(s_wc), wr_cols, 4 * S * W);
  stage(reinterpret_cast<unsigned char*>(s_keys), keys, S * K * C);
  stage(s_kv, key_valid, S * K);
  stage(reinterpret_cast<unsigned char*>(s_wv), wr_vals, S * W);

  const int stride = blockDim.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * stride;
  const int n_rows = static_cast<int>(min(static_cast<long long>(stride),
                                          rows - row0));
  tap::load_tile(tile, in + row0 * cols, n_rows, cols, stride);
  __syncthreads();

  if (threadIdx.x < n_rows) {
    int8_t* row = tile + threadIdx.x;
    int hist[tap::kHistBins];                      // unused without stats
    int sets = 0, resets = 0;
    for (int s = 0; s < S; ++s)
      if (tap::slot_tag<false>(row, stride, cols, s, K, C, s_cmp, s_keys,
                               s_kv, false, hist))
        tap::slot_write<false>(row, stride, cols, s, W, s_wc, s_wv, sets,
                               resets);
  }
  __syncthreads();
  tap::store_tile(out + row0 * cols, tile, n_rows, cols, stride);
}

}  // namespace

// C interface, loaded with ctypes.  The schedule tensors are dense
// (S, C) / (S, K, C) / (S, K) / (S, W) / (S, W) as in the program kernel;
// `sched_bytes` is their total size rounded up to 16.  Returns
// cudaGetLastError() after the launch.
extern "C" int tap_apply_schedule_launch(
    const void* in, void* out, long long rows, int cols, const void* cmp_cols,
    const void* keys, const void* key_valid, const void* wr_cols,
    const void* wr_vals, int S, int K, int C, int W, int sched_bytes,
    int threads, void* stream) {
  const dim3 grid(static_cast<unsigned>((rows + threads - 1) / threads));
  const size_t smem = static_cast<size_t>(sched_bytes) +
                      static_cast<size_t>(cols) * threads;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tap_schedule_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  tap_schedule_kernel<<<grid, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(in), static_cast<int8_t*>(out), rows, cols,
      static_cast<const int32_t*>(cmp_cols), static_cast<const int8_t*>(keys),
      static_cast<const uint8_t*>(key_valid),
      static_cast<const int32_t*>(wr_cols),
      static_cast<const int8_t*>(wr_vals), S, K, C, W, sched_bytes);
  return static_cast<int>(cudaGetLastError());
}
