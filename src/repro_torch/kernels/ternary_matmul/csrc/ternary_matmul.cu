// Packed balanced-ternary matmul for Hopper (sm_90a), on the CUDA cores:
// the decode route.
//
// Replaces, for M < 16 (the wrapper's `TC_MIN_M`; ternary_matmul_tc.cu
// takes the rest), the Pallas kernel `_ternary_matmul_kernel` (entry
// `ternary_matmul`, wrapper `ops.ternary_matmul_op`) of
// src/repro/kernels/ternary_matmul/kernel.py:
//
//   y[M, N] = (x[M, K] @ unpack(packed)[K', N]) * scale[N]
//
// x is fp32 or bf16 [M, K] row-major with K <= K' = 16 * K16 (columns K..K'
// read as zero); packed is int32 [K16, N], bits 2i..2i+1 of word [k16, n]
// holding w[16 * k16 + i, n] + 1 in {0, 1, 2}; scale is fp32 [N]; y has x's
// dtype.  The sum is taken in fp32 and rounded once, to nearest, after the
// scale.
//
// Bound.  A decode step moves K' * N / 4 bytes of words for 2 * M * K' * N
// operations: with M < 16 the bytes bound it (x and y are small), and where
// the words stay in L2 between calls (qwen3-0.6b's 0.79 MB), the latency of
// one CTA's chain of loads, barriers and sums.  So the design spreads the
// work over the whole card and keeps each CTA's chain short.
//
// Design.  The weights stay 2-bit in device memory and are decoded in
// registers: no dense weight is ever built.  A CTA of 8 warps owns BM rows
// by 32 * kCols columns (kCols = 1 or 4, a template parameter): lane l of
// every warp owns the columns n0 + l + 32 c, so each packed word load of a
// warp is 32 consecutive int32 (one 128-byte line).  The 8 warps split the
// K axis (word k16 to warp k16 % 8 within each 32-word chunk), and x is
// staged chunk by chunk in shared memory as fp32, where every lane of a
// warp reads the same address (a broadcast).  A warp issues the loads of
// its 4 words x kCols columns of a chunk before it decodes any.  The wrapper
// picks kCols = 4 where that grid already gives every SM a CTA (qwen2-72b,
// N = 29568: 231 CTAs), else kCols = 1 and a split of the K chunks over a
// thread block cluster of 2 or 4 CTAs (qwen3-0.6b, N = 3072: 96 CTAs x 2).
// The partial sums meet without atomics, in a fixed order: the 8 warps' in
// shared memory in warp order, then the cluster's through distributed
// shared memory in rank order, each CTA of the cluster summing and storing
// its share of the outputs.  So the result does not depend on scheduling.
// BM (1, 2, 4, 8, 16) is a template parameter, the smallest that covers M
// up to 16, so a decode step with one token does no work for padding rows.
//
// Arithmetic.  fp32 FMAs on the CUDA cores, never the TF32 tensor cores:
// TF32 keeps 10 mantissa bits of x, about 5e-4 relative, outside the 1e-4
// tolerance.  With 16 rows or more the tensor-core kernel computes the same
// fp32 product exactly as three bf16 passes (ternary_matmul_tc.cu).
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kPack = 16;                          // trits per int32 word
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kWordsPerWarp = 4;                   // per chunk
constexpr int kChunkWords = kWarps * kWordsPerWarp;
constexpr int kChunkK = kChunkWords * kPack;       // 512 k values
constexpr int kMaxSplit = 4;                       // CTAs per cluster
constexpr uint32_t kZeroWord = 0x55555555u;        // sixteen ternary zeros

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Only the 32-column CTAs (kCols == 1) split K over a cluster: the wrapper
// picks 128 columns only where that grid already fills the card.
template <int kCols>
constexpr bool kMaySplit = kCols == 1;

template <int BM, int kCols>
constexpr int smem_bytes() {
  // the x chunk during the K loop, the warps' partial sums after it; then
  // the CTA's sums, which the other CTAs of its cluster read
  constexpr int kBN = 32 * kCols;
  constexpr int xs = BM * kChunkK;
  constexpr int red = kWarps * BM * kBN;
  return 4 * ((xs > red ? xs : red) + (kMaySplit<kCols> ? BM * kBN : 0));
}

// At most 128 registers a thread, so two CTAs share an SM: unbounded, the
// 16 x 128 tile takes 206 and runs alone
template <typename T, int BM, int kCols>
__global__ void __launch_bounds__(kThreads, 2) ternary_matmul_kernel(
    const T* __restrict__ x, const int32_t* __restrict__ packed,
    const float* __restrict__ scale, T* __restrict__ y, long long M, int Kx,
    int K16, int N) {
  constexpr int kBN = 32 * kCols;                  // columns per CTA
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                                // [BM][kChunkK]
  float* red = smem;                               // [kWarps][BM][kBN]
  int rank = 0, split = 1;
  if constexpr (kMaySplit<kCols>) {
    const cg::cluster_group cluster = cg::this_cluster();
    rank = static_cast<int>(cluster.block_rank());
    split = static_cast<int>(cluster.num_blocks());
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kBN;
  const long long m0 = static_cast<long long>(blockIdx.y) * BM;
  // this CTA's K chunks: a contiguous share of them, by cluster rank
  const int n_chunks = (K16 + kChunkWords - 1) / kChunkWords;
  const int per = (n_chunks + split - 1) / split;
  const int c_lo = min(n_chunks, rank * per);
  const int c_hi = min(n_chunks, c_lo + per);

  float acc[BM][kCols];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = 0.f;

  for (int chunk = c_lo; chunk < c_hi; ++chunk) {
    const int w0 = chunk * kChunkWords;
    // this warp's words of the chunk, loaded before the barrier so their
    // latency overlaps the staging of x
    uint32_t p[kWordsPerWarp][kCols];
#pragma unroll
    for (int j = 0; j < kWordsPerWarp; ++j) {
      const int kw = w0 + warp + j * kWarps;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int n = n0 + c * 32 + lane;
        p[j][c] = (kw < K16 && n < N)
                      ? static_cast<uint32_t>(__ldg(
                            packed + static_cast<long long>(kw) * N + n))
                      : kZeroWord;
      }
    }
    __syncthreads();                   // the previous chunk is consumed
    const int k0 = w0 * kPack;
    for (int i = threadIdx.x; i < BM * kChunkK; i += kThreads) {
      const int m = i / kChunkK;
      const int k = k0 + i % kChunkK;
      xs[i] = (m0 + m < M && k < Kx) ? to_f32(x[(m0 + m) * Kx + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kWordsPerWarp; ++j) {
      const int kb = (warp + j * kWarps) * kPack;   // offset in the chunk
#pragma unroll
      for (int i4 = 0; i4 < kPack; i4 += 4) {
        float wv[4][kCols];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            wv[q][c] = static_cast<float>(
                static_cast<int>((p[j][c] >> (2 * (i4 + q))) & 3u) - 1);
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          const float4 xv =
              *reinterpret_cast<const float4*>(xs + m * kChunkK + kb + i4);
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            acc[m][c] = fmaf(xv.x, wv[0][c], acc[m][c]);
            acc[m][c] = fmaf(xv.y, wv[1][c], acc[m][c]);
            acc[m][c] = fmaf(xv.z, wv[2][c], acc[m][c]);
            acc[m][c] = fmaf(xv.w, wv[3][c], acc[m][c]);
          }
        }
      }
    }
  }

  __syncthreads();                     // xs is dead; reuse it for red
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      red[(warp * BM + m) * kBN + c * 32 + lane] = acc[m][c];
  __syncthreads();
  if constexpr (kMaySplit<kCols>) {
    if (split > 1) {
      const cg::cluster_group cluster = cg::this_cluster();
      float* sums =                              // [BM][kBN], after red
          smem + (BM * kChunkK > kWarps * BM * kBN ? BM * kChunkK
                                                   : kWarps * BM * kBN);
      for (int i = threadIdx.x; i < BM * kBN; i += kThreads) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += red[w * BM * kBN + i];
        sums[i] = s;
      }
      cluster.sync();                  // every CTA's sums are in place
      // this CTA's share of the outputs, the cluster's sums added in rank
      // order
      const int share = (BM * kBN + split - 1) / split;
      const int o_hi = min(BM * kBN, (rank + 1) * share);
      for (int i = rank * share + threadIdx.x; i < o_hi; i += kThreads) {
        const int m = i / kBN;
        const int n = n0 + i % kBN;
        float s = 0.f;
        for (int q = 0; q < split; ++q)
          s += cluster.map_shared_rank(sums, q)[i];
        if (m0 + m < M && n < N) store(y + (m0 + m) * N + n, s * scale[n]);
      }
      cluster.sync();                  // no CTA leaves while read
      return;
    }
  }
  // one CTA for these outputs: its warps' sums, in warp order
  for (int i = threadIdx.x; i < BM * kBN; i += kThreads) {
    const int m = i / kBN;
    const int n = n0 + i % kBN;
    if (m0 + m >= M || n >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * BM * kBN + i];
    store(y + (m0 + m) * N + n, s * scale[n]);
  }
}

template <typename T, int BM, int kCols>
int launch(const void* x, const void* packed, const void* scale, void* y,
           long long M, int Kx, int K16, int N, int split,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes<BM, kCols>();
  auto* kernel = ternary_matmul_kernel<T, BM, kCols>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((N + 32 * kCols - 1) /
                                           (32 * kCols)),
                     static_cast<unsigned>((M + BM - 1) / BM),
                     static_cast<unsigned>(split));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = static_cast<unsigned>(split);
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;    // one CTA needs no cluster
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(x),
      static_cast<const int32_t*>(packed), static_cast<const float*>(scale),
      static_cast<T*>(y), M, Kx, K16, N);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kCols>
int launch_bm(const void* x, const void* packed, const void* scale, void* y,
              long long M, int Kx, int K16, int N, int bm, int split,
              cudaStream_t s) {
  switch (bm) {
    case 1: return launch<T, 1, kCols>(x, packed, scale, y, M, Kx, K16, N,
                                       split, s);
    case 2: return launch<T, 2, kCols>(x, packed, scale, y, M, Kx, K16, N,
                                       split, s);
    case 4: return launch<T, 4, kCols>(x, packed, scale, y, M, Kx, K16, N,
                                       split, s);
    case 8: return launch<T, 8, kCols>(x, packed, scale, y, M, Kx, K16, N,
                                       split, s);
    case 16: return launch<T, 16, kCols>(x, packed, scale, y, M, Kx, K16, N,
                                         split, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_cols(const void* x, const void* packed, const void* scale,
                void* y, long long M, int Kx, int K16, int N, int bm,
                int cols, int split, cudaStream_t s) {
  if (cols == 1)
    return launch_bm<T, 1>(x, packed, scale, y, M, Kx, K16, N, bm, split, s);
  if (cols == 4)
    return launch_bm<T, 4>(x, packed, scale, y, M, Kx, K16, N, bm, split, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C interface, loaded with ctypes.  `dtype` is 0 for fp32 x and y, 1 for
// bf16; `bm` is the M tile (1, 2, 4, 8 or 16), `cols` the columns per lane
// (1 or 4), `split` the CTAs of a cluster that split K (1, 2 or 4; only
// with cols = 1).  All
// tensors contiguous on the current device.  Returns the launch's error,
// or cudaGetLastError() after it.
extern "C" int ternary_matmul_launch(const void* x, const void* packed,
                                     const void* scale, void* y,
                                     long long M, int Kx, int K16, int N,
                                     int dtype, int bm, int cols, int split,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split < 1 || split > kMaxSplit || (cols != 1 && split != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_cols<float>(x, packed, scale, y, M, Kx, K16, N, bm, cols,
                              split, s);
  if (dtype == 1)
    return launch_cols<__nv_bfloat16>(x, packed, scale, y, M, Kx, K16, N,
                                      bm, cols, split, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
