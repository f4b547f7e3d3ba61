// Packed balanced-ternary matmul for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_ternary_matmul_kernel` (entry
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
// Design.  The weights stay 2-bit in device memory and are decoded in
// registers: no dense weight is ever built.  A CTA of 8 warps owns a
// BM x 128 output tile; lane l of every warp owns the four columns
// n0 + l, n0 + 32 + l, n0 + 64 + l, n0 + 96 + l, so each packed word load
// of a warp is 32 consecutive int32 (one 128-byte line) and each word is
// read once per CTA.  The 8 warps split the K axis (word k16 to warp
// k16 % 8 within each 32-word chunk), and x is staged chunk by chunk in
// shared memory as fp32, where every lane of a warp reads the same address
// (a broadcast).  A warp issues the loads of its 4 words x 4 columns of a
// chunk before it decodes any, to keep loads in flight.  At the end the 8
// partial sums of each output meet in shared memory and are added in warp
// order, so the result does not depend on scheduling.  BM (1, 2, 4, 8, 16)
// is a template parameter, chosen by the wrapper as the smallest that
// covers M up to 16, so a decode step with one token does no work for
// padding rows.
//
// Arithmetic.  fp32 FMAs on the CUDA cores, never the TF32 tensor cores:
// TF32 keeps 10 mantissa bits of x, about 5e-4 relative, outside the
// 1e-4 tolerance.  bf16 x with M >= 16 does not come here: it runs on the
// tensor cores in ternary_matmul_tc.cu (bf16 mma with fp32 accumulation,
// exact for bf16 x {-1, 0, 1} products); the wrapper's `kernel_for` routes
// fp32 x, and bf16 x with M < 16, to this kernel.
//
// Bound.  Bytes: x once, K' * N / 4 bytes of words, y once.  Operations:
// 2 * M * K' * N at the fp32 FMA rate.  A decode step (M <= 16) at serving
// widths moves many bytes per FMA, a prefill (M in the thousands) is bound
// by the FMAs.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPack = 16;                          // trits per int32 word
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 4;                           // columns per lane
constexpr int kBN = 32 * kCols;                    // columns per CTA
constexpr int kWordsPerWarp = 4;                   // per chunk
constexpr int kChunkWords = kWarps * kWordsPerWarp;
constexpr int kChunkK = kChunkWords * kPack;       // 512 k values
constexpr uint32_t kZeroWord = 0x55555555u;        // sixteen ternary zeros

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int BM>
constexpr int smem_bytes() {
  // the x chunk during the K loop, the partial sums after it
  return 4 * BM * (kChunkK > kWarps * kBN ? kChunkK : kWarps * kBN);
}

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads) ternary_matmul_kernel(
    const T* __restrict__ x, const int32_t* __restrict__ packed,
    const float* __restrict__ scale, T* __restrict__ y, long long M, int Kx,
    int K16, int N) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;    // [BM][kChunkK]
  float* red = smem;   // [kWarps][BM][kBN]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kBN;
  const long long m0 = static_cast<long long>(blockIdx.y) * BM;

  float acc[BM][kCols];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = 0.f;

  for (int w0 = 0; w0 < K16; w0 += kChunkWords) {
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
  for (int i = threadIdx.x; i < BM * kBN; i += kThreads) {
    const int m = i / kBN;
    const int col = i % kBN;
    const int n = n0 + col;
    if (m0 + m >= M || n >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[(w * BM + m) * kBN + col];
    store(y + (m0 + m) * N + n, s * scale[n]);
  }
}

template <typename T, int BM>
int launch(const void* x, const void* packed, const void* scale, void* y,
           long long M, int Kx, int K16, int N, cudaStream_t stream) {
  constexpr int smem = smem_bytes<BM>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ternary_matmul_kernel<T, BM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((N + kBN - 1) / kBN),
                  static_cast<unsigned>((M + BM - 1) / BM));
  ternary_matmul_kernel<T, BM><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(packed),
      static_cast<const float*>(scale), static_cast<T*>(y), M, Kx, K16, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bm(const void* x, const void* packed, const void* scale, void* y,
              long long M, int Kx, int K16, int N, int bm,
              cudaStream_t stream) {
  switch (bm) {
    case 1: return launch<T, 1>(x, packed, scale, y, M, Kx, K16, N, stream);
    case 2: return launch<T, 2>(x, packed, scale, y, M, Kx, K16, N, stream);
    case 4: return launch<T, 4>(x, packed, scale, y, M, Kx, K16, N, stream);
    case 8: return launch<T, 8>(x, packed, scale, y, M, Kx, K16, N, stream);
    case 16:
      return launch<T, 16>(x, packed, scale, y, M, Kx, K16, N, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C interface, loaded with ctypes.  `dtype` is 0 for fp32 x and y, 1 for
// bf16; `bm` is the M tile (1, 2, 4, 8 or 16).  All tensors contiguous on
// the current device.  Returns cudaGetLastError() after the launch.
extern "C" int ternary_matmul_launch(const void* x, const void* packed,
                                     const void* scale, void* y,
                                     long long M, int Kx, int K16, int N,
                                     int dtype, int bm, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bm<float>(x, packed, scale, y, M, Kx, K16, N, bm, s);
  if (dtype == 1)
    return launch_bm<__nv_bfloat16>(x, packed, scale, y, M, Kx, K16, N, bm,
                                    s);
  return static_cast<int>(cudaErrorInvalidValue);
}
