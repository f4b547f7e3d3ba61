// Packed balanced-ternary matmul on Hopper's tensor cores (sm_90a), for
// bf16 and fp32 x.
//
// Replaces, for M >= 16 (the wrapper's `TC_MIN_M`), the Pallas kernel
// `_ternary_matmul_kernel` (src/repro/kernels/ternary_matmul/kernel.py:35,
// launched by `ternary_matmul` at :75; wrapper `ops.ternary_matmul_op`):
//
//   y[M, N] = (x[M, K] @ unpack(packed)[K', N]) * scale[N]
//
// x is bf16 or fp32 [M, K] row-major with K <= K' = 16 * K16 (columns K..K'
// read as zero); packed is int32 [K16, N], bits 2i..2i+1 of word [k16, n]
// holding w[16 * k16 + i, n] + 1; scale is fp32 [N]; y has x's type.  Fewer
// rows take the CUDA-core kernel (ternary_matmul.cu); the wrapper
// (kernel.py, `kernel_for`) picks.
//
// Exactness.  bf16 x times a weight in {-1, 0, +1} is exact in bf16, so
// `mma.sync.m16n8k16` bf16 x bf16 -> fp32 forms the products the Pallas
// kernel forms (x cast to fp32, `jnp.dot` with an fp32 accumulator); only
// the order of the fp32 sums differs.  fp32 x is split in registers into
// three bf16 parts, x = hi + mid + lo: hi is x with the low 16 bits of its
// word cleared, mid the same of x - hi, lo = x - hi - mid; each difference
// is exact in fp32 and each part holds at most 8 significant bits, so the
// split is exact for |x| >= 2^-110 (below, bits under 2^-133 are lost), and
// an infinite x keeps mid = lo = 0.  Three `mma` per decoded B fragment add
// the three exact products into one fp32 accumulator: the fp32 product
// without TF32's 10-bit x, within 1e-4, and bit for bit on integers whose
// sums stay below 2^24.  The tensor cores' fp32 sums do not round to
// nearest: each `mma` adds its products into the accumulator with the
// low bits cut off, so the error grows with the accumulator's magnitude
// and the number of adds: summed over all of K in one accumulator, fp32 x
// missed 1e-4 + 1e-4·|want| at K = 8192 on an H100 (qwen2-72b's w1 at
// M = 16: 1.5e-4).  So fp32 x sums each chunk of kPromoteK of K from zero
// on the tensor cores and adds that into a separate fp32 total with
// ordinary, rounded FADDs.  The sum is multiplied by scale[n] in fp32 and
// rounded once, to nearest, to y's type.
//
// Bound.  Operations: 2 * M * K * N at the bf16 tensor-core rate (989
// TFLOP/s dense), three times that for fp32 x (three bf16 passes; the
// fp32-FMA rate, 67 TFLOP/s, is the bound of no kernel here).  Bytes: x
// once, K' * N / 4 bytes of words, y once, at 3.35 TB/s.  A prefill (M in
// the thousands) is bound by the operations; a decode batch (M = 16) at
// serving widths by the bytes of the words.
//
// Design.  A CTA owns a BM x 128 output tile and walks K in steps of BK.
// Each step's BM x BK tile of x and its BK / 16 x 128 words go into shared
// memory with `cp.async`, through a ring of stages, so later steps' loads
// are in flight while the tensor cores work on this one; a tile inside
// every edge is staged by a fixed set of 16-byte copies per thread from
// pointers set up once.  x rows are padded by 8 elements, so the
// `ldmatrix.x4` that loads bf16 A fragments, and the 8-byte loads that read
// fp32 A pairs (row stride = 8 mod 32 words), hit distinct banks.  The
// weights are never dense, in shared memory or anywhere: the m16n8k16 B
// fragment gives lane l the column g = l / 4 and, with t = l % 4, k = 2t,
// 2t+1 in register b0 and k = 2t+8, 2t+9 in b1, which are the nibbles at
// bits 4t..4t+3 and 4t+16..4t+19 of the one word [k16, n0 + g].  Each B
// register is decoded from its nibble by three instructions (PRMT, a mask,
// one bf16x2 fma; code c gives c - 1, so 3 gives +2.0 as in the reference),
// with no table in shared memory, and one decoded fragment feeds the warp's
// MI m16 fragments (three passes each for fp32).  The fragments of the next
// k16 slice are loaded before the products of this one are issued.  Tiles
// (the wrapper's `tc_m_tile` picks): 16 rows, 4 warps of 16 x 32, 128-deep
// steps, for decode batches, which wait on the bytes of the words; 64 rows,
// 4 warps of 64 x 32, 64-deep steps, for prefill; 128 rows, 2 x 4 warps of
// 64 x 32, kept for comparison.  fp32 x takes the same tiles with fewer
// ring slots (its staged x is twice the bytes) and fewer CTAs per SM (the
// raw fp32 fragments and the split need registers); its 64-row tile has
// 2 x 2 warps of 32 x 64, so each warp splits half the rows and each split
// fragment feeds eight products per pass.  Ragged edges: rows
// past M, x columns past K and words past K16 or N are zero (zero trits for
// the words), staged element by element where a 16-byte copy would cross
// the edge or the rows are not 16-byte aligned.
//
// Why `mma.sync` and not `wgmma`, for now.  `wgmma` reads B from shared
// memory, in a swizzled layout behind matrix descriptors: the words would
// have to be decoded into a dense bf16 tile in shared memory first (eight
// times their bytes, and a barrier between decode and product).  `mma.sync`
// takes B from registers, where a word decodes straight into fragments.
// It reaches only a part of the card's bf16 rate; a `wgmma`/TMA version is
// the next step while this one trails the library product.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int kPack = 16;                      // trits per int32 word
constexpr int kPromoteK = 512;                 // fp32: K per fresh sum
constexpr int kBN = 128;                       // columns per CTA
constexpr uint32_t kZeroWord = 0x55555555u;    // sixteen ternary zeros

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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One bf16x2 fma: d = a * b + c in each half, rounded to nearest.
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// A B register from one word: the two trits of the nibble at the low half
// of byte `sel & 3` of v (v = w >> 4 (t % 2)) as a bf16 pair c - 1.
// PRMT gives [byte, 0x43, byte, 0x43], the mask keeps 0x4300 | c0 and
// 0x4300 | 4 c1 (128 + c0 and 128 + 4 c1 in bf16), and one fma gives
// (128 + c0) * 1 - 129 and (128 + 4 c1) / 4 - 33: exact, code 3 -> +2.
__device__ __forceinline__ uint32_t decode_pair(uint32_t v, uint32_t sel) {
  return fma_bf16x2(__byte_perm(v, 0x43u, sel) & 0x430C4303u, 0x3E803F80u,
                    0xC204C301u);
}

// x = hi + mid + lo for a pair of fp32 values, each part a bf16 pair in
// the A register layout (low half the first value).  hi and mid are the top
// halves of x and of x - hi; every difference is exact, and lo's low half
// is zero, so PRMT takes all three.  x - hi is NaN only for an infinite or
// NaN x: an infinite x keeps mid = lo = 0, a NaN x stays NaN in hi.
__device__ __forceinline__ void split3(float2 x, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const uint32_t x0 = __float_as_uint(x.x), x1 = __float_as_uint(x.y);
  hi = __byte_perm(x0, x1, 0x7632u);
  const float h0 = __uint_as_float(x0 & 0xffff0000u);
  const float h1 = __uint_as_float(x1 & 0xffff0000u);
  const float r0 = x.x == h0 ? 0.f : x.x - h0;
  const float r1 = x.y == h1 ? 0.f : x.y - h1;
  const uint32_t b0 = __float_as_uint(r0), b1 = __float_as_uint(r1);
  mid = __byte_perm(b0, b1, 0x7632u);
  const float s0 = r0 - __uint_as_float(b0 & 0xffff0000u);
  const float s1 = r1 - __uint_as_float(b1 & 0xffff0000u);
  lo = __byte_perm(__float_as_uint(s0), __float_as_uint(s1), 0x7632u);
}

// The types of x: bf16 (as uint16_t bits) or fp32; y has x's type.
template <class XT>
struct XType {
  static constexpr bool kFp32 = std::is_same<XT, float>::value;
  using Out = typename std::conditional<kFp32, float, __nv_bfloat16>::type;
  // an A fragment of one m16: four bf16 pairs, or four fp32 pairs to split
  using Frag = typename std::conditional<kFp32, float2, uint32_t>::type;
};

// The tile of a CTA: BM x 128 outputs, K walked in steps of BK through a
// ring of kStages slots.  Its warps form a (BM / WM) x (128 / WN) grid,
// each warp owning WM x WN outputs: MI = WM / 16 m16 fragments by
// NI = WN / 8 n8 fragments, 4 fp32 accumulators each.
template <class XT, int BM, int WM, int WN, int BK, int kStages>
struct Tile {
  static constexpr int kElems = 16 / sizeof(XT);    // x per 16-byte chunk
  static constexpr int kKWords = BK / kPack;        // word rows per step
  static constexpr int kXStride = BK + 8;           // x per staged row
  static constexpr int kMI = WM / 16;
  static constexpr int kNI = WN / 8;
  static constexpr int kThreads = 32 * (BM / WM) * (kBN / WN);
  static constexpr int kXBytes = BM * kXStride * sizeof(XT);  // per stage
  static constexpr int kWBytes = kKWords * kBN * 4;           // per stage
  static constexpr int kSmem = kStages * (kXBytes + kWBytes);
  static constexpr int kRowChunks = BK / kElems;  // 16-byte x chunks per row
  static constexpr int kXAll = BM * kRowChunks;   // x chunks per step
  static constexpr int kWAll = kKWords * kBN / 4;  // word chunks per step
  static_assert(kKWords % 2 == 0, "an even number of k16 slices per step");
  static_assert(
      (kXAll % kThreads == 0 || kThreads % kXAll == 0) &&
          (kWAll % kThreads == 0 || kThreads % kWAll == 0),
      "the chunks of a step split evenly over the threads");
};

// Stage step `kt` of x and of the words into the ring slot at xs, ws, for
// a tile that crosses an edge of x or of the words, or whose rows are not
// 16-byte aligned: element by element where a 16-byte copy would cross
// the edge, zero (zero trits for the words) past it.
template <class T, class XT>
__device__ __noinline__ void load_step_edges(
    XT* xs, uint32_t* ws, const XT* __restrict__ x,
    const int32_t* __restrict__ packed, long long M, int Kx, int K16, int N,
    long long m0, int n0, int kt, bool x_vec, bool w_vec) {
  constexpr int kE = T::kElems;
  const int k0 = kt * T::kKWords * kPack;
  for (int c = threadIdx.x; c < T::kXAll; c += T::kThreads) {
    const int r = c / T::kRowChunks;
    const int kc = (c % T::kRowChunks) * kE;
    XT* dst = xs + r * T::kXStride + kc;
    const long long m = m0 + r;
    const int k = k0 + kc;
    if (x_vec && m < M && k + kE <= Kx) {
      cp_async16(dst, x + m * Kx + k);
    } else {
      alignas(16) XT v[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e)
        v[e] = (m < M && k + e < Kx) ? x[m * Kx + k + e] : XT(0);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    }
  }
  const int w0 = kt * T::kKWords;
  for (int c = threadIdx.x; c < T::kWAll; c += T::kThreads) {
    const int r = c / (kBN / 4);
    const int nc = (c % (kBN / 4)) * 4;
    uint32_t* dst = ws + r * kBN + nc;
    const int kw = w0 + r;
    const int n = n0 + nc;
    if (w_vec && kw < K16 && n + 4 <= N) {
      cp_async16(dst, packed + static_cast<long long>(kw) * N + n);
    } else {
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = (kw < K16 && n + e < N)
                   ? static_cast<uint32_t>(
                         packed[static_cast<long long>(kw) * N + n + e])
                   : kZeroWord;
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <class XT, int BM, int WM, int WN, int BK, int kStages,
          int kMinBlocks>
__global__ void __launch_bounds__(
    (Tile<XT, BM, WM, WN, BK, kStages>::kThreads), kMinBlocks)
    ternary_matmul_tc_kernel(const XT* __restrict__ x,
                             const int32_t* __restrict__ packed,
                             const float* __restrict__ scale,
                             typename XType<XT>::Out* __restrict__ y,
                             long long M, int Kx, int K16, int N, bool x_vec,
                             bool w_vec) {
  using T = Tile<XT, BM, WM, WN, BK, kStages>;
  using Frag = typename XType<XT>::Frag;
  constexpr bool kFp32 = XType<XT>::kFp32;
  constexpr int kMI = T::kMI;
  constexpr int kNI = T::kNI;
  constexpr int kKWords = T::kKWords;
  constexpr int kXStride = T::kXStride;
  extern __shared__ __align__(16) unsigned char smem[];
  XT* xs = reinterpret_cast<XT*>(smem);               // [S][BM][BK + 8]
  uint32_t* ws = reinterpret_cast<uint32_t*>(smem + kStages * T::kXBytes);
                                                      // [S][BK / 16][128]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / (kBN / WN);
  const int wn = warp % (kBN / WN);
  const int g = lane / 4;
  const int t = lane % 4;
  const int n0 = blockIdx.x * kBN;
  const long long m0 = static_cast<long long>(blockIdx.y) * BM;
  // lane t's B nibbles are the low halves of bytes t / 2 (b0) and
  // 2 + t / 2 (b1) of w >> 4 (t % 2)
  const int shift = 4 * (t & 1);
  const uint32_t sel0 = (t >> 1) | (4u << 4) | ((t >> 1) << 8) | (4u << 12);
  const uint32_t sel1 = sel0 + 0x202u;

  const auto x_slot = [&](int s) {
    return xs + s * (T::kXBytes / static_cast<int>(sizeof(XT)));
  };
  const auto w_slot = [&](int s) { return ws + s * (T::kWBytes / 4); };
  // Staging a step of a tile inside every edge, with aligned rows: a fixed
  // set of 16-byte copies per thread from pointers set up once here, x
  // chunks kXRows rows apart and word chunks kWRows word rows apart.
  constexpr int kXRows = T::kThreads / T::kRowChunks;
  constexpr int kXChunks = (T::kXAll + T::kThreads - 1) / T::kThreads;
  constexpr int kWRows = T::kThreads / (kBN / 4);
  constexpr int kWChunks = (T::kWAll + T::kThreads - 1) / T::kThreads;
  const int xr = threadIdx.x / T::kRowChunks;
  const int xc = (threadIdx.x % T::kRowChunks) * T::kElems;
  const XT* x_src = x + (m0 + xr) * Kx + xc;
  const long long x_src_rows = static_cast<long long>(kXRows) * Kx;
  const int x_dst = xr * kXStride + xc;
  const int wr = threadIdx.x / (kBN / 4);
  const int wc = (threadIdx.x % (kBN / 4)) * 4;
  const int32_t* w_src = packed + static_cast<long long>(wr) * N + n0 + wc;
  const int w_dst = wr * kBN + wc;
  const bool tile_inside = x_vec && w_vec && m0 + BM <= M && n0 + kBN <= N;
  const auto load = [&](int s, int kt) {
    if (tile_inside && (kt + 1) * BK <= Kx && (kt + 1) * kKWords <= K16) {
#pragma unroll
      for (int i = 0; i < kXChunks; ++i)
        if (T::kXAll >= T::kThreads || threadIdx.x < T::kXAll)
          cp_async16(x_slot(s) + x_dst + i * kXRows * kXStride,
                     x_src + kt * BK + i * x_src_rows);
#pragma unroll
      for (int i = 0; i < kWChunks; ++i)
        if (T::kWAll >= T::kThreads || threadIdx.x < T::kWAll)
          cp_async16(w_slot(s) + w_dst + i * kWRows * kBN,
                     w_src + (static_cast<long long>(kt) * kKWords +
                              i * kWRows) * N);
    } else {
      load_step_edges<T>(x_slot(s), w_slot(s), x, packed, M, Kx, K16, N, m0,
                         n0, kt, x_vec, w_vec);
    }
  };
  // the fragments of k16 slice kk of a staged step: A by ldmatrix (bf16)
  // or as fp32 pairs (a0 (g, 2t), a1 (g + 8, 2t), a2 (g, 2t + 8), a3
  // (g + 8, 2t + 8)), B decoded from the words
  const auto load_frags = [&](Frag (&a)[kMI][4], uint32_t (&b)[kNI][2],
                              int s, int kk) {
#pragma unroll
    for (int i = 0; i < kMI; ++i) {
      if constexpr (kFp32) {
        const float* p = x_slot(s) + (wm * WM + i * 16 + g) * kXStride +
                         kk * 16 + 2 * t;
        a[i][0] = *reinterpret_cast<const float2*>(p);
        a[i][1] = *reinterpret_cast<const float2*>(p + 8 * kXStride);
        a[i][2] = *reinterpret_cast<const float2*>(p + 8);
        a[i][3] = *reinterpret_cast<const float2*>(p + 8 * kXStride + 8);
      } else {
        ldmatrix_x4(a[i], x_slot(s) +
                              (wm * WM + i * 16 + (lane & 15)) * kXStride +
                              kk * 16 + (lane >> 4) * 8);
      }
    }
#pragma unroll
    for (int j = 0; j < kNI; ++j) {
      const uint32_t v = w_slot(s)[kk * kBN + wn * WN + j * 8 + g] >> shift;
      b[j][0] = decode_pair(v, sel0);
      b[j][1] = decode_pair(v, sel1);
    }
  };

  // fp32 x: `acc` holds one chunk of kPromoteK of K, then is added into
  // `total` by ordinary FADDs and starts again from zero (see Exactness)
  float acc[kMI][kNI][4], total[kMI][kNI][4];
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kNI; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = total[i][j][q] = 0.f;
  const auto promote = [&]() {
#pragma unroll
    for (int i = 0; i < kMI; ++i)
#pragma unroll
      for (int j = 0; j < kNI; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          total[i][j][q] += acc[i][j][q];
          acc[i][j][q] = 0.f;
        }
  };
  constexpr int kPromoteSteps = kPromoteK > BK ? kPromoteK / BK : 1;

  const int n_steps = (K16 + kKWords - 1) / kKWords;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) load(s, s);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();      // step 0 has landed
  __syncthreads();

  // Fragments are double-buffered: those of k16 slice kk + 1 are loaded
  // before the products of slice kk are issued.  The last slice of a step
  // loads the first of the next step, after the barrier that makes that
  // step visible.
  Frag a[2][kMI][4];
  uint32_t b[2][kNI][2];
  int rs = 0;                        // ring slot of the step being read
  load_frags(a[0], b[0], 0, 0);
  for (int kt = 0; kt < n_steps; ++kt) {
#pragma unroll
    for (int kk = 0; kk < kKWords; ++kk) {
      if (kk == 0) {
        // refill the slot that step kt - 1 was read from
        const int next = kt + kStages - 1;
        if (next < n_steps) load(rs == 0 ? kStages - 1 : rs - 1, next);
        cp_async_commit();
      }
      if (kk == kKWords - 1) {
        cp_async_wait<kStages - 2>();  // step kt + 1 has landed
        __syncthreads();               // ... for every thread
        rs = rs == kStages - 1 ? 0 : rs + 1;
      }
      load_frags(a[(kk + 1) % 2], b[(kk + 1) % 2], rs, (kk + 1) % kKWords);
#pragma unroll
      for (int i = 0; i < kMI; ++i) {
        if constexpr (kFp32) {
          uint32_t part[3][4];           // hi, mid, lo
#pragma unroll
          for (int q = 0; q < 4; ++q)
            split3(a[kk % 2][i][q], part[0][q], part[1][q], part[2][q]);
#pragma unroll
          for (int p = 0; p < 3; ++p)
#pragma unroll
            for (int j = 0; j < kNI; ++j)
              mma_bf16(acc[i][j], part[p], b[kk % 2][j]);
        } else {
#pragma unroll
          for (int j = 0; j < kNI; ++j)
            mma_bf16(acc[i][j], a[kk % 2][i], b[kk % 2][j]);
        }
      }
    }
    if constexpr (kFp32) {
      if ((kt + 1) % kPromoteSteps == 0 || kt + 1 == n_steps) promote();
    }
  }
  cp_async_wait<0>();

  // c0, c1 at (row g, columns 2t, 2t+1), c2, c3 at (row g + 8, the same)
  const bool n_even = (N % 2) == 0;
#pragma unroll
  for (int j = 0; j < kNI; ++j) {
    const int n = n0 + wn * WN + j * 8 + 2 * t;
    const float s0 = n < N ? scale[n] : 0.f;
    const float s1 = n + 1 < N ? scale[n + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < kMI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long m = m0 + wm * WM + i * 16 + g + 8 * h;
        if (m >= M || n >= N) continue;
        auto* out = y + m * N + n;
        const float v0 = (kFp32 ? total : acc)[i][j][2 * h] * s0;
        const float v1 = (kFp32 ? total : acc)[i][j][2 * h + 1] * s1;
        if constexpr (kFp32) {
          if (n_even) {
            *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
          } else {
            out[0] = v0;
            if (n + 1 < N) out[1] = v1;
          }
        } else if (n_even) {
          *reinterpret_cast<__nv_bfloat162*>(out) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          out[0] = __float2bfloat16_rn(v0);
          if (n + 1 < N) out[1] = __float2bfloat16_rn(v1);
        }
      }
  }
}

template <class XT, int BM, int WM, int WN, int BK, int kStages,
          int kMinBlocks>
int launch(const void* x, const void* packed, const void* scale, void* y,
           long long M, int Kx, int K16, int N, bool x_vec, bool w_vec,
           cudaStream_t stream) {
  using T = Tile<XT, BM, WM, WN, BK, kStages>;
  auto* kernel =
      ternary_matmul_tc_kernel<XT, BM, WM, WN, BK, kStages, kMinBlocks>;
  if (T::kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((N + kBN - 1) / kBN),
                  static_cast<unsigned>((M + BM - 1) / BM));
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(
      static_cast<const XT*>(x), static_cast<const int32_t*>(packed),
      static_cast<const float*>(scale),
      static_cast<typename XType<XT>::Out*>(y), M, Kx, K16, N, x_vec, w_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes.  `dtype` is 0 for fp32 x and y, 1 for
// bf16; packed int32, scale fp32, all contiguous on the current device.
// `bm` is the M tile (16, 64 or 128).  `x_vec` says that every row of x
// starts 16-byte aligned (K a multiple of 16 bytes and an aligned pointer),
// `w_vec` the same of the rows of packed (N % 4 == 0); where not, those
// tiles are staged element by element.  Returns cudaGetLastError() after
// the launch.
extern "C" int ternary_matmul_tc_launch(const void* x, const void* packed,
                                        const void* scale, void* y,
                                        long long M, int Kx, int K16, int N,
                                        int dtype, int bm, int x_vec,
                                        int w_vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool xv = x_vec != 0, wv = w_vec != 0;
  if (dtype == 1) {
    switch (bm) {
      case 16:    // 4 warps of 16 x 32; 128-deep steps, 6 slots
        return launch<uint16_t, 16, 16, 32, 128, 6, 4>(
            x, packed, scale, y, M, Kx, K16, N, xv, wv, s);
      case 64:    // 4 warps of 64 x 32
        return launch<uint16_t, 64, 64, 32, 64, 4, 3>(
            x, packed, scale, y, M, Kx, K16, N, xv, wv, s);
      case 128:   // 2 x 4 warps of 64 x 32
        return launch<uint16_t, 128, 64, 32, 64, 3, 1>(
            x, packed, scale, y, M, Kx, K16, N, xv, wv, s);
    }
  } else if (dtype == 0) {
    switch (bm) {      // fp32: the same tiles, fewer slots and CTAs per SM
      case 16:
        return launch<float, 16, 16, 32, 128, 4, 4>(
            x, packed, scale, y, M, Kx, K16, N, xv, wv, s);
      case 64:    // 2 x 2 warps of 32 x 64: a split A fragment feeds 8
                  // n8 fragments, half as many splits as 64 x 32 warps
        return launch<float, 64, 32, 64, 64, 4, 2>(
            x, packed, scale, y, M, Kx, K16, N, xv, wv, s);
      case 128:
        return launch<float, 128, 64, 32, 64, 3, 1>(
            x, packed, scale, y, M, Kx, K16, N, xv, wv, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
