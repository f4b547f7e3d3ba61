// Packed balanced-ternary matmul on Hopper's tensor cores (sm_90a), with
// warpgroup `wgmma`, for bf16 and fp32 x.
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
// Exactness.  bf16 x times a weight in {-1, 0, +1} is exact in bf16, so a
// bf16 x bf16 -> fp32 `wgmma` forms the products the Pallas kernel forms
// (x cast to fp32, `jnp.dot` with an fp32 accumulator); only the order of
// the fp32 sums differs.  fp32 x is split into three bf16 parts, x = hi +
// mid + lo (`split3`): hi is x with the low 16 bits of its word cleared,
// mid the same of x - hi, lo = x - hi - mid; each difference is exact in
// fp32 and each part holds at most 8 significant bits, so the split is
// exact for |x| >= 2^-110 (below, bits under 2^-133 are lost), and an
// infinite x keeps mid = lo = 0.  Three `wgmma`s per decoded A fragment add
// the three exact products into one fp32 accumulator: the fp32 product
// without TF32's 10-bit x, within 1e-4, and bit for bit on integers whose
// sums stay below 2^24.  The tensor cores' fp32 sums do not round to
// nearest: each product is added into the accumulator with the low bits
// cut off, so the error grows with the accumulator's magnitude and the
// number of adds: summed over all of K in one accumulator, fp32 x missed
// 1e-4 + 1e-4·|want| at K = 8192 on an H100 (qwen2-72b's w1 at M = 16:
// 1.5e-4).  So fp32 x sums each chunk of kPromoteK of K from zero on the
// tensor cores and adds that into a separate fp32 total with ordinary,
// rounded FADDs.  A K split (below) sums each CTA's share of K so, and adds
// the CTAs' partial sums in the order of their ranks.  The sum is
// multiplied by scale[n] in fp32 and rounded once, to nearest, to y's type.
//
// Bound.  Operations: 2 * M * K * N at the bf16 tensor-core rate (989
// TFLOP/s dense), three times that for fp32 x (three bf16 passes).  Bytes:
// x once, K' * N / 4 bytes of words, y once, at 3.35 TB/s.  A prefill (M in
// the thousands) is bound by the operations; a decode batch (M = 16) at
// serving widths by the bytes of the words.
//
// Design: the operands swapped, the weights as A in registers.  A CTA
// computes the transposed tile y^T[n0 .. n0 + BW, m0 .. m0 + BT] =
// unpack(packed)^T x^T with `wgmma.mma_async.m64nBTk16` (A from registers,
// B from shared memory): each of its WG = BW / 64 warpgroups owns 64 weight
// rows (outputs n), and the BT tokens are wgmma's N (16 to 256), so a decode
// batch of 16 runs as n16 with no padding rows.  The weights are never
// dense, in shared memory or anywhere: wgmma's A fragment of a 64 x 16
// slice gives each warp 16 rows and lane l the rows g = l / 4 and g + 8 and,
// with t = l % 4, k = 2t, 2t+1 (registers a0, a1) and 2t+8, 2t+9 (a2, a3),
// which are the nibbles at bits 4t..4t+3 and 4t+16..4t+19 of the one word
// [k16, n0 + row].  Each register is decoded from its nibble by three
// instructions (PRMT, a mask, one bf16x2 fma; code c gives c - 1, so 3
// gives +2.0 as in the reference), with no table.  x is K-major, as wgmma's
// B wants it: each 64 columns of a step's BT rows are a sub-tile of one
// 128-byte row per token in the 128-byte swizzle, read through a matrix
// descriptor advanced 32 bytes per k16 slice.  fp32 x is staged as fp32 and
// split by the consumer threads into three such bf16 tiles (hi, mid, lo);
// one decoded A fragment then feeds three `wgmma`s.
//
// Tiles (the C entry's instances; the wrapper's `tc_shape` picks): a decode
// batch takes 16 tokens by 64 outputs (one warpgroup; K split over a
// cluster); 17-63 rows take 64 by 64; a prefill takes 128 by 128 in bf16
// (two warpgroups) and 64 by 256 in fp32 (four: each step is three passes,
// so its split and its barriers serve more products), or 64 by 128 where
// those grids are small.  256 by 128 and 128 by 256 are built for
// chip_smoke.py's sweep of the tiles.  A step is KW words of K: 16 (256
// deep) for the bf16 16-token tile, 8 (128 deep) for bf16's 128-token
// tiles and fp32's 16-token tile, whose steps are short enough that a
// step's handshakes and decode (below) held them back, else 4 (64 deep).
//
// Pipeline.  A CTA is WG consumer warpgroups and one producer warp.  The
// producer brings each step of x (BT x 64 boxes) and its KW x BW words
// into a ring of S shared-memory stages by TMA (`cp.async.bulk.tensor`,
// tensor maps encoded per call in the C entry), and a stage's `mbarrier`
// counts the bytes in; it refills a stage once every consumer warp has
// released it on a second `mbarrier`.  The consumers wait for a stage,
// decode the A fragments of its KW k16 slices (double-buffered
// registers), issue its `wgmma`s as one group and wait until only that
// group is in flight (none, for the bf16 decode tile: see kDepth); then
// the stage whose products are done is released.  So the decode and the
// issue of one step run under the products of the step before, and no
// barrier spans the CTA.  fp32 x:
// after that wait the consumers split the next step, already landed, into
// the other of two bf16 buffers (a barrier of the consumers' own before the
// split, one after).  This replaces a kernel on the warp-level m16n8k16
// product with B fragments decoded in registers and `cp.async` staging by
// every thread: warp-level products issue too slowly for the card's bf16
// rate, and the threads' own copies and CTA-wide barriers held the
// products back.
//
// K split.  Where the output tiles alone give a small grid (a decode batch),
// the wrapper (`tc_shape`) splits K over a thread block cluster of 2, 4 or
// 8 CTAs, each keeping at least one step.  Each CTA writes its partial tile
// to its shared memory; after a cluster barrier the CTA of rank r reduces
// the rows m = r mod split of the tile from every CTA's shared memory
// (distributed shared memory), in rank order, so the result does not depend
// on timing.
//
// Epilogue.  The accumulators (rows n, columns m) go through shared memory,
// transposed, so that y's rows are stored 4 outputs a thread, coalesced;
// the same buffer carries the K split's partials.
//
// Edges and unaligned operands.  TMA fills what lies past an edge with
// zeros: rows past M and x columns past K are zero, so words past K16 (zero
// words decode to -1) meet only zero x, and words past N give outputs that
// are not stored.  TMA needs 16-byte aligned rows: an operand whose rows are
// not (x: K * size not a multiple of 16 or an offset pointer; the words: N %
// 4 != 0) is staged by the producer warp element by element into the layout
// TMA would give, with zeros past the edges (zero trits for the words).
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kPack = 16;                      // trits per int32 word
constexpr int kPromoteK = 1024;                // fp32: K per fresh sum
constexpr int kSubK = 64;                      // K of a sub-tile (128 bf16 B)
constexpr int kEpPad = 4;                      // floats after an epilogue row
constexpr uint32_t kZeroWord = 0x55555555u;    // sixteen ternary zeros

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// generic-proxy writes to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads of the accumulators above a wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The descriptor of a K-major bf16 tile in the 128-byte swizzle: rows of
// 128 bytes, 8-row groups 1024 bytes apart (SBO), tile at a 1024-byte
// boundary; +2 per k16 slice advances the start by 32 bytes.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4) |
         (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// byte offset of 16-byte chunk `ch` of row r in a 128-byte-swizzled tile
__device__ __forceinline__ int sw128(int r, int ch) {
  return r * 128 + ((ch ^ (r & 7)) << 4);
}

#define F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F8(d, i) F4(d, i), F4(d, i + 4)
#define F32(d, i) F8(d, i), F8(d, i + 8), F8(d, i + 16), F8(d, i + 24)
#define WGMMA_D8(d) F8(d, 0)
#define WGMMA_D32(d) F32(d, 0)
#define WGMMA_D64(d) F32(d, 0), F32(d, 32)
#define WGMMA_D128(d) F32(d, 0), F32(d, 32), F32(d, 64), F32(d, 96)

// d[64 x N] += a[64 x 16] (bf16 registers) * b[16 x N] (bf16, shared
// memory, K-major, descriptor b); N / 2 fp32 accumulators a thread.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<16>(
    float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : WGMMA_D8(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(
    float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : WGMMA_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(
    float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : WGMMA_D64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(
    float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : WGMMA_D128(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef F4
#undef F8
#undef F32
#undef WGMMA_D8
#undef WGMMA_D32
#undef WGMMA_D64
#undef WGMMA_D128

// One bf16x2 fma: d = a * b + c in each half, rounded to nearest.
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// An A register from one word: the two trits of the nibble at the low half
// of byte `sel & 3` of v (v = w >> 4 (t % 2)) as a bf16 pair c - 1.
// PRMT gives [byte, 0x43, byte, 0x43], the mask keeps 0x4300 | c0 and
// 0x4300 | 4 c1 (128 + c0 and 128 + 4 c1 in bf16), and one fma gives
// (128 + c0) * 1 - 129 and (128 + 4 c1) / 4 - 33: exact, code 3 -> +2.
__device__ __forceinline__ uint32_t decode_pair(uint32_t v, uint32_t sel) {
  return fma_bf16x2(__byte_perm(v, 0x43u, sel) & 0x430C4303u, 0x3E803F80u,
                    0xC204C301u);
}

// x = hi + mid + lo for a pair of fp32 values, each part a bf16 pair (low
// half the first value).  hi and mid are the top halves of x and of x - hi;
// every difference is exact, and lo's low half is zero, so PRMT takes all
// three.  x - hi is NaN only for an infinite or NaN x: an infinite x keeps
// mid = lo = 0, a NaN x stays NaN in hi.
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

// mbarriers in shared memory (one thread arrives, or several)
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t tx) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(tx)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// TMA: the box at (c0, c1) (innermost first) of a 2-D tensor map into
// shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// the consumer warpgroups' own barrier (the producer warp does not wait)
template <int kThreads>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// The tile of a CTA: BT tokens by BW = 64 * WG weight rows (outputs), K
// walked in steps of KW words (16 KW deep) through a ring of S stages; WG
// consumer warpgroups and one producer warp.  Shared memory, from a
// 1024-byte boundary: S x-slots (bf16: the swizzled B sub-tiles
// themselves; fp32: fp32 rows of 256 bytes), fp32 only two buffers of
// three swizzled bf16 parts (hi, mid, lo), then S word slots [KW][BW]; the
// epilogue reuses it from the start, BT rows of BW + kEpPad floats; then
// the stages' full and empty barriers.
template <class XT, int BT, int WG, int KW, int S>
struct Tile {
  static constexpr bool kFp32 = std::is_same<XT, float>::value;
  using Out = typename std::conditional<kFp32, float, __nv_bfloat16>::type;
  static constexpr int kBW = 64 * WG;
  static constexpr int kConsumers = 128 * WG;
  static constexpr int kThreads = kConsumers + 32;
  static constexpr int kKW = KW;                      // word rows per step
  static constexpr int kBK = KW * kPack;              // K per step
  static constexpr int kSubs = kBK / kSubK;           // sub-tiles per step
  static constexpr int kPromoteSteps = kPromoteK / kBK;
  static constexpr int kElems = 16 / sizeof(XT);      // x per 16-byte chunk
  static constexpr int kSubChunks = kSubK / kElems;   // chunks per sub row
  static constexpr int kRowChunks = kBK / kElems;     // chunks per x row
  static constexpr int kXSub = BT * kSubK * sizeof(XT);  // one x sub-tile
  static constexpr int kXBytes = kSubs * kXSub;
  static constexpr int kBTile = BT * 128;             // one bf16 B tile
  static constexpr int kSplitBytes = kFp32 ? 2 * 3 * kSubs * kBTile : 0;
  static constexpr int kWBytes = kKW * kBW * 4;
  static constexpr int kPipe = S * (kXBytes + kWBytes) + kSplitBytes;
  static constexpr int kEpStride = kBW + kEpPad;
  static constexpr int kEpBytes = BT * kEpStride * 4;
  static constexpr int kBars = kPipe > kEpBytes ? kPipe : kEpBytes;
  static constexpr int kSmem = kBars + 2 * S * 8 + 1024;
  static constexpr int kXAll = BT * kRowChunks;       // x chunks per step
  static constexpr int kWAll = kKW * kBW / 4;         // word chunks per step
  static_assert(S >= 2, "a stage being read, one loading");
  static_assert(kBK % kSubK == 0 && kPromoteK % kBK == 0, "step sizes");
  static_assert(BT % 16 == 0 && BT <= 256, "wgmma's N, TMA's box");
  static_assert(kSmem <= 227 * 1024, "shared memory");
};

// byte offset of 16-byte chunk ch of x row r in an x slot: a step is
// kSubs sub-tiles of 64 columns, each BT rows of 128 (bf16, swizzled) or
// 256 (fp32) bytes
template <class T>
__device__ __forceinline__ int x_off(int r, int ch) {
  const int sub = ch / T::kSubChunks;
  const int c = ch % T::kSubChunks;
  if constexpr (T::kFp32)
    return sub * T::kXSub + r * (kSubK * 4) + c * 16;
  else
    return sub * T::kXSub + sw128(r, c);
}

// The producer warp's staging of step `step` without TMA, for an operand
// whose rows are not 16-byte aligned (x: K * size not a multiple of 16 or
// an offset pointer; the words: N % 4 != 0): element by element into the
// layout TMA would give, zero past the edges (zero trits for the words: a
// zero word decodes to -1).
template <class T, class XT>
__device__ __noinline__ void stage_by_hand(
    unsigned char* xs, uint32_t* ws, const XT* __restrict__ x,
    const int32_t* __restrict__ packed, long long M, int Kx, int K16, int N,
    long long m0, int n0, int step, bool do_x, bool do_w, int lane) {
  constexpr int kE = T::kElems;
  const int k0 = step * T::kBK;
  for (int c = lane; do_x && c < T::kXAll; c += 32) {
    const int r = c / T::kRowChunks;
    const int ch = c % T::kRowChunks;
    const long long m = m0 + r;
    const int k = k0 + ch * kE;
    alignas(16) XT v[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e)
      v[e] = (m < M && k + e < Kx) ? x[m * Kx + k + e] : XT(0);
    *reinterpret_cast<uint4*>(xs + x_off<T>(r, ch)) =
        *reinterpret_cast<const uint4*>(v);
  }
  const int w0 = step * T::kKW;
  for (int c = lane; do_w && c < T::kWAll; c += 32) {
    const int r = c / (T::kBW / 4);
    const int nc = (c % (T::kBW / 4)) * 4;
    const int kw = w0 + r;
    const int n = n0 + nc;
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = (kw < K16 && n + e < N)
                 ? static_cast<uint32_t>(
                       packed[static_cast<long long>(kw) * N + n + e])
                 : kZeroWord;
    *reinterpret_cast<uint4*>(ws + r * T::kBW + nc) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

template <class XT, int BT, int WG, int KW, int S>
__global__ void __launch_bounds__(128 * WG + 32, 1)
    ternary_matmul_tc_kernel(const __grid_constant__ CUtensorMap x_map,
                             const __grid_constant__ CUtensorMap w_map,
                             const XT* __restrict__ x,
                             const int32_t* __restrict__ packed,
                             const float* __restrict__ scale,
                             typename Tile<XT, BT, WG, KW, S>::Out* y,
                             long long M, int Kx, int K16, int N, bool x_tma,
                             bool w_tma) {
  using T = Tile<XT, BT, WG, KW, S>;
  constexpr bool kFp32 = T::kFp32;
  constexpr int kBW = T::kBW;
  constexpr int kKW = T::kKW;
  constexpr int kND = BT / 2;                 // accumulators per thread
  // wgmma groups left in flight after a step's issue: one, so that the
  // decode of the next step runs under it (double-buffered A registers);
  // none for the bf16 decode tile, whose single set of A registers leaves
  // room for more CTAs an SM, which hides its steps' latency better
  constexpr int kDepth = BT <= 16 && !kFp32 ? 0 : 1;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* const smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* const wbase = smem + S * T::kXBytes + T::kSplitBytes;
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + T::kBars);
  uint64_t* const empty = full + S;
  const auto x_slot = [&](int s) { return smem + s * T::kXBytes; };
  const auto w_slot = [&](int s) {
    return reinterpret_cast<uint32_t*>(wbase + s * T::kWBytes);
  };
  const auto split_tile = [&](int b, int p, int sub) {
    return smem + S * T::kXBytes + ((b * 3 + p) * T::kSubs + sub) * T::kBTile;
  };

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int n0 = blockIdx.x * kBW;
  const long long m0 = static_cast<long long>(blockIdx.y) * BT;
  // the cluster is (1, 1, split): rank = blockIdx.z
  const int split = static_cast<int>(gridDim.z);
  const int rank = static_cast<int>(blockIdx.z);
  const int n_steps = (K16 + kKW - 1) / kKW;
  const int s_beg = static_cast<int>(static_cast<long long>(rank) * n_steps /
                                     split);
  const int n_local = static_cast<int>(
                          static_cast<long long>(rank + 1) * n_steps /
                          split) - s_beg;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);                 // the producer's arrival
      mbar_init(empty + s, 4 * WG);           // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[kND];
  float total[kFp32 ? kND : 1];
  if (tid >= T::kConsumers) {
    // the producer warp: stage j into slot j % S once its last reader is
    // done; TMA for aligned operands (zeros past the edges: x is zero
    // there, so the words' zero fill meets only zeros or outputs past N),
    // by hand for the others
    const uint32_t tx =
        (x_tma ? T::kXBytes : 0) + (w_tma ? T::kWBytes : 0);
    for (int j = 0; j < n_local; ++j) {
      const int s = j % S;
      const int step = s_beg + j;
      if (j >= S) mbar_wait(empty + s, ((j / S) - 1) & 1);
      if (!x_tma || !w_tma) {
        stage_by_hand<T>(x_slot(s), w_slot(s), x, packed, M, Kx, K16, N, m0,
                         n0, step, !x_tma, !w_tma, lane);
        fence_proxy_async();
      }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive_tx(full + s, tx);
        if (x_tma) {
#pragma unroll
          for (int sub = 0; sub < T::kSubs; ++sub)
            tma_load_2d(x_slot(s) + sub * T::kXSub, &x_map, full + s,
                        step * T::kBK + sub * kSubK, static_cast<int>(m0));
        }
        if (w_tma)
          tma_load_2d(w_slot(s), &w_map, full + s, n0, step * kKW);
      }
    }
  } else {
    const int g = lane / 4;
    const int t = lane % 4;
    // this thread's A rows (and accumulator rows): row, row + 8 of the tile
    const int row = (tid / 128) * 64 + ((tid / 32) % 4) * 16 + g;
    // lane t's nibbles are the low halves of bytes t / 2 (a0, a1) and
    // 2 + t / 2 (a2, a3) of w >> 4 (t % 2)
    const int shift = 4 * (t & 1);
    const uint32_t sel0 =
        (t >> 1) | (4u << 4) | ((t >> 1) << 8) | (4u << 12);
    const uint32_t sel1 = sel0 + 0x202u;
    // fp32: split the staged fp32 step in slot s into bf16 buffer b
    const auto split_step = [&](int s, int b) {
#pragma unroll
      for (int c = tid; c < T::kSubs * BT * 8; c += T::kConsumers) {
        const int sub = c / (BT * 8);
        const int r = c / 8 % BT;
        const int ch = c % 8;
        const float4* src = reinterpret_cast<const float4*>(
            x_slot(s) + sub * T::kXSub + r * 256 + ch * 32);
        const float4 u = src[0], v = src[1];
        uint4 hi, mid, lo;
        split3(make_float2(u.x, u.y), hi.x, mid.x, lo.x);
        split3(make_float2(u.z, u.w), hi.y, mid.y, lo.y);
        split3(make_float2(v.x, v.y), hi.z, mid.z, lo.z);
        split3(make_float2(v.z, v.w), hi.w, mid.w, lo.w);
        const int off = sw128(r, ch);
        *reinterpret_cast<uint4*>(split_tile(b, 0, sub) + off) = hi;
        *reinterpret_cast<uint4*>(split_tile(b, 1, sub) + off) = mid;
        *reinterpret_cast<uint4*>(split_tile(b, 2, sub) + off) = lo;
      }
      fence_proxy_async();
    };
    // the A fragments of a staged step, one per k16 slice
    const auto decode = [&](uint32_t (&a)[kKW][4], int s) {
      const uint32_t* w = w_slot(s);
#pragma unroll
      for (int kk = 0; kk < kKW; ++kk) {
        const uint32_t v0 = w[kk * kBW + row] >> shift;
        const uint32_t v1 = w[kk * kBW + row + 8] >> shift;
        a[kk][0] = decode_pair(v0, sel0);
        a[kk][1] = decode_pair(v1, sel0);
        a[kk][2] = decode_pair(v0, sel1);
        a[kk][3] = decode_pair(v1, sel1);
      }
    };

    // fp32 x: `acc` holds one chunk of kPromoteK of K, then is added into
    // `total` by ordinary FADDs and starts again from zero (see Exactness)
#pragma unroll
    for (int i = 0; i < kND; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (kFp32 ? kND : 1); ++i) total[i] = 0.f;
    if constexpr (kFp32) {
      if (n_local > 0) {
        mbar_wait(full, 0);
        split_step(0, 0);
      }
    }

    // local step j: stage j % S, A registers a, fp32 bf16 buffer j % 2
    const auto body = [&](int j, uint32_t (&a)[kKW][4]) {
      const int s = j % S;
      if constexpr (kFp32)
        consumers_sync<T::kConsumers>();     // step j split by everyone
      else
        mbar_wait(full + s, (j / S) & 1);     // step j has landed
      decode(a, s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKW; ++kk) {
        if constexpr (kFp32) {
#pragma unroll
          for (int p = 0; p < 3; ++p)
            wgmma_rs<BT>(acc, a[kk],
                         sw128_desc(split_tile(j % 2, p, kk / 4)) +
                             2 * (kk % 4));
        } else {
          wgmma_rs<BT>(acc, a[kk],
                       sw128_desc(x_slot(s) + kk / 4 * T::kXSub) +
                           2 * (kk % 4));
        }
      }
      wgmma_commit();
      if (kFp32 &&
          ((j + 1) % T::kPromoteSteps == 0 || j + 1 == n_local)) {
        wgmma_wait<0>();
        fence_regs(acc);
#pragma unroll
        for (int i = 0; i < kND; ++i) {
          total[i] += acc[i];
          acc[i] = 0.f;
        }
      } else {
        wgmma_wait<kDepth>();           // wgmma j - kDepth done
      }
      if (j >= kDepth && lane == 0)
        mbar_arrive(empty + (j - kDepth) % S);   // its products are done
      if constexpr (kFp32) {
        if (j + 1 < n_local) {
          mbar_wait(full + (j + 1) % S, ((j + 1) / S) & 1);
          consumers_sync<T::kConsumers>();   // every wgmma j - 1 done
          split_step((j + 1) % S, (j + 1) % 2);
        }
      }
    };
    uint32_t frags[kDepth + 1][kKW][4];
    for (int j0 = 0; j0 < n_local; j0 += kDepth + 1) {
#pragma unroll
      for (int b = 0; b <= kDepth; ++b)
        if (j0 + b < n_local) body(j0 + b, frags[b]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
  }
  __syncthreads();                     // every read of the ring is done

  // the partial tile, transposed: ep[m][n] (rows of kEpStride floats);
  // accumulator 4i + q: row (q < 2 ? row : row + 8), token 8i + 2t + q % 2
  float* const ep = reinterpret_cast<float*>(smem);
  if (tid < T::kConsumers) {
    const int g = lane / 4;
    const int t = lane % 4;
    const int row = (tid / 128) * 64 + ((tid / 32) % 4) * 16 + g;
    const auto sum = [&](int i) -> float {
      if constexpr (kFp32)
        return total[i];
      else
        return acc[i];
    };
#pragma unroll
    for (int i = 0; i < BT / 8; ++i) {
      const int m = 8 * i + 2 * t;
      ep[m * T::kEpStride + row] = sum(4 * i);
      ep[(m + 1) * T::kEpStride + row] = sum(4 * i + 1);
      ep[m * T::kEpStride + row + 8] = sum(4 * i + 2);
      ep[(m + 1) * T::kEpStride + row + 8] = sum(4 * i + 3);
    }
  }
  cluster.sync();                      // every CTA's partial tile written

  // rank r: rows m = r mod split, 4 outputs a thread, partials in rank order
  constexpr int kQuads = kBW / 4;
  const int rows_here = (BT - rank + split - 1) / split;
  const bool n_vec = N % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(scale) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(y) % 16 == 0;
  for (int c = tid; c < rows_here * kQuads; c += T::kThreads) {
    const int m = rank + (c / kQuads) * split;
    const int nq = (c % kQuads) * 4;
    const int off = m * T::kEpStride + nq;
    float4 v = *reinterpret_cast<const float4*>(
        split == 1 ? ep + off : cluster.map_shared_rank(ep, 0) + off);
    for (int q = 1; q < split; ++q) {
      const float4 p =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(ep, q) +
                                           off);
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    const long long mg = m0 + m;
    const int n = n0 + nq;
    if (mg >= M || n >= N) continue;
    auto* out = y + mg * N + n;
    if (n_vec) {
      const float4 s = *reinterpret_cast<const float4*>(scale + n);
      if constexpr (kFp32) {
        *reinterpret_cast<float4*>(out) =
            make_float4(v.x * s.x, v.y * s.y, v.z * s.z, v.w * s.w);
      } else {
        __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out);
        o[0] = __floats2bfloat162_rn(v.x * s.x, v.y * s.y);
        o[1] = __floats2bfloat162_rn(v.z * s.z, v.w * s.w);
      }
    } else {
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (n + e >= N) break;
        const float r = vs[e] * scale[n + e];
        if constexpr (kFp32)
          out[e] = r;
        else
          out[e] = __float2bfloat16_rn(r);
      }
    }
  }
  cluster.sync();                      // peers' reads done before exit
}

// cuTensorMapEncodeTiled, a driver-API call, through the runtime (no link
// against the driver library)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 2-D row-major tensor [rows, cols] of `type` at `base`, read in boxes of
// box_rows x box_cols; false if the driver refuses it
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                const void* base, long long rows, int cols, int box_cols,
                int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class XT, int BT, int WG, int KW, int S>
int launch(const void* x, const void* packed, const void* scale, void* y,
           long long M, int Kx, int K16, int N, int split, bool x_vec,
           bool w_vec, cudaStream_t stream) {
  using T = Tile<XT, BT, WG, KW, S>;
  auto* kernel = ternary_matmul_tc_kernel<XT, BT, WG, KW, S>;
  CUtensorMap x_map = {}, w_map = {};
  if (x_vec &&
      !tensor_map(&x_map,
                  T::kFp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  sizeof(XT), x, M, Kx, kSubK, BT,
                  T::kFp32 ? CU_TENSOR_MAP_SWIZZLE_NONE
                           : CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  if (w_vec && !tensor_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, packed,
                           K16, N, T::kBW, KW, CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  if (T::kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((N + T::kBW - 1) / T::kBW),
                     static_cast<unsigned>((M + BT - 1) / BT),
                     static_cast<unsigned>(split));
  cfg.blockDim = dim3(T::kThreads);
  cfg.dynamicSmemBytes = T::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = static_cast<unsigned>(split);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, x_map, w_map, static_cast<const XT*>(x),
      static_cast<const int32_t*>(packed), static_cast<const float*>(scale),
      static_cast<typename T::Out*>(y), M, Kx, K16, N, x_vec, w_vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes.  `dtype` is 0 for fp32 x and y, 1 for
// bf16; packed int32, scale fp32, all contiguous on the current device.
// (bt, bw) is the tile, tokens by outputs, one of the instances below;
// `split` the CTAs of a cluster that split K (1, 2, 4 or 8).  `x_vec` says
// that every row of x starts 16-byte aligned (K a multiple of 16 bytes and
// an aligned pointer), `w_vec` the same of the rows of packed (N % 4 == 0
// and an aligned pointer): those operands come in by TMA, through a tensor
// map encoded here, the others are staged by hand.  Returns
// cudaGetLastError() after the launch, or an error if a tensor map or the
// launch is refused.
extern "C" int ternary_matmul_tc_launch(const void* x, const void* packed,
                                        const void* scale, void* y,
                                        long long M, int Kx, int K16, int N,
                                        int dtype, int bt, int bw, int split,
                                        int x_vec, int w_vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool xv = x_vec != 0, wv = w_vec != 0;
  if (split != 1 && split != 2 && split != 4 && split != 8)
    return static_cast<int>(cudaErrorInvalidValue);
#define TC_TILE(XT, BT, BW, KW, S)                                         \
  if (bt == BT && bw == BW)                                                \
    return launch<XT, BT, BW / 64, KW, S>(x, packed, scale, y, M, Kx, K16, \
                                          N, split, xv, wv, s);
  // (tokens, outputs, words per step, stages)
  if (dtype == 1) {
    TC_TILE(uint16_t, 16, 64, 16, 4)
    TC_TILE(uint16_t, 64, 64, 4, 6)
    TC_TILE(uint16_t, 64, 128, 4, 6)
    TC_TILE(uint16_t, 128, 128, 8, 5)
    TC_TILE(uint16_t, 64, 256, 4, 8)
    TC_TILE(uint16_t, 256, 128, 8, 3)
    TC_TILE(uint16_t, 128, 256, 4, 6)
  } else if (dtype == 0) {              // fp32: fewer stages (fp32 staging)
    TC_TILE(float, 16, 64, 8, 4)
    TC_TILE(float, 64, 64, 4, 4)
    TC_TILE(float, 64, 128, 4, 4)
    TC_TILE(float, 128, 128, 4, 3)
    TC_TILE(float, 64, 256, 4, 4)
  }
#undef TC_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}
