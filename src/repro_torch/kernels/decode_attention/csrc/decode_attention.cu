// GQA decode attention for Hopper (sm_90a): one new token's attention,
// read straight from a bf16 or fp16 KV cache as it lies.
//
// Replaces no Pallas kernel: the JAX package's decode attention
// (src/repro/models/attention.py, `attend_decode`) is plain jnp.  The
// port's plain path (`models/attention.py`, the einsum path of
// `attend_decode`) expands the cache's kv heads to all H query heads and
// converts K and V to fp32 over every slot, masked ones included, at every
// step: copies many times the cache's own bytes.  This kernel computes the
// same function without any copy of the cache:
//
//   out[b, 0, h, :] = sum_t softmax_t(s)[t] v[b, t, h / n_rep, :],
//   s[t] = (q[b, 0, h, :] . k[b, t, h / n_rep, :]) * scale,  t < n_valid
//
// q [B, 1, H, hd] and out contiguous; k, v [B, L, Hk, hd] with any strides
// that are multiples of 8 elements over a contiguous last dim; n_rep =
// H / Hk; hd a multiple of 32 up to 256; only the first n_valid slots are
// read.  Scores, softmax and P.V are fp32 (bf16 and fp16 convert exactly),
// on the CUDA cores; the output is rounded once, to nearest, to q's dtype.
//
// Bound.  Each step reads the valid part of the cache once: 4 * hd bytes a
// slot and kv head for about 4 * n_rep * hd FLOPs, 8 FLOP/B at n_rep = 8,
// below the H100's 67 TFLOP/s fp32 over 3.35 TB/s (20 FLOP/B): the bytes
// bound it.  So each K and V element is read from device memory once and
// serves all of its group's query heads, and the arithmetic is laid out so
// that shared-memory traffic stays below the FMAs.
//
// Design.  A CTA of 8 warps owns one (sequence, kv head, group of G <= 8
// query heads, split of the slots): G is the smallest of 1, 2, 4, 8 that
// holds n_rep heads (more heads take several groups; heads past n_rep are
// zero and not stored).  K and V stream through a 2-stage ring of 64-slot
// tiles in shared memory (cp.async, 16 bytes a thread; slots past n_valid
// are zero-filled, never read): one tile is in flight while the CTA works
// on the other, and two CTAs share an SM at hd <= 128.  Per tile:
//   scores  thread = (2 slots, all G heads, an eighth of hd: 8-element
//           chunks c = r mod 8): per chunk 2 K loads and 2G q loads (q is
//           held in shared memory in fp32, each chunk's halves swizzled so
//           that a warp's eight chunks fall on distinct banks) for 16G
//           FMAs; the eighths meet in three halving shuffle steps;
//   softmax one warp per head: the tile's max, the running max's
//           correction, p = exp(s - m) in place, per-lane partial sums;
//   P.V     warp w takes slots 8w..8w+7, lane l the dim pairs 2l + 64j,
//           all G heads in registers: per 4 slots G broadcast loads of p
//           and one 4-byte V load a pair and slot for 8G FMAs.
// The 8 warps' partial P.V sums (disjoint slots, one running max) meet in
// shared memory in warp order at the end, so the result does not depend on
// scheduling.  With one split the CTA divides by the sum and stores; with
// several (the wrapper adapts the count to the grid: a batch of 128 x 8 kv
// heads fills the card with one, a single sequence splits its slots), each
// stores its sums, max and denominator, and a second kernel merges them
// with the usual max rescale.  hd = 64, 128 and 256 are compiled as
// constants; other multiples of 32 take a kernel that reads hd at run time.
#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;             // cache slots per tile
constexpr int kStages = 2;            // tiles in the shared-memory ring
constexpr int kRowS = kTile + 4;      // floats per head of the score tile
constexpr int kMaxHd = 256;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* part;     // several splits: sums [bases, splits, G, hd], then
                   // (max, denominator) [bases, splits, G, 2]
  long long k_sb, k_st, k_sh, v_sb, v_st, v_sh;   // strides, in elements
  int n_heads, n_kv, n_rep, groups, hd, n_valid, splits, tiles_per_split;
  float scale;
};

template <typename T> __device__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f32(__half x) {
  return __half2float(x);
}

// two packed elements (the lower first) to fp32
template <typename T> __device__ float2 pair_f32(uint32_t w);
template <> __device__ __forceinline__ float2 pair_f32<__nv_bfloat16>(
    uint32_t w) {
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}
template <> __device__ __forceinline__ float2 pair_f32<__half>(uint32_t w) {
  __half2 h;
  memcpy(&h, &w, sizeof(h));
  return __half22float2(h);
}

template <typename T> __device__ T from_f32(float x);
template <> __device__ __forceinline__ __nv_bfloat16 from_f32(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32(float x) {
  return __float2half_rn(x);
}

template <typename T>
__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = pair_f32<T>(w[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// q in shared memory as fp32, the two float4 halves of each 8-element
// chunk c swapped where bit 2 of c is set: the eight chunks that a warp's
// eighths read at once then fall on distinct banks
__device__ __forceinline__ int q_index(int h, int hd, int c, int half) {
  return h * hd + 8 * c + 4 * (half ^ ((c >> 2) & 1));
}

int smem_bytes(int group, int hd) {
  return 2 * kStages * kTile * 2 * hd +
         4 * (group * hd + group * kRowS + 3 * group);
}

// One CTA's work.  HD is the head dim, or 0 for a head dim read from the
// parameters (any multiple of 32 up to 256; NP = 4 then).
template <typename T, int G, int HD>
__global__ void __launch_bounds__(kThreads, HD > 0 && HD <= 128 ? 2 : 1)
    decode_attention_kernel(const Params p) {
  constexpr int NP = HD > 0 ? (HD + 63) / 64 : kMaxHd / 64;  // pairs a lane
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = HD > 0 ? HD : p.hd;
  const int chunks = hd / 8;           // 16-byte pieces of a row
  const int row = 2 * hd;              // bytes of a K or V row
  unsigned char* kbuf = smem;
  unsigned char* vbuf = kbuf + kStages * kTile * row;
  float* q_s = reinterpret_cast<float*>(vbuf + kStages * kTile * row);
  float* s_s = q_s + G * hd;           // [G][kRowS]: scores, then p
  float* corr_s = s_s + G * kRowS;     // [G]
  float* l_s = corr_s + G;
  float* m_s = l_s + G;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long base = blockIdx.x;
  const int split = blockIdx.y;
  const int grp = static_cast<int>(base % p.groups);
  const long long bk = base / p.groups;
  const int kvh = static_cast<int>(bk % p.n_kv);
  const long long b = bk / p.n_kv;
  const int head0 = kvh * p.n_rep + grp * G;
  const int nh = min(G, p.n_rep - grp * G);
  const int n_tiles = (p.n_valid + kTile - 1) / kTile;
  const int tile0 = split * p.tiles_per_split;
  const int tile1 = min(tile0 + p.tiles_per_split, n_tiles);

  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  auto load_tile = [&](int tile, int stage) {
    unsigned char* kd = kbuf + stage * kTile * row;
    unsigned char* vd = vbuf + stage * kTile * row;
    for (int c = tid; c < kTile * chunks; c += kThreads) {
      const int r = c / chunks, cc = c - r * chunks;
      const int t = tile * kTile + r;
      const bool ok = t < p.n_valid;
      const long long ts = ok ? t : 0;
      cp_async16(kd + r * row + cc * 16, kg + ts * p.k_st + cc * 8,
                 ok ? 16 : 0);
      cp_async16(vd + r * row + cc * 16, vg + ts * p.v_st + cc * 8,
                 ok ? 16 : 0);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (tile0 + s < tile1) load_tile(tile0 + s, s);
    cp_async_commit();
  }
  // the group's queries in fp32 (exact), zero past its last head
  const T* qg = static_cast<const T*>(p.q) + (b * p.n_heads + head0) * hd;
  for (int i = tid; i < G * hd; i += kThreads) {
    const int h = i / hd, d = i - h * hd;
    q_s[q_index(h, hd, d / 8, (d / 4) & 1) + (d & 3)] =
        h < nh ? to_f32(qg[i]) : 0.f;
  }

  constexpr int kHeadsPerWarp = (G + kWarps - 1) / kWarps;
  float m_run[kHeadsPerWarp], l_part[kHeadsPerWarp];
#pragma unroll
  for (int j = 0; j < kHeadsPerWarp; ++j) {
    m_run[j] = -INFINITY;
    l_part[j] = 0.f;
  }
  float acc[G][NP][2];
#pragma unroll
  for (int h = 0; h < G; ++h)
#pragma unroll
    for (int j = 0; j < NP; ++j) acc[h][j][0] = acc[h][j][1] = 0.f;

  // the scores' roles: lane = 8 x (slot pair of the warp's 4) + eighth
  const int eighth = lane & 7;
  const int b0 = eighth & 1, b1 = (eighth >> 1) & 1, b2 = eighth >> 2;
  const int t_pair = 2 * (warp * 4 + (lane >> 3));
  constexpr int GB = G >= 2 ? G / 2 : 1;     // heads a lane keeps after
  constexpr int GC = GB >= 2 ? GB / 2 : 1;   // the 2nd and 3rd steps
  const int my_head = (G >= 2 ? b1 * GB : 0) + (GB >= 2 ? b2 * GC : 0);
  const bool writes = (G >= 2 || b1 == 0) && (GB >= 2 || b2 == 0);

  for (int tile = tile0; tile < tile1; ++tile) {
    const int stage = (tile - tile0) % kStages;
    cp_async_wait<kStages - 2>();
    __syncthreads();
    {
      const int next = tile + kStages - 1;
      if (next < tile1) load_tile(next, (next - tile0) % kStages);
      cp_async_commit();
    }
    const unsigned char* kt = kbuf + stage * kTile * row;
    const unsigned char* vt = vbuf + stage * kTile * row;

    // ---- scores: 2 slots x G heads over an eighth of hd ---------------
    float sc[2 * G];
#pragma unroll
    for (int i = 0; i < 2 * G; ++i) sc[i] = 0.f;
    const unsigned char* k0 = kt + t_pair * row;
    const unsigned char* k1 = k0 + row;
#pragma unroll
    for (int c = eighth; c < chunks; c += 8) {
      float x0[8], x1[8];
      unpack8<T>(*reinterpret_cast<const uint4*>(k0 + c * 16), x0);
      unpack8<T>(*reinterpret_cast<const uint4*>(k1 + c * 16), x1);
#pragma unroll
      for (int h = 0; h < G; ++h) {
        const float4 qa =
            *reinterpret_cast<const float4*>(q_s + q_index(h, hd, c, 0));
        const float4 qb =
            *reinterpret_cast<const float4*>(q_s + q_index(h, hd, c, 1));
        const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          sc[h] = fmaf(qv[e], x0[e], sc[h]);
          sc[G + h] = fmaf(qv[e], x1[e], sc[G + h]);
        }
      }
    }
    // the eighths meet in three halving steps: a lane keeps one slot, then
    // half of the heads, then half again (a full sum where one is left)
    float sa[G], sb[GB], sd[GC];
#pragma unroll
    for (int h = 0; h < G; ++h) {
      const float send = b0 ? sc[h] : sc[G + h];
      const float keep = b0 ? sc[G + h] : sc[h];
      sa[h] = keep + __shfl_xor_sync(kFull, send, 1);
    }
    if constexpr (G >= 2) {
#pragma unroll
      for (int h = 0; h < GB; ++h) {
        const float send = b1 ? sa[h] : sa[GB + h];
        const float keep = b1 ? sa[GB + h] : sa[h];
        sb[h] = keep + __shfl_xor_sync(kFull, send, 2);
      }
    } else {
      sb[0] = sa[0] + __shfl_xor_sync(kFull, sa[0], 2);
    }
    if constexpr (GB >= 2) {
#pragma unroll
      for (int h = 0; h < GC; ++h) {
        const float send = b2 ? sb[h] : sb[GC + h];
        const float keep = b2 ? sb[GC + h] : sb[h];
        sd[h] = keep + __shfl_xor_sync(kFull, send, 4);
      }
    } else {
      sd[0] = sb[0] + __shfl_xor_sync(kFull, sb[0], 4);
    }
    {
      const int t = t_pair + b0;
      const bool valid = tile * kTile + t < p.n_valid;
      if (writes) {
#pragma unroll
        for (int h = 0; h < GC; ++h)
          s_s[(my_head + h) * kRowS + t] = valid ? sd[h] * p.scale
                                                 : -INFINITY;
      }
    }
    __syncthreads();

    // ---- online softmax: one warp per head ----------------------------
#pragma unroll
    for (int j = 0; j < kHeadsPerWarp; ++j) {
      const int h = warp + kWarps * j;
      if (h < G) {
        float* srow = s_s + h * kRowS;
        float s0 = srow[lane], s1 = srow[lane + 32];
        float mx = fmaxf(s0, s1);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
        // every tile holds a valid slot, so mx is finite
        const float m_new = fmaxf(m_run[j], mx);
        const float corr =
            m_run[j] == -INFINITY ? 0.f : expf(m_run[j] - m_new);
        s0 = expf(s0 - m_new);
        s1 = expf(s1 - m_new);
        l_part[j] = l_part[j] * corr + (s0 + s1);
        srow[lane] = s0;
        srow[lane + 32] = s1;
        if (lane == 0) corr_s[h] = corr;
        m_run[j] = m_new;
      }
    }
    __syncthreads();

    // ---- P.V: 8 slots a warp, dim pairs 2 lane + 64 j, all G heads ----
#pragma unroll
    for (int h = 0; h < G; ++h) {
      const float c = corr_s[h];
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        acc[h][j][0] *= c;
        acc[h][j][1] *= c;
      }
    }
#pragma unroll
    for (int t4 = warp * (kTile / kWarps); t4 < (warp + 1) * (kTile / kWarps);
         t4 += 4) {
      float pr[G][4];
#pragma unroll
      for (int h = 0; h < G; ++h) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(s_s + h * kRowS + t4);
        pr[h][0] = p4.x;
        pr[h][1] = p4.y;
        pr[h][2] = p4.z;
        pr[h][3] = p4.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const unsigned char* vr = vt + (t4 + u) * row;
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          const int d = 2 * lane + 64 * j;
          if (d < hd) {
            const float2 vv =
                pair_f32<T>(*reinterpret_cast<const uint32_t*>(vr + 2 * d));
#pragma unroll
            for (int h = 0; h < G; ++h) {
              acc[h][j][0] = fmaf(pr[h][u], vv.x, acc[h][j][0]);
              acc[h][j][1] = fmaf(pr[h][u], vv.y, acc[h][j][1]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // each head's denominator over its warp's lanes
#pragma unroll
  for (int j = 0; j < kHeadsPerWarp; ++j) {
    const int h = warp + kWarps * j;
    if (h < G) {
      float l = l_part[j];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(kFull, l, o);
      if (lane == 0) {
        l_s[h] = l;
        m_s[h] = m_run[j];
      }
    }
  }
  __syncthreads();
  // the warps' partial sums meet in warp order, over the ring
  float* red = reinterpret_cast<float*>(smem);       // [kWarps][G][hd]
#pragma unroll
  for (int h = 0; h < G; ++h)
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int d = 2 * lane + 64 * j;
      if (d < hd) {
        red[(warp * G + h) * hd + d] = acc[h][j][0];
        red[(warp * G + h) * hd + d + 1] = acc[h][j][1];
      }
    }
  __syncthreads();
  T* out = static_cast<T*>(p.out) + (b * p.n_heads + head0) * hd;
  const long long cell = (base * p.splits + split) * G;
  for (int i = tid; i < nh * hd; i += kThreads) {
    const int h = i / hd, d = i - h * hd;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += red[(w * G + h) * hd + d];
    if (p.splits == 1)
      out[i] = from_f32<T>(o / l_s[h]);
    else
      p.part[(cell + h) * hd + d] = o;
  }
  if (p.splits > 1 && tid < nh) {
    float* ml = p.part + static_cast<long long>(gridDim.x) * p.splits * G * hd;
    ml[2 * (cell + tid)] = m_s[tid];
    ml[2 * (cell + tid) + 1] = l_s[tid];
  }
}

// Several splits: out = sum_s e^(m_s - M) o_s / sum_s e^(m_s - M) l_s,
// M the largest of the splits' maxima m_s.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_attention_merge(const Params p, int group) {
  const long long base = blockIdx.x;
  const int h = blockIdx.y;
  const int grp = static_cast<int>(base % p.groups);
  const long long bk = base / p.groups;
  const int kvh = static_cast<int>(bk % p.n_kv);
  const long long b = bk / p.n_kv;
  const int head0 = kvh * p.n_rep + grp * group;
  if (h >= min(group, p.n_rep - grp * group)) return;
  const int hd = p.hd;
  const float* ml =
      p.part + static_cast<long long>(gridDim.x) * p.splits * group * hd;
  float mx = -INFINITY;
  for (int s = 0; s < p.splits; ++s)
    mx = fmaxf(mx, ml[2 * ((base * p.splits + s) * group + h)]);
  T* out = static_cast<T*>(p.out) + (b * p.n_heads + head0 + h) * hd;
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    float num = 0.f, den = 0.f;
    for (int s = 0; s < p.splits; ++s) {
      const long long c = (base * p.splits + s) * group + h;
      const float w = expf(ml[2 * c] - mx);
      num = fmaf(w, p.part[c * hd + d], num);
      den = fmaf(w, ml[2 * c + 1], den);
    }
    out[d] = from_f32<T>(num / den);
  }
}

template <typename T, int G, int HD>
int launch(const Params& p, long long bases, cudaStream_t stream) {
  const int smem = smem_bytes(G, p.hd);
  auto* kernel = decode_attention_kernel<T, G, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(static_cast<unsigned>(bases),
                static_cast<unsigned>(p.splits)),
           kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return static_cast<int>(err);
  decode_attention_merge<T><<<dim3(static_cast<unsigned>(bases), G),
                              kThreads, 0, stream>>>(p, G);
  return static_cast<int>(cudaGetLastError());
}

// the head dims the main paths use are compiled as constants; the others
// (96, 160, ...) take the kernel that reads hd at run time
template <typename T, int G>
int launch_hd(const Params& p, long long bases, cudaStream_t s) {
  switch (p.hd) {
    case 64: return launch<T, G, 64>(p, bases, s);
    case 128: return launch<T, G, 128>(p, bases, s);
    case 256: return launch<T, G, 256>(p, bases, s);
  }
  return launch<T, G, 0>(p, bases, s);
}

template <typename T>
int launch_group(const Params& p, int group, long long bases,
                 cudaStream_t s) {
  switch (group) {
    case 1: return launch_hd<T, 1>(p, bases, s);
    case 2: return launch_hd<T, 2>(p, bases, s);
    case 4: return launch_hd<T, 4>(p, bases, s);
    case 8: return launch_hd<T, 8>(p, bases, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 bf16, 1 fp16.  group: query heads a CTA holds (1, 2, 4, 8).
// The slots' tiles split over `splits` CTAs of `tiles_per_split` each, no
// CTA empty; `part` holds their partial results when splits > 1.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, void* out, void* part,
    long long k_sb, long long k_st, long long k_sh, long long v_sb,
    long long v_st, long long v_sh, int B, int H, int Hk, int hd,
    int n_valid, float scale, int dtype, int group, int splits,
    int tiles_per_split, void* stream) {
  const long long n_tiles = (n_valid + kTile - 1) / kTile;
  if (B < 1 || Hk < 1 || H < Hk || H % Hk || hd < 32 || hd > kMaxHd ||
      hd % 32 || n_valid < 1 || splits < 1 || splits > 65535 ||
      tiles_per_split < 1 ||
      static_cast<long long>(splits) * tiles_per_split < n_tiles ||
      static_cast<long long>(splits - 1) * tiles_per_split >= n_tiles ||
      (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.part = static_cast<float*>(part);
  p.k_sb = k_sb;
  p.k_st = k_st;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_st = v_st;
  p.v_sh = v_sh;
  p.n_heads = H;
  p.n_kv = Hk;
  p.n_rep = H / Hk;
  p.groups = group > 0 ? (p.n_rep + group - 1) / group : 0;
  p.hd = hd;
  p.n_valid = n_valid;
  p.splits = splits;
  p.tiles_per_split = tiles_per_split;
  p.scale = scale;
  const long long bases = static_cast<long long>(B) * Hk * p.groups;
  if (bases < 1 || bases > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_group<__nv_bfloat16>(p, group, bases, s);
  if (dtype == 1) return launch_group<__half>(p, group, bases, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
