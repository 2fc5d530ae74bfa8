// The split body of decode attention (flash-decoding) for Hopper (sm_90a),
// shared by decode_attention.cu (the whole kernel's split body, the split
// body of one rank's partials, and the block combine) and decode_partials.cu
// (the cluster body, which runs the same tile loop and ends in a merge
// through distributed shared memory, and the warp combine).  The notes on
// what each body computes and what bounds it are at the top of those two
// sources.  Each including source is its own library, so these live in an
// anonymous namespace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// A pair of neighbouring head-dim elements: the unit every lane loads.
template <typename T> struct Pair;
template <> struct Pair<float> {
  using type = float2;
  static __device__ __forceinline__ float2 load(const float2* p) { return *p; }
  static __device__ __forceinline__ float2 make(float2 v) { return v; }
  static __device__ __forceinline__ float scalar(float x) { return x; }
};
template <> struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ float2 load(const __nv_bfloat162* p) {
    return __bfloat1622float2(*p);
  }
  static __device__ __forceinline__ __nv_bfloat162 make(float2 v) {
    return __float22bfloat162_rn(v);
  }
  static __device__ __forceinline__ float scalar(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// The split body (flash-decoding)
// ---------------------------------------------------------------------------
namespace split {

constexpr int TK = 64;       // bf16: cache slots per tile (a split holds whole tiles of 64)
constexpr int F32_TK = 32;   // fp32: cache slots per tile
constexpr int F32_WARPS = 4;

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Where one CTA's work lies: the cache slots [lo, hi) of batch row b.
struct Range {
  int lo, hi, n_tiles;
};
__device__ __forceinline__ Range slot_range(const int32_t* cache_len, int b, int cap,
                                            int per_split, int tk) {
  const int len = max(0, min(cache_len[b], cap));
  Range r;
  r.lo = blockIdx.x * per_split;
  r.hi = min(r.lo + per_split, len);
  r.n_tiles = r.hi > r.lo ? (r.hi - r.lo + tk - 1) / tk : 0;
  return r;
}

// The bf16 body's layout.  DP: the head dim padded to 64, 128, 192 or 256
// (the pad columns hold zeros); KW: the tile's slots each warp scores; NW:
// warps.  WK warps share a tile along its slots, WM along the query rows
// (16 each), and each warp keeps its own softmax state over its slots.
// CLUSTER: the cluster body's CTA, which takes 2 or 4 tiles of a rank's
// 2,048-slot slice: a ring of 2 stages (3 timed the same) in less shared
// memory.
template <int DP, int KW, int NW, bool CLUSTER = false>
struct MmaCfg {
  static constexpr int RS = DP + 8;  // row stride (elements): a 16-byte pad keeps ldmatrix conflict-free
  static constexpr int STAGES = DP > 192 || CLUSTER ? 2 : 3;
  static constexpr int WK = TK / KW;
  static constexpr int WM = NW / WK;
  static constexpr int ROWS = 16 * WM;  // query rows staged (those past G are 0)
  static constexpr int TILE = TK * RS;
  static constexpr size_t RING = sizeof(__nv_bfloat16) * 2 * STAGES * TILE;
  static constexpr size_t PARTS = sizeof(float) * (size_t)WK * ROWS * (DP + 2);
  static constexpr size_t Q = sizeof(__nv_bfloat16) * ROWS * RS;
  static constexpr size_t SMEM = (RING > PARTS ? RING : PARTS) + Q;
  // the cluster body: the CTA's merged m and l beside the warps' states
  static constexpr size_t PARTS_C = PARTS + sizeof(float) * 2 * ROWS;
  static constexpr size_t SMEM_C = (RING > PARTS_C ? RING : PARTS_C) + Q;
};

// The end of a CTA: the WK warps' states of each query row are merged, and
// then either the output row is written (no scratch: one split) or this
// split's m (log2 domain), l and unnormalised acc (decode_combine_kernel).
template <typename T>
__device__ __forceinline__ void finish_rows(const float* Po, const float* Pm, const float* Pl,
                                            int wk_n, int rows, int dstride, int G, int H,
                                            int D, int b, int kh, T* out, float* part_m,
                                            float* part_l, float* part_acc) {
  const int splits = gridDim.x, split = blockIdx.x;
  const int half = D / 2;
  for (int i = threadIdx.x; i < G * half; i += blockDim.x) {
    const int r = i / half, c = 2 * (i - r * half);
    float M = -INFINITY;
    for (int w = 0; w < wk_n; ++w) M = fmaxf(M, Pm[w * rows + r]);
    float L = 0.f, ox = 0.f, oy = 0.f;
    if (M != -INFINITY) {
      for (int w = 0; w < wk_n; ++w) {
        const float sc = exp2f(Pm[w * rows + r] - M);
        const float2 o = *reinterpret_cast<const float2*>(Po + (size_t)(w * rows + r) * dstride + c);
        L += Pl[w * rows + r] * sc;
        ox += o.x * sc;
        oy += o.y * sc;
      }
    }
    const size_t row = (size_t)b * H + (size_t)kh * G + r;
    if (part_acc == nullptr) {
      const float inv = L > 0.f ? 1.f / L : 0.f;
      reinterpret_cast<typename Pair<T>::type*>(out + row * D)[c / 2] =
          Pair<T>::make(make_float2(ox * inv, oy * inv));
    } else {
      const size_t pr = row * splits + split;
      *reinterpret_cast<float2*>(part_acc + pr * D + c) = make_float2(ox, oy);
      if (c == 0) {
        part_m[pr] = M;
        part_l[pr] = L;
      }
    }
  }
}

constexpr float LN2 = 0.6931471805599453f;
// The most CTAs a cluster of the cluster body holds (non-portable above 8).
constexpr int MAX_CLUSTER = 16;

// The cluster body's end: one cluster of gridDim.x CTAs per (batch row, kv
// head), CTA s holding the states of range s.  Each CTA first merges its
// WK warps' states of each query row as finish_rows does, acc in place of
// warp 0's slot of Po (each element read and written by one thread), m
// (log2 domain) and l into Cm, Cl.  After cluster.sync() CTA s takes every
// gridDim.x-th unit of 4 head-dim columns of a row, reads that unit of
// every CTA's state through distributed shared memory (all loads issued
// first), merges them in split order, so that a repeat gives the same
// bits, and writes it to the record (B, H, D + 4): acc's D columns, then m
// (natural log domain), l and two zero pads from the unit of column 0.  A
// row no range saw gives m = -inf, l = 0, acc = 0.  The last cluster.sync()
// keeps each CTA's shared memory until the others have read it.
__device__ __forceinline__ void cluster_finish(float* Po, const float* Pm, const float* Pl,
                                               float* Cm, float* Cl, int wk_n, int rows,
                                               int dstride, int G, int H, int D, int b, int kh,
                                               float* __restrict__ rec) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int half = D / 2;
  for (int i = threadIdx.x; i < G * half; i += blockDim.x) {
    const int r = i / half, c = 2 * (i - r * half);
    float M = -INFINITY;
    for (int w = 0; w < wk_n; ++w) M = fmaxf(M, Pm[w * rows + r]);
    float L = 0.f, ox = 0.f, oy = 0.f;
    if (M != -INFINITY) {
      for (int w = 0; w < wk_n; ++w) {
        const float sc = exp2f(Pm[w * rows + r] - M);
        const float2 o = *reinterpret_cast<const float2*>(Po + (size_t)(w * rows + r) * dstride + c);
        L += Pl[w * rows + r] * sc;
        ox += o.x * sc;
        oy += o.y * sc;
      }
    }
    *reinterpret_cast<float2*>(Po + (size_t)r * dstride + c) = make_float2(ox, oy);
    if (c == 0) {
      Cm[r] = M;
      Cl[r] = L;
    }
  }
  cluster.sync();
  const int splits = (int)cluster.num_blocks(), me = (int)cluster.block_rank();
  const int q4 = D / 4;
  for (int u = me * blockDim.x + threadIdx.x; u < G * q4; u += splits * blockDim.x) {
    const int r = u / q4, c = 4 * (u - r * q4);
    float ms[MAX_CLUSTER], ls[MAX_CLUSTER];
    float4 as[MAX_CLUSTER];
#pragma unroll
    for (int s = 0; s < MAX_CLUSTER; ++s) {
      if (s < splits) {
        ms[s] = cluster.map_shared_rank(Cm, s)[r];
        ls[s] = cluster.map_shared_rank(Cl, s)[r];
        as[s] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(Po, s) +
                                                 (size_t)r * dstride + c);
      }
    }
    float M = -INFINITY;
#pragma unroll
    for (int s = 0; s < MAX_CLUSTER; ++s)
      if (s < splits) M = fmaxf(M, ms[s]);
    float L = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    if (M != -INFINITY) {
#pragma unroll
      for (int s = 0; s < MAX_CLUSTER; ++s) {
        if (s < splits) {
          const float w = exp2f(ms[s] - M);
          L = fmaf(ls[s], w, L);
          o.x = fmaf(as[s].x, w, o.x);
          o.y = fmaf(as[s].y, w, o.y);
          o.z = fmaf(as[s].z, w, o.z);
          o.w = fmaf(as[s].w, w, o.w);
        }
      }
    }
    float* rr = rec + ((size_t)b * H + (size_t)kh * G + r) * (D + 4);
    *reinterpret_cast<float4*>(rr + c) = o;
    if (c == 0) *reinterpret_cast<float4*>(rr + D) = make_float4(M * LN2, L, 0.f, 0.f);
  }
  cluster.sync();
}

// CLUSTER: the cluster body (one cluster of gridDim.x CTAs per (b, kv
// head), writing the record `rec` through cluster_finish); else the split
// body (finish_rows).
template <int DP, int KW, int NW, bool CLUSTER>
__global__ void __launch_bounds__(NW * 32) decode_split_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ cache_len,
    __nv_bfloat16* __restrict__ out, float* __restrict__ part_m, float* __restrict__ part_l,
    float* __restrict__ part_acc, float* __restrict__ rec, int cap, int H, int KH, int D,
    int per_split, float qscale) {
  using C = MmaCfg<DP, KW, NW, CLUSTER>;
  constexpr int RS = C::RS, STAGES = C::STAGES, WK = C::WK, ROWS = C::ROWS, TILE = C::TILE;
  constexpr int ND = DP / 8, KD = DP / 16, NJ = KW / 8;
  constexpr int NTH = NW * 32;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int G = H / KH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WK, wk = warp - wm * WK;
  const int g = lane >> 2, t4 = lane & 3;   // fragment row group and column pair
  const int lm = lane >> 3, lr = lane & 7;  // ldmatrix: which 8 x 8 matrix, which of its rows

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // ROWS x RS
  unsigned char* body = smem_raw + C::Q;  // the K/V ring, then the warps' partial states
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(body);      // STAGES x TK x RS
  __nv_bfloat16* Vs = Ks + STAGES * TILE;                          // STAGES x TK x RS

  const Range rg = slot_range(cache_len, b, cap, per_split, TK);
  const int nv = D / 8;  // 16-byte vectors per row

  // Q (zeros past G and past D, by cp.async in the first tile's group), and
  // the ring's pad columns, which the tile loads never write: P V reads
  // them, and they must not be NaN.
  const __nv_bfloat16* qb = q + ((size_t)b * H + (size_t)kh * G) * D;
  for (int i = tid; i < ROWS * (DP / 8); i += NTH) {
    const int r = i / (DP / 8), c = (i - r * (DP / 8)) * 8;
    const bool ok = r < G && c < D;
    hopper::cp_async16(Qs + r * RS + c, ok ? qb + (size_t)r * D + c : qb, ok);
  }
  if (D < DP) {
    const int pv = (DP - D) / 8;
    for (int i = tid; i < 2 * STAGES * TK * pv; i += NTH) {
      const int r = i / pv, c = D + (i - r * pv) * 8;
      *reinterpret_cast<int4*>(Ks + r * RS + c) = make_int4(0, 0, 0, 0);
    }
  }

  const size_t pos_stride = (size_t)KH * D;
  const __nv_bfloat16* kb = k + ((size_t)b * cap * KH + kh) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * cap * KH + kh) * D;
  auto load_tile = [&](int t, int st) {
    const int s0 = rg.lo + t * TK;
    __nv_bfloat16* kd = Ks + st * TILE;
    __nv_bfloat16* vd = Vs + st * TILE;
    for (int i = tid; i < TK * nv; i += NTH) {
      const int j = i / nv, c = (i - j * nv) * 8;
      const bool ok = s0 + j < rg.hi;  // zeros past the range: never another row's slots
      const size_t off = ok ? (size_t)(s0 + j) * pos_stride + c : 0;
      hopper::cp_async16(kd + j * RS + c, kb + off, ok);
      hopper::cp_async16(vd + j * RS + c, vb + off, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < rg.n_tiles) load_tile(s, s);
    hopper::cp_async_commit();
  }

  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int kw0 = wk * KW;  // this warp's slots within each tile

  for (int t = 0; t < rg.n_tiles; ++t) {
    if (t + STAGES - 1 < rg.n_tiles) load_tile(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    hopper::cp_async_commit();  // possibly empty, so that the wait below names tile t
    hopper::cp_async_wait<STAGES - 1>();
    __syncthreads();
    const __nv_bfloat16* kt = Ks + (t % STAGES) * TILE + kw0 * RS;
    const __nv_bfloat16* vt = Vs + (t % STAGES) * TILE + kw0 * RS;

    // S (16 x KW) = Q K^T; a tile that ends past the range skips the
    // 16-slot blocks past it (warp-uniform; their scores are masked below),
    // and a full tile runs without those branches.
    const int base = rg.lo + t * TK + kw0;
    auto tile = [&](auto full) {
      constexpr bool FULL = decltype(full)::value;
      float s[NJ][4];
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nj][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[4];
        hopper::ldsm_x4(a[0], a[1], a[2], a[3],
                        Qs + (wm * 16 + lr + 8 * (lm & 1)) * RS + kk * 16 + 8 * (lm >> 1));
#pragma unroll
        for (int nj = 0; nj < NJ; nj += 2) {
          if constexpr (!FULL) {
            if (base + nj * 8 >= rg.hi) break;
          }
          uint32_t b0, b1, b2, b3;
          hopper::ldsm_x4(b0, b1, b2, b3, kt + (nj * 8 + lr + 8 * (lm >> 1)) * RS + kk * 16 + 8 * (lm & 1));
          hopper::mma_bf16(s[nj], a, b0, b1);
          hopper::mma_bf16(s[nj + 1], a, b2, b3);
        }
      }

      // Mask the slots past the range, scale into the exp2 domain, and update
      // the online softmax of this thread's two rows.
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mt = -INFINITY;
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = base + nj * 8 + 2 * t4 + e < rg.hi ? s[nj][2 * hf + e] * qscale : -INFINITY;
            s[nj][2 * hf + e] = x;
            mt = fmaxf(mt, x);
          }
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        const float mn = fmaxf(m[hf], mt);
        const float ms = mn == -INFINITY ? 0.f : mn;  // no slot seen yet: p = 0 below
        const float alpha = exp2f(m[hf] - ms);         // 0 while m is -inf
        float ps = 0.f;
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(s[nj][2 * hf + e] - ms);
            s[nj][2 * hf + e] = p;
            ps += p;
          }
        ps += __shfl_xor_sync(0xffffffffu, ps, 1);
        ps += __shfl_xor_sync(0xffffffffu, ps, 2);
        l[hf] = l[hf] * alpha + ps;
        m[hf] = mn;
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          o[nd][2 * hf] *= alpha;
          o[nd][2 * hf + 1] *= alpha;
        }
      }

      // O (16 x DP) += P V, P from the score accumulators
#pragma unroll
      for (int kk = 0; kk < KW / 16; ++kk) {
        if constexpr (!FULL) {
          if (base + kk * 16 >= rg.hi) break;  // p is 0 there
        }
        const uint32_t a[4] = {hopper::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               hopper::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               hopper::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               hopper::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int nd = 0; nd < ND; nd += 2) {
          uint32_t b0, b1, b2, b3;
          hopper::ldsm_x4_trans(b0, b1, b2, b3, vt + (kk * 16 + lr + 8 * (lm & 1)) * RS + nd * 8 + 8 * (lm >> 1));
          hopper::mma_bf16(o[nd], a, b0, b1);
          hopper::mma_bf16(o[nd + 1], a, b2, b3);
        }
      }
    };
    if (base + KW <= rg.hi)
      tile(std::true_type{});
    else
      tile(std::false_type{});
    __syncthreads();  // the stage is consumed before the next load overwrites it
  }
  hopper::cp_async_wait<0>();  // only empty groups remain; the ring becomes Po
  __syncthreads();

  // Each warp's state, then the merge over the WK warps of each row.
  float* Po = reinterpret_cast<float*>(body);  // WK x ROWS x (DP), unnormalised
  float* Pm = Po + (size_t)WK * ROWS * DP;     // WK x ROWS
  float* Pl = Pm + WK * ROWS;                  // WK x ROWS
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = wm * 16 + g + 8 * hf;
    float* po = Po + (size_t)(wk * ROWS + r) * DP;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<float2*>(po + nd * 8 + 2 * t4) = make_float2(o[nd][2 * hf], o[nd][2 * hf + 1]);
    if (t4 == 0) {
      Pm[wk * ROWS + r] = m[hf];
      Pl[wk * ROWS + r] = l[hf];
    }
  }
  __syncthreads();
  if constexpr (CLUSTER) {
    float* Cm = Pl + WK * ROWS;  // ROWS, then Cl: ROWS
    cluster_finish(Po, Pm, Pl, Cm, Cm + ROWS, WK, ROWS, DP, G, H, D, b, kh, rec);
  } else {
    finish_rows<__nv_bfloat16>(Po, Pm, Pl, WK, ROWS, DP, G, H, D, b, kh, out, part_m, part_l,
                               part_acc);
  }
}

// The fp32 body's layout: F32_WARPS warps, query rows warp, warp + 4, ...
// (RPW of them per warp), lanes across the head dim (DP / 32 elements each),
// a two-stage ring of F32_TK slots.
template <int DP, int RPW>
struct F32Cfg {
  static constexpr int STAGES = 2;
  static constexpr int ROWS = F32_WARPS * RPW;
  static constexpr int TILE = F32_TK * DP;
  static constexpr size_t RING = sizeof(float) * 2 * STAGES * TILE;
  static constexpr size_t PARTS = sizeof(float) * (size_t)ROWS * (DP + 2);
  static constexpr size_t Q = sizeof(float) * ROWS * DP;
  static constexpr size_t SMEM = (RING > PARTS ? RING : PARTS) + Q;
};

template <int DP, int RPW>
__global__ void __launch_bounds__(F32_WARPS * 32) decode_split_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int32_t* __restrict__ cache_len, float* __restrict__ out, float* __restrict__ part_m,
    float* __restrict__ part_l, float* __restrict__ part_acc, int cap, int H, int KH, int D,
    int per_split, float qscale) {
  using C = F32Cfg<DP, RPW>;
  constexpr int STAGES = C::STAGES, ROWS = C::ROWS, TILE = C::TILE, DPL = DP / 32;
  constexpr int NTH = F32_WARPS * 32;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int G = H / KH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // ROWS x DP
  unsigned char* body = smem_raw + C::Q;
  float* Ks = reinterpret_cast<float*>(body);      // STAGES x F32_TK x DP
  float* Vs = Ks + STAGES * TILE;

  const Range rg = slot_range(cache_len, b, cap, per_split, F32_TK);
  const int nv = D / 4;
  const float* qb = q + ((size_t)b * H + (size_t)kh * G) * D;
  for (int i = tid; i < ROWS * (DP / 4); i += NTH) {  // in the first tile's group
    const int r = i / (DP / 4), c = (i - r * (DP / 4)) * 4;
    const bool ok = r < G && c < D;
    hopper::cp_async16(Qs + r * DP + c, ok ? qb + (size_t)r * D + c : qb, ok);
  }
  if (D < DP) {
    const int pv = (DP - D) / 4;
    for (int i = tid; i < 2 * STAGES * F32_TK * pv; i += NTH) {
      const int r = i / pv, c = D + (i - r * pv) * 4;
      *reinterpret_cast<float4*>(Ks + r * DP + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  const size_t pos_stride = (size_t)KH * D;
  const float* kb = k + ((size_t)b * cap * KH + kh) * D;
  const float* vb = v + ((size_t)b * cap * KH + kh) * D;
  auto load_tile = [&](int t, int st) {
    const int s0 = rg.lo + t * F32_TK;
    float* kd = Ks + st * TILE;
    float* vd = Vs + st * TILE;
    for (int i = tid; i < F32_TK * nv; i += NTH) {
      const int j = i / nv, c = (i - j * nv) * 4;
      const bool ok = s0 + j < rg.hi;
      const size_t off = ok ? (size_t)(s0 + j) * pos_stride + c : 0;
      hopper::cp_async16(kd + j * DP + c, kb + off, ok);
      hopper::cp_async16(vd + j * DP + c, vb + off, ok);
    }
  };
  if (rg.n_tiles > 0) load_tile(0, 0);
  hopper::cp_async_commit();

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
  }
  for (int t = 0; t < rg.n_tiles; ++t) {
    if (t + 1 < rg.n_tiles) load_tile(t + 1, (t + 1) % STAGES);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    __syncthreads();
    const float* kt = Ks + (t % STAGES) * TILE;
    const float* vt = Vs + (t % STAGES) * TILE;
    // Scores: lane j ends up holding slot j's score of each row; each dot
    // product is spread over the lanes and summed by shuffles.
    float sc[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) sc[r] = -INFINITY;
    // Every row of the template is scored, those past G on zero queries:
    // a branch per row would keep the compiler from interleaving the rows'
    // shuffle chains.
#pragma unroll 2
    for (int j = 0; j < F32_TK; ++j) {
      float kf[DPL];
#pragma unroll
      for (int e = 0; e < DPL; ++e) kf[e] = kt[j * DP + lane + 32 * e];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float* qr = Qs + (warp + F32_WARPS * r) * DP + lane;
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < DPL; ++e) d = fmaf(qr[32 * e], kf[e], d);
        d = warp_sum(d) * qscale;  // into the exp2 domain
        if (lane == j) sc[r] = d;
      }
    }
    const bool seen = rg.lo + t * F32_TK + lane < rg.hi;
    float p[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float x = seen ? sc[r] : -INFINITY;
      const float mn = fmaxf(m[r], warp_max(x));
      const float ms = mn == -INFINITY ? 0.f : mn;
      const float alpha = exp2f(m[r] - ms);
      p[r] = exp2f(x - ms);
      l[r] = l[r] * alpha + warp_sum(p[r]);
      m[r] = mn;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[r][e] *= alpha;
    }
    for (int j = 0; j < F32_TK; ++j) {
      float vf[DPL];
#pragma unroll
      for (int e = 0; e < DPL; ++e) vf[e] = vt[j * DP + lane + 32 * e];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[r][e] = fmaf(pj, vf[e], acc[r][e]);
      }
    }
    __syncthreads();
  }
  hopper::cp_async_wait<0>();
  __syncthreads();

  float* Po = reinterpret_cast<float*>(body);  // ROWS x DP
  float* Pm = Po + (size_t)ROWS * DP;
  float* Pl = Pm + ROWS;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = warp + F32_WARPS * r;
#pragma unroll
    for (int e = 0; e < DPL; ++e) Po[row * DP + lane + 32 * e] = acc[r][e];
    if (lane == 0) {
      Pm[row] = m[r];
      Pl[row] = l[r];
    }
  }
  __syncthreads();
  finish_rows<float>(Po, Pm, Pl, 1, ROWS, DP, G, H, D, b, kh, out, part_m, part_l, part_acc);
}

// The block combine: out[row] = sum_s acc_s 2^(m_s - M) / sum_s l_s
// 2^(m_s - M), M = max_s m_s; 0 when no split saw a slot.  One CTA per
// (batch row, head).  Split s of row r: m at part_m[r * mr + s * ms], l at
// part_l with the same strides, acc at part_acc[r * ar + s * as]; m_s is
// read times in_scale into the exp2 domain.  With out == nullptr the row's
// record goes to rec (B, H, D + 4): the unnormalised acc, m (natural log
// domain), l and two zero pads.
template <typename T>
__global__ void __launch_bounds__(128) decode_combine_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_acc, T* __restrict__ out, float* __restrict__ rec, int splits,
    int D, size_t mr, size_t ms, size_t ar, size_t as, float in_scale) {
  extern __shared__ float wts[];  // splits
  __shared__ float red[4];
  const size_t row = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* pm = part_m + row * mr;
  const float* pl = part_l + row * mr;
  float M = -INFINITY;
  for (int s = tid; s < splits; s += 128) M = fmaxf(M, pm[s * ms] * in_scale);
  M = warp_max(M);
  if (lane == 0) red[warp] = M;
  __syncthreads();
  M = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  __syncthreads();
  float L = 0.f;
  for (int s = tid; s < splits; s += 128) {
    const float w = M == -INFINITY ? 0.f : exp2f(pm[s * ms] * in_scale - M);
    wts[s] = w;
    L += pl[s * ms] * w;
  }
  L = warp_sum(L);
  if (lane == 0) red[warp] = L;
  __syncthreads();
  L = red[0] + red[1] + red[2] + red[3];
  const float* pa = part_acc + row * ar;
  if (out == nullptr) {
    float* rr = rec + row * (D + 4);
    for (int d = tid; d < D; d += 128) {
      float o = 0.f;
      for (int s = 0; s < splits; ++s) o = fmaf(pa[s * as + d], wts[s], o);
      rr[d] = o;
    }
    if (tid < 4) rr[D + tid] = tid == 0 ? M * LN2 : (tid == 1 ? L : 0.f);
    return;
  }
  const float inv = L > 0.f ? 1.f / L : 0.f;
  for (int d = tid; d < D; d += 128) {
    float o = 0.f;
    for (int s = 0; s < splits; ++s) o = fmaf(pa[s * as + d], wts[s], o);
    out[row * D + d] = from_float<T>(o * inv);
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace split

}  // namespace
