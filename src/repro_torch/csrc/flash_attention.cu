// Blocked (flash) attention for Hopper (sm_90a), fp32 and bf16.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (the
// Pallas kernel body _fa_kernel).  For q (B, Sq, H, D) and k/v
// (B, Sk, KH, D) it computes, for every batch row b, head h and query i,
//
//     out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / G] * D^-1/2) v[b, j, h / G]
//
// over the keys j that query i sees: j < Sk, j <= i + q_offset when
// causal, j > i + q_offset - window when a window is given.  G = H / KH.
// A query that sees no key gives 0, as attention_ref does (the Pallas
// kernel's NEG_INF = -1e30 lets a fully masked tile add exp(0) = 1 for
// every masked key; here masked scores are a true -inf and never count).
//
// Given an lse pointer (the training path), every body also writes each
// query's log-sum-exp of its scaled scores, lse[b, h, i] (fp32, natural
// log; -inf where the query sees no key), which the backward kernel
// (flash_attention_bwd.cu) reads; serving and prefill pass null.
//
// What bounds it: operations.  Causal prefill does 4 * B * H * D flops per
// visible (query, key) pair, about Sq / 2 pairs per query, against reading
// q, k, v and writing out once: at Sq = 2048 and D = 128 that is some 500
// flops per byte in bf16, above the card's ridge (~295), so the kernel is
// bound by arithmetic: 989 TFLOP/s on the tensor cores in bf16, 67 TFLOP/s
// on the CUDA cores in fp32.
//
// What the design does about it: one CTA per (query tile, head, batch
// row).  Only the band of key tiles that the tile's queries can see is
// visited (the loop bounds of flash_attention.py:51-62), so causal prefill
// does half the pairs.  The running max m, sum l and the accumulator stay
// in registers (online softmax in the exp2 domain).  Masks are computed
// only on tiles that straddle the diagonal, the window's edge or Sk.  CTAs
// are issued longest first (the last query tiles see the most keys).
// Three bodies, chosen by the caller (kernels/flash_attention.py::body_for):
//
// * wgmma (bf16, D in {64, 128, 192, 256}: rows of whole 128-byte swizzle
//   atoms; q, k, v 16-byte aligned): a 128-query tile on two consumer
//   warpgroups of 64 rows and a producer warpgroup, one thread of which
//   loads Q once and streams K and V tiles (128 keys at D = 64, 64
//   above) through a 2-stage ring by TMA (4-D maps over (B, S, heads, D),
//   128-byte swizzled, zero past Sq and Sk), each tile on its own mbarrier
//   so that Q K^T starts before V has landed.  S = Q K^T is a wgmma from
//   shared memory (K K-major); P is rounded to bf16 in registers, as
//   attention_ref rounds its probabilities to v's dtype, and is the
//   register A operand of O += P V (V N-major: the transpose bit).
//   Consumers release a stage once both products have read it.
// * mma (bf16 with D a multiple of 16, such as zamba2's 112): 64-query
//   tiles on 4 warps, each owning 16 query rows; S = Q K^T and O += P V are
//   mma.sync m16n8k16 products fed by ldmatrix from shared tiles whose
//   rows are padded by 16 bytes (conflict-free), loaded by all threads
//   before the compute.
// * fp32 (fp32, and bf16 head dims that are not a multiple of 16): the CUDA
//   cores in fp32.  256 threads; the query tile is staged once, scaled by
//   D^-1/2 * log2(e), transposed, and each thread owns a 4 x 4 block of
//   the 64 x 64 score tile and the same 4 query rows of the output: two
//   16-byte shared loads feed 16 FMAs.
//
// Registers: ptxas compiles the wgmma body to the 168 registers a thread
// of a 384-thread CTA may hold (setmaxnreg hands registers from the
// producer to the consumers at run time, but ptxas does not budget the
// consumer code above 168).  With 128-key tiles at D = 128 the
// accumulators (O, S and the bf16 P) leave too few for ptxas to keep
// several wgmmas in flight: it serialises them (its warning C7512) and
// spills; 64-key tiles avoid both and measured 3 % faster (PERF.md, PR
// 14).  At D = 192 and 256, O alone takes 96 and 128 registers, and the
// products stay serialised.
//
// What it does not do yet: overlap the softmax of one tile with the
// products of the next (ping-pong between the consumer warpgroups), one
// CTA per KV head for MQA, or a TMA store of the output tile; the fp32
// body takes up to 222 KB of shared memory at D = 256, so one of its CTAs
// runs per SM.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC -I csrc; bound through a plain C entry point.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;          // queries per CTA
constexpr int BK = 64;          // keys per shared-memory tile
constexpr int NT = 256;         // threads per CTA: 16 x 16, each a 4 x 4 score block
constexpr int QS = BQ + 4;      // row stride of the transposed Q tile (keeps float4 alignment)
constexpr int KS = BK + 4;      // row stride of the transposed K tile
constexpr int PS = BQ + 4;      // row stride of the transposed P tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// One 16-byte vector of T, widened to floats.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  static __device__ __forceinline__ void store4(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* f) {
    const int4 v = *reinterpret_cast<const int4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
  static __device__ __forceinline__ void store4(__nv_bfloat16* p, const float* f) {
    __nv_bfloat162 h[2] = {__float22bfloat162_rn(make_float2(f[0], f[1])),
                           __float22bfloat162_rn(make_float2(f[2], f[3]))};
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
  }
};

__device__ __forceinline__ int floordiv(int a, int b) {  // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// Reductions over the 16 lanes that share a query row (same half-warp).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// DV: 16-lane passes over the head dim in float4s (ceil(D / 64)).
template <typename T, int DV>
__global__ void __launch_bounds__(NT) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, int H, int KH, int D,
    int causal, int has_window, int window, int q_offset, float qscale) {
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;          // D x QS: the scaled query tile, transposed
  float* Kt = Qt + D * QS;   // D x KS: the key tile, transposed
  float* Vs = Kt + D * KS;   // BK x D: the value tile
  float* Pt = Vs + BK * D;   // BK x PS: probabilities, transposed

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // score block: rows ty*4.., keys tx*4..
  constexpr int VEC = Vec<T>::N;
  const int vecs = D / VEC;

  // Stage the query tile: rows vary fastest, so the transposed stores of a
  // warp land on consecutive words.
  const size_t q_stride = (size_t)H * D;  // elements between query positions
  const T* qb = q + ((size_t)b * Sq * H + h) * D;
  for (int i = tid; i < BQ * vecs; i += NT) {
    const int r = i % BQ, c = (i / BQ) * VEC;
    float f[VEC];
    if (q0 + r < Sq) {
      Vec<T>::load(qb + (size_t)(q0 + r) * q_stride + c, f);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) Qt[(c + e) * QS + r] = f[e] * qscale;
  }

  // The band of key tiles any query of this tile can see.
  const int n_kv = (Sk + BK - 1) / BK;
  const int q_last = min(q0 + BQ, Sq) - 1;
  int lo = 0, hi = n_kv;
  if (causal) hi = max(0, min(n_kv, floordiv(q_last + q_offset, BK) + 1));
  if (has_window) lo = max(0, floordiv(q0 + q_offset - window + 1, BK));

  float m[4], l[4], acc[4][DV][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int dv = 0; dv < DV; ++dv)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][dv][e] = 0.f;
  }

  const size_t kv_stride = (size_t)KH * D;  // elements between key positions
  const T* kb = k + ((size_t)b * Sk * KH + kh) * D;
  const T* vb = v + ((size_t)b * Sk * KH + kh) * D;

  for (int t = lo; t < hi; ++t) {
    const int k0 = t * BK;
    const int kn = min(BK, Sk - k0);
    __syncthreads();  // the previous tile is consumed (and Qt is written)
    for (int i = tid; i < BK * vecs; i += NT) {
      const int j = i % BK, c = (i / BK) * VEC;
      float f[VEC];
      if (j < kn) {
        Vec<T>::load(kb + (size_t)(k0 + j) * kv_stride + c, f);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) f[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) Kt[(c + e) * KS + j] = f[e];
    }
    for (int i = tid; i < BK * vecs; i += NT) {
      const int j = i / vecs, c = (i - j * vecs) * VEC;
      float f[VEC];
      if (j < kn) {
        Vec<T>::load(vb + (size_t)(k0 + j) * kv_stride + c, f);
      } else {  // zeros, never garbage: P is 0 there, and 0 * NaN is NaN
#pragma unroll
        for (int e = 0; e < VEC; ++e) f[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; e += 4)
        *reinterpret_cast<float4*>(Vs + j * D + c + e) =
            make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
    }
    __syncthreads();

    // Scores, in the log2 domain.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(Qt + d * QS + ty * 4);
      const float4 kv = *reinterpret_cast<const float4*>(Kt + d * KS + tx * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

    // Mask, then the online-softmax update of each of the 4 rows.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i + q_offset;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        const bool seen = kpos < Sk && (!causal || kpos <= qpos) &&
                          (!has_window || kpos > qpos - window);
        if (!seen) s[i][j] = -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
      const float mn = fmaxf(m[i], row_max(mt));
      const float ms = mn == -INFINITY ? 0.f : mn;  // no key seen yet: p = 0 below
      const float alpha = exp2f(m[i] - ms);          // 0 while m is -inf
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - ms);
        ps += s[i][j];
      }
      l[i] = l[i] * alpha + row_sum(ps);
      m[i] = mn;
#pragma unroll
      for (int dv = 0; dv < DV; ++dv)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][dv][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Pt + (tx * 4 + j) * PS + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc += P V over the tile's real keys.
    for (int j = 0; j < kn; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(Pt + j * PS + ty * 4);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int dv = 0; dv < DV; ++dv) {
        const int c = (tx + 16 * dv) * 4;
        if (c < D) {
          const float4 vv = *reinterpret_cast<const float4*>(Vs + j * D + c);
          const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][dv][e] = fmaf(pa[i], va[e], acc[i][dv][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;  // no key seen: 0
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * H + h) * Sq + r] = l[i] > 0.f ? (m[i] + log2f(l[i])) * LN2 : -INFINITY;
    T* ob = out + ((size_t)b * Sq + r) * q_stride + (size_t)h * D;
#pragma unroll
    for (int dv = 0; dv < DV; ++dv) {
      const int c = (tx + 16 * dv) * 4;
      if (c < D) {
        const float o[4] = {acc[i][dv][0] * inv, acc[i][dv][1] * inv,
                            acc[i][dv][2] * inv, acc[i][dv][3] * inv};
        Vec<T>::store4(ob + c, o);
      }
    }
  }
}


// ---------------------------------------------------------------------------
// bf16 on the tensor cores (D a multiple of 16)
// ---------------------------------------------------------------------------
constexpr int TC_BQ = 64;   // queries per CTA: 16 per warp
constexpr int TC_BK = 64;   // keys per shared-memory tile
constexpr int TC_NT = 128;  // 4 warps

using hopper::ldsm_x4;
using hopper::ldsm_x4_trans;
using hopper::mma_bf16;
using hopper::pack_bf16;

template <int D>
__global__ void __launch_bounds__(TC_NT) flash_attention_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int Sq, int Sk, int H, int KH, int causal, int has_window,
    int window, int q_offset, float qscale) {
  constexpr int RS = D + 8;  // row stride in elements: a 16-byte pad keeps ldmatrix conflict-free
  constexpr int NV = D / 8;  // 16-byte vectors per row
  constexpr int ND = D / 8;  // 8-wide column tiles of the output
  constexpr int KD = D / 16; // 16-deep steps of Q K^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // TC_BQ x RS
  __nv_bfloat16* Ks = Qs + TC_BQ * RS;                               // TC_BK x RS
  __nv_bfloat16* Vs = Ks + TC_BK * RS;                               // TC_BK x RS

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = qt * TC_BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row group and column pair
  const int lm = lane >> 3, lr = lane & 7; // ldmatrix: which 8 x 8 matrix, which of its rows

  const size_t q_stride = (size_t)H * D;
  const __nv_bfloat16* qb = q + ((size_t)b * Sq * H + h) * D;
  for (int i = tid; i < TC_BQ * NV; i += TC_NT) {
    const int r = i / NV, c = (i - r * NV) * 8;
    int4 val = make_int4(0, 0, 0, 0);
    if (q0 + r < Sq) val = *reinterpret_cast<const int4*>(qb + (size_t)(q0 + r) * q_stride + c);
    *reinterpret_cast<int4*>(Qs + r * RS + c) = val;
  }

  const int n_kv = (Sk + TC_BK - 1) / TC_BK;
  const int q_last = min(q0 + TC_BQ, Sq) - 1;
  int lo = 0, hi = n_kv;
  if (causal) hi = max(0, min(n_kv, floordiv(q_last + q_offset, TC_BK) + 1));
  if (has_window) lo = max(0, floordiv(q0 + q_offset - window + 1, TC_BK));

  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0 and row0 + 8

  const size_t kv_stride = (size_t)KH * D;
  const __nv_bfloat16* kb = k + ((size_t)b * Sk * KH + kh) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * Sk * KH + kh) * D;

  for (int t = lo; t < hi; ++t) {
    const int k0 = t * TC_BK;
    const int kn = min(TC_BK, Sk - k0);
    __syncthreads();  // the previous tile is consumed (and Qs is written)
    for (int i = tid; i < TC_BK * NV; i += TC_NT) {
      const int j = i / NV, c = (i - j * NV) * 8;
      int4 kv4 = make_int4(0, 0, 0, 0), vv4 = make_int4(0, 0, 0, 0);
      if (j < kn) {  // zeros past Sk, never garbage: P is 0 there, and 0 * NaN is NaN
        kv4 = *reinterpret_cast<const int4*>(kb + (size_t)(k0 + j) * kv_stride + c);
        vv4 = *reinterpret_cast<const int4*>(vb + (size_t)(k0 + j) * kv_stride + c);
      }
      *reinterpret_cast<int4*>(Ks + j * RS + c) = kv4;
      *reinterpret_cast<int4*>(Vs + j * RS + c) = vv4;
    }
    __syncthreads();

    // S (16 x 64 per warp) = Q K^T
    float s[8][4];
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nj][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      ldsm_x4(a[0], a[1], a[2], a[3], Qs + (warp * 16 + lr + 8 * (lm & 1)) * RS + kk * 16 + 8 * (lm >> 1));
#pragma unroll
      for (int nj = 0; nj < 8; nj += 2) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(b0, b1, b2, b3, Ks + (nj * 8 + lr + 8 * (lm >> 1)) * RS + kk * 16 + 8 * (lm & 1));
        mma_bf16(s[nj], a, b0, b1);
        mma_bf16(s[nj + 1], a, b2, b3);
      }
    }

    // Mask, scale into the exp2 domain, online-softmax update of both rows.
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int qpos = row0 + 8 * hf + q_offset;
      float mt = -INFINITY;
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + nj * 8 + 2 * t4 + e;
          const bool seen = kpos < Sk && (!causal || kpos <= qpos) &&
                            (!has_window || kpos > qpos - window);
          const float x = seen ? s[nj][2 * hf + e] * qscale : -INFINITY;
          s[nj][2 * hf + e] = x;
          mt = fmaxf(mt, x);
        }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float mn = fmaxf(m[hf], mt);
      const float ms = mn == -INFINITY ? 0.f : mn;  // no key seen yet: p = 0 below
      const float alpha = exp2f(m[hf] - ms);         // 0 while m is -inf
      float ps = 0.f;
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
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

    // O (16 x D per warp) += P V, P from the score accumulators
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(b0, b1, b2, b3, Vs + (kk * 16 + lr + 8 * (lm & 1)) * RS + nd * 8 + 8 * (lm >> 1));
        mma_bf16(o[nd], a, b0, b1);
        mma_bf16(o[nd + 1], a, b2, b3);
      }
    }
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row0 + 8 * hf;
    if (r >= Sq) continue;
    const float inv = l[hf] > 0.f ? 1.f / l[hf] : 0.f;  // no key seen: 0
    if (lse != nullptr && t4 == 0)
      lse[((size_t)b * H + h) * Sq + r] = l[hf] > 0.f ? (m[hf] + log2f(l[hf])) * LN2 : -INFINITY;
    __nv_bfloat16* ob = out + ((size_t)b * Sq + r) * q_stride + (size_t)h * D;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(ob + nd * 8 + 2 * t4) =
          __floats2bfloat162_rn(o[nd][2 * hf] * inv, o[nd][2 * hf + 1] * inv);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                       int Sq, int Sk, int H, int KH, int causal, int has_window, int window,
                       int q_offset, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)(TC_BQ + 2 * TC_BK) * (D + 8);
  auto kernel = flash_attention_mma_kernel<D>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const float qscale = LOG2E / sqrtf((float)D);
  dim3 grid((Sq + TC_BQ - 1) / TC_BQ, H, B);
  kernel<<<grid, TC_NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse, Sq, Sk, H,
      KH, causal, has_window, window, q_offset, qscale);
  return cudaGetLastError();
}

cudaError_t launch_mma_dim(const void* q, const void* k, const void* v, void* out, float* lse,
                           int B, int Sq, int Sk, int H, int KH, int D, int causal,
                           int has_window, int window, int q_offset, cudaStream_t s) {
#define FA_MMA_CASE(DD) \
  case DD: return launch_mma<DD>(q, k, v, out, lse, B, Sq, Sk, H, KH, causal, has_window, window, q_offset, s);
  switch (D) {
    FA_MMA_CASE(16) FA_MMA_CASE(32) FA_MMA_CASE(48) FA_MMA_CASE(64)
    FA_MMA_CASE(80) FA_MMA_CASE(96) FA_MMA_CASE(112) FA_MMA_CASE(128)
    FA_MMA_CASE(144) FA_MMA_CASE(160) FA_MMA_CASE(176) FA_MMA_CASE(192)
    FA_MMA_CASE(208) FA_MMA_CASE(224) FA_MMA_CASE(240) FA_MMA_CASE(256)
    default: return cudaErrorInvalidValue;
  }
#undef FA_MMA_CASE
}

// ---------------------------------------------------------------------------
// bf16 on wgmma, fed by TMA (D in {64, 128, 192, 256})
// ---------------------------------------------------------------------------
namespace wg {

constexpr int BQ = 128;      // queries per CTA: two consumer warpgroups of 64
constexpr int THREADS = 384; // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int STAGES = 2;

template <int D>
struct Cfg {
  static constexpr int BKV = D <= 64 ? 128 : 64;  // keys per tile (see the note on registers)
  static constexpr int NB = D / 64;                // 64-wide column blocks of a row
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BKV * D * 2;
  static constexpr int SMEM = 1024 /* alignment */ + Q_BYTES + 2 * STAGES * KV_BYTES +
                              (1 + 3 * STAGES) * 8;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int Sq, int Sk, int H, int KH, int causal, int has_window,
    int window, int q_offset, float qscale) {
  using C = Cfg<D>;
  constexpr int BKV = C::BKV, NB = C::NB;
  extern __shared__ __align__(16) uint8_t wg_smem[];  // aligned here to 1024 bytes
  uint8_t* smem = wg_smem + ((1024 - (hopper::smem_addr(wg_smem) & 1023)) & 1023);
  uint8_t* Qs = smem;                          // NB blocks of BQ rows x 128 bytes
  uint8_t* Ks = Qs + C::Q_BYTES;               // STAGES x NB blocks of BKV rows x 128 bytes
  uint8_t* Vs = Ks + STAGES * C::KV_BYTES;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(Vs + STAGES * C::KV_BYTES);
  uint64_t* kfull = qbar + 1;
  uint64_t* vfull = kfull + STAGES;
  uint64_t* empty = vfull + STAGES;

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;

  // The band of key tiles any query of this tile can see.
  const int n_kv = (Sk + BKV - 1) / BKV;
  const int q_last = min(q0 + BQ, Sq) - 1;
  int lo = 0, hi = n_kv;
  if (causal) hi = max(0, min(n_kv, floordiv(q_last + q_offset, BKV) + 1));
  if (has_window) lo = max(0, floordiv(q0 + q_offset - window + 1, BKV));

  if (tid == 0) {
    hopper::mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&kfull[s], 1);
      hopper::mbar_init(&vfull[s], 1);
      hopper::mbar_init(&empty[s], 2 * 128);  // every consumer thread releases a stage
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // The role of this thread's warpgroup, uniform across each warp as the
  // compiler can see, so that it sizes each role's registers by setmaxnreg.
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == 2) {  // producer warpgroup: one thread issues every load
    hopper::regs_dealloc<40>();
    if (tid == 2 * 128) {
      hopper::mbar_arrive_expect_tx(qbar, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < NB; ++c)
        hopper::tma_load_4d(Qs + c * BQ * 128, &qmap, qbar, 64 * c, h, q0, b);
      for (int t = lo, it = 0; t < hi; ++t, ++it) {
        const int s = it % STAGES;
        hopper::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        uint8_t* ks = Ks + s * C::KV_BYTES;
        uint8_t* vs = Vs + s * C::KV_BYTES;
        hopper::mbar_arrive_expect_tx(&kfull[s], C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < NB; ++c)
          hopper::tma_load_4d(ks + c * BKV * 128, &kmap, &kfull[s], 64 * c, kh, t * BKV, b);
        hopper::mbar_arrive_expect_tx(&vfull[s], C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < NB; ++c)
          hopper::tma_load_4d(vs + c * BKV * 128, &vmap, &vfull[s], 64 * c, kh, t * BKV, b);
      }
    }
  } else {  // consumer warpgroups
    hopper::regs_alloc<232>();
    const int wgi = tid >> 7, t128 = tid & 127, lane = t128 & 31, c4 = lane & 3;
    const int row0 = wgi * 64 + (t128 >> 5) * 16 + (lane >> 2);  // rows row0 and row0 + 8
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    hopper::mbar_wait(qbar, 0);

    for (int t = lo, it = 0; t < hi; ++t, ++it) {
      const int s = it % STAGES, ph = (it / STAGES) & 1;
      const uint8_t* ks = Ks + s * C::KV_BYTES;
      const uint8_t* vs = Vs + s * C::KV_BYTES;

      // S (64 x BKV per warpgroup) = Q K^T
      float sc[BKV / 2];
      hopper::mbar_wait(&kfull[s], ph);
      hopper::wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        const uint64_t da = hopper::desc_sw128(
            Qs + (kd >> 2) * BQ * 128 + wgi * 64 * 128 + (kd & 3) * 32, 16, 1024);
        const uint64_t db =
            hopper::desc_sw128(ks + (kd >> 2) * BKV * 128 + (kd & 3) * 32, 16, 1024);
        hopper::wgmma_ss<BKV, 0>(sc, da, db, kd > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);

      // Mask (on the tiles that straddle an edge), scale into the exp2
      // domain, and the online-softmax update of both rows.
      const int k0 = t * BKV;
      const bool edge = k0 + BKV > Sk || (causal && k0 + BKV - 1 > q0 + q_offset) ||
                        (has_window && k0 <= q_last + q_offset - window);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int qpos = q0 + row0 + 8 * hf + q_offset;
        float mt = -INFINITY;
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = sc[4 * j + 2 * hf + e] * qscale;
            if (edge) {
              const int kpos = k0 + 8 * j + 2 * c4 + e;
              const bool seen = kpos < Sk && (!causal || kpos <= qpos) &&
                                (!has_window || kpos > qpos - window);
              if (!seen) x = -INFINITY;
            }
            sc[4 * j + 2 * hf + e] = x;
            mt = fmaxf(mt, x);
          }
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        const float mn = fmaxf(m[hf], mt);
        const float ms = mn == -INFINITY ? 0.f : mn;  // no key seen yet: p = 0 below
        const float alpha = exp2f(m[hf] - ms);         // 0 while m is -inf
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(sc[4 * j + 2 * hf + e] - ms);
            sc[4 * j + 2 * hf + e] = p;
            ps += p;
          }
        ps += __shfl_xor_sync(0xffffffffu, ps, 1);
        ps += __shfl_xor_sync(0xffffffffu, ps, 2);
        l[hf] = l[hf] * alpha + ps;
        m[hf] = mn;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j + 2 * hf] *= alpha;
          o[4 * j + 2 * hf + 1] *= alpha;
        }
      }

      // O (64 x D per warpgroup) += P V, P from the score registers
      uint32_t pa[BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
      hopper::mbar_wait(&vfull[s], ph);
      hopper::fence_regs(o);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const uint64_t db = hopper::desc_sw128(vs + kk * 16 * 128, BKV * 128, 1024);
        hopper::wgmma_rs<D, 1>(o, pa[kk], db, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      hopper::mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = q0 + row0 + 8 * hf;
      if (r >= Sq) continue;
      const float inv = l[hf] > 0.f ? 1.f / l[hf] : 0.f;  // no key seen: 0
      if (lse != nullptr && c4 == 0)
        lse[((size_t)b * H + h) * Sq + r] = l[hf] > 0.f ? (m[hf] + log2f(l[hf])) * LN2 : -INFINITY;
      __nv_bfloat16* ob = out + (((size_t)b * Sq + r) * H + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(ob + 8 * j + 2 * c4) =
            __floats2bfloat162_rn(o[4 * j + 2 * hf] * inv, o[4 * j + 2 * hf + 1] * inv);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                   int Sq, int Sk, int H, int KH, int causal, int has_window, int window,
                   int q_offset, cudaStream_t stream) {
  using C = Cfg<D>;
  if (Sk == 0 && lse != nullptr) return cudaErrorInvalidValue;  // the wrapper fills it
  if (Sk == 0)  // no key: every query gives 0
    return cudaMemsetAsync(out, 0, (size_t)B * Sq * H * D * 2, stream);
  CUtensorMap qmap, kmap, vmap;
  const cuuint64_t qdims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)Sq, (cuuint64_t)B};
  const cuuint64_t qstrides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                  (cuuint64_t)Sq * H * D * 2};
  const cuuint32_t qbox[4] = {64, 1, BQ, 1};
  const cuuint64_t kdims[4] = {(cuuint64_t)D, (cuuint64_t)KH, (cuuint64_t)Sk, (cuuint64_t)B};
  const cuuint64_t kstrides[3] = {(cuuint64_t)D * 2, (cuuint64_t)KH * D * 2,
                                  (cuuint64_t)Sk * KH * D * 2};
  const cuuint32_t kbox[4] = {64, 1, (cuuint32_t)C::BKV, 1};
  cudaError_t e = hopper::encode_bf16_map(&qmap, q, 4, qdims, qstrides, qbox);
  if (e == cudaSuccess) e = hopper::encode_bf16_map(&kmap, k, 4, kdims, kstrides, kbox);
  if (e == cudaSuccess) e = hopper::encode_bf16_map(&vmap, v, 4, kdims, kstrides, kbox);
  if (e != cudaSuccess) return e;
  auto kernel = flash_wgmma_kernel<D>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return e;
  const float qscale = LOG2E / sqrtf((float)D);
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, C::SMEM, stream>>>(qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out),
                                             lse, Sq, Sk, H, KH, causal, has_window, window,
                                             q_offset, qscale);
  return cudaGetLastError();
}

cudaError_t launch_dim(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                       int Sq, int Sk, int H, int KH, int D, int causal, int has_window,
                       int window, int q_offset, cudaStream_t s) {
  switch (D) {
    case 64: return launch<64>(q, k, v, out, lse, B, Sq, Sk, H, KH, causal, has_window, window, q_offset, s);
    case 128: return launch<128>(q, k, v, out, lse, B, Sq, Sk, H, KH, causal, has_window, window, q_offset, s);
    case 192: return launch<192>(q, k, v, out, lse, B, Sq, Sk, H, KH, causal, has_window, window, q_offset, s);
    case 256: return launch<256>(q, k, v, out, lse, B, Sq, Sk, H, KH, causal, has_window, window, q_offset, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wg

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)D * QS + (size_t)D * KS + (size_t)BK * D + (size_t)BK * PS);
}

template <typename T, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                   int Sq, int Sk, int H, int KH, int D, int causal, int has_window, int window,
                   int q_offset, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  auto kernel = flash_attention_kernel<T, DV>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const float qscale = LOG2E / sqrtf((float)D);
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, Sq, Sk, H, KH, D, causal, has_window, window, q_offset, qscale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                         int Sq, int Sk, int H, int KH, int D, int causal, int has_window,
                         int window, int q_offset, cudaStream_t s) {
  switch ((D + 63) / 64) {
    case 1: return launch<T, 1>(q, k, v, out, lse, B, Sq, Sk, H, KH, D, causal, has_window, window, q_offset, s);
    case 2: return launch<T, 2>(q, k, v, out, lse, B, Sq, Sk, H, KH, D, causal, has_window, window, q_offset, s);
    case 3: return launch<T, 3>(q, k, v, out, lse, B, Sq, Sk, H, KH, D, causal, has_window, window, q_offset, s);
    default: return launch<T, 4>(q, k, v, out, lse, B, Sq, Sk, H, KH, D, causal, has_window, window, q_offset, s);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Dynamic shared memory of the wgmma body at head dim D (0: no such body).
extern "C" int flash_attention_wgmma_smem_bytes(int D) {
  switch (D) {
    case 64: return wg::Cfg<64>::SMEM;
    case 128: return wg::Cfg<128>::SMEM;
    case 192: return wg::Cfg<192>::SMEM;
    case 256: return wg::Cfg<256>::SMEM;
    default: return 0;
  }
}

// q (B, Sq, H, D), k/v (B, Sk, KH, D), out (B, Sq, H, D): contiguous, of one
// dtype (0 = fp32, 1 = bf16).  lse: null, or (B, H, Sq) fp32 for each
// query's log-sum-exp (with Sk > 0).  D at most 256 and a whole number of
// 16-byte vectors; H a multiple of KH.  body: 0 = fp32, 1 = mma, 2 = wgmma
// (see the note at the top); a body that cannot take these inputs is
// refused.  Returns a cudaError_t code, 0 on success.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      float* lse, int B, int Sq, int Sk, int H, int KH, int D,
                                      int causal, int has_window, int window, int q_offset,
                                      int dtype, int body, void* stream) {
  const int itemsize = dtype == 0 ? 4 : 2;
  if (B < 0 || Sq < 0 || Sk < 0 || KH <= 0 || H % KH != 0 || D <= 0 || D > 256 ||
      (D * itemsize) % 16 != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const bool ok = body == 0 ? true
                : body == 1 ? dtype == 1 && D % 16 == 0
                : body == 2 ? dtype == 1 && D % 64 == 0 && D != 0 && aligned16(q) &&
                                  aligned16(k) && aligned16(v) && aligned16(out)
                : false;
  if (!ok) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (body == 2)
    e = wg::launch_dim(q, k, v, out, lse, B, Sq, Sk, H, KH, D, causal, has_window, window, q_offset, s);
  else if (body == 1)
    e = launch_mma_dim(q, k, v, out, lse, B, Sq, Sk, H, KH, D, causal, has_window, window, q_offset, s);
  else if (dtype == 0)
    e = launch_dtype<float>(q, k, v, out, lse, B, Sq, Sk, H, KH, D, causal, has_window, window, q_offset, s);
  else
    e = launch_dtype<__nv_bfloat16>(q, k, v, out, lse, B, Sq, Sk, H, KH, D, causal, has_window, window, q_offset, s);
  return (int)e;
}
