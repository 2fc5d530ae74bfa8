// The backward of blocked (flash) attention for Hopper (sm_90a), fp32 and
// bf16.
//
// The TPU side has no such kernel: the reference takes the gradient of
// src/repro/kernels/flash_attention.py::flash_attention (no custom_vjp) as
// XLA's compiled gradient.  Here the forward kernel (flash_attention.cu)
// runs on the card's training path, so its gradient is a kernel too.  For
// q (B, Sq, H, D), k/v (B, Sk, KH, D), the forward's output o and dO
// (B, Sq, H, D), and the forward's log-sum-exp lse (B, H, Sq) fp32, it
// computes, with G = H / KH and the forward's masks (j < Sk; j <= i +
// q_offset when causal; j > i + q_offset - window with a window):
//
//     delta[b,h,i] = sum_d dO[b,i,h,d] o[b,i,h,d]                  (pass 1)
//     P[i,j]  = exp(q_i . k_j * D^-1/2 - lse_i)       (0 where j is masked)
//     dP[i,j] = dO_i . v_j,   dS[i,j] = P[i,j] (dP[i,j] - delta_i)
//     dv_j = sum_{h in group} sum_i P[i,j] dO_i                     (pass 2)
//     dk_j = sum_{h in group} sum_i dS[i,j] q_i * D^-1/2            (pass 2)
//     dq_i = sum_j dS[i,j] k_j * D^-1/2                              (pass 3)
//
// A query that sees no key has lse = -inf: its P is 0 (never exp of NaN),
// so its dq is 0 and it adds nothing to dk and dv.
//
// What bounds it: operations.  Each visible (query, key) pair and head
// costs 2·D flops in each of seven products (S and dP in pass 2, S and dP
// again in pass 3, dV, dK, dQ): 14·D, of which the least work is 10·D (the
// second S and dP are the price of having no atomics), against reading q,
// k, v, o, dO once and writing dq, dk, dv once.  At NeMo's training shape
// (S = 2048, D = 128, causal) that is well above the card's ridge in bf16.
//
// What the design does about it: no atomics, so gradients repeat bit for
// bit from run to run.
// * Pass 2 (dK, dV): one CTA per (key tile, KV head, batch row).  It loops
//   over the G query heads of its group and over the query tiles that see
//   its key tile (the band: the forward's loop bound turned around), so the
//   group's dk and dv are summed inside the CTA.  It recomputes S^T = K Q^T
//   and P^T, then dV += P^T dO (P rounded to bf16, as the forward rounds it
//   before P V), dP^T = V dO^T, dS^T = P^T (dP^T - delta), dK += dS^T Q.
// * Pass 3 (dQ): one CTA per (query tile, head, batch row), longest tiles
//   first, over the key tiles its queries see: S = Q K^T, P, dP = dO V^T,
//   dS, dQ += dS K.
// Two bodies, chosen by the caller (kernels/flash_attention_bwd.py):
// * mma (bf16, D a multiple of 16 up to 128): 64-row tiles on 4 warps of
//   16 rows; every product is mma.sync m16n8k16 with fp32 sums, fed by
//   ldmatrix (transposed for the operands whose reduction runs down the
//   tile's rows) from shared tiles padded by 16 bytes a row; P and dS are
//   rounded to bf16 in registers as the A operand of the next product.  The
//   dK and dV sums (pass 2) and dQ (pass 3) stay in registers.
// * fp32 (fp32, and bf16 head dims mma does not take): the CUDA cores in
//   fp32, 32-row tiles on 256 threads, every tile in shared memory.
//
// What it does not do yet: wgmma, TMA, a persistent grid, or more than one
// CTA per KV head's group for MQA (granite's 48 query heads share one KV
// head, so pass 2 runs 48 heads in one CTA per key tile).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC -I csrc; bound through a plain C entry point.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ int floordiv(int a, int b) {  // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ bool seen(int qpos, int kpos, int Sk, int causal, int has_window,
                                     int window) {
  return kpos < Sk && (!causal || kpos <= qpos) && (!has_window || kpos > qpos - window);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The first and last (exclusive) query a key tile [k0, k_last] is seen by.
__device__ __forceinline__ void query_band(int k0, int k_last, int Sq, int causal,
                                           int has_window, int window, int q_offset, int* lo,
                                           int* hi) {
  *lo = causal ? max(0, k0 - q_offset) : 0;
  *hi = has_window ? min(Sq, k_last - q_offset + window) : Sq;
}

// ---------------------------------------------------------------------------
// pass 1: delta = rowsum(dO * O), one warp per (b, i, h) row
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256) bwd_delta_kernel(const T* __restrict__ o,
                                                        const T* __restrict__ dO,
                                                        float* __restrict__ delta, int B,
                                                        int Sq, int H, int D) {
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= (long long)B * Sq * H) return;  // whole warps leave together
  const T* op = o + row * D;
  const T* dp = dO + row * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(to_f(op[c]), to_f(dp[c]), acc);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) {
    const int h = (int)(row % H);
    const long long bi = row / H;
    const int i = (int)(bi % Sq), b = (int)(bi / Sq);
    delta[((size_t)b * H + h) * Sq + i] = acc;
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (D a multiple of 16, at most 128)
// ---------------------------------------------------------------------------
constexpr int TC = 64;      // rows of every tile: 16 per warp
constexpr int TC_NT = 128;  // 4 warps

using hopper::ldsm_x4;
using hopper::ldsm_x4_trans;
using hopper::mma_bf16;
using hopper::pack_bf16;
using bf16 = __nv_bfloat16;

// Loads rows [r0, r0 + TC) of a (rows, stride) bf16 matrix into a padded
// shared tile, zeros past n_rows.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, size_t stride, int r0,
                                          int n_rows, int tid) {
  constexpr int RS = D + 8, NV = D / 8;
  for (int i = tid; i < TC * NV; i += TC_NT) {
    const int r = i / NV, c = (i - r * NV) * 8;
    int4 val = make_int4(0, 0, 0, 0);  // zeros, never garbage: 0 * NaN is NaN
    if (r0 + r < n_rows) val = *reinterpret_cast<const int4*>(src + (size_t)(r0 + r) * stride + c);
    *reinterpret_cast<int4*>(dst + r * RS + c) = val;
  }
}

// acc (16 x 64 per warp) = A_rows (16 x D, this warp's rows of tile A) . B^T
// (B: 64 rows x D): the forward's S = Q K^T.
template <int D>
__device__ __forceinline__ void rows_dot_rows(float (&acc)[8][4], const bf16* A, const bf16* Bt,
                                              int warp, int lm, int lr) {
  constexpr int RS = D + 8;
#pragma unroll
  for (int nj = 0; nj < 8; ++nj)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nj][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a[0], a[1], a[2], a[3], A + (warp * 16 + lr + 8 * (lm & 1)) * RS + kk * 16 + 8 * (lm >> 1));
#pragma unroll
    for (int nj = 0; nj < 8; nj += 2) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4(b0, b1, b2, b3, Bt + (nj * 8 + lr + 8 * (lm >> 1)) * RS + kk * 16 + 8 * (lm & 1));
      mma_bf16(acc[nj], a, b0, b1);
      mma_bf16(acc[nj + 1], a, b2, b3);
    }
  }
}

// acc (16 x D per warp) += X (16 x 64, fp32 fragments of rows_dot_rows,
// rounded to bf16) . M (M: 64 rows x D): the forward's O += P V.
template <int D>
__device__ __forceinline__ void frag_dot_tile(float (&acc)[D / 8][4], const float (&x)[8][4],
                                              const bf16* M, int lm, int lr) {
  constexpr int RS = D + 8;
#pragma unroll
  for (int kk = 0; kk < TC / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int nd = 0; nd < D / 8; nd += 2) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_trans(b0, b1, b2, b3, M + (kk * 16 + lr + 8 * (lm & 1)) * RS + nd * 8 + 8 * (lm >> 1));
      mma_bf16(acc[nd], a, b0, b1);
      mma_bf16(acc[nd + 1], a, b2, b3);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(TC_NT) bwd_dkdv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dO, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk, int H, int KH, int causal,
    int has_window, int window, int q_offset, float scale_log2, float scale) {
  constexpr int RS = D + 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // TC x RS each
  bf16* Vs = Ks + TC * RS;
  bf16* Qs = Vs + TC * RS;
  bf16* dOs = Qs + TC * RS;
  float* Ls = reinterpret_cast<float*>(dOs + TC * RS);  // lse * log2(e) of the query tile
  float* Ds = Ls + TC;                                  // delta of the query tile

  const int kh = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * TC;
  const int G = H / KH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, lm = lane >> 3, lr = lane & 7;

  const size_t kv_stride = (size_t)KH * D, q_stride = (size_t)H * D;
  load_tile<D>(Ks, k + ((size_t)b * Sk * KH + kh) * D, kv_stride, k0, Sk, tid);
  load_tile<D>(Vs, v + ((size_t)b * Sk * KH + kh) * D, kv_stride, k0, Sk, tid);

  int qlo, qhi;
  query_band(k0, min(k0 + TC, Sk) - 1, Sq, causal, has_window, window, q_offset, &qlo, &qhi);
  const int t_lo = qlo / TC, t_hi = qhi > qlo ? (qhi + TC - 1) / TC : t_lo;

  float dkacc[ND][4], dvacc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkacc[nd][e] = dvacc[nd][e] = 0.f;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0 and key0 + 8

  for (int gi = 0; gi < G; ++gi) {
    const int h = kh * G + gi;
    const bf16* qb = q + ((size_t)b * Sq * H + h) * D;
    const bf16* db = dO + ((size_t)b * Sq * H + h) * D;
    const float* lb = lse + ((size_t)b * H + h) * Sq;
    const float* deb = delta + ((size_t)b * H + h) * Sq;
    for (int t = t_lo; t < t_hi; ++t) {
      const int q0 = t * TC;
      __syncthreads();  // the previous tile is consumed
      load_tile<D>(Qs, qb, q_stride, q0, Sq, tid);
      load_tile<D>(dOs, db, q_stride, q0, Sq, tid);
      for (int r = tid; r < TC; r += TC_NT) {
        const bool in = q0 + r < Sq;
        Ls[r] = in ? lb[q0 + r] * LOG2E : -INFINITY;
        Ds[r] = in ? deb[q0 + r] : 0.f;
      }
      __syncthreads();

      // S^T (16 keys x 64 queries per warp) = K Q^T, then P^T in place
      float s[8][4];
      rows_dot_rows<D>(s, Ks, Qs, warp, lm, lr);
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = key0 + 8 * (e >> 1);
          const int qi = nj * 8 + 2 * t4 + (e & 1);
          const float L = Ls[qi];
          const bool on = L != -INFINITY &&
                          seen(q0 + qi + q_offset, kpos, Sk, causal, has_window, window);
          s[nj][e] = on ? exp2f(s[nj][e] * scale_log2 - L) : 0.f;
        }
      // dP^T = V dO^T, then dS^T = P^T (dP^T - delta) in place
      float dp[8][4];
      rows_dot_rows<D>(dp, Vs, dOs, warp, lm, lr);
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[nj][e] = s[nj][e] * (dp[nj][e] - Ds[nj * 8 + 2 * t4 + (e & 1)]);
      frag_dot_tile<D>(dvacc, s, dOs, lm, lr);   // dV += P^T dO
      frag_dot_tile<D>(dkacc, dp, Qs, lm, lr);   // dK += dS^T Q
    }
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int kpos = key0 + 8 * hf;
    if (kpos >= Sk) continue;
    const size_t base = (((size_t)b * Sk + kpos) * KH + kh) * D;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      *reinterpret_cast<__nv_bfloat162*>(dk + base + nd * 8 + 2 * t4) =
          __floats2bfloat162_rn(dkacc[nd][2 * hf] * scale, dkacc[nd][2 * hf + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + base + nd * 8 + 2 * t4) =
          __floats2bfloat162_rn(dvacc[nd][2 * hf], dvacc[nd][2 * hf + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(TC_NT) bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dO, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int Sq, int Sk, int H, int KH, int causal, int has_window, int window,
    int q_offset, float scale_log2, float scale) {
  constexpr int RS = D + 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // TC x RS each
  bf16* dOs = Qs + TC * RS;
  bf16* Ks = dOs + TC * RS;
  bf16* Vs = Ks + TC * RS;

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = qt * TC;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, lm = lane >> 3, lr = lane & 7;

  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)KH * D;
  load_tile<D>(Qs, q + ((size_t)b * Sq * H + h) * D, q_stride, q0, Sq, tid);
  load_tile<D>(dOs, dO + ((size_t)b * Sq * H + h) * D, q_stride, q0, Sq, tid);
  const int row0 = q0 + warp * 16 + g;  // this thread's queries: row0 and row0 + 8
  float L[2], Dl[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row0 + 8 * hf;
    L[hf] = r < Sq ? lse[((size_t)b * H + h) * Sq + r] * LOG2E : -INFINITY;
    Dl[hf] = r < Sq ? delta[((size_t)b * H + h) * Sq + r] : 0.f;
  }

  // the band of key tiles any query of this tile sees (the forward's)
  const int n_kv = (Sk + TC - 1) / TC;
  const int q_last = min(q0 + TC, Sq) - 1;
  int lo = 0, hi = n_kv;
  if (causal) hi = max(0, min(n_kv, floordiv(q_last + q_offset, TC) + 1));
  if (has_window) lo = max(0, floordiv(q0 + q_offset - window + 1, TC));

  float dqacc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqacc[nd][e] = 0.f;
  const bf16* kb = k + ((size_t)b * Sk * KH + kh) * D;
  const bf16* vb = v + ((size_t)b * Sk * KH + kh) * D;

  for (int t = lo; t < hi; ++t) {
    const int k0 = t * TC;
    __syncthreads();  // the previous tile is consumed (and Q, dO are written)
    load_tile<D>(Ks, kb, kv_stride, k0, Sk, tid);
    load_tile<D>(Vs, vb, kv_stride, k0, Sk, tid);
    __syncthreads();

    float s[8][4], dp[8][4];
    rows_dot_rows<D>(s, Qs, Ks, warp, lm, lr);   // S = Q K^T
    rows_dot_rows<D>(dp, dOs, Vs, warp, lm, lr); // dP = dO V^T
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1;
        const int kpos = k0 + nj * 8 + 2 * t4 + (e & 1);
        const bool on = L[hf] != -INFINITY &&
                        seen(row0 + 8 * hf + q_offset, kpos, Sk, causal, has_window, window);
        const float p = on ? exp2f(s[nj][e] * scale_log2 - L[hf]) : 0.f;
        dp[nj][e] = p * (dp[nj][e] - Dl[hf]);   // dS
      }
    frag_dot_tile<D>(dqacc, dp, Ks, lm, lr);    // dQ += dS K
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row0 + 8 * hf;
    if (r >= Sq) continue;
    bf16* out = dq + (((size_t)b * Sq + r) * H + h) * D;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(out + nd * 8 + 2 * t4) =
          __floats2bfloat162_rn(dqacc[nd][2 * hf] * scale, dqacc[nd][2 * hf + 1] * scale);
  }
}

size_t mma_smem_bytes(int D) {
  return sizeof(bf16) * 4 * (size_t)TC * (D + 8) + 2 * TC * sizeof(float);
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* dO,
                       const float* lse, const float* delta, void* dq, void* dk, void* dv, int B,
                       int Sq, int Sk, int H, int KH, int causal, int has_window, int window,
                       int q_offset, cudaStream_t s) {
  const size_t smem = mma_smem_bytes(D);
  auto k_dkdv = bwd_dkdv_mma_kernel<D>;
  auto k_dq = bwd_dq_mma_kernel<D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(k_dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(k_dq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const float scale = 1.f / sqrtf((float)D), scale_log2 = LOG2E * scale;
  const bf16 *qq = static_cast<const bf16*>(q), *kk = static_cast<const bf16*>(k),
             *vv = static_cast<const bf16*>(v), *dd = static_cast<const bf16*>(dO);
  k_dkdv<<<dim3((Sk + TC - 1) / TC, KH, B), TC_NT, smem, s>>>(
      qq, kk, vv, dd, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Sk, H, KH,
      causal, has_window, window, q_offset, scale_log2, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  k_dq<<<dim3((Sq + TC - 1) / TC, H, B), TC_NT, smem, s>>>(
      qq, kk, vv, dd, lse, delta, static_cast<bf16*>(dq), Sq, Sk, H, KH, causal, has_window,
      window, q_offset, scale_log2, scale);
  return cudaGetLastError();
}

cudaError_t launch_mma_dim(const void* q, const void* k, const void* v, const void* dO,
                           const float* lse, const float* delta, void* dq, void* dk, void* dv,
                           int B, int Sq, int Sk, int H, int KH, int D, int causal,
                           int has_window, int window, int q_offset, cudaStream_t s) {
#define FB_MMA_CASE(DD)                                                                        \
  case DD:                                                                                     \
    return launch_mma<DD>(q, k, v, dO, lse, delta, dq, dk, dv, B, Sq, Sk, H, KH, causal,       \
                          has_window, window, q_offset, s);
  switch (D) {
    FB_MMA_CASE(16) FB_MMA_CASE(32) FB_MMA_CASE(48) FB_MMA_CASE(64)
    FB_MMA_CASE(80) FB_MMA_CASE(96) FB_MMA_CASE(112) FB_MMA_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef FB_MMA_CASE
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores (any dtype and head dim the entry takes)
// ---------------------------------------------------------------------------
constexpr int FT = 32;   // rows of every tile
constexpr int F_NT = 256;

// Rows [r0, r0 + FT) of a (rows, stride) matrix into a (FT, D + 1) fp32
// shared tile, zeros past n_rows.
template <typename T>
__device__ __forceinline__ void load_f32(float* dst, const T* src, size_t stride, int r0,
                                         int n_rows, int D, int tid) {
  for (int i = tid; i < FT * D; i += F_NT) {
    const int r = i / D, c = i - r * D;
    dst[r * (D + 1) + c] = r0 + r < n_rows ? to_f(src[(size_t)(r0 + r) * stride + c]) : 0.f;
  }
}

// DU: columns each thread owns, c = (tid & 7) + 8 u for u < DU (D <= 8 DU).
template <typename T, int DU>
__global__ void __launch_bounds__(F_NT) bwd_dkdv_f32_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dO, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H, int KH, int D, int causal,
    int has_window, int window, int q_offset, float scale_log2, float scale) {
  extern __shared__ __align__(16) float fsm[];
  const int RS = D + 1;
  float* Ks = fsm;            // FT x RS each
  float* Vs = Ks + FT * RS;
  float* Qs = Vs + FT * RS;
  float* dOs = Qs + FT * RS;
  float* Ps = dOs + FT * RS;  // FT x (FT + 1): P^T (keys x queries)
  float* dSs = Ps + FT * (FT + 1);
  float* Ls = dSs + FT * (FT + 1);
  float* Ds = Ls + FT;

  const int kh = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * FT;
  const int G = H / KH;
  const int tid = threadIdx.x;
  const int j = tid >> 3, c8 = tid & 7;  // this thread's key row and column lane

  const size_t kv_stride = (size_t)KH * D, q_stride = (size_t)H * D;
  load_f32(Ks, k + ((size_t)b * Sk * KH + kh) * D, kv_stride, k0, Sk, D, tid);
  load_f32(Vs, v + ((size_t)b * Sk * KH + kh) * D, kv_stride, k0, Sk, D, tid);

  int qlo, qhi;
  query_band(k0, min(k0 + FT, Sk) - 1, Sq, causal, has_window, window, q_offset, &qlo, &qhi);
  const int t_lo = qlo / FT, t_hi = qhi > qlo ? (qhi + FT - 1) / FT : t_lo;

  float dkacc[DU], dvacc[DU];
#pragma unroll
  for (int u = 0; u < DU; ++u) dkacc[u] = dvacc[u] = 0.f;

  for (int gi = 0; gi < G; ++gi) {
    const int h = kh * G + gi;
    const T* qb = q + ((size_t)b * Sq * H + h) * D;
    const T* db = dO + ((size_t)b * Sq * H + h) * D;
    const float* lb = lse + ((size_t)b * H + h) * Sq;
    const float* deb = delta + ((size_t)b * H + h) * Sq;
    // this head's sums apart, added to the group's once: the fp32 chain
    // stays Sq long, not G * Sq (granite's MQA sums 48 heads)
    float dkh[DU], dvh[DU];
#pragma unroll
    for (int u = 0; u < DU; ++u) dkh[u] = dvh[u] = 0.f;
    for (int t = t_lo; t < t_hi; ++t) {
      const int q0 = t * FT;
      __syncthreads();  // the previous tile is consumed
      load_f32(Qs, qb, q_stride, q0, Sq, D, tid);
      load_f32(dOs, db, q_stride, q0, Sq, D, tid);
      if (tid < FT) {
        const bool in = q0 + tid < Sq;
        Ls[tid] = in ? lb[q0 + tid] * LOG2E : -INFINITY;
        Ds[tid] = in ? deb[q0 + tid] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // this thread's 4 (key j, query i) entries
        const int i = c8 + 8 * e;
        float sv = 0.f, dpv = 0.f;
        for (int d = 0; d < D; ++d) {
          sv = fmaf(Ks[j * RS + d], Qs[i * RS + d], sv);
          dpv = fmaf(Vs[j * RS + d], dOs[i * RS + d], dpv);
        }
        const bool on = Ls[i] != -INFINITY &&
                        seen(q0 + i + q_offset, k0 + j, Sk, causal, has_window, window);
        const float p = on ? exp2f(sv * scale_log2 - Ls[i]) : 0.f;
        Ps[j * (FT + 1) + i] = p;
        dSs[j * (FT + 1) + i] = p * (dpv - Ds[i]);
      }
      __syncthreads();
      for (int i = 0; i < FT; ++i) {
        const float p = Ps[j * (FT + 1) + i], ds = dSs[j * (FT + 1) + i];
#pragma unroll
        for (int u = 0; u < DU; ++u) {
          const int c = c8 + 8 * u;
          if (c < D) {
            dvh[u] = fmaf(p, dOs[i * RS + c], dvh[u]);
            dkh[u] = fmaf(ds, Qs[i * RS + c], dkh[u]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < DU; ++u) {
      dkacc[u] += dkh[u];
      dvacc[u] += dvh[u];
    }
  }

  if (k0 + j < Sk) {
    const size_t base = (((size_t)b * Sk + k0 + j) * KH + kh) * D;
#pragma unroll
    for (int u = 0; u < DU; ++u) {
      const int c = c8 + 8 * u;
      if (c < D) {
        dk[base + c] = from_f<T>(dkacc[u] * scale);
        dv[base + c] = from_f<T>(dvacc[u]);
      }
    }
  }
}

template <typename T, int DU>
__global__ void __launch_bounds__(F_NT) bwd_dq_f32_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dO, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int Sq, int Sk, int H, int KH, int D, int causal, int has_window,
    int window, int q_offset, float scale_log2, float scale) {
  extern __shared__ __align__(16) float fsm[];
  const int RS = D + 1;
  float* Qs = fsm;            // FT x RS each
  float* dOs = Qs + FT * RS;
  float* Ks = dOs + FT * RS;
  float* Vs = Ks + FT * RS;
  float* dSs = Vs + FT * RS;  // FT x (FT + 1): dS (queries x keys)
  float* Ls = dSs + FT * (FT + 1);
  float* Ds = Ls + FT;

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = qt * FT;
  const int tid = threadIdx.x;
  const int i = tid >> 3, c8 = tid & 7;  // this thread's query row and column lane

  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)KH * D;
  load_f32(Qs, q + ((size_t)b * Sq * H + h) * D, q_stride, q0, Sq, D, tid);
  load_f32(dOs, dO + ((size_t)b * Sq * H + h) * D, q_stride, q0, Sq, D, tid);
  if (tid < FT) {
    const bool in = q0 + tid < Sq;
    Ls[tid] = in ? lse[((size_t)b * H + h) * Sq + q0 + tid] * LOG2E : -INFINITY;
    Ds[tid] = in ? delta[((size_t)b * H + h) * Sq + q0 + tid] : 0.f;
  }

  const int n_kv = (Sk + FT - 1) / FT;
  const int q_last = min(q0 + FT, Sq) - 1;
  int lo = 0, hi = n_kv;
  if (causal) hi = max(0, min(n_kv, floordiv(q_last + q_offset, FT) + 1));
  if (has_window) lo = max(0, floordiv(q0 + q_offset - window + 1, FT));

  float dqacc[DU];
#pragma unroll
  for (int u = 0; u < DU; ++u) dqacc[u] = 0.f;
  const T* kb = k + ((size_t)b * Sk * KH + kh) * D;
  const T* vb = v + ((size_t)b * Sk * KH + kh) * D;

  for (int t = lo; t < hi; ++t) {
    const int k0 = t * FT;
    __syncthreads();  // the previous tile is consumed (and Q, dO, L, D are written)
    load_f32(Ks, kb, kv_stride, k0, Sk, D, tid);
    load_f32(Vs, vb, kv_stride, k0, Sk, D, tid);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // this thread's 4 (query i, key j) entries
      const int j = c8 + 8 * e;
      float sv = 0.f, dpv = 0.f;
      for (int d = 0; d < D; ++d) {
        sv = fmaf(Qs[i * RS + d], Ks[j * RS + d], sv);
        dpv = fmaf(dOs[i * RS + d], Vs[j * RS + d], dpv);
      }
      const bool on = Ls[i] != -INFINITY &&
                      seen(q0 + i + q_offset, k0 + j, Sk, causal, has_window, window);
      const float p = on ? exp2f(sv * scale_log2 - Ls[i]) : 0.f;
      dSs[i * (FT + 1) + j] = p * (dpv - Ds[i]);
    }
    __syncthreads();
    for (int j = 0; j < FT; ++j) {
      const float ds = dSs[i * (FT + 1) + j];
#pragma unroll
      for (int u = 0; u < DU; ++u) {
        const int c = c8 + 8 * u;
        if (c < D) dqacc[u] = fmaf(ds, Ks[j * RS + c], dqacc[u]);
      }
    }
  }

  if (q0 + i < Sq) {
    T* out = dq + (((size_t)b * Sq + q0 + i) * H + h) * D;
#pragma unroll
    for (int u = 0; u < DU; ++u) {
      const int c = c8 + 8 * u;
      if (c < D) out[c] = from_f<T>(dqacc[u] * scale);
    }
  }
}

size_t f32_smem_bytes(int D) {
  return sizeof(float) * (4 * (size_t)FT * (D + 1) + 2 * (size_t)FT * (FT + 1) + 2 * FT);
}

template <typename T, int DU>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* dO,
                       const float* lse, const float* delta, void* dq, void* dk, void* dv, int B,
                       int Sq, int Sk, int H, int KH, int D, int causal, int has_window,
                       int window, int q_offset, cudaStream_t s) {
  const size_t smem = f32_smem_bytes(D);
  auto k_dkdv = bwd_dkdv_f32_kernel<T, DU>;
  auto k_dq = bwd_dq_f32_kernel<T, DU>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(k_dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(k_dq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const float scale = 1.f / sqrtf((float)D), scale_log2 = LOG2E * scale;
  const T *qq = static_cast<const T*>(q), *kk = static_cast<const T*>(k),
          *vv = static_cast<const T*>(v), *dd = static_cast<const T*>(dO);
  k_dkdv<<<dim3((Sk + FT - 1) / FT, KH, B), F_NT, smem, s>>>(
      qq, kk, vv, dd, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, H, KH, D,
      causal, has_window, window, q_offset, scale_log2, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  k_dq<<<dim3((Sq + FT - 1) / FT, H, B), F_NT, smem, s>>>(
      qq, kk, vv, dd, lse, delta, static_cast<T*>(dq), Sq, Sk, H, KH, D, causal, has_window,
      window, q_offset, scale_log2, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_f32_dtype(const void* q, const void* k, const void* v, const void* dO,
                             const float* lse, const float* delta, void* dq, void* dk, void* dv,
                             int B, int Sq, int Sk, int H, int KH, int D, int causal,
                             int has_window, int window, int q_offset, cudaStream_t s) {
#define FB_F32_CASE(N, DU)                                                                     \
  case N:                                                                                      \
    return launch_f32<T, DU>(q, k, v, dO, lse, delta, dq, dk, dv, B, Sq, Sk, H, KH, D, causal, \
                             has_window, window, q_offset, s);
  switch ((D + 63) / 64) {
    FB_F32_CASE(1, 8) FB_F32_CASE(2, 16) FB_F32_CASE(3, 24) FB_F32_CASE(4, 32)
    default: return cudaErrorInvalidValue;
  }
#undef FB_F32_CASE
}

template <typename T>
cudaError_t launch_delta(const void* o, const void* dO, float* delta, int B, int Sq, int H,
                         int D, cudaStream_t s) {
  const long long rows = (long long)B * Sq * H;
  const long long blocks = (rows + 7) / 8;  // 8 warps a block
  bwd_delta_kernel<T><<<(unsigned)blocks, 256, 0, s>>>(static_cast<const T*>(o),
                                                       static_cast<const T*>(dO), delta, B, Sq,
                                                       H, D);
  return cudaGetLastError();
}

}  // namespace

// q, o, dO, dq (B, Sq, H, D); k, v, dk, dv (B, Sk, KH, D): contiguous, of
// one dtype (0 = fp32, 1 = bf16).  lse (B, H, Sq) fp32: the forward's
// log-sum-exp; delta (B, H, Sq) fp32: scratch.  D at most 256 and a whole
// number of 16-byte vectors; H a multiple of KH; Sk > 0.  body: 0 = fp32,
// 1 = mma (bf16, D a multiple of 16 up to 128); a body that cannot take
// these inputs is refused.  Runs pass 1 (delta), pass 2 (dk, dv) and pass 3
// (dq) on ``stream``.  Returns a cudaError_t code, 0 on success.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dO, const float* lse,
                                          float* delta, void* dq, void* dk, void* dv, int B,
                                          int Sq, int Sk, int H, int KH, int D, int causal,
                                          int has_window, int window, int q_offset, int dtype,
                                          int body, void* stream) {
  const int itemsize = dtype == 0 ? 4 : 2;
  if (B < 0 || Sq < 0 || Sk <= 0 || KH <= 0 || H % KH != 0 || D <= 0 || D > 256 ||
      (D * itemsize) % 16 != 0 || (dtype != 0 && dtype != 1) || (long long)Sq * H > (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const bool ok = body == 0 ? true : body == 1 ? dtype == 1 && D % 16 == 0 && D <= 128 : false;
  if (!ok) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0 ? launch_delta<float>(o, dO, delta, B, Sq, H, D, s)
                             : launch_delta<bf16>(o, dO, delta, B, Sq, H, D, s);
  if (e != cudaSuccess) return (int)e;
  if (body == 1)
    e = launch_mma_dim(q, k, v, dO, lse, delta, dq, dk, dv, B, Sq, Sk, H, KH, D, causal,
                       has_window, window, q_offset, s);
  else if (dtype == 0)
    e = launch_f32_dtype<float>(q, k, v, dO, lse, delta, dq, dk, dv, B, Sq, Sk, H, KH, D, causal,
                                has_window, window, q_offset, s);
  else
    e = launch_f32_dtype<bf16>(q, k, v, dO, lse, delta, dq, dk, dv, B, Sq, Sk, H, KH, D, causal,
                               has_window, window, q_offset, s);
  return (int)e;
}
