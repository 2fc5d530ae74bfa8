// The gradient of the Mamba-2 SSD chunked scan for Hopper (sm_90a), fp32 and
// bf16 inputs.
//
// The Pallas kernel src/repro/kernels/ssd_scan.py::ssd_scan has no backward:
// the reference differentiates its plain path (ref.py::ssd_chunked_ref) with
// XLA.  This kernel computes that gradient from the state entering each
// chunk, which the forward's chunked body leaves in fp32 under grad mode.
// Per chunk of L steps of each (b, h), with s = cumsum(a dt) in fp64 (as the
// forward sums it), G_ij = exp(s_i - s_j) for j <= i, dy the gradient of y,
// S_in the state entering the chunk and Sb the gradient of the state leaving
// it:
//
//     Sb_in = exp(s_L) Sb + sum_i exp(s_i) dy_i c_i^T          (chunks in reverse)
//     dx_j  = sum_i (c_i . b_j) G_ij dt_j dy_i + exp(s_L - s_j) dt_j Sb b_j
//     db_j  = sum_i (dy_i . x_j) G_ij dt_j c_i + exp(s_L - s_j) dt_j Sb^T x_j
//     dc_i  = sum_j (dy_i . x_j) G_ij dt_j b_j + exp(s_i) S_in^T dy_i
//     d(dt) = the direct terms + a * (the reverse cumsum of sbar, the gradient of s)
//     da    = sum over b and steps of dt * (that reverse cumsum)
//
// Steps, one stream (kernels/ssd_scan_bwd.py says what each buffer holds):
//   (a') one CTA per (b, chunk, h): the chunk's own sum_i exp(s_i) dy_i c_i^T
//        and exp(s_L), the forward's step (a) with exp(s_i) for weights;
//   (b') the pass over the chunks in reverse, in parallel over (b, h) and the
//        P x N state: each own term is overwritten in place by the Sb leaving
//        its chunk, and Sb_in of chunk 0 is the initial state's gradient;
//   (c'1) one CTA per (b, chunk, h), by blocks of 32 rows i: C B^T and dY X^T
//        on the rows up to the diagonal, masked and weighted, then dc and the
//        rows' part of sbar (to scratch);
//   (c'2) one CTA per (b, chunk, h), by blocks of 32 columns j: the same two
//        products transposed, then dx, db, the direct d(dt), the columns'
//        part of sbar, and the reverse cumsum over the chunk for d(dt) and
//        the chunk's part of da (summed by the wrapper in a fixed order: no
//        atomics anywhere).
//
// What bounds it: at mamba2-780m's B = 2, T = 2048 the function must read x,
// b, c, dy, dt and the saved states and write dx, db, dc and d(dt), about
// 330 MB: 98 us at 3.35 TB/s; its products are about 8 L^2 (N + P) / 2 +
// 10 L P N flops a chunk and head, 31 GFLOP there, 31 us on the tensor
// cores but 0.46 ms on the CUDA cores.  This first kernel does all of its
// arithmetic in fp32 on the CUDA cores (bf16 inputs are widened as they are
// staged), so it is bound by operations, and by shared memory's bandwidth
// before that: every product is a 4 x 4 register tile per thread fed by
// scalar loads from rows of odd stride (conflict-free whichever way a
// product reads them).  The products on mma.sync or wgmma are later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC -I csrc; bound through a plain C entry point.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ssd_common.cuh"

namespace {

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Chunk rows padded to whole blocks of RB (the pad has dt = 0 and dy = 0).
__host__ __device__ __forceinline__ int rows32(int L) { return (L + RB - 1) / RB * RB; }

// Rows [j0, j0 + rows) of the chunk starting at step t0 of a (B, T, H, W)
// tensor into dst (row stride ds), as fp32: zeros past the chunk and past T.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ds, const T* src, int W, int j0, int rows,
                                          int L, int Tn, int H, int b, int h, int t0) {
  constexpr int VEC = Vec<T>::N;
  const int nv = W / VEC;
  for (int i = threadIdx.x; i < rows * nv; i += NT) {
    const int r = i / nv, w = (i - r * nv) * VEC;
    const int j = j0 + r, t = t0 + j;
    float f[VEC];
    if (j < L && t < Tn) {
      Vec<T>::load(src + (((size_t)b * Tn + t) * H + h) * W + w, f);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[r * ds + w + e] = f[e];
  }
}

// acc[i][j] += sum_{k0 <= k < k1} A(mb + mg i, k) B(k, nb + ng j), with
// A(m, k) = A[m am + k ak] and B(k, n) = B[k bk + n bn]: a thread's 4 x 4
// tile spread over the output (rows mg apart, columns ng apart), so that
// neighbouring threads read neighbouring rows or columns.
__device__ __forceinline__ void mm44(float (&acc)[4][4], const float* A, int am, int ak,
                                     const float* B, int bk, int bn, int mb, int mg, int nb,
                                     int ng, int k0, int k1) {
  for (int k = k0; k < k1; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = A[(mb + mg * i) * am + k * ak];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = B[k * bk + (nb + ng * j) * bn];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero44(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The shared tiles of (c'1) and (c'2): every row stride is odd.
struct DualSmem {
  int LQ, N1, P1, TS;
  float* full_n;  // LQ x N1: B (c'1) or C (c'2) of the whole chunk
  float* full_p;  // LQ x P1: X (c'1) or dY (c'2)
  float* blk_n;   // RB x N1: C (c'1) or B (c'2) of the block
  float* blk_p;   // RB x P1: dY (c'1) or X (c'2) of the block
  float* st;      // P x N1: S_in (c'1) or Sb (c'2)
  float* t1;      // RB x TS
  float* t2;      // RB x TS
  float* sv;      // LQ: s, rounded to fp32
  float* sl;      // LQ: the rest of s
  float* dv;      // LQ: dt
  float* part;    // RB x 32: per-thread partial sums of a row
  float* part2;   // RB x 32
  float* vec;     // 4 LQ + 16 of the kernel's own vectors
};

__host__ __device__ __forceinline__ size_t dual_floats(int L, int P, int N) {
  const size_t LQ = rows32(L), N1 = N + 1, P1 = P + 1, TS = LQ + 1;
  return LQ * N1 + LQ * P1 + RB * N1 + RB * P1 + (size_t)P * N1 + 2 * RB * TS + 3 * LQ +
         2 * RB * 32 + 4 * LQ + 16;
}

__device__ __forceinline__ DualSmem carve_dual(float* smem, int L, int P, int N) {
  DualSmem d;
  d.LQ = rows32(L);
  d.N1 = N + 1;
  d.P1 = P + 1;
  d.TS = d.LQ + 1;
  d.full_n = smem;
  d.full_p = d.full_n + d.LQ * d.N1;
  d.blk_n = d.full_p + d.LQ * d.P1;
  d.blk_p = d.blk_n + RB * d.N1;
  d.st = d.blk_p + RB * d.P1;
  d.t1 = d.st + P * d.N1;
  d.t2 = d.t1 + RB * d.TS;
  d.sv = d.t2 + RB * d.TS;
  d.sl = d.sv + d.LQ;
  d.dv = d.sl + d.LQ;
  d.part = d.dv + d.LQ;
  d.part2 = d.part + RB * 32;
  d.vec = d.part2 + RB * 32;
  return d;
}

// dt of the chunk and s = cumsum(a dt) over its LQ rows (then synced).
__device__ __forceinline__ void stage_s(const DualSmem& d, const float* dt, float ah, int L, int Tn,
                                        int H, int b, int h, int t0) {
  for (int j = threadIdx.x; j < d.LQ; j += NT) {
    const int t = t0 + j;
    d.dv[j] = (j < L && t < Tn) ? dt[((size_t)b * Tn + t) * H + h] : 0.f;
  }
  __syncthreads();
  chunk_cumsum(d.sv, d.sl, d.dv, d.LQ, ah);
  __syncthreads();
}

// A (P x N) fp32 state from global memory into a tile of row stride N1.
__device__ __forceinline__ void load_state(float* dst, int n1, const float* src, int P, int N) {
  for (int i = threadIdx.x; i < P * N; i += NT) {
    const int p = i / N, n = i - p * N;
    dst[p * n1 + n] = src[i];
  }
}

// (a'): the chunk's own sum_i exp(s_i) dy_i c_i^T, (P, N) fp32, and exp(s_L).
// Grid (H, n_chunks, B).
template <typename T>
__global__ void __launch_bounds__(NT) ssd_bwd_chunk_state_kernel(
    const T* __restrict__ dy, const float* __restrict__ dt, const float* __restrict__ a,
    const T* __restrict__ cm, float* __restrict__ own, float* __restrict__ decays, int Tn, int H,
    int P, int N, int L) {
  extern __shared__ __align__(16) float smem[];
  const ChunkSmem s = carve(smem, L, P, N);
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int tid = threadIdx.x;
  for (int i = tid; i < N * P; i += NT) s.St[i] = 0.f;
  stage_chunk<T>(s, dy, dt, cm, nullptr, Tn, H, P, N, L, b, h, c * L);  // Xs = dY, Bt = C^T
  __syncthreads();
  chunk_cumsum(s.sv, s.sl, s.dv, s.LP, a[h]);
  __syncthreads();
  for (int j = tid; j < s.LP; j += NT) s.wv[j] = expf(s.sv[j] + s.sl[j]);
  __syncthreads();
  chunk_state(s, 0.f, P, N);
  __syncthreads();
  const size_t ci = chunk_index(b, c, h, nc, H);
  float* out = own + ci * P * N;
  for (int i = tid; i < N * P; i += NT) {
    const int p = i / N, n = i - p * N;
    out[i] = s.St[n * P + p];
  }
  const int jL = s.LP - 1;
  if (tid == 0) decays[ci] = expf(s.sv[jL] + s.sl[jL]);
}

// (b'): Sb leaving chunk nc - 1 = dstate (or 0), Sb leaving chunk c - 1 =
// exp(s_L[c]) Sb + own[c]; each own term is overwritten by the Sb leaving its
// chunk, and the last step gives the initial state's gradient (where asked).
// Grid (ceil(P N / 256), B H), one thread per state element.
__global__ void __launch_bounds__(256) ssd_bwd_state_pass_kernel(
    float* sbar, const float* __restrict__ decays, const float* __restrict__ dstate,
    float* __restrict__ dinit, int nc, int H, int PN) {
  constexpr int BATCH = 8;
  const int idx = blockIdx.x * 256 + threadIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  if (idx >= PN) return;
  float st = dstate != nullptr ? dstate[(size_t)bh * PN + idx] : 0.f;
  for (int c0 = nc - 1; c0 >= 0; c0 -= BATCH) {
    float u[BATCH], dc[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      if (c0 - k >= 0) {
        const size_t ci = chunk_index(b, c0 - k, h, nc, H);
        u[k] = sbar[ci * PN + idx];
        dc[k] = decays[ci];
      }
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      if (c0 - k >= 0) {
        sbar[chunk_index(b, c0 - k, h, nc, H) * PN + idx] = st;
        st = dc[k] * st + u[k];
      }
    }
  }
  if (dinit != nullptr) dinit[(size_t)bh * PN + idx] = st;
}

// (c'1): by blocks of RB rows i, with j < the block's end:
//   Q_ij = (c_i . b_j) G_ij dt_j (dy_i . x_j) and E_ij = (dy_i . x_j) G_ij dt_j,
//   dc_i = sum_j E_ij b_j + exp(s_i) S_in^T dy_i,
//   sbar_i (rows' part) = sum_j Q_ij + exp(s_i) dy_i . (S_in c_i), to srow.
// Grid (H, n_chunks, B).
template <typename T>
__global__ void __launch_bounds__(NT) ssd_bwd_rows_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const T* __restrict__ bm, const T* __restrict__ cm, const T* __restrict__ dy,
    const float* __restrict__ states_in, T* __restrict__ dc, float* __restrict__ srow, int Tn,
    int H, int P, int N, int L) {
  extern __shared__ __align__(16) float smem[];
  const DualSmem d = carve_dual(smem, L, P, N);
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = c * L, LQ = d.LQ, N1 = d.N1, P1 = d.P1, TS = d.TS;
  const size_t ci = chunk_index(b, c, h, nc, H);
  float* rs = d.vec;  // RB: the rows' sums of Q
  load_rows<T>(d.full_n, N1, bm, N, 0, LQ, L, Tn, H, b, h, t0);
  load_rows<T>(d.full_p, P1, x, P, 0, LQ, L, Tn, H, b, h, t0);
  load_state(d.st, N1, states_in + ci * P * N, P, N);
  stage_s(d, dt, a[h], L, Tn, H, b, h, t0);

  for (int r0 = 0; r0 < LQ; r0 += RB) {
    load_rows<T>(d.blk_n, N1, cm, N, r0, RB, L, Tn, H, b, h, t0);
    load_rows<T>(d.blk_p, P1, dy, P, r0, RB, L, Tn, H, b, h, t0);
    __syncthreads();
    const int jn = r0 + RB;
    {  // Q and E on rows [r0, r0 + RB), columns [0, jn)
      const int mg = RB / 4, ng = jn / 4;
      for (int u = tid; u < mg * ng; u += NT) {
        const int mb = u / ng, nb = u - mb * ng;
        float cb[4][4], dm[4][4];
        zero44(cb);
        zero44(dm);
        mm44(cb, d.blk_n, N1, 1, d.full_n, 1, N1, mb, mg, nb, ng, 0, N);
        mm44(dm, d.blk_p, P1, 1, d.full_p, 1, P1, mb, mg, nb, ng, 0, P);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int r = mb + mg * ii, i = r0 + r;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = nb + ng * jj;
            const float g = j <= i ? expf(s_diff(d.sv, d.sl, i, j)) * d.dv[j] : 0.f;
            d.t1[r * TS + j] = cb[ii][jj] * g * dm[ii][jj];
            d.t2[r * TS + j] = dm[ii][jj] * g;
          }
        }
      }
    }
    __syncthreads();
    for (int r = warp; r < RB; r += NT / 32) {  // the rows' sums of Q, a warp a row
      float v = 0.f;
      for (int j = lane; j < jn; j += 32) v += d.t1[r * TS + j];
      v = warp_sum(v);
      if (lane == 0) rs[r] = v;
    }
    {  // dc on rows [r0, r0 + RB), and the rows' dy . (S_in c) in parts
      const int mg = RB / 4, ng = N / 4;
      for (int u = tid; u < mg * ng; u += NT) {
        const int mb = u / ng, nb = u - mb * ng;
        float acc[4][4], inter[4][4];
        zero44(acc);
        zero44(inter);
        mm44(acc, d.t2, TS, 1, d.full_n, N1, 1, mb, mg, nb, ng, 0, jn);
        mm44(inter, d.blk_p, P1, 1, d.st, N1, 1, mb, mg, nb, ng, 0, P);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int r = mb + mg * ii, i = r0 + r, t = t0 + i;
          const float e = expf(d.sv[i] + d.sl[i]);
          float ps = 0.f;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int n = nb + ng * jj;
            ps = fmaf(d.blk_n[r * N1 + n], inter[ii][jj], ps);
            if (i < L && t < Tn)
              dc[(((size_t)b * Tn + t) * H + h) * N + n] = from_f32<T>(acc[ii][jj] + e * inter[ii][jj]);
          }
          d.part[r * 32 + nb] = ps;
        }
      }
    }
    __syncthreads();
    if (tid < RB) {
      const int i = r0 + tid;
      float v = 0.f;
      for (int g = 0; g < N / 4; ++g) v += d.part[tid * 32 + g];
      srow[ci * LQ + i] = rs[tid] + expf(d.sv[i] + d.sl[i]) * v;
    }
    __syncthreads();  // the block's tiles are consumed before the next block's
  }
}

// (c'2): by blocks of RB columns j, with i from the block's start:
//   F_ji = (c_i . b_j) G_ij dt_j, E_ji = (dy_i . x_j) G_ij dt_j,
//   H_j = sum_i (c_i . b_j) G_ij (dy_i . x_j),
//   dx_j = sum_i F_ji dy_i + w_j Sb b_j, db_j = sum_i E_ji c_i + w_j Sb^T x_j
//   (w_j = exp(s_L - s_j) dt_j), R_j = exp(s_L - s_j) x_j . (Sb b_j);
// then d(dt)_j = H_j + R_j + a sum_{k >= j} sbar_k, with sbar = srow - dt (H
// + R) and sbar_L += sum_j dt_j R_j + exp(s_L) <Sb, S_in>, and the chunk's
// part of da = sum_j dt_j sum_{k >= j} sbar_k.  Grid (H, n_chunks, B).
template <typename T>
__global__ void __launch_bounds__(NT) ssd_bwd_cols_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const T* __restrict__ bm, const T* __restrict__ cm, const T* __restrict__ dy,
    const float* __restrict__ states_in, const float* __restrict__ sbar,
    const float* __restrict__ srow, T* __restrict__ dx, float* __restrict__ ddt,
    T* __restrict__ db, float* __restrict__ da_part, int Tn, int H, int P, int N, int L) {
  extern __shared__ __align__(16) float smem[];
  const DualSmem d = carve_dual(smem, L, P, N);
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = c * L, LQ = d.LQ, N1 = d.N1, P1 = d.P1, TS = d.TS;
  const size_t ci = chunk_index(b, c, h, nc, H);
  const float ah = a[h];
  float* direct = d.vec;         // LQ: the direct d(dt)
  float* scol = direct + LQ;     // LQ: the columns' part of sbar
  float* rdt = scol + LQ;        // LQ: dt_j R_j
  float* red = rdt + LQ;         // 16: a block reduction's warps
  load_rows<T>(d.full_n, N1, cm, N, 0, LQ, L, Tn, H, b, h, t0);
  load_rows<T>(d.full_p, P1, dy, P, 0, LQ, L, Tn, H, b, h, t0);
  load_state(d.st, N1, sbar + ci * P * N, P, N);
  stage_s(d, dt, ah, L, Tn, H, b, h, t0);
  {  // <Sb, S_in>, summed in a fixed order
    const float* entering = states_in + ci * P * N;
    float v = 0.f;
    for (int i = tid; i < P * N; i += NT) {
      const int p = i / N, n = i - p * N;
      v = fmaf(d.st[p * N1 + n], entering[i], v);
    }
    v = warp_sum(v);
    if (lane == 0) red[warp] = v;
  }
  const int jL = LQ - 1;
  const float eL = expf(d.sv[jL] + d.sl[jL]);

  for (int c0 = 0; c0 < LQ; c0 += RB) {
    load_rows<T>(d.blk_n, N1, bm, N, c0, RB, L, Tn, H, b, h, t0);
    load_rows<T>(d.blk_p, P1, x, P, c0, RB, L, Tn, H, b, h, t0);
    __syncthreads();
    const int ni = LQ - c0;  // rows i in [c0, LQ)
    const float* cs = d.full_n + c0 * N1;
    const float* ys = d.full_p + c0 * P1;
    {  // F and E on columns [c0, c0 + RB), rows [c0, LQ); H in parts
      const int mg = RB / 4, ng = ni / 4;
      for (int u = tid; u < mg * ng; u += NT) {
        const int mb = u / ng, nb = u - mb * ng;
        float cb[4][4], dm[4][4];
        zero44(cb);
        zero44(dm);
        mm44(cb, d.blk_n, N1, 1, cs, 1, N1, mb, mg, nb, ng, 0, N);
        mm44(dm, d.blk_p, P1, 1, ys, 1, P1, mb, mg, nb, ng, 0, P);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int r = mb + mg * jj, j = c0 + r;
          float hs = 0.f;
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            const int q = nb + ng * ii, i = c0 + q;
            const float g = j <= i ? expf(s_diff(d.sv, d.sl, i, j)) : 0.f;
            hs = fmaf(cb[jj][ii] * g, dm[jj][ii], hs);
            d.t1[r * TS + q] = cb[jj][ii] * g * d.dv[j];
            d.t2[r * TS + q] = dm[jj][ii] * g * d.dv[j];
          }
          d.part[r * 32 + nb] = hs;
        }
      }
    }
    __syncthreads();
    {  // dx on columns [c0, c0 + RB), and x_j . (Sb b_j) in parts
      const int mg = RB / 4, ng = P / 4;
      for (int u = tid; u < mg * ng; u += NT) {
        const int mb = u / ng, nb = u - mb * ng;
        float acc[4][4], sb[4][4];
        zero44(acc);
        zero44(sb);
        mm44(acc, d.t1, TS, 1, ys, P1, 1, mb, mg, nb, ng, 0, ni);
        mm44(sb, d.blk_n, N1, 1, d.st, 1, N1, mb, mg, nb, ng, 0, N);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int r = mb + mg * jj, j = c0 + r, t = t0 + j;
          const float w = expf(s_diff(d.sv, d.sl, jL, j)) * d.dv[j];
          float ps = 0.f;
#pragma unroll
          for (int pp = 0; pp < 4; ++pp) {
            const int p = nb + ng * pp;
            ps = fmaf(d.blk_p[r * P1 + p], sb[jj][pp], ps);
            if (j < L && t < Tn)
              dx[(((size_t)b * Tn + t) * H + h) * P + p] = from_f32<T>(acc[jj][pp] + w * sb[jj][pp]);
          }
          d.part2[r * 32 + nb] = ps;
        }
      }
    }
    {  // db on columns [c0, c0 + RB)
      const int mg = RB / 4, ng = N / 4;
      for (int u = tid; u < mg * ng; u += NT) {
        const int mb = u / ng, nb = u - mb * ng;
        float acc[4][4], sx[4][4];
        zero44(acc);
        zero44(sx);
        mm44(acc, d.t2, TS, 1, cs, N1, 1, mb, mg, nb, ng, 0, ni);
        mm44(sx, d.blk_p, P1, 1, d.st, N1, 1, mb, mg, nb, ng, 0, P);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int r = mb + mg * jj, j = c0 + r, t = t0 + j;
          if (!(j < L && t < Tn)) continue;
          const float w = expf(s_diff(d.sv, d.sl, jL, j)) * d.dv[j];
#pragma unroll
          for (int nn = 0; nn < 4; ++nn) {
            const int n = nb + ng * nn;
            db[(((size_t)b * Tn + t) * H + h) * N + n] = from_f32<T>(acc[jj][nn] + w * sx[jj][nn]);
          }
        }
      }
    }
    __syncthreads();
    if (tid < RB) {
      const int j = c0 + tid;
      float hsum = 0.f, rsum = 0.f;
      for (int g = 0; g < ni / 4; ++g) hsum += d.part[tid * 32 + g];
      for (int g = 0; g < P / 4; ++g) rsum += d.part2[tid * 32 + g];
      const float r = expf(s_diff(d.sv, d.sl, jL, j)) * rsum;
      direct[j] = hsum + r;
      scol[j] = -d.dv[j] * (hsum + r);
      rdt[j] = d.dv[j] * r;
    }
    __syncthreads();  // the block's tiles are consumed before the next block's
  }

  // sbar over the chunk, then its reverse cumsum in fp64 (warp 0, each lane a
  // contiguous segment), d(dt) and the chunk's part of da
  if (warp == 0) {
    const int seg = LQ / 32;
    const int k0 = lane * seg, k1 = k0 + seg;
    const float* rows = srow + ci * LQ;
    double tail = 0.0;  // the sum of dt_j R_j, and the extra term at s_L
    for (int k = k0; k < k1; ++k) tail += (double)rdt[k];
    tail = warp_sum(tail);
    float dot = 0.f;
    for (int w = 0; w < NT / 32; ++w) dot += red[w];
    const double last = tail + (double)eL * dot;
    double run = 0.0;  // this lane's segment total
    for (int k = k0; k < k1; ++k) run += (double)rows[k] + scol[k] + (k == jL ? last : 0.0);
    double after = run;  // inclusive suffix sum over the lanes from this one on
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double dn = __shfl_down_sync(0xffffffffu, after, o);
      if (lane + o < 32) after += dn;
    }
    double acc = after - run;  // the sum over the segments after this one
    double da = 0.0;
    for (int k = k1 - 1; k >= k0; --k) {
      acc += (double)rows[k] + scol[k] + (k == jL ? last : 0.0);
      const int t = t0 + k;
      if (k < L && t < Tn) ddt[((size_t)b * Tn + t) * H + h] = direct[k] + (float)((double)ah * acc);
      da += (double)d.dv[k] * acc;
    }
    da = warp_sum(da);
    if (lane == 0) da_part[ci] = (float)da;
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

size_t largest_smem(int L, int P, int N) {
  const size_t a = smem_bytes(L, P, N), c = sizeof(float) * dual_floats(L, P, N);
  return a > c ? a : c;
}

template <typename T>
cudaError_t launch_bwd(const void* x, const float* dt, const float* a, const void* b,
                       const void* c, const void* dy, const float* states_in, const float* dstate,
                       void* dx, float* ddt, void* db, void* dc, float* dinit, float* sbar,
                       float* decays, float* srow, float* da_part, int B, int Tn, int H, int P,
                       int N, int L, cudaStream_t s) {
  const int nc = (Tn + L - 1) / L;
  const dim3 grid(H, nc, B);
  cudaError_t e = cudaSuccess;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(b);
  const T* ct = static_cast<const T*>(c);
  const T* dyt = static_cast<const T*>(dy);
  if (nc > 0) {  // (a')
    const size_t smem = smem_bytes(L, P, N);
    e = set_smem(ssd_bwd_chunk_state_kernel<T>, smem);
    if (e != cudaSuccess) return e;
    ssd_bwd_chunk_state_kernel<T><<<grid, NT, smem, s>>>(dyt, dt, a, ct, sbar, decays, Tn, H, P,
                                                        N, L);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  // (b')
  const int PN = P * N;
  ssd_bwd_state_pass_kernel<<<dim3((PN + 255) / 256, B * H), 256, 0, s>>>(sbar, decays, dstate,
                                                                          dinit, nc, H, PN);
  e = cudaGetLastError();
  if (e != cudaSuccess || nc == 0) return e;
  // (c'1), (c'2)
  const size_t smem = sizeof(float) * dual_floats(L, P, N);
  e = set_smem(ssd_bwd_rows_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  ssd_bwd_rows_kernel<T><<<grid, NT, smem, s>>>(xt, dt, a, bt, ct, dyt, states_in,
                                                static_cast<T*>(dc), srow, Tn, H, P, N, L);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = set_smem(ssd_bwd_cols_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  ssd_bwd_cols_kernel<T><<<grid, NT, smem, s>>>(xt, dt, a, bt, ct, dyt, states_in, sbar, srow,
                                                static_cast<T*>(dx), ddt, static_cast<T*>(db),
                                                da_part, Tn, H, P, N, L);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Shared memory (bytes) the largest CTA takes for chunk L, head dim P and
// state dim N: the wrapper holds it against the card's limit.
extern "C" size_t ssd_scan_bwd_smem_bytes(int L, int P, int N) { return largest_smem(L, P, N); }

// x, dy (B, T, H, P) and b, c (B, T, H, N) of one dtype (0 = fp32, 1 = bf16);
// dt (B, T, H) and a (H,) fp32; states_in (B, nc, H, P, N) fp32, the state
// entering each of the nc = ceil(T / L) chunks; dstate (B, H, P, N) fp32 or
// null (zero).  Outputs: dx, db, dc in x's dtype, d(dt) fp32, dinit (B, H,
// P, N) fp32 or null (not wanted).  Scratch, fp32: sbar (B, nc, H, P, N),
// decays and da_part (B, nc, H), whose sum over (B, nc) is da, and srow
// (B, nc, H, ceil(L / 32) * 32).  All contiguous; x, b, c, dy, dx, db, dc on
// 16-byte boundaries; P and N whole 16-byte vectors and multiples of 4;
// 1 <= L <= 128.  Returns a cudaError_t code, 0 on success.
extern "C" int ssd_scan_bwd_launch(const void* x, const void* dt, const void* a, const void* b,
                                   const void* c, const void* dy, const void* states_in,
                                   const void* dstate, void* dx, void* ddt, void* db, void* dc,
                                   void* dinit, void* sbar, void* decays, void* srow,
                                   void* da_part, int B, int Tn, int H, int P, int N, int L,
                                   int dtype, void* stream) {
  const int itemsize = dtype == 0 ? 4 : 2;
  if (B < 0 || Tn < 0 || H < 0 || P <= 0 || N <= 0 || L <= 0 || L > 128 ||
      (P * itemsize) % 16 != 0 || (N * itemsize) % 16 != 0 || P % 4 != 0 || N % 4 != 0 ||
      N > 128 || P > 128 || (dtype != 0 && dtype != 1) || !aligned16(x) || !aligned16(b) ||
      !aligned16(c) || !aligned16(dy) || !aligned16(dx) || !aligned16(db) || !aligned16(dc))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return 0;
  if (Tn > 0 && (states_in == nullptr || sbar == nullptr || decays == nullptr ||
                 srow == nullptr || da_part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* entering = static_cast<const float*>(states_in);
  const float* ds = static_cast<const float*>(dstate);
  float* ddtf = static_cast<float*>(ddt);
  float* di = static_cast<float*>(dinit);
  float* sb = static_cast<float*>(sbar);
  float* dec = static_cast<float*>(decays);
  float* sr = static_cast<float*>(srow);
  float* dap = static_cast<float*>(da_part);
  cudaError_t e;
  if (dtype == 0)
    e = launch_bwd<float>(x, dtf, af, b, c, dy, entering, ds, dx, ddtf, db, dc, di, sb, dec, sr, dap,
                          B, Tn, H, P, N, L, s);
  else
    e = launch_bwd<__nv_bfloat16>(x, dtf, af, b, c, dy, entering, ds, dx, ddtf, db, dc, di, sb, dec, sr,
                                  dap, B, Tn, H, P, N, L, s);
  return (int)e;
}
