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
//   (c'1) one CTA per (b, chunk, h), by blocks of rows i (32 at a time in
//        fp32, 16 a warp in mma): C B^T and dY X^T on the rows up to the
//        diagonal, masked and weighted, then dc and the rows' part of sbar
//        (to scratch);
//   (c'2) one CTA per (b, chunk, h), by blocks of columns j (as rows in
//        (c'1)): the same two products transposed, then dx, db, the direct
//        d(dt), the columns' part of sbar, and the reverse cumsum over the
//        chunk for d(dt) and the chunk's part of da (summed by the wrapper
//        in a fixed order: no atomics anywhere).
//
// What bounds it: at mamba2-780m's B = 2, T = 2048 the function must read x,
// b, c, dy, dt and the saved states and write dx, db, dc and d(dt), about
// 330 MB: 98 us at 3.35 TB/s; its products are about 8 L^2 (N + P) / 2 +
// 10 L P N flops a chunk and head, 31 GFLOP there, 31 us on the tensor
// cores but 0.46 ms on the CUDA cores.  Two bodies (kernels/ssd_scan_bwd.py
// picks one), the same four steps and guarantees (s in fp64, Gamma the exp
// of a masked difference, da from ordered partials, no atomics):
//
// * mma (bf16): the products on mma.sync m16n8k16 from ldmatrix with fp32
//   sums.  C B^T and dY X^T have exact bf16 operands.  Every product with
//   an fp32 operand runs as two, its bf16 high part and its bf16 rest, as
//   the forward's (c) does: the masked, weighted L x L tiles times B, C or
//   dY, the state terms (S_in^T dy in dc, Sb b and Sb^T x in dx and db),
//   and (a')'s sum of exp(s_i) dy_i c_i^T (the forward's mma chunk-state
//   kernel with OWN set).  One rounding to bf16 (2^-9 of a term) moved the
//   forward's y by 0.25 where terms cancel; in two parts an operand keeps
//   about 2^-17.  b, c, x and dy are staged in bf16 (about 140 KB a CTA at
//   mamba2's widths, against 200 KB widened to fp32), in two halves: X and
//   dY first, so that dY X^T (or X dY^T) runs while C, B and the state
//   (split into its two parts as it is staged) arrive, and s is summed by
//   the warp with the fewest products.  A warp owns 16 rows i in (c'1) and
//   16 columns j in (c'2), with the tiles up to (from) the diagonal: the
//   warps' products are uneven, so the busiest warp sets a CTA's time, and
//   one CTA of 8 warps fits an SM (registers: up to 226 a thread at P =
//   64).  It is bound by the latency of its busiest warp's products, not
//   by bytes.
// * fp32 (both dtypes; fp32 inputs stay here, as the reference's SSD
//   tolerance rules out TF32): all arithmetic in fp32 on the CUDA cores,
//   bf16 inputs widened as they are staged, so it is bound by operations,
//   and by shared memory's bandwidth before that: every product is a 4 x 4
//   register tile per thread fed by scalar loads from rows of odd stride
//   (conflict-free whichever way a product reads them).
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

// The end of (c'2), warp 0: sbar over the chunk's n rows (the rows' parts
// in `rows`, the columns' in scol, and at the last row the sum of dt_j R_j
// plus exp(s_L) <Sb, S_in>, whose warps' parts are red[0 .. nred)), then its
// reverse cumsum in fp64, each lane a contiguous segment; d(dt) = direct +
// a (that sum) and the chunk's part of da = sum_k dt_k (that sum).
__device__ void finish_chunk(const float* rows, const float* scol, const float* rdt,
                             const float* direct, const float* dv, const float* red, int nred,
                             float eL, int n, int L, int Tn, int H, int b, int h, int t0,
                             float ah, float* __restrict__ ddt, float* __restrict__ da_part,
                             size_t ci) {
  const int lane = threadIdx.x & 31;
  const int seg = (n + 31) / 32;
  const int k0 = min(lane * seg, n), k1 = min(k0 + seg, n);
  const int jL = n - 1;
  double tail = 0.0;  // the sum of dt_j R_j, and the extra term at s_L
  for (int k = k0; k < k1; ++k) tail += (double)rdt[k];
  tail = warp_sum(tail);
  float dot = 0.f;
  for (int w = 0; w < nred; ++w) dot += red[w];
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
    da += (double)dv[k] * acc;
  }
  da = warp_sum(da);
  if (lane == 0) da_part[ci] = (float)da;
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

  if (warp == 0)
    finish_chunk(srow + ci * LQ, scol, rdt, direct, d.dv, red, NT / 32, eL, LQ, L, Tn, H, b, h,
                 t0, ah, ddt, da_part, ci);
}

// ---------------------------------------------------------------------------
// the mma body (bf16): (a') on the forward's mma chunk-state kernel, (b') as
// above, (c'1) and (c'2) on mma.sync m16n8k16 from ldmatrix with fp32 sums
// ---------------------------------------------------------------------------
// The bf16 tiles of (c'1) and (c'2): the chunk's C, B, X and dY, rows
// padded to 16 and columns to 16 (N) or to the compiled P (zeros), each row
// 16 bytes longer (ldmatrix without bank conflicts); an fp32 state in two
// bf16 parts, [p][n]; fp32 vectors of LP: s (two parts) and dt, then (c'2)'s
// direct d(dt), the columns' part of sbar and dt_j R_j; 16 warps' parts.
struct MmaSmem {
  int LP, NP, PP, CS, XS;
  __nv_bfloat16 *Cs, *Bs, *Xs, *Ys, *Sh, *Sl;
  float *sv, *sl, *dv, *direct, *scol, *rdt, *red;
};

__host__ __device__ __forceinline__ size_t mma_dual_smem(int L, int P, int N) {
  const size_t LP = round16(L), PP = padded_p(P), CS = round16(N) + 8, XS = PP + 8;
  return 2 * (2 * LP * CS + 2 * LP * XS + 2 * PP * CS) + 4 * (6 * LP + 16);
}

__device__ __forceinline__ MmaSmem carve_mma(unsigned char* smem, int L, int P, int N) {
  MmaSmem m;
  m.LP = round16(L);
  m.NP = round16(N);
  m.PP = padded_p(P);
  m.CS = m.NP + 8;
  m.XS = m.PP + 8;
  m.Cs = reinterpret_cast<__nv_bfloat16*>(smem);
  m.Bs = m.Cs + m.LP * m.CS;
  m.Xs = m.Bs + m.LP * m.CS;
  m.Ys = m.Xs + m.LP * m.XS;
  m.Sh = m.Ys + m.LP * m.XS;
  m.Sl = m.Sh + m.PP * m.CS;
  m.sv = reinterpret_cast<float*>(m.Sl + m.PP * m.CS);
  m.sl = m.sv + m.LP;
  m.dv = m.sl + m.LP;
  m.direct = m.dv + m.LP;
  m.scol = m.direct + m.LP;
  m.rdt = m.scol + m.LP;
  m.red = m.rdt + m.LP;
  return m;
}

// Staging in two halves, so that the first product runs while the rest
// arrives.  The first: X and dY by cp.async (one group), then C and B (a
// second), and dt; once X, dY and dt are in (synced), warp `cw` sums s =
// cumsum(a dt) while the others start on dY X^T (or X dY^T).
__device__ __forceinline__ void stage_mma_first(const MmaSmem& m, const __nv_bfloat16* x,
                                                const float* dt, float ah,
                                                const __nv_bfloat16* bm,
                                                const __nv_bfloat16* cm,
                                                const __nv_bfloat16* dy, int Tn, int H, int P,
                                                int N, int L, int b, int h, int t0, int cw) {
  stage_rows(m.Xs, m.XS, x, P, m.PP, m.LP, L, Tn, H, b, h, t0);
  stage_rows(m.Ys, m.XS, dy, P, m.PP, m.LP, L, Tn, H, b, h, t0);
  hopper::cp_async_commit();
  stage_rows(m.Cs, m.CS, cm, N, m.NP, m.LP, L, Tn, H, b, h, t0);
  stage_rows(m.Bs, m.CS, bm, N, m.NP, m.LP, L, Tn, H, b, h, t0);
  hopper::cp_async_commit();
  stage_dt(m.dv, dt, m.LP, L, Tn, H, b, h, t0);
  hopper::cp_async_wait<1>();
  __syncthreads();
  chunk_cumsum(m.sv, m.sl, m.dv, m.LP, ah, cw);
}

// The second: a state in two parts (returning this thread's part of its
// dot product with `other`, where given); once C, B, the state and s are
// in, synced.
__device__ __forceinline__ float stage_mma_second(const MmaSmem& m, const float* state, int P,
                                                  int N, const float* other = nullptr) {
  const float dot = stage_state_split(m.Sh, m.Sl, m.CS, state, P, N, m.PP, m.NP, other);
  hopper::cp_async_wait<0>();
  __syncthreads();
  return dot;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float bf(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// (c'1), mma: warp w takes rows i of [16 w, 16 w + 16) and the columns j of
// the n8 tiles up to its diagonal:
//   DM = dY X^T and CB = C B^T (exact bf16 operands);
//   Q_ij = CB G dt_j DM summed over j (the rows' part of sbar), E = DM G dt_j;
//   dc_i = E B (E in two parts) + exp(s_i) S_in^T dy_i (S_in in two parts);
//   srow_i = sum_j Q_ij + exp(s_i) c_i . (S_in^T dy_i).
// Grid (H, n_chunks, B), LP / 16 warps.
__global__ void __launch_bounds__(256) ssd_bwd_rows_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a, const __nv_bfloat16* __restrict__ bm,
    const __nv_bfloat16* __restrict__ cm, const __nv_bfloat16* __restrict__ dy,
    const float* __restrict__ states_in, __nv_bfloat16* __restrict__ dc,
    float* __restrict__ srow, int Tn, int H, int P, int N, int L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const MmaSmem m = carve_mma(smem_raw, L, P, N);
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int t0 = c * L, LQ = rows32(L);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const size_t ci = chunk_index(b, c, h, nc, H);
  // warp 0 has the fewest products here: it sums s
  stage_mma_first(m, x, dt, a[h], bm, cm, dy, Tn, H, P, N, L, b, h, t0, 0);

  const int i0 = warp * 16;
  const int nj_end = 2 * (warp + 1);  // n8 tiles of j < i0 + 16
  float dm[16][4], cb[16][4];
#pragma unroll
  for (int nj = 0; nj < 16; ++nj)
#pragma unroll
    for (int e = 0; e < 4; ++e) dm[nj][e] = cb[nj][e] = 0.f;
  for (int kk = 0; kk < m.PP / 16; ++kk) {
    uint32_t af[4];
    ldsm_a(af, m.Ys, m.XS, i0, kk * 16);
#pragma unroll
    for (int nj = 0; nj < 16; nj += 2) {
      if (nj < nj_end) {  // warp-uniform
        uint32_t bq[4];
        ldsm_b(bq, m.Xs, m.XS, nj * 8, kk * 16);
        mma2(dm[nj], dm[nj + 1], af, bq);
      }
    }
  }
  stage_mma_second(m, states_in + ci * P * N, P, N);
  for (int kk = 0; kk < m.NP / 16; ++kk) {
    uint32_t af[4];
    ldsm_a(af, m.Cs, m.CS, i0, kk * 16);
#pragma unroll
    for (int nj = 0; nj < 16; nj += 2) {
      if (nj < nj_end) {
        uint32_t bq[4];
        ldsm_b(bq, m.Bs, m.CS, nj * 8, kk * 16);
        mma2(cb[nj], cb[nj + 1], af, bq);
      }
    }
  }
  // Q's row sums; E = DM G dt_j in place of DM (masked before the exp)
  float q[2] = {0.f, 0.f};
#pragma unroll
  for (int nj = 0; nj < 16; ++nj) {
    if (nj < nj_end) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + g + 8 * (e >> 1), j = nj * 8 + 2 * t4 + (e & 1);
        const float gd = j <= i ? expf(s_diff(m.sv, m.sl, i, j)) * m.dv[j] : 0.f;
        q[e >> 1] = fmaf(cb[nj][e] * gd, dm[nj][e], q[e >> 1]);
        dm[nj][e] *= gd;
      }
    }
  }
  // E B, over the 16-deep blocks of j up to the diagonal
  float acc[16][4], inter[16][4];
#pragma unroll
  for (int nd = 0; nd < 16; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = inter[nd][e] = 0.f;
  const int nd_end = m.NP / 8;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    if (kk <= warp) {
      uint32_t ah[4], al[4];
      acc_to_a(dm[2 * kk], dm[2 * kk + 1], ah, al);
#pragma unroll
      for (int nd = 0; nd < 16; nd += 2) {
        if (nd < nd_end) {
          uint32_t bq[4];
          ldsm_bt(bq, m.Bs, m.CS, kk * 16, nd * 8);
          mma2(acc[nd], acc[nd + 1], ah, bq);
          mma2(acc[nd], acc[nd + 1], al, bq);
        }
      }
    }
  }
  // S_in^T dy_i (= dY S_in), S_in in two parts
  for (int kk = 0; kk < m.PP / 16; ++kk) {
    uint32_t af[4];
    ldsm_a(af, m.Ys, m.XS, i0, kk * 16);
#pragma unroll
    for (int nd = 0; nd < 16; nd += 2) {
      if (nd < nd_end) {
        uint32_t bq[4];
        ldsm_bt(bq, m.Sh, m.CS, kk * 16, nd * 8);
        mma2(inter[nd], inter[nd + 1], af, bq);
        ldsm_bt(bq, m.Sl, m.CS, kk * 16, nd * 8);
        mma2(inter[nd], inter[nd + 1], af, bq);
      }
    }
  }
  // dc, and c_i . (S_in^T dy_i) for srow
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int i = i0 + g + 8 * hf, t = t0 + i;
    const float es = expf(m.sv[i] + m.sl[i]);
    const bool keep = i < L && t < Tn;
    __nv_bfloat16* row = dc + (((size_t)b * Tn + t) * H + h) * N;
#pragma unroll
    for (int nd = 0; nd < 16; ++nd) {
      if (nd < nd_end) {
        const int n = nd * 8 + 2 * t4;
        const float v0 = inter[nd][2 * hf], v1 = inter[nd][2 * hf + 1];
        ps[hf] = fmaf(bf(m.Cs + i * m.CS + n), v0, ps[hf]);
        ps[hf] = fmaf(bf(m.Cs + i * m.CS + n + 1), v1, ps[hf]);
        if (keep && n < N)
          Vec<__nv_bfloat16>::store2(row + n, acc[nd][2 * hf] + es * v0,
                                     acc[nd][2 * hf + 1] + es * v1);
      }
    }
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const float qs = quad_sum(q[hf]), cs = quad_sum(ps[hf]);
    const int i = i0 + g + 8 * hf;
    if (t4 == 0) srow[ci * LQ + i] = qs + expf(m.sv[i] + m.sl[i]) * cs;
  }
}

// (c'2), mma: warp w takes columns j of [16 w, 16 w + 16) as its rows and
// the rows i of the n8 tiles from its diagonal on:
//   DM^T = X dY^T and CB^T = B C^T (exact bf16 operands);
//   H_j = sum_i CB G DM; F = CB G dt_j and E = DM G dt_j;
//   dx_j = F dY (F in two parts) + w_j Sb b_j (Sb in two parts),
//   db_j = E C (E in two parts) + w_j Sb^T x_j (w_j = exp(s_L - s_j) dt_j),
//   R_j = exp(s_L - s_j) x_j . (Sb b_j);
// then d(dt) and the chunk's part of da as the fp32 body's (c'2) finishes.
// Grid (H, n_chunks, B), LP / 16 warps.  PP: P padded (padded_p).
template <int PP>
__global__ void __launch_bounds__(256) ssd_bwd_cols_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a, const __nv_bfloat16* __restrict__ bm,
    const __nv_bfloat16* __restrict__ cm, const __nv_bfloat16* __restrict__ dy,
    const float* __restrict__ states_in, const float* __restrict__ sbar,
    const float* __restrict__ srow, __nv_bfloat16* __restrict__ dx, float* __restrict__ ddt,
    __nv_bfloat16* __restrict__ db, float* __restrict__ da_part, int Tn, int H, int P, int N,
    int L) {
  constexpr int ND = PP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const MmaSmem m = carve_mma(smem_raw, L, P, N);
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int t0 = c * L, LQ = rows32(L), LP = m.LP;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const size_t ci = chunk_index(b, c, h, nc, H);
  const float ah = a[h];
  const int nwarps = blockDim.x / 32;
  // the last warp has the fewest products here: it sums s
  stage_mma_first(m, x, dt, ah, bm, cm, dy, Tn, H, P, N, L, b, h, t0, nwarps - 1);

  const int j0 = warp * 16;
  const int nt_end = (LP - j0) / 8;  // n8 tiles of i in [j0, LP)
  float dm[16][4], cb[16][4];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dm[nt][e] = cb[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < PP / 16; ++kk) {
    uint32_t af[4];
    ldsm_a(af, m.Xs, m.XS, j0, kk * 16);
#pragma unroll
    for (int nt = 0; nt < 16; nt += 2) {
      if (nt < nt_end) {
        uint32_t bq[4];
        ldsm_b(bq, m.Ys, m.XS, j0 + nt * 8, kk * 16);
        mma2(dm[nt], dm[nt + 1], af, bq);
      }
    }
  }
  {  // Sb in two parts, and <Sb, S_in> in fp32, summed in a fixed order
    const float v = warp_sum(stage_mma_second(m, sbar + ci * P * N, P, N,
                                              states_in + ci * P * N));
    if (lane == 0) m.red[warp] = v;
  }
  const int jL = LP - 1;
  const float eL = expf(m.sv[jL] + m.sl[jL]);
  for (int kk = 0; kk < m.NP / 16; ++kk) {
    uint32_t af[4];
    ldsm_a(af, m.Bs, m.CS, j0, kk * 16);
#pragma unroll
    for (int nt = 0; nt < 16; nt += 2) {
      if (nt < nt_end) {
        uint32_t bq[4];
        ldsm_b(bq, m.Cs, m.CS, j0 + nt * 8, kk * 16);
        mma2(cb[nt], cb[nt + 1], af, bq);
      }
    }
  }
  // H's parts; F = CB G dt_j in place of CB, E = DM G dt_j in place of DM
  float hs[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    if (nt < nt_end) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + g + 8 * (e >> 1), i = j0 + nt * 8 + 2 * t4 + (e & 1);
        const float gg = j <= i ? expf(s_diff(m.sv, m.sl, i, j)) : 0.f;
        hs[e >> 1] = fmaf(cb[nt][e] * gg, dm[nt][e], hs[e >> 1]);
        const float gd = gg * m.dv[j];
        cb[nt][e] *= gd;
        dm[nt][e] *= gd;
      }
    }
  }
  // dx: F dY over the 16-deep blocks of i from the diagonal, and Sb b_j
  float ax[ND][4], sbb[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) ax[nd][e] = sbb[nd][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    if (2 * kk < nt_end) {
      uint32_t fh[4], fl[4];
      acc_to_a(cb[2 * kk], cb[2 * kk + 1], fh, fl);
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t bq[4];
        ldsm_bt(bq, m.Ys, m.XS, j0 + kk * 16, nd * 8);
        mma2(ax[nd], ax[nd + 1], fh, bq);
        mma2(ax[nd], ax[nd + 1], fl, bq);
      }
    }
  }
  for (int kk = 0; kk < m.NP / 16; ++kk) {
    uint32_t af[4];
    ldsm_a(af, m.Bs, m.CS, j0, kk * 16);
#pragma unroll
    for (int nd = 0; nd < ND; nd += 2) {
      uint32_t bq[4];
      ldsm_b(bq, m.Sh, m.CS, nd * 8, kk * 16);
      mma2(sbb[nd], sbb[nd + 1], af, bq);
      ldsm_b(bq, m.Sl, m.CS, nd * 8, kk * 16);
      mma2(sbb[nd], sbb[nd + 1], af, bq);
    }
  }
  float rp[2] = {0.f, 0.f};  // x_j . (Sb b_j), in parts
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int j = j0 + g + 8 * hf, t = t0 + j;
    const float w = expf(s_diff(m.sv, m.sl, jL, j)) * m.dv[j];
    const bool keep = j < L && t < Tn;
    __nv_bfloat16* row = dx + (((size_t)b * Tn + t) * H + h) * P;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int p = nd * 8 + 2 * t4;
      const float v0 = sbb[nd][2 * hf], v1 = sbb[nd][2 * hf + 1];
      rp[hf] = fmaf(bf(m.Xs + j * m.XS + p), v0, rp[hf]);
      rp[hf] = fmaf(bf(m.Xs + j * m.XS + p + 1), v1, rp[hf]);
      if (keep && p < P)
        Vec<__nv_bfloat16>::store2(row + p, ax[nd][2 * hf] + w * v0, ax[nd][2 * hf + 1] + w * v1);
    }
  }
  // db: E C over the same blocks, and Sb^T x_j
  float adb[16][4], sbx[16][4];
#pragma unroll
  for (int nd = 0; nd < 16; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) adb[nd][e] = sbx[nd][e] = 0.f;
  const int nd_end = m.NP / 8;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    if (2 * kk < nt_end) {
      uint32_t eh[4], el[4];
      acc_to_a(dm[2 * kk], dm[2 * kk + 1], eh, el);
#pragma unroll
      for (int nd = 0; nd < 16; nd += 2) {
        if (nd < nd_end) {
          uint32_t bq[4];
          ldsm_bt(bq, m.Cs, m.CS, j0 + kk * 16, nd * 8);
          mma2(adb[nd], adb[nd + 1], eh, bq);
          mma2(adb[nd], adb[nd + 1], el, bq);
        }
      }
    }
  }
#pragma unroll
  for (int kk = 0; kk < PP / 16; ++kk) {
    uint32_t af[4];
    ldsm_a(af, m.Xs, m.XS, j0, kk * 16);
#pragma unroll
    for (int nd = 0; nd < 16; nd += 2) {
      if (nd < nd_end) {
        uint32_t bq[4];
        ldsm_bt(bq, m.Sh, m.CS, kk * 16, nd * 8);
        mma2(sbx[nd], sbx[nd + 1], af, bq);
        ldsm_bt(bq, m.Sl, m.CS, kk * 16, nd * 8);
        mma2(sbx[nd], sbx[nd + 1], af, bq);
      }
    }
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int j = j0 + g + 8 * hf, t = t0 + j;
    if (!(j < L && t < Tn)) continue;
    const float w = expf(s_diff(m.sv, m.sl, jL, j)) * m.dv[j];
    __nv_bfloat16* row = db + (((size_t)b * Tn + t) * H + h) * N;
#pragma unroll
    for (int nd = 0; nd < 16; ++nd) {
      const int n = nd * 8 + 2 * t4;
      if (nd < nd_end && n < N)
        Vec<__nv_bfloat16>::store2(row + n, adb[nd][2 * hf] + w * sbx[nd][2 * hf],
                                   adb[nd][2 * hf + 1] + w * sbx[nd][2 * hf + 1]);
    }
  }
  // the direct d(dt), the columns' part of sbar and dt_j R_j, a row a quad
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const float hsum = quad_sum(hs[hf]), rsum = quad_sum(rp[hf]);
    const int j = j0 + g + 8 * hf;
    if (t4 == 0) {
      const float r = expf(s_diff(m.sv, m.sl, jL, j)) * rsum;
      m.direct[j] = hsum + r;
      m.scol[j] = -m.dv[j] * (hsum + r);
      m.rdt[j] = m.dv[j] * r;
    }
  }
  __syncthreads();
  if (warp == 0)
    finish_chunk(srow + ci * LQ, m.scol, m.rdt, m.direct, m.dv, m.red, nwarps, eL, LP, L, Tn, H,
                 b, h, t0, ah, ddt, da_part, ci);
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Shared memory (bytes) of the body's largest CTA (0 = fp32, 1 = mma).
size_t largest_smem(int L, int P, int N, int body) {
  const size_t a = body == 1 ? mma_state_smem(L, P, N) : smem_bytes(L, P, N);
  const size_t c = body == 1 ? mma_dual_smem(L, P, N) : sizeof(float) * dual_floats(L, P, N);
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

template <int PP>
cudaError_t launch_cols_mma(dim3 grid, int threads, size_t smem, const __nv_bfloat16* x,
                            const float* dt, const float* a, const __nv_bfloat16* b,
                            const __nv_bfloat16* c, const __nv_bfloat16* dy,
                            const float* states_in, const float* sbar, const float* srow,
                            void* dx, float* ddt, void* db, float* da_part, int Tn, int H, int P,
                            int N, int L, cudaStream_t s) {
  auto kernel = ssd_bwd_cols_mma_kernel<PP>;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, s>>>(x, dt, a, b, c, dy, states_in, sbar, srow,
                                     static_cast<__nv_bfloat16*>(dx), ddt,
                                     static_cast<__nv_bfloat16*>(db), da_part, Tn, H, P, N, L);
  return cudaGetLastError();
}

// The mma body: (a') on the forward's mma chunk-state kernel (OWN), (b'),
// then (c'1) and (c'2) on mma.sync.
cudaError_t launch_bwd_mma(const void* x, const float* dt, const float* a, const void* b,
                           const void* c, const void* dy, const float* states_in,
                           const float* dstate, void* dx, float* ddt, void* db, void* dc,
                           float* dinit, float* sbar, float* decays, float* srow,
                           float* da_part, int B, int Tn, int H, int P, int N, int L,
                           cudaStream_t s) {
  const int nc = (Tn + L - 1) / L;
  const dim3 grid(H, nc, B);
  const __nv_bfloat16* xt = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* bt = static_cast<const __nv_bfloat16*>(b);
  const __nv_bfloat16* ct = static_cast<const __nv_bfloat16*>(c);
  const __nv_bfloat16* dyt = static_cast<const __nv_bfloat16*>(dy);
  cudaError_t e = cudaSuccess;
  if (nc > 0) {  // (a'): sum_j exp(s_j) dy_j c_j^T
    const size_t smem = mma_state_smem(L, P, N);
    e = set_smem(ssd_chunk_state_mma_kernel<true>, smem);
    if (e != cudaSuccess) return e;
    ssd_chunk_state_mma_kernel<true><<<grid, STATE_THREADS, smem, s>>>(dyt, dt, a, ct, sbar,
                                                                       decays, Tn, H, P, N, L);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const int PN = P * N;  // (b')
  ssd_bwd_state_pass_kernel<<<dim3((PN + 255) / 256, B * H), 256, 0, s>>>(sbar, decays, dstate,
                                                                          dinit, nc, H, PN);
  e = cudaGetLastError();
  if (e != cudaSuccess || nc == 0) return e;
  const size_t smem = mma_dual_smem(L, P, N);
  const int threads = 32 * (round16(L) / 16);
  e = set_smem(ssd_bwd_rows_mma_kernel, smem);  // (c'1)
  if (e != cudaSuccess) return e;
  ssd_bwd_rows_mma_kernel<<<grid, threads, smem, s>>>(xt, dt, a, bt, ct, dyt, states_in,
                                                      static_cast<__nv_bfloat16*>(dc), srow, Tn,
                                                      H, P, N, L);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  switch (padded_p(P)) {  // (c'2)
    case 16:
      return launch_cols_mma<16>(grid, threads, smem, xt, dt, a, bt, ct, dyt, states_in, sbar,
                                 srow, dx, ddt, db, da_part, Tn, H, P, N, L, s);
    case 32:
      return launch_cols_mma<32>(grid, threads, smem, xt, dt, a, bt, ct, dyt, states_in, sbar,
                                 srow, dx, ddt, db, da_part, Tn, H, P, N, L, s);
    case 64:
      return launch_cols_mma<64>(grid, threads, smem, xt, dt, a, bt, ct, dyt, states_in, sbar,
                                 srow, dx, ddt, db, da_part, Tn, H, P, N, L, s);
    default:
      return launch_cols_mma<128>(grid, threads, smem, xt, dt, a, bt, ct, dyt, states_in, sbar,
                                  srow, dx, ddt, db, da_part, Tn, H, P, N, L, s);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Shared memory (bytes) the largest CTA of a body (0 = fp32, 1 = mma)
// takes for chunk L, head dim P and state dim N: the wrapper holds it
// against the card's limit.
extern "C" size_t ssd_scan_bwd_smem_bytes(int L, int P, int N, int body) {
  return largest_smem(L, P, N, body);
}

// x, dy (B, T, H, P) and b, c (B, T, H, N) of one dtype (0 = fp32, 1 = bf16);
// dt (B, T, H) and a (H,) fp32; states_in (B, nc, H, P, N) fp32, the state
// entering each of the nc = ceil(T / L) chunks; dstate (B, H, P, N) fp32 or
// null (zero).  Outputs: dx, db, dc in x's dtype, d(dt) fp32, dinit (B, H,
// P, N) fp32 or null (not wanted).  Scratch, fp32: sbar (B, nc, H, P, N),
// decays and da_part (B, nc, H), whose sum over (B, nc) is da, and srow
// (B, nc, H, ceil(L / 32) * 32).  All contiguous; x, b, c, dy, dx, db, dc on
// 16-byte boundaries; P and N whole 16-byte vectors and multiples of 4;
// 1 <= L <= 128.  body: 0 = fp32 (both dtypes), 1 = mma (bf16).  Returns a
// cudaError_t code, 0 on success.
extern "C" int ssd_scan_bwd_launch(const void* x, const void* dt, const void* a, const void* b,
                                   const void* c, const void* dy, const void* states_in,
                                   const void* dstate, void* dx, void* ddt, void* db, void* dc,
                                   void* dinit, void* sbar, void* decays, void* srow,
                                   void* da_part, int B, int Tn, int H, int P, int N, int L,
                                   int dtype, int body, void* stream) {
  const int itemsize = dtype == 0 ? 4 : 2;
  if (B < 0 || Tn < 0 || H < 0 || P <= 0 || N <= 0 || L <= 0 || L > 128 ||
      (P * itemsize) % 16 != 0 || (N * itemsize) % 16 != 0 || P % 4 != 0 || N % 4 != 0 ||
      N > 128 || P > 128 || (dtype != 0 && dtype != 1) || (body != 0 && body != 1) ||
      (body == 1 && dtype != 1) || !aligned16(x) || !aligned16(b) || !aligned16(c) ||
      !aligned16(dy) || !aligned16(dx) || !aligned16(db) || !aligned16(dc))
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
  if (body == 1)
    e = launch_bwd_mma(x, dtf, af, b, c, dy, entering, ds, dx, ddtf, db, dc, di, sb, dec, sr, dap,
                       B, Tn, H, P, N, L, s);
  else if (dtype == 0)
    e = launch_bwd<float>(x, dtf, af, b, c, dy, entering, ds, dx, ddtf, db, dc, di, sb, dec, sr, dap,
                          B, Tn, H, P, N, L, s);
  else
    e = launch_bwd<__nv_bfloat16>(x, dtf, af, b, c, dy, entering, ds, dx, ddtf, db, dc, di, sb, dec, sr,
                                  dap, B, Tn, H, P, N, L, s);
  return (int)e;
}
