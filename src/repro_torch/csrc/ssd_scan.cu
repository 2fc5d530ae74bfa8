// Mamba-2 SSD chunked scan for Hopper (sm_90a), fp32 and bf16 inputs.
//
// Replaces src/repro/kernels/ssd_scan.py::ssd_scan (the Pallas kernel body
// _ssd_kernel).  For x (B, T, H, P), dt (B, T, H) fp32, a (H,) fp32 and
// b/c (B, T, H, N), each chunk of L steps of each (b, h) computes
//
//     s     = cumsum(a * dt)
//     G_ij  = exp(s_i - s_j) * dt_j * [j <= i]
//     y     = ((C B^T) . G) X + exp(s) * (C S_in^T)
//     S_out = exp(s_L) * S_in + sum_j exp(s_L - s_j) * dt_j * x_j (x) b_j
//
// with padded steps (t >= T) given dt = 0, y in x's dtype and the final
// state (B, H, P, N) in fp32.  Unlike the Pallas kernel, this one takes an
// initial state (B, H, P, N) fp32, as ssd_chunked_ref does; without one the
// scan starts from zero.
//
// What bounds it: operations, here.  Per chunk and head the function needs
// L (L + 1) (N + P) + 4 L P N flops (the pairs j <= i of C B^T and of its
// product with X, then C S_in^T and the state update) against reading x, dt,
// b, c and writing y once; at mamba2-780m's L = 128, P = 64, N = 128 that is
// about 75 flops per byte in bf16 and 37 in fp32.  On the tensor cores bf16
// is bound by bytes (the ridge is about 295 flops per byte); on the CUDA
// cores fp32 is bound by operations (ridge 20).
//
// Three bodies, chosen by the wrapper (kernels/ssd_scan.py):
//
// * chunked (the chunked algorithm of the Mamba-2 paper, Dao & Gu 2024,
//   section 6), three launches:
//   (a) one CTA per (b, chunk, h): s, and the chunk's own state
//       S_c = sum_j exp(s_L - s_j) dt_j x_j (x) b_j, written with exp(s_L)
//       to fp32 scratch (B, n_chunks, H, P, N) and (B, n_chunks, H);
//   (b) the inter-chunk pass S_in[c + 1] = exp(s_L[c]) S_in[c] + S_c, in
//       sequence over chunks, in parallel over (b, h) and the P x N state;
//       it overwrites each S_c with S_in[c] in place and writes the final
//       state (in bf16, where the gradient will read them, `keep` has it
//       write the fp32 S_in[c] in place as well as the bf16 parts (c) reads);
//   (c) one CTA per (b, chunk, h): the whole output of the chunk,
//       y = ((C B^T) . G) X + exp(s) (C S_in^T), rounded once.
//   (The diagonal product sits in (c) and not in (a), so that y is
//   rounded to x's dtype once and no fp32 y goes through device memory.)
//   bf16: C B^T, ((C B^T) . G) X and C S_in^T run on mma.sync m16n8k16
//   from ldmatrix with fp32 sums, and so does the state product of (a).
//   b, c and x are exact in bf16, but w . x (w_j = exp(s_L - s_j) dt_j),
//   (C B^T) . G and S_in are fp32 values: each goes in as a bf16 high part
//   and its bf16 rest, two products, so that the state keeps fp32's
//   accuracy and y bf16's (one rounding to bf16 costs 2^-9 of each term,
//   which moved y by 0.25 where terms of up to 65 cancel, on mamba2-780m's
//   shapes).  fp32: the same three launches on the CUDA cores, with the
//   serial body's per-chunk code.  The scratch is read and written about
//   four times (a writes, b reads and writes, c reads).  At a whole call
//   (mamba2-780m's 48 heads: 1,536 CTAs each for (a) and (c)) the card is
//   full; on one tensor-parallel rank's heads (3 of them at |model| = 16:
//   96 CTAs, one wave) each launch lasts as long as its slowest CTA's
//   serial chain of loads and products, and nothing of one launch overlaps
//   the next: 8.0 + 3.7 + 18.1 us by launch, 37.9 us in all, against a
//   2.89 us bound (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 7g).
//
// * fused (bf16; ssd_fused_kernel): (a), the pass over chunks and (c) in
//   one cooperative launch, for a rank's heads, where the whole grid fits
//   one wave (the wrapper checks it against the card's occupancy, and the
//   driver refuses a cooperative grid that the card cannot hold at once,
//   whatever else runs on it).  One CTA a chunk writes the chunk's own
//   state; after a grid barrier every CTA walks the pass (b)'s fmaf chain
//   of a 1 / n_chunks share of its head's state elements through every
//   chunk; after a second barrier it reads the state entering its chunk:
//   two rounds of loads a CTA in place of a launch.  `split` CTAs may share
//   a chunk by P columns of the state and of y, where that still fits one
//   wave (each stages all of B and C and forms all of C B^T).  The grid
//   barriers need no buffer of counters kept between calls, so the body
//   is safe on any stream and under CUDA-graph replay.  One rank at
//   |model| = 16 takes 32.8 us at mamba2's 3 heads and 35.6 at zamba2's 7,
//   against chunked's 38.3 / 40.9 in turns; chunked's three launches
//   joined by programmatic dependent launch, (c) staging and forming M X
//   before it waits on (b), took 37.9 / 36.9 (NVIDIA H100 80GB HBM3,
//   700 W; chip_smoke.py phase 7g, tools/kernel_variants.py ssd_scan_rank
//   --pdl).
//   A fused CTA is a serial chain of loads, barriers and products: at
//   mamba2's 3 heads, one CTA a chunk, 11.7 us of launch, barriers and
//   flags, 3.8 of staging, 2.3 of stores, 5.1 of the pass over chunks
//   folded by each CTA (walking it takes 3-4 us less) and 8.6 of products
//   (NVIDIA H100 80GB HBM3, 700 W; each step left out in turn by
//   tools/kernel_variants.py ssd_scan_fused --unchecked, with the flags
//   between CTAs that the grid barriers replaced).  It takes what the
//   chunked body takes in bf16, every product's terms in the same order, so
//   its y, final state and kept states are the chunked body's bit for bit.
//
// * serial (the first port's body): one CTA of 256 threads owns a whole
//   (b, h) and loops over its chunks, with the (P x N) state kept in shared
//   memory from one chunk to the next, all in fp32 on the CUDA cores.
//   Shared memory is the constraint: staging b, c, x, G and S in fp32 at
//   L = 128, P = 64, N = 128 takes 256 KB, more than the 227 KB a block may
//   use, so (C B^T) . G is built 32 rows at a time and each 32-row block of
//   y is finished before the next (216 KB in all); only the blocks of C B^T
//   on or below the diagonal are computed.  B * H CTAs (96 for mamba2-780m
//   at B = 2) occupy 96 of 132 SMs and run their chunks in sequence.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC -I csrc; bound through a plain C entry point.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "ssd_common.cuh"

namespace {

// y of the chunk starting at t0: ((C B^T) . G) X + exp(s) (C St^T), in
// row blocks of RB (s, Ct, Bt, Xs, St staged; ends after a __syncthreads).
template <typename T>
__device__ __forceinline__ void chunk_y(const ChunkSmem& s, T* y, int Tn, int H, int P, int N,
                                        int L, int b, int h, int t0) {
  const int tid = threadIdx.x, LP = s.LP, LS = s.LS;
  const float* sv = s.sv;
  const float* sl = s.sl;
  const float* dv = s.dv;
  for (int r0 = 0; r0 < LP; r0 += RB) {
    const int rows = min(RB, LP - r0);
    const int jn = r0 + rows;  // columns j <= i < jn
    const int cg = jn / 4;
    // Mt[j][i - r0] = (C_i . B_j) * exp(s_i - s_j) * dt_j for j <= i, else 0.
    for (int mi = tid; mi < (rows / 4) * cg; mi += NT) {
      const int ig = mi / cg;
      const int i0 = r0 + ig * 4, j0 = (mi - ig * cg) * 4;
      float acc[4][4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = 0.f;
      if (j0 <= i0 + 3) {
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          const float4 cv = *reinterpret_cast<const float4*>(s.Ct + n * LS + i0);
          const float4 bv = *reinterpret_cast<const float4*>(s.Bt + n * LS + j0);
          const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
          const float ba[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = fmaf(ca[ii], ba[jj], acc[ii][jj]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j0 + jj;
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int i = i0 + ii;
          const float g = j <= i ? expf(s_diff(sv, sl, i, j)) * dv[j] : 0.f;
          s.Mt[j * MS + (i - r0)] = acc[ii][jj] * g;
        }
      }
    }
    __syncthreads();

    // y rows [r0, r0 + rows): blocks of 4 rows x 2 columns of P.
    const int pg = P / 2;
    for (int mi = tid; mi < (rows / 4) * pg; mi += NT) {
      const int ig = mi / pg;
      const int i0 = r0 + ig * 4, p0 = (mi - ig * pg) * 2;
      float intra[4][2], inter[4][2];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) intra[ii][0] = intra[ii][1] = inter[ii][0] = inter[ii][1] = 0.f;
      const int jend = min(jn, i0 + 4);
      for (int j = 0; j < jend; ++j) {
        const float4 mv = *reinterpret_cast<const float4*>(s.Mt + j * MS + ig * 4);
        const float2 xv = *reinterpret_cast<const float2*>(s.Xs + j * P + p0);
        const float ma[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          intra[ii][0] = fmaf(ma[ii], xv.x, intra[ii][0]);
          intra[ii][1] = fmaf(ma[ii], xv.y, intra[ii][1]);
        }
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float4 cv = *reinterpret_cast<const float4*>(s.Ct + n * LS + i0);
        const float2 st = *reinterpret_cast<const float2*>(s.St + n * P + p0);
        const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          inter[ii][0] = fmaf(ca[ii], st.x, inter[ii][0]);
          inter[ii][1] = fmaf(ca[ii], st.y, inter[ii][1]);
        }
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = i0 + ii, t = t0 + i;
        if (i < L && t < Tn) {
          const float e = expf(sv[i] + sl[i]);
          Vec<T>::store2(y + (((size_t)b * Tn + t) * H + h) * P + p0,
                         intra[ii][0] + e * inter[ii][0], intra[ii][1] + e * inter[ii][1]);
        }
      }
    }
    __syncthreads();  // Mt is rewritten by the next row block
  }
}

// The serial body: one CTA per (b, h), its chunks in sequence.
template <typename T>
__global__ void __launch_bounds__(NT) ssd_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const T* __restrict__ bm, const T* __restrict__ cm, const float* __restrict__ init,
    T* __restrict__ y, float* __restrict__ final_state, int Tn, int H, int P, int N, int L) {
  extern __shared__ __align__(16) float smem[];
  const ChunkSmem s = carve(smem, L, P, N);
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const float ah = a[h];
  const size_t bh = (size_t)b * H + h;
  for (int i = tid; i < N * P; i += NT) {
    const int n = i / P, p = i - n * P;
    s.St[i] = init != nullptr ? init[(bh * P + p) * N + n] : 0.f;
  }
  const int n_chunks = (Tn + L - 1) / L;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * L;
    __syncthreads();  // the previous chunk is consumed
    stage_chunk<T>(s, x, dt, bm, cm, Tn, H, P, N, L, b, h, t0);
    __syncthreads();
    chunk_cumsum(s.sv, s.sl, s.dv, s.LP, ah);
    __syncthreads();
    const int jL = s.LP - 1;
    for (int j = tid; j < s.LP; j += NT) s.wv[j] = expf(s_diff(s.sv, s.sl, jL, j)) * s.dv[j];
    chunk_y<T>(s, y, Tn, H, P, N, L, b, h, t0);
    chunk_state(s, expf(s.sv[jL] + s.sl[jL]), P, N);
  }
  __syncthreads();
  for (int i = tid; i < N * P; i += NT) {
    const int p = i / N, n = i - p * N;
    final_state[(bh * P + p) * N + n] = s.St[n * P + p];
  }
}

// ---------------------------------------------------------------------------
// The chunked body
// ---------------------------------------------------------------------------
// (a), fp32: the chunk's own state and exp(s_L).  Grid (H, n_chunks, B).
template <typename T>
__global__ void __launch_bounds__(NT) ssd_chunk_state_f32_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const T* __restrict__ bm, float* __restrict__ states, float* __restrict__ decays, int Tn,
    int H, int P, int N, int L) {
  extern __shared__ __align__(16) float smem[];
  const ChunkSmem s = carve(smem, L, P, N);
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int tid = threadIdx.x;
  for (int i = tid; i < N * P; i += NT) s.St[i] = 0.f;
  stage_chunk<T>(s, x, dt, bm, nullptr, Tn, H, P, N, L, b, h, c * L);
  __syncthreads();
  chunk_cumsum(s.sv, s.sl, s.dv, s.LP, a[h]);
  __syncthreads();
  const int jL = s.LP - 1;
  for (int j = tid; j < s.LP; j += NT) s.wv[j] = expf(s_diff(s.sv, s.sl, jL, j)) * s.dv[j];
  __syncthreads();
  chunk_state(s, 0.f, P, N);
  __syncthreads();
  const size_t ci = chunk_index(b, c, h, nc, H);
  float* out = states + ci * P * N;
  for (int i = tid; i < N * P; i += NT) {
    const int p = i / N, n = i - p * N;
    out[i] = s.St[n * P + p];
  }
  if (tid == 0) decays[ci] = expf(s.sv[jL] + s.sl[jL]);
}

// (c), fp32: y of the chunk from S_in.  Grid (H, n_chunks, B).
template <typename T>
__global__ void __launch_bounds__(NT) ssd_chunk_out_f32_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const T* __restrict__ bm, const T* __restrict__ cm, const float* __restrict__ states,
    T* __restrict__ y, int Tn, int H, int P, int N, int L) {
  extern __shared__ __align__(16) float smem[];
  const ChunkSmem s = carve(smem, L, P, N);
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int tid = threadIdx.x;
  const float* in = states + chunk_index(b, c, h, nc, H) * P * N;
  for (int i = tid; i < N * P; i += NT) {
    const int n = i / P, p = i - n * P;
    s.St[i] = in[(size_t)p * N + n];
  }
  stage_chunk<T>(s, x, dt, bm, cm, Tn, H, P, N, L, b, h, c * L);
  __syncthreads();
  chunk_cumsum(s.sv, s.sl, s.dv, s.LP, a[h]);
  __syncthreads();
  chunk_y<T>(s, y, Tn, H, P, N, L, b, h, c * L);
}

// Shared memory (bytes) of (c) in bf16.
size_t mma_out_smem(int L, int PP, int N) {
  const size_t LP = round16(L), CS = round16(N) + 8;
  const size_t RR = LP > 2 * (size_t)PP ? LP : 2 * (size_t)PP;
  return 2 * ((LP + RR) * CS + LP * (PP + 8)) + 4 * 3 * LP;
}

// (c), bf16: y of the chunk.  Warp w takes rows 16w .. 16w + 15: G = C B^T
// over the column blocks on or below its diagonal, masked and weighted into
// M = (C B^T) . G, then M X and C S_in^T, all on mma.sync with fp32 sums.
// M and S_in are fp32 values: each goes in as a bf16 high part and its bf16
// rest, two products, since one rounding to bf16 (2^-9 of each term) moves
// y by more than bf16's tolerance where large terms cancel.  S_in comes
// split so from (b); B's tile is dead once C B^T is formed, so S_in's two
// parts take its place, loaded by cp.async under M and M X.
// Grid (H, n_chunks, B), LP / 16 warps.  PP: P padded to 16, 32, 64 or 128.
template <int PP>
__global__ void __launch_bounds__(256) ssd_chunk_out_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const __nv_bfloat16* __restrict__ bm, const __nv_bfloat16* __restrict__ cm,
    const __nv_bfloat16* __restrict__ s_in, __nv_bfloat16* __restrict__ y, int Tn, int H, int P,
    int N, int L) {
  constexpr int ND = PP / 8, XS = PP + 8;
  const int LP = round16(L), NP = round16(N);
  const int CS = NP + 8;
  const int RR = max(LP, 2 * PP);  // rows of the region that holds B, then S_in
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // LP x CS
  __nv_bfloat16* Bs = Cs + LP * CS;                                 // LP x CS, then:
  __nv_bfloat16* Sh = Bs;                                           //   PP x CS: bf16(S_in)
  __nv_bfloat16* Sl = Bs + PP * CS;                                 //   PP x CS: bf16(S_in - Sh)
  __nv_bfloat16* Xs = Bs + RR * CS;                                 // LP x XS
  float* sv = reinterpret_cast<float*>(Xs + LP * XS);               // LP
  float* dv = sv + LP;                                              // LP
  float* sl = dv + LP;                                              // LP
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int t0 = c * L;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, lm = lane >> 3, lr = lane & 7;

  stage_rows(Cs, CS, cm, N, NP, LP, L, Tn, H, b, h, t0);
  stage_rows(Bs, CS, bm, N, NP, LP, L, Tn, H, b, h, t0);
  stage_rows(Xs, XS, x, P, PP, LP, L, Tn, H, b, h, t0);
  hopper::cp_async_commit();
  stage_dt(dv, dt, LP, L, Tn, H, b, h, t0);
  hopper::cp_async_wait<0>();
  __syncthreads();
  chunk_cumsum(sv, sl, dv, LP, a[h]);
  __syncthreads();

  const int i0 = warp * 16;
  const int nj_end = 2 * (warp + 1);  // 8-wide column blocks j < i0 + 16
  float gm[16][4];
#pragma unroll
  for (int nj = 0; nj < 16; ++nj)
#pragma unroll
    for (int e = 0; e < 4; ++e) gm[nj][e] = 0.f;
  for (int kk = 0; kk < NP / 16; ++kk) {
    uint32_t ac[4];
    hopper::ldsm_x4(ac[0], ac[1], ac[2], ac[3], Cs + (i0 + lr + 8 * (lm & 1)) * CS + kk * 16 + 8 * (lm >> 1));
#pragma unroll
    for (int nj = 0; nj < 16; nj += 2) {
      if (nj < nj_end) {  // warp-uniform
        uint32_t b0, b1, b2, b3;
        hopper::ldsm_x4(b0, b1, b2, b3, Bs + (nj * 8 + lr + 8 * (lm >> 1)) * CS + kk * 16 + 8 * (lm & 1));
        hopper::mma_bf16(gm[nj], ac, b0, b1);
        hopper::mma_bf16(gm[nj + 1], ac, b2, b3);
      }
    }
  }
  __syncthreads();  // every warp is done with B: S_in's two parts take its place
  {
    const size_t PN = (size_t)P * N;
    const __nv_bfloat16* hi = s_in + chunk_index(b, c, h, nc, H) * 2 * PN;
    const int nv = NP / 8;
    for (int i = tid; i < PP * nv; i += blockDim.x) {
      const int p = i / nv, c8 = (i - p * nv) * 8;
      const bool ok = p < P && c8 < N;
      const size_t off = ok ? (size_t)p * N + c8 : 0;
      hopper::cp_async16(Sh + p * CS + c8, hi + off, ok);
      hopper::cp_async16(Sl + p * CS + c8, hi + PN + off, ok);
    }
    hopper::cp_async_commit();  // in flight under M and M X
  }

  // M_ij = (C_i . B_j) exp(s_i - s_j) dt_j for j <= i, else 0
#pragma unroll
  for (int nj = 0; nj < 16; ++nj) {
    if (nj < nj_end) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + g + 8 * (e >> 1), j = nj * 8 + 2 * t4 + (e & 1);
        gm[nj][e] = j <= i ? gm[nj][e] * expf(s_diff(sv, sl, i, j)) * dv[j] : 0.f;
      }
    }
  }
  float yd[ND][4], yo[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) yd[nd][e] = yo[nd][e] = 0.f;
  // M X, over the 16-deep blocks of j up to the diagonal, M in two parts
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    if (kk <= warp) {
      uint32_t ah[4], al[4];
      acc_to_a(gm[2 * kk], gm[2 * kk + 1], ah, al);
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t b0, b1, b2, b3;
        hopper::ldsm_x4_trans(b0, b1, b2, b3, Xs + (kk * 16 + lr + 8 * (lm & 1)) * XS + nd * 8 + 8 * (lm >> 1));
        hopper::mma_bf16(yd[nd], ah, b0, b1);
        hopper::mma_bf16(yd[nd + 1], ah, b2, b3);
        hopper::mma_bf16(yd[nd], al, b0, b1);
        hopper::mma_bf16(yd[nd + 1], al, b2, b3);
      }
    }
  }
  hopper::cp_async_wait<0>();
  __syncthreads();  // S_in's parts are staged
  // C S_in^T, S_in in two parts
  for (int kk = 0; kk < NP / 16; ++kk) {
    uint32_t ac[4];
    hopper::ldsm_x4(ac[0], ac[1], ac[2], ac[3], Cs + (i0 + lr + 8 * (lm & 1)) * CS + kk * 16 + 8 * (lm >> 1));
#pragma unroll
    for (int nd = 0; nd < ND; nd += 2) {
      const int so = (nd * 8 + lr + 8 * (lm >> 1)) * CS + kk * 16 + 8 * (lm & 1);
      uint32_t b0, b1, b2, b3;
      hopper::ldsm_x4(b0, b1, b2, b3, Sh + so);
      hopper::mma_bf16(yo[nd], ac, b0, b1);
      hopper::mma_bf16(yo[nd + 1], ac, b2, b3);
      hopper::ldsm_x4(b0, b1, b2, b3, Sl + so);
      hopper::mma_bf16(yo[nd], ac, b0, b1);
      hopper::mma_bf16(yo[nd + 1], ac, b2, b3);
    }
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int i = i0 + g + 8 * hf, t = t0 + i;
    if (i >= L || t >= Tn) continue;
    const float e = expf(sv[i] + sl[i]);
    __nv_bfloat16* yr = y + (((size_t)b * Tn + t) * H + h) * P;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int p = nd * 8 + 2 * t4;
      if (p < P)
        Vec<__nv_bfloat16>::store2(yr + p, yd[nd][2 * hf] + e * yo[nd][2 * hf],
                                   yd[nd][2 * hf + 1] + e * yo[nd][2 * hf + 1]);
    }
  }
}

// (b): S_in[0] = init (or 0), S_in[c + 1] = exp(s_L[c]) S_in[c] + S_c; the
// last step gives the final state.  S_in[c] goes to s_in: fp32 in place of
// S_c (s_in == states; fp32 inputs), or as the bf16 high part and the bf16
// rest of each element, (P N) of each after the other per chunk (bf16
// inputs: what (c) multiplies by), and with `keep` in fp32 in place of S_c
// as well (what the gradient reads).  Grid (ceil(P N / 256), B H), one
// thread per state element, the chunks' loads batched ahead of the chain.
__global__ void __launch_bounds__(256) ssd_state_pass_kernel(
    float* states, const float* __restrict__ decays, const float* __restrict__ init,
    void* s_in, int pairs, int keep, float* __restrict__ final_state, int nc, int H, int PN) {
  constexpr int BATCH = 8;
  const int idx = blockIdx.x * 256 + threadIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  if (idx >= PN) return;
  float st = init != nullptr ? init[(size_t)bh * PN + idx] : 0.f;
  for (int c0 = 0; c0 < nc; c0 += BATCH) {
    float sc[BATCH], dc[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      if (c0 + u < nc) {
        const size_t ci = chunk_index(b, c0 + u, h, nc, H);
        sc[u] = states[ci * PN + idx];
        dc[u] = decays[ci];
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      if (c0 + u < nc) {
        const size_t ci = chunk_index(b, c0 + u, h, nc, H);
        if (pairs) {
          __nv_bfloat16* out = static_cast<__nv_bfloat16*>(s_in) + ci * 2 * PN + idx;
          const __nv_bfloat16 hi = __float2bfloat16(st);
          out[0] = hi;
          out[PN] = __float2bfloat16(st - __bfloat162float(hi));
          if (keep) states[ci * PN + idx] = st;
        } else {
          static_cast<float*>(s_in)[ci * PN + idx] = st;
        }
        st = dc[u] * st + sc[u];
      }
    }
  }
  final_state[(size_t)bh * PN + idx] = st;
}

// ---------------------------------------------------------------------------
// The fused body (bf16): (a), the pass over chunks and (c) in one launch
// ---------------------------------------------------------------------------
// Columns [0, W) of rows [t0, t0 + L) of a (B, T, H, ld) bf16 tensor (src
// already at the first column) into a (LP x stride) tile by cp.async (the
// caller commits and waits): zeros past the chunk, past T and past W.
__device__ __forceinline__ void stage_cols(__nv_bfloat16* dst, int stride, const __nv_bfloat16* src,
                                           int ld, int W, int WP, int LP, int L, int Tn, int H,
                                           int b, int h, int t0) {
  const int nv = WP / 8;
  for (int i = threadIdx.x; i < LP * nv; i += blockDim.x) {
    const int j = i / nv, c = (i - j * nv) * 8;
    const int t = t0 + j;
    const bool ok = j < L && t < Tn && c < W;
    hopper::cp_async16(dst + j * stride + c,
                       ok ? src + (((size_t)b * Tn + t) * H + h) * ld + c : src, ok);
  }
}

// Shared memory (bytes) of a fused CTA: chunk L, PP (its P columns padded to
// 16, 32, 64 or 128), N.
size_t fused_smem(int L, int PP, int N) {
  const size_t LP = round16(L), CS = round16(N) + 8, XS = (size_t)PP + 8;
  const size_t U = 2 * LP * XS > 2 * (size_t)PP * CS ? 2 * LP * XS : 2 * (size_t)PP * CS;
  return 2 * (2 * LP * CS + LP * XS + U) + 4 * 3 * LP;
}

// Grid (H * split, n_chunks, B), LP / 16 warps, launched cooperatively, so
// that every CTA of the grid is resident at once (the driver refuses a
// grid that the card cannot hold at once).  CTA (h * split + ps, c, b)
// takes chunk c and P columns [ps P / split, (ps + 1) P / split) of head h.
// In order:
//  1. stage B and its X columns (one cp.async group) and C (a second), dt;
//     s = cumsum(a dt) while B and X are in flight;
//  2. (a): its columns of the chunk's own state S_c on mma.sync (u = w . x
//     in two bf16 parts), written in fp32 to `own` with exp(s_L) to
//     `decays`;
//  3. a grid barrier; then the pass over chunks (b), walked: CTA c takes
//     a 1 / nc share of its columns' state elements through every chunk
//     of its (b, h); a second grid barrier; then its S_in[c] to shared
//     memory as a bf16 high part and the rest;
//  4. (c): C B^T, M = (C B^T) . G and M X for its columns, C S_in^T, and y
//     rounded once, as ssd_chunk_out_mma_kernel computes them.
// Every product keeps (a)'s and (c)'s order of terms, and the walk (b)'s,
// so a rank's heads are bit for bit what the chunked body gives.  At P up
// to 64 two CTAs share an SM (128 registers each): zamba2's rank, 224
// chunks on 132 SMs, is then one wave.
template <int PP>
__global__ void __launch_bounds__(256, PP <= 64 ? 2 : 1) ssd_fused_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const __nv_bfloat16* __restrict__ bm, const __nv_bfloat16* __restrict__ cm,
    const float* __restrict__ init, __nv_bfloat16* __restrict__ y, float* __restrict__ final_state,
    float* own, float* decays, float* __restrict__ kept, int Tn, int H, int P, int N, int L,
    int split) {
  constexpr int ND = PP / 8, XS = PP + 8;
  const int LP = round16(L), NP = round16(N), CS = NP + 8;
  const int nc = gridDim.y, PS = P / split;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // LP x CS
  __nv_bfloat16* Bs = Cs + LP * CS;                                 // LP x CS
  __nv_bfloat16* Xs = Bs + LP * CS;                                 // LP x XS: its columns of X
  __nv_bfloat16* Ur = Xs + LP * XS;  // u's two parts (LP x XS each), then S_in's (PP x CS each)
  const int U = max(2 * LP * XS, 2 * PP * CS);
  float* sv = reinterpret_cast<float*>(Ur + U);                     // LP
  float* dv = sv + LP;                                              // LP
  float* sl = dv + LP;                                              // LP
  const int h = blockIdx.x / split, ps = blockIdx.x - h * split, c = blockIdx.y, b = blockIdx.z;
  const int p0 = ps * PS, t0 = c * L;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, nw = blockDim.x >> 5;
  const int g = lane >> 2, t4 = lane & 3, lm = lane >> 3, lr = lane & 7;
  const size_t PN = (size_t)P * N, bh = (size_t)b * H + h;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();

  // 1. staging; s is summed while B and X are still in flight
  stage_rows(Bs, CS, bm, N, NP, LP, L, Tn, H, b, h, t0);  // stage B
  stage_cols(Xs, XS, x + p0, P, PS, PP, LP, L, Tn, H, b, h, t0);  // stage X
  hopper::cp_async_commit();
  stage_rows(Cs, CS, cm, N, NP, LP, L, Tn, H, b, h, t0);  // stage C
  hopper::cp_async_commit();
  stage_dt(dv, dt, LP, L, Tn, H, b, h, t0);
  __syncthreads();
  chunk_cumsum(sv, sl, dv, LP, a[h]);  // s, under B's and X's loads
  hopper::cp_async_wait<1>();
  __syncthreads();

  // 2. (a), as ssd_chunk_state_mma_kernel<false>
  const int jL = LP - 1;
  __nv_bfloat16* Uh = Ur;
  __nv_bfloat16* Ul = Ur + LP * XS;
  for (int i = tid; i < LP * (PP / 8); i += blockDim.x) {
    const int j = i / (PP / 8), c8 = (i - j * (PP / 8)) * 8;
    float f[8];
    Vec<__nv_bfloat16>::load(Xs + j * XS + c8, f);
    const float w = expf(s_diff(sv, sl, jL, j)) * dv[j];
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_bf16(f[2 * e] * w, f[2 * e + 1] * w, hi[e], lo[e]);
    *reinterpret_cast<uint4*>(Uh + j * XS + c8) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(Ul + j * XS + c8) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  __syncthreads();
  const size_t ci = chunk_index(b, c, h, nc, H);
  float* own_c = own + ci * PN + (size_t)p0 * N;
  // units of 16 p x 16 n, two a warp at a time: two chains of dependent
  // products in flight, each unit's terms in (a)'s order
  const int npr = NP / 16, units = (PP / 16) * npr;
  for (int u0 = warp; u0 < units; u0 += 2 * nw) {
    const int un[2] = {u0, u0 + nw};
    const bool two = un[1] < units;  // warp-uniform
    float acc[2][2][4] = {};
    for (int kk = 0; kk < LP / 16; ++kk) {  // (a)'s products
      uint32_t b0, b1, b2, b3;
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        if (w == 1 && !two) break;
        const int mt = un[w] / npr, np = un[w] - mt * npr;
        uint32_t ah[4], al[4];
        const int ua = (kk * 16 + 8 * (lm >> 1) + lr) * XS + mt * 16 + 8 * (lm & 1);
        hopper::ldsm_x4_trans(ah[0], ah[1], ah[2], ah[3], Uh + ua);
        hopper::ldsm_x4_trans(al[0], al[1], al[2], al[3], Ul + ua);
        hopper::ldsm_x4_trans(b0, b1, b2, b3, Bs + (kk * 16 + lr + 8 * (lm & 1)) * CS + np * 16 + 8 * (lm >> 1));
        hopper::mma_bf16(acc[w][0], ah, b0, b1);
        hopper::mma_bf16(acc[w][1], ah, b2, b3);
        hopper::mma_bf16(acc[w][0], al, b0, b1);
        hopper::mma_bf16(acc[w][1], al, b2, b3);
      }
    }
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      if (w == 1 && !two) break;
      const int mt = un[w] / npr, np = un[w] - mt * npr;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int p = mt * 16 + g + 8 * hf, n = np * 16 + nt * 8 + 2 * t4;
          if (p < PS && n < N)  // store S_c
            *reinterpret_cast<float2*>(own_c + (size_t)p * N + n) =
                make_float2(acc[w][nt][2 * hf], acc[w][nt][2 * hf + 1]);
        }
    }
  }
  if (tid == 0) decays[ci] = expf(sv[jL] + sl[jL]);

  // 3. S_in[c], the state entering this chunk: every element's chain st =
  // fmaf(exp(s_L[k]), st, S_k) from the initial state (or 0) in chunk
  // order, the expression ssd_state_pass_kernel evaluates, so the same
  // bits.  Once every chunk's own state is in device memory (the grid
  // barrier), CTA c walks the chain of its 1 / nc share of its columns'
  // elements through every chunk, writing S_in[k] of that share (in place
  // of S_k, or to `kept`) and the final state; after a second barrier it
  // reads its S_in[c] and puts it in shared memory as a bf16 high part and
  // the rest: two rounds of loads a CTA.
  grid.sync();  // every S_c and decay is written; u is dead
  __nv_bfloat16* Sh = Ur;            // PP x CS: bf16(S_in)
  __nv_bfloat16* Sl = Ur + PP * CS;  // PP x CS: bf16(S_in - Sh)
  {
    const int nv = NP / 8;  // zeros past its columns and past N
    for (int i = tid; i < PP * nv; i += blockDim.x) {
      const int p = i / nv, c8 = (i - p * nv) * 8;
      if (p >= PS || c8 >= N) {
        *reinterpret_cast<uint4*>(Sh + p * CS + c8) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(Sl + p * CS + c8) = make_uint4(0, 0, 0, 0);
      }
    }
  }
  const int q4 = PS * N / 4;  // float4s of its columns of the state
  const float4* init4 =
      init != nullptr ? reinterpret_cast<const float4*>(init + bh * PN + (size_t)p0 * N) : nullptr;
  float* sin = kept != nullptr ? kept : own;
  const int lo = (int)((long long)q4 * c / nc), hi = (int)((long long)q4 * (c + 1) / nc);
  constexpr int KW = 8;  // chunks loaded at once
  for (int i = lo + tid; i < hi; i += blockDim.x) {
    float4 st = init4 != nullptr ? __ldg(init4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k0 = 0; k0 < nc; k0 += KW) {  // the walk
      float4 sc[KW];
      float dc[KW];
#pragma unroll
      for (int v = 0; v < KW; ++v) {
        if (k0 + v < nc) {
          const size_t ck = chunk_index(b, k0 + v, h, nc, H);
          dc[v] = __ldcg(decays + ck);
          sc[v] = __ldcg(reinterpret_cast<const float4*>(own + ck * PN + (size_t)p0 * N) + i);
        }
      }
#pragma unroll
      for (int v = 0; v < KW; ++v) {
        if (k0 + v < nc) {
          const size_t ck = chunk_index(b, k0 + v, h, nc, H);
          reinterpret_cast<float4*>(sin + ck * PN + (size_t)p0 * N)[i] = st;  // S_in[k]
          st.x = fmaf(dc[v], st.x, sc[v].x);
          st.y = fmaf(dc[v], st.y, sc[v].y);
          st.z = fmaf(dc[v], st.z, sc[v].z);
          st.w = fmaf(dc[v], st.w, sc[v].w);
        }
      }
    }
    reinterpret_cast<float4*>(final_state + (bh * P + p0) * N)[i] = st;
  }
  grid.sync();  // every share of S_in is written
  const float4* mine = reinterpret_cast<const float4*>(sin + ci * PN + (size_t)p0 * N);
  for (int i = tid; i < q4; i += blockDim.x) {
    const float4 st = __ldcg(mine + i);
    const int p = (4 * i) / N, n = 4 * i - p * N;
    uint32_t h0, l0, h1, l1;
    split_bf16(st.x, st.y, h0, l0);
    split_bf16(st.z, st.w, h1, l1);
    *reinterpret_cast<uint2*>(Sh + p * CS + n) = make_uint2(h0, h1);
    *reinterpret_cast<uint2*>(Sl + p * CS + n) = make_uint2(l0, l1);
  }
  hopper::cp_async_wait<0>();  // C
  __syncthreads();              // and S_in's two parts are staged

  // 4. (c), as ssd_chunk_out_mma_kernel: C B^T, M, M X, then C S_in^T.
  // Row block rb's triangular products grow with rb, and warps w and w + 4
  // share a scheduler (SM sub-partition): with 8 warps, warp w < 4 takes
  // block w and warp 4 + v block 7 - v, so that each scheduler holds 9 of
  // the 36 blocks' units rather than up to 12.
  const int rb = nw == 8 && warp >= 4 ? 11 - warp : warp;
  const int i0 = rb * 16;
  const int nj_end = 2 * (rb + 1);  // 8-wide column blocks j < i0 + 16
  float gm[16][4];
#pragma unroll
  for (int nj = 0; nj < 16; ++nj)
#pragma unroll
    for (int e = 0; e < 4; ++e) gm[nj][e] = 0.f;
  for (int kk = 0; kk < NP / 16; ++kk) {  // C B^T
    uint32_t ac[4];
    hopper::ldsm_x4(ac[0], ac[1], ac[2], ac[3], Cs + (i0 + lr + 8 * (lm & 1)) * CS + kk * 16 + 8 * (lm >> 1));
#pragma unroll
    for (int nj = 0; nj < 16; nj += 2) {
      if (nj < nj_end) {  // warp-uniform
        uint32_t b0, b1, b2, b3;
        hopper::ldsm_x4(b0, b1, b2, b3, Bs + (nj * 8 + lr + 8 * (lm >> 1)) * CS + kk * 16 + 8 * (lm & 1));
        hopper::mma_bf16(gm[nj], ac, b0, b1);
        hopper::mma_bf16(gm[nj + 1], ac, b2, b3);
      }
    }
  }
#pragma unroll
  for (int nj = 0; nj < 16; ++nj) {
    if (nj < nj_end) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + g + 8 * (e >> 1), j = nj * 8 + 2 * t4 + (e & 1);
        gm[nj][e] = j <= i ? gm[nj][e] * expf(s_diff(sv, sl, i, j)) * dv[j] : 0.f;  // M = (C B^T) . G
      }
    }
  }
  float yd[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) yd[nd][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {  // M X
    if (kk <= rb) {
      uint32_t ah[4], al[4];
      acc_to_a(gm[2 * kk], gm[2 * kk + 1], ah, al);
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t b0, b1, b2, b3;
        hopper::ldsm_x4_trans(b0, b1, b2, b3, Xs + (kk * 16 + lr + 8 * (lm & 1)) * XS + nd * 8 + 8 * (lm >> 1));
        hopper::mma_bf16(yd[nd], ah, b0, b1);
        hopper::mma_bf16(yd[nd + 1], ah, b2, b3);
        hopper::mma_bf16(yd[nd], al, b0, b1);
        hopper::mma_bf16(yd[nd + 1], al, b2, b3);
      }
    }
  }
  float yo[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) yo[nd][e] = 0.f;
  for (int kk = 0; kk < NP / 16; ++kk) {  // C S_in^T
    uint32_t ac[4];
    hopper::ldsm_x4(ac[0], ac[1], ac[2], ac[3], Cs + (i0 + lr + 8 * (lm & 1)) * CS + kk * 16 + 8 * (lm >> 1));
#pragma unroll
    for (int nd = 0; nd < ND; nd += 2) {
      const int so = (nd * 8 + lr + 8 * (lm >> 1)) * CS + kk * 16 + 8 * (lm & 1);
      uint32_t b0, b1, b2, b3;
      hopper::ldsm_x4(b0, b1, b2, b3, Sh + so);
      hopper::mma_bf16(yo[nd], ac, b0, b1);
      hopper::mma_bf16(yo[nd + 1], ac, b2, b3);
      hopper::ldsm_x4(b0, b1, b2, b3, Sl + so);
      hopper::mma_bf16(yo[nd], ac, b0, b1);
      hopper::mma_bf16(yo[nd + 1], ac, b2, b3);
    }
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int i = i0 + g + 8 * hf, t = t0 + i;
    if (i >= L || t >= Tn) continue;
    const float e = expf(sv[i] + sl[i]);
    __nv_bfloat16* yr = y + (((size_t)b * Tn + t) * H + h) * P + p0;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int p = nd * 8 + 2 * t4;
      if (p < PS)  // store y
        Vec<__nv_bfloat16>::store2(yr + p, yd[nd][2 * hf] + e * yo[nd][2 * hf],
                                   yd[nd][2 * hf + 1] + e * yo[nd][2 * hf + 1]);
    }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Shared memory (bytes) the chunked body's largest CTA takes.
size_t chunked_smem_bytes(int L, int P, int N, int dtype) {
  if (dtype == 0) return smem_bytes(L, P, N);
  const size_t sa = mma_state_smem(L, P, N), sc = mma_out_smem(L, padded_p(P), N);
  return sa > sc ? sa : sc;
}

template <int PP>
cudaError_t launch_out_mma(dim3 grid, int threads, size_t smem, const void* x, const float* dt,
                           const float* a, const void* b, const void* c, const void* s_in,
                           void* y, int Tn, int H, int P, int N, int L, cudaStream_t s) {
  auto kernel = ssd_chunk_out_mma_kernel<PP>;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), dt, a, static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(c), static_cast<const __nv_bfloat16*>(s_in),
      static_cast<__nv_bfloat16*>(y), Tn, H, P, N, L);
  return cudaGetLastError();
}

// The chunked body: (a), (b), (c) on one stream.
cudaError_t launch_chunked(const void* x, const float* dt, const float* a, const void* b,
                           const void* c, const float* init, void* y, float* fs, float* states,
                           float* decays, void* s_in, int keep, int B, int Tn, int H, int P,
                           int N, int L, int dtype, cudaStream_t s) {
  const int nc = (Tn + L - 1) / L;
  const dim3 grid(H, nc, B);
  cudaError_t e = cudaSuccess;
  if (nc > 0) {  // (a)
    if (dtype == 1) {
      const size_t smem = mma_state_smem(L, P, N);
      e = set_smem(ssd_chunk_state_mma_kernel<false>, smem);
      if (e != cudaSuccess) return e;
      ssd_chunk_state_mma_kernel<false><<<grid, STATE_THREADS, smem, s>>>(
          static_cast<const __nv_bfloat16*>(x), dt, a, static_cast<const __nv_bfloat16*>(b),
          states, decays, Tn, H, P, N, L);
      e = cudaGetLastError();
    } else {
      const size_t smem = smem_bytes(L, P, N);
      e = set_smem(ssd_chunk_state_f32_kernel<float>, smem);
      if (e != cudaSuccess) return e;
      ssd_chunk_state_f32_kernel<float><<<grid, NT, smem, s>>>(
          static_cast<const float*>(x), dt, a, static_cast<const float*>(b), states, decays, Tn,
          H, P, N, L);
      e = cudaGetLastError();
    }
    if (e != cudaSuccess) return e;
  }
  // (b)
  const int PN = P * N;
  ssd_state_pass_kernel<<<dim3((PN + 255) / 256, B * H), 256, 0, s>>>(
      states, decays, init, dtype == 1 ? s_in : states, dtype == 1, keep, fs, nc, H, PN);
  e = cudaGetLastError();
  if (e != cudaSuccess || nc == 0) return e;
  // (c)
  if (dtype == 1) {
    const int pp = padded_p(P);
    const size_t smem = mma_out_smem(L, pp, N);
    const int threads = 32 * (round16(L) / 16);
    switch (pp) {
      case 16: return launch_out_mma<16>(grid, threads, smem, x, dt, a, b, c, s_in, y, Tn, H, P, N, L, s);
      case 32: return launch_out_mma<32>(grid, threads, smem, x, dt, a, b, c, s_in, y, Tn, H, P, N, L, s);
      case 64: return launch_out_mma<64>(grid, threads, smem, x, dt, a, b, c, s_in, y, Tn, H, P, N, L, s);
      default: return launch_out_mma<128>(grid, threads, smem, x, dt, a, b, c, s_in, y, Tn, H, P, N, L, s);
    }
  }
  const size_t smem = smem_bytes(L, P, N);
  e = set_smem(ssd_chunk_out_f32_kernel<float>, smem);
  if (e != cudaSuccess) return e;
  ssd_chunk_out_f32_kernel<float><<<grid, NT, smem, s>>>(
      static_cast<const float*>(x), dt, a, static_cast<const float*>(b),
      static_cast<const float*>(c), states, static_cast<float*>(y), Tn, H, P, N, L);
  return cudaGetLastError();
}

// The fused body: one cooperative launch of (H * split, n_chunks, B) CTAs
// (with no chunk, the state pass alone gives the final state: the initial
// one or 0).  A grid that the card cannot hold at once is refused
// (cudaErrorCooperativeLaunchTooLarge).
template <int PP>
cudaError_t launch_fused_pp(const void* x, const float* dt, const float* a, const void* b,
                            const void* c, const float* init, void* y, float* fs, float* own,
                            float* decays, float* kept, int B, int Tn, int H, int P, int N, int L,
                            int split, cudaStream_t s) {
  const size_t smem = fused_smem(L, PP, N);
  auto kernel = ssd_fused_kernel<PP>;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H * split, (Tn + L - 1) / L, B);
  cfg.blockDim = dim3(32 * (round16(L) / 16), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const __nv_bfloat16*>(x), dt, a,
                         static_cast<const __nv_bfloat16*>(b), static_cast<const __nv_bfloat16*>(c),
                         init, static_cast<__nv_bfloat16*>(y), fs, own, decays, kept, Tn, H, P, N,
                         L, split);
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves the context sound: clear it
    return e;
  }
  return cudaGetLastError();
}

cudaError_t launch_fused(const void* x, const float* dt, const float* a, const void* b,
                         const void* c, const float* init, void* y, float* fs, float* own,
                         float* decays, float* kept, int B, int Tn, int H, int P, int N, int L,
                         int split, cudaStream_t s) {
  if (Tn == 0) {
    const int PN = P * N;
    ssd_state_pass_kernel<<<dim3((PN + 255) / 256, B * H), 256, 0, s>>>(
        nullptr, nullptr, init, nullptr, 0, 0, fs, 0, H, PN);
    return cudaGetLastError();
  }
#define SSD_FUSED_CASE(PP_)                                                                   \
  case PP_:                                                                                   \
    return launch_fused_pp<PP_>(x, dt, a, b, c, init, y, fs, own, decays, kept, B, Tn, H, P, \
                                N, L, split, s);
  switch (padded_p(P / split)) {
    SSD_FUSED_CASE(16) SSD_FUSED_CASE(32) SSD_FUSED_CASE(64) default: SSD_FUSED_CASE(128)
  }
#undef SSD_FUSED_CASE
}

template <int PP>
int fused_blocks_pp(int L, int N) {
  const size_t smem = fused_smem(L, PP, N);
  auto kernel = ssd_fused_kernel<PP>;
  int n = 0;
  if (set_smem(kernel, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, 32 * (round16(L) / 16), smem) !=
          cudaSuccess) {
    cudaGetLastError();  // clear a refusal
    return 0;
  }
  return n;
}

template <typename T>
cudaError_t launch_serial(const void* x, const float* dt, const float* a, const void* b,
                          const void* c, const float* init, void* y, float* fs, int B, int Tn,
                          int H, int P, int N, int L, cudaStream_t stream) {
  const size_t smem = smem_bytes(L, P, N);
  auto kernel = ssd_scan_kernel<T>;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(H, B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(b), static_cast<const T*>(c),
      init, static_cast<T*>(y), fs, Tn, H, P, N, L);
  return cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) the largest CTA of a body (0 = serial, 1 =
// chunked) takes for chunk L, head dim P, state dim N and dtype (0 = fp32,
// 1 = bf16): the wrapper holds it against the card's limit before it
// launches.
extern "C" size_t ssd_scan_smem_bytes(int L, int P, int N, int dtype, int body) {
  return body == 1 ? chunked_smem_bytes(L, P, N, dtype) : smem_bytes(L, P, N);
}

static bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// x (B, T, H, P) and b/c (B, T, H, N) of one dtype (0 = fp32, 1 = bf16);
// dt (B, T, H) and a (H,) fp32; init (B, H, P, N) fp32 or null; outputs
// y (B, T, H, P) in x's dtype and the final state (B, H, P, N) fp32; all
// contiguous; x, b, c and y on 16-byte boundaries (every body loads and
// stores them in vectors).  P and N whole numbers of 16-byte vectors; 1 <= L.  body: 0 =
// serial, 1 = chunked (L <= 128, and P <= 128 in bf16), whose scratch is
// states (B, ceil(T / L), H, P, N) and decays (B, ceil(T / L), H), fp32,
// and in bf16 s_in, (B, ceil(T / L), H, 2, P, N) bf16 (null in fp32).  After
// the chunked body, states holds the fp32 state entering each chunk: in
// fp32 always, in bf16 where keep is set (the gradient's input).  Returns a
// cudaError_t code, 0 on success.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a, const void* b,
                               const void* c, const void* init, void* y, void* final_state,
                               void* states, void* decays, void* s_in, int B, int Tn, int H,
                               int P, int N, int L, int dtype, int body, int keep, void* stream) {
  const int itemsize = dtype == 0 ? 4 : 2;
  if (B < 0 || Tn < 0 || H < 0 || P <= 0 || N <= 0 || L <= 0 || (P * itemsize) % 16 != 0 ||
      (N * itemsize) % 16 != 0 || (dtype != 0 && dtype != 1) || (body != 0 && body != 1) ||
      !aligned16(x) || !aligned16(b) || !aligned16(c) || !aligned16(y))
    return (int)cudaErrorInvalidValue;
  if (body == 1 && (L > 128 || (dtype == 1 && P > 128) ||
                    (Tn > 0 && (states == nullptr || decays == nullptr ||
                                (dtype == 1 && s_in == nullptr)))))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* in = static_cast<const float*>(init);
  float* fs = static_cast<float*>(final_state);
  cudaError_t e;
  if (body == 1)
    e = launch_chunked(x, dtf, af, b, c, in, y, fs, static_cast<float*>(states),
                       static_cast<float*>(decays), s_in, keep, B, Tn, H, P, N, L, dtype, s);
  else if (dtype == 0)
    e = launch_serial<float>(x, dtf, af, b, c, in, y, fs, B, Tn, H, P, N, L, s);
  else
    e = launch_serial<__nv_bfloat16>(x, dtf, af, b, c, in, y, fs, B, Tn, H, P, N, L, s);
  return (int)e;
}

// The fused body's CTAs an SM holds for chunk L, head dim P, state dim N
// and `split` CTAs a chunk (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// at its shared memory and registers); 0 where it takes no such shape.
extern "C" int ssd_scan_fused_blocks_per_sm(int L, int P, int N, int split) {
  if (L < 1 || L > 128 || P <= 0 || N <= 0 || N % 8 != 0 || split < 1 || P % split != 0 ||
      (P / split) % 8 != 0 || P / split > 128)
    return 0;
  switch (padded_p(P / split)) {
    case 16: return fused_blocks_pp<16>(L, N);
    case 32: return fused_blocks_pp<32>(L, N);
    case 64: return fused_blocks_pp<64>(L, N);
    default: return fused_blocks_pp<128>(L, N);
  }
}

// The fused body (bf16): x, dt, a, b, c, init, y and final_state as
// ssd_scan_launch takes them (init, when given, also on a 16-byte
// boundary), L <= 128, P and N multiples of 8, `split` CTAs a chunk, each
// taking P / split columns (a multiple of 8, at most 128).  Scratch: own
// (B, ceil(T / L), H, P, N) and decays (B, ceil(T / L), H) fp32.  kept
// (B, ceil(T / L), H, P, N) fp32 or null: the state entering each chunk, as
// the chunked body leaves it with `keep`.  The grid, B H split ceil(T / L)
// CTAs, must fit the card at once (ssd_scan_fused_blocks_per_sm's CTAs an
// SM): the cooperative launch refuses it otherwise.  Returns a cudaError_t
// code, 0 on success.
extern "C" int ssd_scan_fused_launch(const void* x, const void* dt, const void* a, const void* b,
                                     const void* c, const void* init, void* y, void* final_state,
                                     void* own, void* decays, void* kept, int B, int Tn, int H,
                                     int P, int N, int L, int split, void* stream) {
  if (B < 0 || Tn < 0 || H < 0 || P <= 0 || N <= 0 || L <= 0 || L > 128 || P % 8 != 0 ||
      N % 8 != 0 || split < 1 || P % split != 0 || (P / split) % 8 != 0 || P / split > 128 ||
      !aligned16(x) || !aligned16(b) || !aligned16(c) || !aligned16(y) ||
      !aligned16(final_state) || (init != nullptr && !aligned16(init)) ||
      (kept != nullptr && !aligned16(kept)) ||
      (Tn > 0 && (own == nullptr || decays == nullptr || !aligned16(own))))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return 0;
  return (int)launch_fused(x, static_cast<const float*>(dt), static_cast<const float*>(a), b, c,
                           static_cast<const float*>(init), y, static_cast<float*>(final_state),
                           static_cast<float*>(own), static_cast<float*>(decays),
                           static_cast<float*>(kept), B, Tn, H, P, N, L, split,
                           static_cast<cudaStream_t>(stream));
}
