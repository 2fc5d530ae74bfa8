// Pieces of the Mamba-2 SSD scan shared by its forward (ssd_scan.cu) and
// its gradient (ssd_scan_bwd.cu): vector loads, the fp32 per-chunk tiles
// and their staging, the chunk's cumulative sum of a*dt in fp64, and the
// chunk-state product on the CUDA cores; and for bf16 on the tensor cores
// (mma.sync m16n8k16 with fp32 sums): the bf16 tiles and their staging by
// cp.async, ldmatrix fragments of a tile stored either way round, the split
// of an fp32 operand into a bf16 high part and its bf16 rest, and the
// chunk-state product (the forward's step (a) and the gradient's (a')).
// Each including source is its own library, so these live in an anonymous
// namespace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int NT = 256;      // threads per CTA of the fp32 code
constexpr int RB = 32;       // rows of (C B^T) . G built at a time
constexpr int MS = RB + 4;   // row stride of that block, transposed

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
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
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(make_float2(a, b));
  }
};

__host__ __device__ __forceinline__ int padded(int L) { return (L + 3) & ~3; }


// ---------------------------------------------------------------------------
// fp32 per-chunk work on the CUDA cores (the serial body, and the chunked
// body's fp32 launches)
// ---------------------------------------------------------------------------
// The shared tiles of one chunk.
struct ChunkSmem {
  int LP, LS;   // chunk rows padded to whole float4s (the pad has dt = 0); row stride of Bt, Ct
  float* Ct;    // N x LS: C of the chunk, transposed
  float* Bt;    // N x LS: B of the chunk, transposed
  float* Xs;    // LP x P: X of the chunk
  float* St;    // N x P: the state, transposed
  float* Mt;    // LP x MS: RB rows of (C B^T) . G, transposed
  float* sv;    // LP: s = cumsum(a dt), rounded to fp32
  float* dv;    // LP: dt (0 past T)
  float* wv;    // LP: exp(s_L - s_j) dt_j
  float* sl;    // LP: the rest of s (s_diff)
};

__device__ __forceinline__ ChunkSmem carve(float* smem, int L, int P, int N) {
  ChunkSmem c;
  c.LP = padded(L);
  c.LS = c.LP + 4;
  c.Ct = smem;
  c.Bt = c.Ct + N * c.LS;
  c.Xs = c.Bt + N * c.LS;
  c.St = c.Xs + c.LP * P;
  c.Mt = c.St + N * P;
  c.sv = c.Mt + c.LP * MS;
  c.dv = c.sv + c.LP;
  c.wv = c.dv + c.LP;
  c.sl = c.wv + c.LP;
  return c;
}

// Stages dt, B, C (transposed; zeros when cm is null) and X of the chunk
// starting at step t0.
template <typename T>
__device__ __forceinline__ void stage_chunk(const ChunkSmem& s, const T* x, const float* dt,
                                            const T* bm, const T* cm, int Tn, int H, int P,
                                            int N, int L, int b, int h, int t0) {
  const int tid = threadIdx.x, LP = s.LP, LS = s.LS;
  constexpr int VEC = Vec<T>::N;
  const int nvec = N / VEC, pvec = P / VEC;
  for (int j = tid; j < LP; j += NT) {
    const int t = t0 + j;
    s.dv[j] = (j < L && t < Tn) ? dt[((size_t)b * Tn + t) * H + h] : 0.f;
  }
  for (int i = tid; i < LP * nvec; i += NT) {  // rows fastest: conflict-free stores
    const int j = i % LP, c = (i / LP) * VEC;
    const int t = t0 + j;
    float fb[VEC], fc[VEC];
    if (j < L && t < Tn) {
      const size_t off = (((size_t)b * Tn + t) * H + h) * N + c;
      Vec<T>::load(bm + off, fb);
      if (cm != nullptr) {
        Vec<T>::load(cm + off, fc);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) fc[e] = 0.f;
      }
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) fb[e] = fc[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      s.Bt[(c + e) * LS + j] = fb[e];
      s.Ct[(c + e) * LS + j] = fc[e];
    }
  }
  for (int i = tid; i < LP * pvec; i += NT) {
    const int j = i / pvec, c = (i - j * pvec) * VEC;
    const int t = t0 + j;
    float f[VEC];
    if (j < L && t < Tn) {
      Vec<T>::load(x + (((size_t)b * Tn + t) * H + h) * P + c, f);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) s.Xs[j * P + c + e] = f[e];
  }
}

// s = cumsum(a dt) over LP rows, in fp64: one warp, each lane a contiguous
// segment, then a warp scan of the segment totals; s is kept as its fp32
// rounding sv and the rest sl.  Every body computes s this way.  Over a
// chunk s reaches a few hundred, where an fp32 s_i - s_j is off by ~1e-5
// absolute: that moved y by up to 4e-4 at T = 8192, past fp32's tolerance.
__device__ __forceinline__ void chunk_cumsum(float* sv, float* sl, const float* dv, int LP,
                                             float ah, int warp = 0) {
  const int tid = threadIdx.x & 31;
  if ((int)(threadIdx.x >> 5) == warp) {
    const int seg = (LP + 31) / 32;
    const int j0 = tid * seg, j1 = min(j0 + seg, LP);
    double run = 0.0;
    for (int j = j0; j < j1; ++j) run += (double)ah * dv[j];
    double incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double up = __shfl_up_sync(0xffffffffu, incl, o);
      if (tid >= o) incl += up;
    }
    double acc = __shfl_up_sync(0xffffffffu, incl, 1);
    if (tid == 0) acc = 0.0;
    for (int j = j0; j < j1; ++j) {
      acc += (double)ah * dv[j];
      const float hi = (float)acc;
      sv[j] = hi;
      sl[j] = (float)(acc - (double)hi);
    }
  }
}

// s_i - s_j from s's two parts: the fp32 difference of the rounded parts is
// rounded once, and the rests add what the rounding dropped.
__device__ __forceinline__ float s_diff(const float* sv, const float* sl, int i, int j) {
  return (sv[i] - sv[j]) + (sl[i] - sl[j]);
}

// St = decay St + sum_j B_j (x) (X_j w_j): blocks of 4 n x 4 p (wv staged).
__device__ __forceinline__ void chunk_state(const ChunkSmem& s, float decay, int P, int N) {
  const int tid = threadIdx.x, LP = s.LP, LS = s.LS;
  const int pq = P / 4;
  for (int mi = tid; mi < (N / 4) * pq; mi += NT) {
    const int n0 = (mi / pq) * 4, p0 = (mi % pq) * 4;
    float acc[4][4];
#pragma unroll
    for (int nn = 0; nn < 4; ++nn)
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) acc[nn][pp] = 0.f;
    for (int j = 0; j < LP; ++j) {
      const float4 xv = *reinterpret_cast<const float4*>(s.Xs + j * P + p0);
      const float w = s.wv[j];
      const float xw[4] = {xv.x * w, xv.y * w, xv.z * w, xv.w * w};
      float ba[4];
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) ba[nn] = s.Bt[(n0 + nn) * LS + j];
#pragma unroll
      for (int nn = 0; nn < 4; ++nn)
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) acc[nn][pp] = fmaf(ba[nn], xw[pp], acc[nn][pp]);
    }
#pragma unroll
    for (int nn = 0; nn < 4; ++nn)
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        float* st = s.St + (n0 + nn) * P + p0 + pp;
        *st = decay * *st + acc[nn][pp];
      }
  }
}

// Shared memory (bytes) of the fp32 per-chunk tiles for chunk L, head dim P,
// state dim N.
size_t smem_bytes(int L, int P, int N) {
  const size_t LP = padded(L);
  return sizeof(float) * (2 * (size_t)N * (LP + 4) + LP * P + (size_t)N * P + LP * MS + 4 * LP);
}


// Scratch layout: states (B, n_chunks, H, P, N) and decays (B, n_chunks, H).
__device__ __forceinline__ size_t chunk_index(int b, int c, int h, int nc, int H) {
  return ((size_t)b * nc + c) * H + h;
}


// ---------------------------------------------------------------------------
// bf16 on the tensor cores (mma.sync m16n8k16, fp32 sums)
// ---------------------------------------------------------------------------
// bf16 tiles of the chunked body: rows padded to 16 (zeros), columns padded
// to 16 and then by 8 more elements, a 16-byte pad that keeps ldmatrix free
// of bank conflicts.
__host__ __device__ __forceinline__ int round16(int n) { return (n + 15) & ~15; }

// Rows [t0, t0 + L) of a (B, T, H, W) bf16 tensor into a (LP x stride) tile
// by cp.async (the caller commits and waits): zeros past the chunk, past T
// and past W.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int stride, const __nv_bfloat16* src,
                                           int W, int WP, int LP, int L, int Tn, int H, int b,
                                           int h, int t0) {
  const int nv = WP / 8;
  for (int i = threadIdx.x; i < LP * nv; i += blockDim.x) {
    const int j = i / nv, c = (i - j * nv) * 8;
    const int t = t0 + j;
    const bool ok = j < L && t < Tn && c < W;
    hopper::cp_async16(dst + j * stride + c,
                       ok ? src + (((size_t)b * Tn + t) * H + h) * W + c : src, ok);
  }
}

__device__ __forceinline__ void stage_dt(float* dv, const float* dt, int LP, int L, int Tn, int H,
                                         int b, int h, int t0) {
  for (int j = threadIdx.x; j < LP; j += blockDim.x) {
    const int t = t0 + j;
    dv[j] = (j < L && t < Tn) ? dt[((size_t)b * Tn + t) * H + h] : 0.f;
  }
}

constexpr int STATE_THREADS = 256;

// Shared memory (bytes) of (a) in bf16.
size_t mma_state_smem(int L, int P, int N) {
  const size_t LP = round16(L);
  return 2 * (LP * (round16(N) + 8) + 2 * LP * (round16(P) + 8)) + 4 * 3 * LP;
}

// f0, f1 as a bf16 pair (hi) and the bf16 pair of what that rounding left
// (lo): hi + lo holds an fp32 value to about 2^-17 of itself, where hi alone
// holds it to 2^-9.  A product with an fp32 operand runs as two products.
__device__ __forceinline__ void split_bf16(float f0, float f1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 hv = __floats2bfloat162_rn(f0, f1);
  const float2 hf = __bfloat1622float2(hv);
  hi = *reinterpret_cast<const uint32_t*>(&hv);
  lo = hopper::pack_bf16(f0 - hf.x, f1 - hf.y);
}

// The A fragments (16 x 16) of a product whose depth is the columns of two
// fp32 accumulator tiles (16 x 8 each: depth 0..7 and 8..15), in two parts.
__device__ __forceinline__ void acc_to_a(const float (&t0)[4], const float (&t1)[4],
                                         uint32_t (&ah)[4], uint32_t (&al)[4]) {
  split_bf16(t0[0], t0[1], ah[0], al[0]);
  split_bf16(t0[2], t0[3], ah[1], al[1]);
  split_bf16(t1[0], t1[1], ah[2], al[2]);
  split_bf16(t1[2], t1[3], ah[3], al[3]);
}

// ldmatrix fragments from a bf16 tile of row stride `st` (elements).
// A (16 x 16) at rows m0.., depth k0.. of a tile stored [m][k]:
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const __nv_bfloat16* t, int st, int m0,
                                       int k0) {
  const int lane = threadIdx.x & 31, lm = lane >> 3, lr = lane & 7;
  hopper::ldsm_x4(a[0], a[1], a[2], a[3], t + (m0 + lr + 8 * (lm & 1)) * st + k0 + 8 * (lm >> 1));
}
// B of the two n8 tiles at n0.. and n0 + 8.. (b[0], b[1] the first's), depth
// k0.., of a tile stored [n][k]:
__device__ __forceinline__ void ldsm_b(uint32_t (&b)[4], const __nv_bfloat16* t, int st, int n0,
                                       int k0) {
  const int lane = threadIdx.x & 31, lm = lane >> 3, lr = lane & 7;
  hopper::ldsm_x4(b[0], b[1], b[2], b[3], t + (n0 + lr + 8 * (lm >> 1)) * st + k0 + 8 * (lm & 1));
}
// ... and of a tile stored [k][n]:
__device__ __forceinline__ void ldsm_bt(uint32_t (&b)[4], const __nv_bfloat16* t, int st, int k0,
                                        int n0) {
  const int lane = threadIdx.x & 31, lm = lane >> 3, lr = lane & 7;
  hopper::ldsm_x4_trans(b[0], b[1], b[2], b[3],
                        t + (k0 + lr + 8 * (lm & 1)) * st + n0 + 8 * (lm >> 1));
}

// c0 (+)= a b[0..1], c1 (+)= a b[2..3]: two n8 tiles of one A.
__device__ __forceinline__ void mma2(float (&c0)[4], float (&c1)[4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[4]) {
  hopper::mma_bf16(c0, a, b[0], b[1]);
  hopper::mma_bf16(c1, a, b[2], b[3]);
}

// P padded to the bf16 kernels' compiled widths.
__host__ __device__ __forceinline__ int padded_p(int P) {
  return P <= 16 ? 16 : (P <= 32 ? 32 : (P <= 64 ? 64 : 128));
}

// A (P x N) fp32 state (row stride N) into two bf16 tiles [p][n] of row
// stride st: its high parts and their rests, zeros past P and N (N a
// multiple of 8, the rows 32-byte aligned).  Each thread loads four
// 8-element pieces before it converts any.  With `other`, returns this
// thread's part of <src, other> (fp32, in a fixed order).
__device__ __forceinline__ float stage_state_split(__nv_bfloat16* hi, __nv_bfloat16* lo, int st,
                                                   const float* __restrict__ src, int P, int N,
                                                   int PP, int NP,
                                                   const float* __restrict__ other = nullptr) {
  constexpr int U = 4;
  const int nv = NP / 8, n_items = PP * nv;
  float dot = 0.f;
  for (int i0 = threadIdx.x; i0 < n_items; i0 += U * blockDim.x) {
    float4 v[U][2], w[U][2];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * blockDim.x;
      const int p = i / nv, c8 = (i - p * nv) * 8;
      const bool ok = i < n_items && p < P && c8 < N;
      const size_t off = ok ? (size_t)p * N + c8 : 0;
      v[u][0] = ok ? *reinterpret_cast<const float4*>(src + off) : make_float4(0.f, 0.f, 0.f, 0.f);
      v[u][1] = ok ? *reinterpret_cast<const float4*>(src + off + 4) : make_float4(0.f, 0.f, 0.f, 0.f);
      if (other != nullptr) {
        w[u][0] = ok ? *reinterpret_cast<const float4*>(other + off) : make_float4(0.f, 0.f, 0.f, 0.f);
        w[u][1] = ok ? *reinterpret_cast<const float4*>(other + off + 4) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i >= n_items) break;
      const int p = i / nv, c8 = (i - p * nv) * 8;
      uint32_t h[4], l[4];
      split_bf16(v[u][0].x, v[u][0].y, h[0], l[0]);
      split_bf16(v[u][0].z, v[u][0].w, h[1], l[1]);
      split_bf16(v[u][1].x, v[u][1].y, h[2], l[2]);
      split_bf16(v[u][1].z, v[u][1].w, h[3], l[3]);
      *reinterpret_cast<uint4*>(hi + p * st + c8) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo + p * st + c8) = make_uint4(l[0], l[1], l[2], l[3]);
      if (other != nullptr) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          dot = fmaf(v[u][k].x, w[u][k].x, dot);
          dot = fmaf(v[u][k].y, w[u][k].y, dot);
          dot = fmaf(v[u][k].z, w[u][k].z, dot);
          dot = fmaf(v[u][k].w, w[u][k].w, dot);
        }
      }
    }
  }
  return dot;
}

// (a), bf16: the chunk's own state S_c[p][n] = sum_j u_j[p] b_j[n], u = w . x
// (w_j = exp(s_L - s_j) dt_j), as two tensor-core products: u's bf16 high
// part, then its bf16 rest.  With OWN, the gradient's (a'): x is dy, b is c
// and w_j = exp(s_j), so that S_c is the chunk's own sum_j exp(s_j) dy_j
// c_j^T.  Grid (H, n_chunks, B), 8 warps.
template <bool OWN>
__global__ void __launch_bounds__(STATE_THREADS) ssd_chunk_state_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const __nv_bfloat16* __restrict__ bm, float* __restrict__ states, float* __restrict__ decays,
    int Tn, int H, int P, int N, int L) {
  const int LP = round16(L), NP = round16(N), PP = round16(P);
  const int BS = NP + 8, US = PP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // LP x BS
  __nv_bfloat16* Uh = Bs + LP * BS;                                 // LP x US: bf16(u)
  __nv_bfloat16* Ul = Uh + LP * US;                                 // LP x US: bf16(u - Uh)
  float* sv = reinterpret_cast<float*>(Ul + LP * US);               // LP
  float* dv = sv + LP;                                              // LP
  float* sl = dv + LP;                                              // LP
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int t0 = c * L;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, lm = lane >> 3, lr = lane & 7;

  stage_rows(Bs, BS, bm, N, NP, LP, L, Tn, H, b, h, t0);
  stage_rows(Uh, US, x, P, PP, LP, L, Tn, H, b, h, t0);  // x, made into u in place below
  hopper::cp_async_commit();
  stage_dt(dv, dt, LP, L, Tn, H, b, h, t0);
  hopper::cp_async_wait<0>();
  __syncthreads();
  chunk_cumsum(sv, sl, dv, LP, a[h]);
  __syncthreads();
  const int jL = LP - 1;
  const int pv = PP / 8;
  for (int i = tid; i < LP * pv; i += STATE_THREADS) {
    const int j = i / pv, c8 = (i - j * pv) * 8;
    float f[8];
    Vec<__nv_bfloat16>::load(Uh + j * US + c8, f);
    const float w = OWN ? expf(sv[j] + sl[j]) : expf(s_diff(sv, sl, jL, j)) * dv[j];
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_bf16(f[2 * e] * w, f[2 * e + 1] * w, hi[e], lo[e]);
    *reinterpret_cast<uint4*>(Uh + j * US + c8) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(Ul + j * US + c8) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  __syncthreads();

  // S_c (PP x NP): units of 16 rows of p by 16 columns of n, one per warp at a time.
  const size_t ci = chunk_index(b, c, h, nc, H);
  float* out = states + ci * P * N;
  const int npr = NP / 16;
  for (int unit = warp; unit < (PP / 16) * npr; unit += STATE_THREADS / 32) {
    const int mt = unit / npr, np = unit - mt * npr;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int kk = 0; kk < LP / 16; ++kk) {
      uint32_t ah[4], al[4], b0, b1, b2, b3;
      const int ua = (kk * 16 + 8 * (lm >> 1) + lr) * US + mt * 16 + 8 * (lm & 1);
      hopper::ldsm_x4_trans(ah[0], ah[1], ah[2], ah[3], Uh + ua);
      hopper::ldsm_x4_trans(al[0], al[1], al[2], al[3], Ul + ua);
      hopper::ldsm_x4_trans(b0, b1, b2, b3, Bs + (kk * 16 + lr + 8 * (lm & 1)) * BS + np * 16 + 8 * (lm >> 1));
      hopper::mma_bf16(acc[0], ah, b0, b1);
      hopper::mma_bf16(acc[1], ah, b2, b3);
      hopper::mma_bf16(acc[0], al, b0, b1);
      hopper::mma_bf16(acc[1], al, b2, b3);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int p = mt * 16 + g + 8 * hf, n = np * 16 + nt * 8 + 2 * t4;
        if (p < P && n < N)
          *reinterpret_cast<float2*>(out + (size_t)p * N + n) =
              make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
      }
  }
  if (tid == 0) decays[ci] = expf(sv[jL] + sl[jL]);
}

}  // namespace
