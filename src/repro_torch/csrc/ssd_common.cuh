// Pieces of the Mamba-2 SSD scan shared by its forward (ssd_scan.cu) and
// its gradient (ssd_scan_bwd.cu): vector loads, the fp32 per-chunk tiles
// and their staging, the chunk's cumulative sum of a*dt in fp64, and the
// chunk-state product on the CUDA cores.  Each including source is its
// own library, so these live in an anonymous namespace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// s = cumsum(a dt) over LP rows, in fp64: warp 0, each lane a contiguous
// segment, then a warp scan of the segment totals; s is kept as its fp32
// rounding sv and the rest sl.  Every body computes s this way.  Over a
// chunk s reaches a few hundred, where an fp32 s_i - s_j is off by ~1e-5
// absolute: that moved y by up to 4e-4 at T = 8192, past fp32's tolerance.
__device__ __forceinline__ void chunk_cumsum(float* sv, float* sl, const float* dv, int LP,
                                             float ah) {
  const int tid = threadIdx.x;
  if (tid < 32) {
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

}  // namespace
