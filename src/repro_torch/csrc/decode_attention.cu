// One-token GQA decode attention for Hopper (sm_90a), fp32 and bf16.
//
// Replaces src/repro/kernels/decode_attention.py::decode_attention (the
// Pallas kernel body _dec_kernel).  It computes, for every batch row b and
// query head h,
//
//     out[b, h] = softmax(q[b, h] . K[b, :len, h / G]^T * D^-1/2) V[b, :len, h / G]
//
// with len = clamp(cache_len[b], 0, T) and G = H / KH.  A row with len == 0
// gives 0, as decode_attention_ref does (the Pallas kernel gives the mean of
// V over its first block there, because its -1e30 mask makes every masked
// weight exp(0) = 1).
//
// What bounds it: reading the cache.  Each (b, kv head) pair reads its
// len rows of K and V once, 2 * B * len * KH * D * itemsize bytes in all,
// against 4 * B * H * len * D flops: about G / itemsize flops per byte,
// far below the card's ridge, so the kernel is bound by device memory.
//
// What the design does about it: one CTA per (row chunk, kv head, batch row)
// streams the valid prefix of its K/V slice through shared memory in tiles
// of TK rows, with 16-byte loads, and never touches the slots past len.
// All G query rows of that kv head (up to 32 per CTA) are spread over the
// CTA's warps and read each staged tile from shared memory, so K and V leave
// device memory once per CTA and not once per query head.  Scores, the
// running max m, the running sum l and the accumulator stay in fp32
// (online softmax, exp2 with log2(e) folded into the query scale).
//
// What it does not do yet: at serving batch sizes B * KH CTAs fill few of
// the 132 SMs (Mistral-NeMo at B=2 launches 16), so the card's bandwidth is
// far from used.  Splitting T across CTAs with a second combine pass
// (flash-decoding) and overlapping tile loads with compute (cp.async or
// TMA) are the next steps.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC; bound through a plain C entry point.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TK = 64;         // cache rows per shared-memory tile
constexpr int KPL = TK / 32;   // tile rows scored by each lane
constexpr int MAX_ROWS = 32;   // query rows per CTA
constexpr int NWARPS = 8;      // warps per CTA (those without query rows only load)
constexpr int LOADS = 4;       // tile loads each thread keeps in flight
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

// Row stride of the staged K tile, in pairs: odd, so that 32 lanes reading
// the same column of 32 different rows hit 32 different banks.
__host__ __device__ __forceinline__ int k_stride(int npairs) { return npairs | 1; }

// DPP: head-dim pairs each lane accumulates (ceil(D / 64)).
// RPW: query rows each warp carries (a power of two covering its share).
template <typename T, int DPP, int RPW>
__global__ void __launch_bounds__(NWARPS * 32) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int32_t* __restrict__ cache_len, T* __restrict__ out,
    int cap, int H, int KH, int D, int rows_per_cta, float qscale) {
  using P = typename Pair<T>::type;
  const int npairs = D / 2;
  const int kstride = k_stride(npairs);
  const int G = H / KH;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int row0 = blockIdx.x * rows_per_cta;
  const int nrows = min(rows_per_cta, G - row0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int srows = nwarps * RPW;  // query rows staged (the extra ones are 0)

  extern __shared__ __align__(16) unsigned char smem[];
  P* v_s = reinterpret_cast<P*>(smem);                  // TK x npairs
  P* k_s = v_s + TK * npairs;                           // TK x kstride
  float* q_s = reinterpret_cast<float*>(k_s + TK * kstride);  // srows x D
  float* p_s = q_s + srows * D;                         // srows x TK

  const int len = max(0, min(cache_len[b], cap));
  const T* qb = q + ((size_t)b * H + (size_t)kh * G + row0) * D;
  for (int i = threadIdx.x; i < srows * D; i += blockDim.x) {
    const int r = i / D;
    q_s[i] = r < nrows ? Pair<T>::scalar(qb[i]) * qscale : 0.f;
  }

  float m[RPW], l[RPW];
  float2 acc[RPW][DPP];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPP; ++i) acc[r][i] = make_float2(0.f, 0.f);
  }

  const size_t pos_stride = (size_t)KH * D;  // elements between cache slots
  const T* kb = k + ((size_t)b * cap * KH + kh) * D;
  const T* vb = v + ((size_t)b * cap * KH + kh) * D;
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  const int vecs = D / VEC;
  const bool has_rows = warp < nrows;  // warp-uniform

  for (int t0 = 0; t0 < len; t0 += TK) {
    const int nk = min(TK, len - t0);
    __syncthreads();  // the previous tile is consumed (and q_s is written)
    // Stage the tile: LOADS 16-byte loads of K and of V in flight per thread.
    const int total = nk * vecs;
    for (int base = threadIdx.x; base < total; base += LOADS * blockDim.x) {
      int4 kr[LOADS], vr[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int i = base + u * blockDim.x;
        if (i < total) {
          const int j = i / vecs, c = i - j * vecs;
          const size_t g = (size_t)(t0 + j) * pos_stride + (size_t)c * VEC;
          kr[u] = *reinterpret_cast<const int4*>(kb + g);
          vr[u] = *reinterpret_cast<const int4*>(vb + g);
        }
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int i = base + u * blockDim.x;
        if (i < total) {
          const int j = i / vecs, c = i - j * vecs;
          reinterpret_cast<int4*>(v_s + j * npairs)[c] = vr[u];
          uint32_t* kd = reinterpret_cast<uint32_t*>(k_s + j * kstride) + c * 4;
          kd[0] = (uint32_t)kr[u].x;
          kd[1] = (uint32_t)kr[u].y;
          kd[2] = (uint32_t)kr[u].z;
          kd[3] = (uint32_t)kr[u].w;
        }
      }
    }
    __syncthreads();
    if (!has_rows) continue;

    // Scores: lane owns tile rows lane + 32 * kk.
    float s[RPW][KPL];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) s[r][kk] = 0.f;
    for (int pi = 0; pi < npairs; ++pi) {
      float2 kf[KPL];
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk)
        kf[kk] = Pair<T>::load(k_s + (lane + 32 * kk) * kstride + pi);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float2 qf =
            *reinterpret_cast<const float2*>(q_s + (warp + r * nwarps) * D + 2 * pi);
#pragma unroll
        for (int kk = 0; kk < KPL; ++kk)
          s[r][kk] = fmaf(qf.x, kf[kk].x, fmaf(qf.y, kf[kk].y, s[r][kk]));
      }
    }

    // Online softmax update, one warp per query row.
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      float* pr = p_s + (warp + r * nwarps) * TK;
      float mt = -INFINITY;
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) {
        if (lane + 32 * kk >= nk) s[r][kk] = -INFINITY;
        mt = fmaxf(mt, s[r][kk]);
      }
      const float mn = fmaxf(m[r], warp_max(mt));  // finite: nk >= 1
      const float alpha = exp2f(m[r] - mn);
      float ps = 0.f;
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) {
        const float p = exp2f(s[r][kk] - mn);
        ps += p;
        pr[lane + 32 * kk] = p;
      }
      l[r] = l[r] * alpha + warp_sum(ps);
      m[r] = mn;
#pragma unroll
      for (int i = 0; i < DPP; ++i) {
        acc[r][i].x *= alpha;
        acc[r][i].y *= alpha;
      }
    }
    __syncwarp();

    // acc += P V: lane owns head-dim pairs lane + 32 * i.
    for (int j = 0; j < nk; ++j) {
      float2 vf[DPP];
#pragma unroll
      for (int i = 0; i < DPP; ++i) {
        const int pi = lane + 32 * i;
        vf[i] = pi < npairs ? Pair<T>::load(v_s + j * npairs + pi) : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float p = p_s[(warp + r * nwarps) * TK + j];
#pragma unroll
        for (int i = 0; i < DPP; ++i) {
          acc[r][i].x = fmaf(p, vf[i].x, acc[r][i].x);
          acc[r][i].y = fmaf(p, vf[i].y, acc[r][i].y);
        }
      }
    }
  }

  if (!has_rows) return;
  P* ob = reinterpret_cast<P*>(out + ((size_t)b * H + (size_t)kh * G + row0) * D);
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = warp + r * nwarps;
    if (row >= nrows) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int i = 0; i < DPP; ++i) {
      const int pi = lane + 32 * i;
      if (pi < npairs)
        ob[row * npairs + pi] = Pair<T>::make(make_float2(acc[r][i].x * inv, acc[r][i].y * inv));
    }
  }
}

template <typename T, int DPP, int RPW>
cudaError_t launch(const void* q, const void* k, const void* v, const int32_t* lens,
                   void* out, int B, int H, int KH, int T_, int D, int rows_per_cta,
                   int n_chunks, int nwarps, cudaStream_t stream) {
  using P = typename Pair<T>::type;
  const int npairs = D / 2;
  const size_t smem = sizeof(P) * (size_t)TK * (npairs + k_stride(npairs)) +
                      sizeof(float) * (size_t)nwarps * RPW * (D + TK);
  auto kernel = decode_attention_kernel<T, DPP, RPW>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const float qscale = LOG2E / sqrtf((float)D);
  dim3 grid(n_chunks, KH, B);
  kernel<<<grid, nwarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lens,
      static_cast<T*>(out), T_, H, KH, D, rows_per_cta, qscale);
  return cudaGetLastError();
}

template <typename T, int DPP>
cudaError_t launch_rpw(int rpw, const void* q, const void* k, const void* v,
                       const int32_t* lens, void* out, int B, int H, int KH, int T_, int D,
                       int rows_per_cta, int n_chunks, int nwarps, cudaStream_t s) {
  if (rpw == 1) return launch<T, DPP, 1>(q, k, v, lens, out, B, H, KH, T_, D, rows_per_cta, n_chunks, nwarps, s);
  if (rpw == 2) return launch<T, DPP, 2>(q, k, v, lens, out, B, H, KH, T_, D, rows_per_cta, n_chunks, nwarps, s);
  return launch<T, DPP, 4>(q, k, v, lens, out, B, H, KH, T_, D, rows_per_cta, n_chunks, nwarps, s);
}

template <typename T>
cudaError_t launch_dtype(int dpp, int rpw, const void* q, const void* k, const void* v,
                         const int32_t* lens, void* out, int B, int H, int KH, int T_, int D,
                         int rows_per_cta, int n_chunks, int nwarps, cudaStream_t s) {
  switch (dpp) {
    case 1: return launch_rpw<T, 1>(rpw, q, k, v, lens, out, B, H, KH, T_, D, rows_per_cta, n_chunks, nwarps, s);
    case 2: return launch_rpw<T, 2>(rpw, q, k, v, lens, out, B, H, KH, T_, D, rows_per_cta, n_chunks, nwarps, s);
    case 3: return launch_rpw<T, 3>(rpw, q, k, v, lens, out, B, H, KH, T_, D, rows_per_cta, n_chunks, nwarps, s);
    default: return launch_rpw<T, 4>(rpw, q, k, v, lens, out, B, H, KH, T_, D, rows_per_cta, n_chunks, nwarps, s);
  }
}

}  // namespace

// q (B, H, D), k/v (B, T, KH, D), out (B, H, D): contiguous, of one dtype
// (0 = fp32, 1 = bf16); cache_len (B,) int32.  D even, at most 256, and a
// whole number of 16-byte vectors.  Returns a cudaError_t code, 0 on success.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* cache_len, void* out, int B, int H,
                                       int KH, int T_, int D, int dtype, void* stream) {
  const int itemsize = dtype == 0 ? 4 : 2;
  if (B < 0 || KH <= 0 || H % KH != 0 || T_ < 0 || D <= 0 || D > 256 || D % 2 != 0 ||
      (D * itemsize) % 16 != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return 0;
  const int G = H / KH;
  const int n_chunks = (G + MAX_ROWS - 1) / MAX_ROWS;
  const int rows_per_cta = (G + n_chunks - 1) / n_chunks;
  const int nwarps = NWARPS;
  const int need = (rows_per_cta + nwarps - 1) / nwarps;  // at most MAX_ROWS / NWARPS
  const int rpw = need <= 1 ? 1 : (need <= 2 ? 2 : 4);
  const int dpp = (D + 63) / 64;
  const int32_t* lens = static_cast<const int32_t*>(cache_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      dtype == 0
          ? launch_dtype<float>(dpp, rpw, q, k, v, lens, out, B, H, KH, T_, D, rows_per_cta, n_chunks, nwarps, s)
          : launch_dtype<__nv_bfloat16>(dpp, rpw, q, k, v, lens, out, B, H, KH, T_, D, rows_per_cta, n_chunks, nwarps, s);
  return (int)e;
}
