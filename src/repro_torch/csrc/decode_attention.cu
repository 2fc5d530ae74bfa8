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
// below the card's ridge (295 in bf16), so the kernel is bound by device
// memory, but granite's MQA (G = 48) needs 48 flops per byte of cache in
// bf16: 160 TFLOP/s at 3.35 TB/s, more than the fp32 CUDA cores give.
//
// Two bodies, chosen by the wrapper (kernels/decode_attention.py):
//
// * split (flash-decoding; bf16 on the tensor cores, fp32 on the CUDA
//   cores).  A grid of (splits, KH, B) CTAs: each CTA takes every query row
//   of its kv head (up to 128 in bf16, 64 in fp32), so the cache is read
//   once, and one contiguous range of cache slots; the wrapper picks
//   `splits` from B, KH and the capacity T (never from cache_len, which
//   stays on the device) so that there are about two CTAs per SM.  Tiles of
//   slots go through a ring of 16-byte cp.async loads (3 stages, 2 at head
//   dims above 192), so loads stay in flight while the previous tile is
//   scored.  bf16: S = Q K^T and O += P V on mma.sync m16n8k16 from
//   ldmatrix, the query rows padded to 16 and the head dim to 64, 128, 192
//   or 256 (zeros); warps split a tile's 64 slots between them when there
//   are few query rows, each with its own online softmax, merged at the
//   end.  fp32: lanes across the head dim and warp-shuffle sums.  Softmax
//   in fp32 in the exp2 domain.  With one split the CTA writes the output;
//   with more, each writes its m, l and unnormalised acc in fp32 to scratch
//   the wrapper allocates, and a combine kernel rescales and sums them.  A
//   split whose range holds no valid slot writes m = -inf and l = 0.
//
// Partials (decode_attention_partials_launch): the split body over one
// rank's slice of a cache split along T, every CTA writing its m, l and
// acc, then the combine in a mode that writes the slice's m (natural log
// domain), l and unnormalised acc in fp32 in place of the output; and the
// combine alone (decode_combine_launch) over n such partials laid out
// (n, B, H), which gives the output of the whole cache.  A slice with no
// valid slot gives m = -inf, l = 0 and acc = 0, and weighs 0.
//
// * single (the first port's body).  One CTA per (query-row chunk of 32,
//   kv head, batch row) streams the valid prefix of its K/V slice through
//   shared memory in tiles of TK rows, loaded and then scored, each lane
//   scoring its tile rows as a serial chain over the head dim, in fp32 on
//   the CUDA cores.  At serving batch sizes B * KH CTAs fill few of the 132
//   SMs (Mistral-NeMo at B = 2 launches 16), and granite's 48 query rows
//   take two CTAs, each reading the whole cache.
//
// What the split body does not do yet: TMA loads, and keeping the partials
// out of device memory (a cluster's distributed shared memory could merge
// them).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC -I csrc; bound through a plain C entry point.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

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
template <int DP, int KW, int NW>
struct MmaCfg {
  static constexpr int RS = DP + 8;  // row stride (elements): a 16-byte pad keeps ldmatrix conflict-free
  static constexpr int STAGES = DP > 192 ? 2 : 3;
  static constexpr int WK = TK / KW;
  static constexpr int WM = NW / WK;
  static constexpr int ROWS = 16 * WM;  // query rows staged (those past G are 0)
  static constexpr int TILE = TK * RS;
  static constexpr size_t RING = sizeof(__nv_bfloat16) * 2 * STAGES * TILE;
  static constexpr size_t PARTS = sizeof(float) * (size_t)WK * ROWS * (DP + 2);
  static constexpr size_t Q = sizeof(__nv_bfloat16) * ROWS * RS;
  static constexpr size_t SMEM = (RING > PARTS ? RING : PARTS) + Q;
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

template <int DP, int KW, int NW>
__global__ void __launch_bounds__(NW * 32) decode_split_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ cache_len,
    __nv_bfloat16* __restrict__ out, float* __restrict__ part_m, float* __restrict__ part_l,
    float* __restrict__ part_acc, int cap, int H, int KH, int D, int per_split, float qscale) {
  using C = MmaCfg<DP, KW, NW>;
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
  finish_rows<__nv_bfloat16>(Po, Pm, Pl, WK, ROWS, DP, G, H, D, b, kh, out, part_m, part_l,
                             part_acc);
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

// out[row] = sum_s acc_s 2^(m_s - M) / sum_s l_s 2^(m_s - M), M = max_s m_s;
// 0 when no split saw a slot.  One CTA per (batch row, head).  Split s of
// row r is at r * rstride + s * sstride (acc: times D); m_s is read times
// in_scale into the exp2 domain.  With out == nullptr the row's combined m
// (natural log domain), l and unnormalised acc go to out_m, out_l, out_acc.
constexpr float LN2 = 0.6931471805599453f;
template <typename T>
__global__ void __launch_bounds__(128) decode_combine_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_acc, T* __restrict__ out, float* __restrict__ out_m,
    float* __restrict__ out_l, float* __restrict__ out_acc, int splits, int D,
    size_t rstride, size_t sstride, float in_scale) {
  extern __shared__ float wts[];  // splits
  __shared__ float red[4];
  const size_t row = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* pm = part_m + row * rstride;
  const float* pl = part_l + row * rstride;
  float M = -INFINITY;
  for (int s = tid; s < splits; s += 128) M = fmaxf(M, pm[s * sstride] * in_scale);
  M = warp_max(M);
  if (lane == 0) red[warp] = M;
  __syncthreads();
  M = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  __syncthreads();
  float L = 0.f;
  for (int s = tid; s < splits; s += 128) {
    const float w = M == -INFINITY ? 0.f : exp2f(pm[s * sstride] * in_scale - M);
    wts[s] = w;
    L += pl[s * sstride] * w;
  }
  L = warp_sum(L);
  if (lane == 0) red[warp] = L;
  __syncthreads();
  L = red[0] + red[1] + red[2] + red[3];
  const float* pa = part_acc + row * rstride * D;
  if (out == nullptr) {
    for (int d = tid; d < D; d += 128) {
      float o = 0.f;
      for (int s = 0; s < splits; ++s) o = fmaf(pa[s * sstride * D + d], wts[s], o);
      out_acc[row * D + d] = o;
    }
    if (tid == 0) {
      out_m[row] = M * LN2;
      out_l[row] = L;
    }
    return;
  }
  const float inv = L > 0.f ? 1.f / L : 0.f;
  for (int d = tid; d < D; d += 128) {
    float o = 0.f;
    for (int s = 0; s < splits; ++s) o = fmaf(pa[s * sstride * D + d], wts[s], o);
    out[row * D + d] = from_float<T>(o * inv);
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int DP, int KW, int NW>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const int32_t* lens, void* out,
                       float* pm, float* pl, float* pa, int B, int H, int KH, int T_, int D,
                       int splits, int per_split, cudaStream_t stream) {
  using C = MmaCfg<DP, KW, NW>;
  auto kernel = decode_split_mma_kernel<DP, KW, NW>;
  cudaError_t e = set_smem(kernel, C::SMEM);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(splits, KH, B), NW * 32, C::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), lens, static_cast<__nv_bfloat16*>(out), pm, pl, pa,
      T_, H, KH, D, per_split, LOG2E / sqrtf((float)D));
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_mma_rows(int G, const void* q, const void* k, const void* v,
                            const int32_t* lens, void* out, float* pm, float* pl, float* pa,
                            int B, int H, int KH, int T_, int D, int splits, int per_split,
                            cudaStream_t s) {
  const int mt = (G + 15) / 16;  // 16-row tiles of query rows
  if (mt == 1) return launch_mma<DP, 16, 4>(q, k, v, lens, out, pm, pl, pa, B, H, KH, T_, D, splits, per_split, s);
  if (mt == 2) return launch_mma<DP, 32, 4>(q, k, v, lens, out, pm, pl, pa, B, H, KH, T_, D, splits, per_split, s);
  if (mt <= 4) return launch_mma<DP, 32, 8>(q, k, v, lens, out, pm, pl, pa, B, H, KH, T_, D, splits, per_split, s);
  return launch_mma<DP, 64, 8>(q, k, v, lens, out, pm, pl, pa, B, H, KH, T_, D, splits, per_split, s);
}

template <int DP, int RPW>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const int32_t* lens, void* out,
                       float* pm, float* pl, float* pa, int B, int H, int KH, int T_, int D,
                       int splits, int per_split, cudaStream_t stream) {
  using C = F32Cfg<DP, RPW>;
  auto kernel = decode_split_f32_kernel<DP, RPW>;
  cudaError_t e = set_smem(kernel, C::SMEM);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(splits, KH, B), F32_WARPS * 32, C::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      lens, static_cast<float*>(out), pm, pl, pa, T_, H, KH, D, per_split,
      LOG2E / sqrtf((float)D));
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_f32_rows(int G, const void* q, const void* k, const void* v,
                            const int32_t* lens, void* out, float* pm, float* pl, float* pa,
                            int B, int H, int KH, int T_, int D, int splits, int per_split,
                            cudaStream_t s) {
  const int rpw = (G + F32_WARPS - 1) / F32_WARPS;
  if (rpw <= 1) return launch_f32<DP, 1>(q, k, v, lens, out, pm, pl, pa, B, H, KH, T_, D, splits, per_split, s);
  if (rpw <= 2) return launch_f32<DP, 2>(q, k, v, lens, out, pm, pl, pa, B, H, KH, T_, D, splits, per_split, s);
  if (rpw <= 4) return launch_f32<DP, 4>(q, k, v, lens, out, pm, pl, pa, B, H, KH, T_, D, splits, per_split, s);
  if (rpw <= 8) return launch_f32<DP, 8>(q, k, v, lens, out, pm, pl, pa, B, H, KH, T_, D, splits, per_split, s);
  if (rpw <= 12) return launch_f32<DP, 12>(q, k, v, lens, out, pm, pl, pa, B, H, KH, T_, D, splits, per_split, s);
  return launch_f32<DP, 16>(q, k, v, lens, out, pm, pl, pa, B, H, KH, T_, D, splits, per_split, s);
}

// The split body: (splits, KH, B) CTAs, then the combine when splits > 1,
// or (om != nullptr, the partials) always, into om, ol and oa.
cudaError_t launch(const void* q, const void* k, const void* v, const int32_t* lens, void* out,
                   float* pm, float* pl, float* pa, float* om, float* ol, float* oa, int B, int H,
                   int KH, int T_, int D, int dtype, int splits, int per_split, cudaStream_t s) {
  const int G = H / KH;
  const int dp = D <= 64 ? 64 : (D <= 128 ? 128 : (D <= 192 ? 192 : 256));
  cudaError_t e;
#define DEC_SPLIT_CASE(DP, FN) \
  case DP: e = FN<DP>(G, q, k, v, lens, out, pm, pl, pa, B, H, KH, T_, D, splits, per_split, s); break;
  if (dtype == 1) {
    switch (dp) {
      DEC_SPLIT_CASE(64, launch_mma_rows) DEC_SPLIT_CASE(128, launch_mma_rows)
      DEC_SPLIT_CASE(192, launch_mma_rows) default: DEC_SPLIT_CASE(256, launch_mma_rows)
    }
  } else {
    switch (dp) {
      DEC_SPLIT_CASE(64, launch_f32_rows) DEC_SPLIT_CASE(128, launch_f32_rows)
      DEC_SPLIT_CASE(192, launch_f32_rows) default: DEC_SPLIT_CASE(256, launch_f32_rows)
    }
  }
#undef DEC_SPLIT_CASE
  if (e != cudaSuccess || (splits == 1 && om == nullptr)) return e;
  const size_t smem = sizeof(float) * splits;
  if (dtype == 1) {
    decode_combine_kernel<__nv_bfloat16><<<B * H, 128, smem, s>>>(
        pm, pl, pa, om ? nullptr : static_cast<__nv_bfloat16*>(out), om, ol, oa, splits, D,
        splits, 1, 1.f);
  } else {
    decode_combine_kernel<float><<<B * H, 128, smem, s>>>(
        pm, pl, pa, om ? nullptr : static_cast<float*>(out), om, ol, oa, splits, D, splits, 1,
        1.f);
  }
  return cudaGetLastError();
}

}  // namespace split

}  // namespace

static bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// q (B, H, D), k/v (B, T, KH, D), out (B, H, D): contiguous, of one dtype
// (0 = fp32, 1 = bf16); cache_len (B,) int32.  D even, at most 256, and a
// whole number of 16-byte vectors; q, k, v and out on 16-byte boundaries
// (both bodies load them 16 bytes a thread).  body: 0 = single, 1 = split.  The
// split body takes up to 128 query rows per kv head in bf16 and 64 in fp32,
// and `splits` CTAs of `per_split` slots each (a multiple of 64) covering
// T; with more than one split, part_m and part_l (B, H, splits) and
// part_acc (B, H, splits, D) are fp32 scratch.  Returns a cudaError_t code,
// 0 on success.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* cache_len, void* out, void* part_m,
                                       void* part_l, void* part_acc, int B, int H, int KH,
                                       int T_, int D, int dtype, int body, int splits,
                                       int per_split, void* stream) {
  const int itemsize = dtype == 0 ? 4 : 2;
  if (B < 0 || KH <= 0 || H % KH != 0 || T_ < 0 || D <= 0 || D > 256 || D % 2 != 0 ||
      (D * itemsize) % 16 != 0 || (dtype != 0 && dtype != 1) || (body != 0 && body != 1) ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return 0;
  const int G = H / KH;
  const int32_t* lens = static_cast<const int32_t*>(cache_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    if (G > (dtype == 1 ? 128 : 64) || splits < 1 || per_split < 1 ||
        per_split % split::TK != 0 || (long long)splits * per_split < T_ ||
        (splits > 1 && (part_m == nullptr || part_l == nullptr || part_acc == nullptr)))
      return (int)cudaErrorInvalidValue;
    return (int)split::launch(q, k, v, lens, out, static_cast<float*>(part_m),
                              static_cast<float*>(part_l), static_cast<float*>(part_acc), nullptr,
                              nullptr, nullptr, B, H, KH, T_, D, dtype, splits, per_split, s);
  }
  const int n_chunks = (G + MAX_ROWS - 1) / MAX_ROWS;
  const int rows_per_cta = (G + n_chunks - 1) / n_chunks;
  const int nwarps = NWARPS;
  const int need = (rows_per_cta + nwarps - 1) / nwarps;  // at most MAX_ROWS / NWARPS
  const int rpw = need <= 1 ? 1 : (need <= 2 ? 2 : 4);
  const int dpp = (D + 63) / 64;
  cudaError_t e =
      dtype == 0
          ? launch_dtype<float>(dpp, rpw, q, k, v, lens, out, B, H, KH, T_, D, rows_per_cta, n_chunks, nwarps, s)
          : launch_dtype<__nv_bfloat16>(dpp, rpw, q, k, v, lens, out, B, H, KH, T_, D, rows_per_cta, n_chunks, nwarps, s);
  return (int)e;
}

// The partials of one rank's slice of a cache split along T: q, k, v and
// cache_len as decode_attention_launch takes them for the split body (its
// limits), part_m/part_l (B, H, splits) and part_acc (B, H, splits, D) fp32
// scratch; out_m/out_l (B, H) and out_acc (B, H, D) fp32 receive the
// slice's m (natural log domain of q.k / sqrt(D)), l and unnormalised acc.
extern "C" int decode_attention_partials_launch(
    const void* q, const void* k, const void* v, const void* cache_len, void* part_m,
    void* part_l, void* part_acc, void* out_m, void* out_l, void* out_acc, int B, int H, int KH,
    int T_, int D, int dtype, int splits, int per_split, void* stream) {
  const int itemsize = dtype == 0 ? 4 : 2;
  if (B < 0 || KH <= 0 || H % KH != 0 || T_ < 0 || D <= 0 || D > 256 || D % 2 != 0 ||
      (D * itemsize) % 16 != 0 || (dtype != 0 && dtype != 1) || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || H / KH > (dtype == 1 ? 128 : 64) || splits < 1 ||
      per_split < 1 || per_split % split::TK != 0 || (long long)splits * per_split < T_ ||
      part_m == nullptr || part_l == nullptr || part_acc == nullptr || out_m == nullptr ||
      out_l == nullptr || out_acc == nullptr)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return 0;
  return (int)split::launch(q, k, v, static_cast<const int32_t*>(cache_len), nullptr,
                            static_cast<float*>(part_m), static_cast<float*>(part_l),
                            static_cast<float*>(part_acc), static_cast<float*>(out_m),
                            static_cast<float*>(out_l), static_cast<float*>(out_acc), B, H, KH,
                            T_, D, dtype, splits, per_split, static_cast<cudaStream_t>(stream));
}

// The combine of n partials: m and l (n, rows), acc (n, rows, D), fp32, m
// in the natural log domain; out (rows, D) in dtype (0 = fp32, 1 = bf16).
extern "C" int decode_combine_launch(const void* m, const void* l, const void* acc, void* out,
                                     int n, int rows, int D, int dtype, void* stream) {
  if (n < 1 || rows < 0 || D <= 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pm = static_cast<const float*>(m);
  const float* pl = static_cast<const float*>(l);
  const float* pa = static_cast<const float*>(acc);
  const size_t smem = sizeof(float) * n;
  if (dtype == 1) {
    split::decode_combine_kernel<__nv_bfloat16><<<rows, 128, smem, s>>>(
        pm, pl, pa, static_cast<__nv_bfloat16*>(out), nullptr, nullptr, nullptr, n, D, 1,
        (size_t)rows, LOG2E);
  } else {
    split::decode_combine_kernel<float><<<rows, 128, smem, s>>>(
        pm, pl, pa, static_cast<float*>(out), nullptr, nullptr, nullptr, n, D, 1, (size_t)rows,
        LOG2E);
  }
  return (int)cudaGetLastError();
}
