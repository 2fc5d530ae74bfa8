// One tensor-parallel rank's decode attention over its slice of a cache
// split along T, for Hopper (sm_90a): the cluster body of the partials and
// the warp combine.  Together they replace the second half of
// src/repro/kernels/decode_attention.py::decode_attention's work where GSPMD
// partitions its caller's cache along T over `model`: every rank attends
// over its slots, the ranks' partials are all-gathered, and every rank
// combines them.  The function is the split body's partials and their
// combine (decode_attention.cu; kernels/decode_attention.py's plain
// versions define both).
//
// The record: one fp32 record per (b, h) row, acc's D unnormalised values,
// then m (natural log domain), l and two zero pads (D + 4 floats, a whole
// number of 16-byte vectors).  A slice with no valid slot gives m = -inf,
// l = 0, acc = 0.
//
// What bounds it: at |model| = 16 a rank reads 2,048 slots, 16.8 MB of
// NeMo's cache a layer (5 us at 3.35 TB/s) and 1 MB of granite's; the
// split body spends as long again on its second launch (the combine in
// partials mode), the round trip of its per-CTA partials through device
// memory and the copies around them, and the block combine of 16 records
// on one 128-thread CTA a row with two block reductions.  So latency, not
// bytes, is what a rank pays.
//
// * cluster (decode_partials_cluster_launch, bf16).  One launch: the split
//   body's grid (splits, KH, B) and its tile loop unchanged (decode_split.cuh:
//   the cp.async ring, mma.sync from ldmatrix, the online softmax in the exp2
//   domain), launched with cudaLaunchKernelEx as one thread-block cluster of
//   `splits` CTAs per (b, kv head): up to 16 (non-portable above 8), the
//   largest size of which the card holds all B * KH clusters at once
//   (decode_cluster_fits: cudaOccupancyMaxActiveClusters: 16 clusters of
//   16 CTAs of 4 warps at 255 registers do not fit 132 SMs at once, so
//   NeMo's shape takes clusters of 8), with a 2-stage ring.  Where the
//   slice has more tiles than the cluster CTAs, each CTA takes several
//   (at NeMo's, 4).  Each CTA merges its warps' states in shared memory;
//   after cluster.sync() the CTAs read each other's (m, l, acc) through
//   distributed shared memory and merge them in split order, each CTA its
//   share of the rows' 4-column units, writing the record; nothing goes
//   through device memory before it.
// * warp combine (decode_combine_warp_launch).  n ranks' records laid out
//   (n, B, H, D + 4), read where they lie (any slice stride), into the
//   output: one warp a (b, h) row and a CTA, no shared memory and no
//   barrier, lanes across D with 16-byte loads, every slice's loads issued
//   before the weighted sum, the sums in slice order, so that every rank
//   computes the same bits from the same records.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC -I csrc; bound through a plain C entry point.

#include "decode_split.cuh"

namespace {

namespace split {

__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __float22bfloat162_rn(make_float2(v.x, v.y));
  q[1] = __float22bfloat162_rn(make_float2(v.z, v.w));
}

// The warp combine of n slices' records, slice s at rec + s * sstride (each
// (rows, D + 4), D a multiple of 4), into out (rows, D): one warp a row and
// a CTA, no shared memory and no barrier, so that every row's loads come
// from an SM of its own.  Lanes lie across D,
// V float4s each.  Every lane reads every slice's m and l (one address for
// the whole warp, one transaction) and its float4s of every slice's acc,
// GROUP slices' loads issued before the first product (all of them for
// n <= GROUP; above it the largest m comes from a first pass), then the
// weights and the sums in slice order: every rank that combines the same
// records computes the same bits.  The arithmetic is the block combine's.
template <typename T, int V>
__global__ void __launch_bounds__(32) decode_combine_warp_kernel(
    const float* __restrict__ rec, T* __restrict__ out, int n, int rows, int D, size_t sstride) {
  constexpr int GROUP = 16 / V;
  const int row = blockIdx.x, lane = threadIdx.x;
  const float* base = rec + (size_t)row * (D + 4);
  float M = -INFINITY;
  if (n > GROUP) {
    for (int s = lane; s < n; s += 32) M = fmaxf(M, base[s * sstride + D] * LOG2E);
    M = warp_max(M);
  }
  float L = 0.f;
  float4 o[V];
#pragma unroll
  for (int v = 0; v < V; ++v) o[v] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < n; s0 += GROUP) {
    float2 ml[GROUP];
    float4 a[GROUP][V];
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      if (s0 + j < n) {
        const float* p = base + (size_t)(s0 + j) * sstride;
        ml[j] = *reinterpret_cast<const float2*>(p + D);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int c = 4 * (lane + 32 * v);
          a[j][v] = c < D ? *reinterpret_cast<const float4*>(p + c) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
    if (n <= GROUP) {
#pragma unroll
      for (int j = 0; j < GROUP; ++j)
        if (j < n) M = fmaxf(M, ml[j].x * LOG2E);
    }
    if (M == -INFINITY) continue;  // the same in every lane: nothing seen yet
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      if (s0 + j < n) {
        const float w = exp2f(ml[j].x * LOG2E - M);
        L = fmaf(ml[j].y, w, L);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          o[v].x = fmaf(a[j][v].x, w, o[v].x);
          o[v].y = fmaf(a[j][v].y, w, o[v].y);
          o[v].z = fmaf(a[j][v].z, w, o[v].z);
          o[v].w = fmaf(a[j][v].w, w, o[v].w);
        }
      }
    }
  }
  const float inv = L > 0.f ? 1.f / L : 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int c = 4 * (lane + 32 * v);
    if (c < D)
      store4(out + (size_t)row * D + c,
             make_float4(o[v].x * inv, o[v].y * inv, o[v].z * inv, o[v].w * inv));
  }
}

// The cluster body's launch configuration: (splits, KH, B) CTAs in
// clusters of `splits` along x (non-portable above 8).
template <int DP, int KW, int NW>
cudaError_t cluster_config(int splits, int KH, int B, cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute& attr) {
  using C = MmaCfg<DP, KW, NW, true>;
  auto kernel = decode_split_mma_kernel<DP, KW, NW, true>;
  cudaError_t e = set_smem(kernel, C::SMEM_C);
  if (e != cudaSuccess) return e;
  if (splits > 8) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(splits, KH, B);
  cfg.blockDim = dim3(NW * 32, 1, 1);
  cfg.dynamicSmemBytes = C::SMEM_C;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = splits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <int DP, int KW, int NW>
cudaError_t launch_mma_cluster(const void* q, const void* k, const void* v, const int32_t* lens,
                               float* rec, int B, int H, int KH, int T_, int D, int splits,
                               int per_split, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = cluster_config<DP, KW, NW>(splits, KH, B, cfg, attr);
  if (e != cudaSuccess) return e;
  cfg.stream = stream;
  e = cudaLaunchKernelEx(&cfg, decode_split_mma_kernel<DP, KW, NW, true>,
                         static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                         static_cast<const __nv_bfloat16*>(v), lens,
                         static_cast<__nv_bfloat16*>(nullptr), static_cast<float*>(nullptr),
                         static_cast<float*>(nullptr), static_cast<float*>(nullptr), rec, T_, H,
                         KH, D, per_split, LOG2E / sqrtf((float)D));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// How many clusters of `c` CTAs of the cluster body the card holds at once
// (cudaOccupancyMaxActiveClusters); 0 if it holds none or refuses the size.
template <int DP, int KW, int NW>
int cluster_fits(int c) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int n = 0;
  if (cluster_config<DP, KW, NW>(c, 1, 1, cfg, attr) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&n, decode_split_mma_kernel<DP, KW, NW, true>, &cfg) !=
          cudaSuccess) {
    cudaGetLastError();  // clear a refusal
    return 0;
  }
  return n;
}

template <int DP>
cudaError_t launch_cluster_rows(int G, const void* q, const void* k, const void* v,
                                const int32_t* lens, float* rec, int B, int H, int KH, int T_,
                                int D, int splits, int per_split, cudaStream_t s) {
  const int mt = (G + 15) / 16;  // 16-row tiles of query rows
  if (mt == 1) return launch_mma_cluster<DP, 16, 4>(q, k, v, lens, rec, B, H, KH, T_, D, splits, per_split, s);
  if (mt == 2) return launch_mma_cluster<DP, 32, 4>(q, k, v, lens, rec, B, H, KH, T_, D, splits, per_split, s);
  if (mt <= 4) return launch_mma_cluster<DP, 32, 8>(q, k, v, lens, rec, B, H, KH, T_, D, splits, per_split, s);
  return launch_mma_cluster<DP, 64, 8>(q, k, v, lens, rec, B, H, KH, T_, D, splits, per_split, s);
}

template <int DP>
int cluster_fits_rows(int G, int c) {
  const int mt = (G + 15) / 16;
  if (mt == 1) return cluster_fits<DP, 16, 4>(c);
  if (mt == 2) return cluster_fits<DP, 32, 4>(c);
  if (mt <= 4) return cluster_fits<DP, 32, 8>(c);
  return cluster_fits<DP, 64, 8>(c);
}

}  // namespace split

}  // namespace

static bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The partials of one rank's slice of a cache split along T on the cluster
// body, bf16: q (B, H, D), k/v (B, T, KH, D), cache_len (B,) int32 as
// decode_attention_launch takes them for the split body (D a whole number
// of 16-byte vectors up to 256, up to 128 query rows per kv head, 16-byte
// boundaries), one cluster of `splits` CTAs (1 to 16; decode_cluster_fits
// says how many clusters of that size the card holds) of `per_split` slots
// each (a multiple of 64) covering T, into the record rec (B, H, D + 4)
// fp32.  Returns a cudaError_t code, 0 on success: a cluster launch the
// card refuses returns its error.
extern "C" int decode_partials_cluster_launch(const void* q, const void* k, const void* v,
                                              const void* cache_len, void* rec, int B, int H,
                                              int KH, int T_, int D, int splits, int per_split,
                                              void* stream) {
  if (B < 0 || KH <= 0 || H % KH != 0 || T_ < 0 || D <= 0 || D > 256 || D % 8 != 0 ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(rec) || H / KH > 128 ||
      splits < 1 || splits > split::MAX_CLUSTER || per_split < 1 ||
      per_split % split::TK != 0 || (long long)splits * per_split < T_)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return 0;
  const int dp = D <= 64 ? 64 : (D <= 128 ? 128 : (D <= 192 ? 192 : 256));
  const int G = H / KH;
  const int32_t* lens = static_cast<const int32_t*>(cache_len);
  float* r = static_cast<float*>(rec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dp) {
    case 64: return (int)split::launch_cluster_rows<64>(G, q, k, v, lens, r, B, H, KH, T_, D, splits, per_split, s);
    case 128: return (int)split::launch_cluster_rows<128>(G, q, k, v, lens, r, B, H, KH, T_, D, splits, per_split, s);
    case 192: return (int)split::launch_cluster_rows<192>(G, q, k, v, lens, r, B, H, KH, T_, D, splits, per_split, s);
    default: return (int)split::launch_cluster_rows<256>(G, q, k, v, lens, r, B, H, KH, T_, D, splits, per_split, s);
  }
}

// How many clusters of c CTAs (1 to 16) of the cluster body the card holds
// at once for G query rows per kv head at head dim D in bf16; 0 if none or
// if the shape is not the body's.
extern "C" int decode_cluster_fits(int G, int D, int c) {
  if (G < 1 || G > 128 || D <= 0 || D > 256 || D % 8 != 0 || c < 1 || c > split::MAX_CLUSTER)
    return 0;
  const int dp = D <= 64 ? 64 : (D <= 128 ? 128 : (D <= 192 ? 192 : 256));
  switch (dp) {
    case 64: return split::cluster_fits_rows<64>(G, c);
    case 128: return split::cluster_fits_rows<128>(G, c);
    case 192: return split::cluster_fits_rows<192>(G, c);
    default: return split::cluster_fits_rows<256>(G, c);
  }
}

// The warp combine of n slices' records into the output: rec holds slice s
// at rec + s * sstride floats, each (rows, D + 4) fp32 as the partials
// write it (D a multiple of 4 up to 256; rec and sstride on 16-byte
// boundaries); out (rows, D) in dtype (0 = fp32, 1 = bf16).
extern "C" int decode_combine_warp_launch(const void* rec, void* out, int n, int rows, int D,
                                          long long sstride, int dtype, void* stream) {
  if (n < 1 || rows < 0 || D <= 0 || D % 4 != 0 || D > 256 || sstride < 0 || sstride % 4 != 0 ||
      !aligned16(rec) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rec);
  const size_t ss = (size_t)sstride;
  if (dtype == 1) {
    if (D <= 128)
      split::decode_combine_warp_kernel<__nv_bfloat16, 1><<<rows, 32, 0, s>>>(
          r, static_cast<__nv_bfloat16*>(out), n, rows, D, ss);
    else
      split::decode_combine_warp_kernel<__nv_bfloat16, 2><<<rows, 32, 0, s>>>(
          r, static_cast<__nv_bfloat16*>(out), n, rows, D, ss);
  } else {
    if (D <= 128)
      split::decode_combine_warp_kernel<float, 1><<<rows, 32, 0, s>>>(
          r, static_cast<float*>(out), n, rows, D, ss);
    else
      split::decode_combine_warp_kernel<float, 2><<<rows, 32, 0, s>>>(
          r, static_cast<float*>(out), n, rows, D, ss);
  }
  return (int)cudaGetLastError();
}
