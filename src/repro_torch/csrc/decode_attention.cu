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
// * single (the first port's body).  One CTA per (query-row chunk of 32,
//   kv head, batch row) streams the valid prefix of its K/V slice through
//   shared memory in tiles of TK rows, loaded and then scored, each lane
//   scoring its tile rows as a serial chain over the head dim, in fp32 on
//   the CUDA cores.  At serving batch sizes B * KH CTAs fill few of the 132
//   SMs (Mistral-NeMo at B = 2 launches 16), and granite's 48 query rows
//   take two CTAs, each reading the whole cache.
//
// Partials (decode_attention_partials_launch): one rank's slice of a cache
// split along T, written as one fp32 record per (b, h) row: acc's D
// unnormalised values, then m (natural log domain), l and two zero pads
// (D + 4 floats, a whole number of 16-byte vectors).  A slice with no
// valid slot gives m = -inf, l = 0, acc = 0.  Here the split body (every
// CTA writing its m, l and acc to fp32 scratch), then the block combine in
// a mode that writes the record: two launches, and fp32's only body; the
// cluster body, one launch, is decode_partials.cu's.  The block combine
// (decode_combine_launch: one 128-thread CTA a row, two block reductions,
// each thread's dependent chain of scalar loads over the slices) gives the
// output of the whole cache from n ranks' records laid out (n, B, H, D + 4)
// as the all-gather leaves them; decode_partials.cu's warp combine is the
// one redesigned for Hopper.
//
// What the split body does not do yet: TMA loads; the cluster merge in the
// whole kernel (decode_attention_launch) at long T, where the split body's
// combine launch remains.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC -I csrc; bound through a plain C entry point.

#include "decode_split.cuh"

namespace {

constexpr int TK = 64;         // cache rows per shared-memory tile
constexpr int KPL = TK / 32;   // tile rows scored by each lane
constexpr int MAX_ROWS = 32;   // query rows per CTA
constexpr int NWARPS = 8;      // warps per CTA (those without query rows only load)
constexpr int LOADS = 4;       // tile loads each thread keeps in flight

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

namespace split {

template <int DP, int KW, int NW>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const int32_t* lens, void* out,
                       float* pm, float* pl, float* pa, int B, int H, int KH, int T_, int D,
                       int splits, int per_split, cudaStream_t stream) {
  using C = MmaCfg<DP, KW, NW>;
  auto kernel = decode_split_mma_kernel<DP, KW, NW, false>;
  cudaError_t e = set_smem(kernel, C::SMEM);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(splits, KH, B), NW * 32, C::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), lens, static_cast<__nv_bfloat16*>(out), pm, pl, pa,
      nullptr, T_, H, KH, D, per_split, LOG2E / sqrtf((float)D));
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
// or (rec != nullptr, the partials) always, into the record rec.
cudaError_t launch(const void* q, const void* k, const void* v, const int32_t* lens, void* out,
                   float* pm, float* pl, float* pa, float* rec, int B, int H, int KH, int T_,
                   int D, int dtype, int splits, int per_split, cudaStream_t s) {
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
  if (e != cudaSuccess || (splits == 1 && rec == nullptr)) return e;
  const size_t smem = sizeof(float) * splits;
  // split s of row r: m and l at r * splits + s, acc at (r * splits + s) * D
  const size_t mr = splits, ms = 1, ar = (size_t)splits * D, as = D;
  if (dtype == 1) {
    decode_combine_kernel<__nv_bfloat16><<<B * H, 128, smem, s>>>(
        pm, pl, pa, rec ? nullptr : static_cast<__nv_bfloat16*>(out), rec, splits, D, mr, ms, ar,
        as, 1.f);
  } else {
    decode_combine_kernel<float><<<B * H, 128, smem, s>>>(
        pm, pl, pa, rec ? nullptr : static_cast<float*>(out), rec, splits, D, mr, ms, ar, as,
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
                              B, H, KH, T_, D, dtype, splits, per_split, s);
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

// The partials of one rank's slice of a cache split along T on the split
// body: q, k, v and cache_len as decode_attention_launch takes them for
// the split body (its limits), `splits` CTAs of `per_split` slots into the
// fp32 scratch part_m/part_l (B, H, splits) and part_acc (B, H, splits, D),
// then the block combine in its partials mode, which writes the slice's
// record rec (B, H, D + 4) fp32: the unnormalised acc (D), m (natural log
// domain of q.k / sqrt(D)), l and two zero pads.  Returns a cudaError_t
// code, 0 on success.
extern "C" int decode_attention_partials_launch(
    const void* q, const void* k, const void* v, const void* cache_len, void* part_m,
    void* part_l, void* part_acc, void* rec, int B, int H, int KH, int T_, int D, int dtype,
    int splits, int per_split, void* stream) {
  const int itemsize = dtype == 0 ? 4 : 2;
  if (B < 0 || KH <= 0 || H % KH != 0 || T_ < 0 || D <= 0 || D > 256 || D % 2 != 0 ||
      (D * itemsize) % 16 != 0 || (dtype != 0 && dtype != 1) || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(rec) || H / KH > (dtype == 1 ? 128 : 64) ||
      splits < 1 || per_split < 1 || per_split % split::TK != 0 ||
      (long long)splits * per_split < T_ || part_m == nullptr || part_l == nullptr ||
      part_acc == nullptr)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return 0;
  return (int)split::launch(q, k, v, static_cast<const int32_t*>(cache_len), nullptr,
                            static_cast<float*>(part_m), static_cast<float*>(part_l),
                            static_cast<float*>(part_acc), static_cast<float*>(rec), B, H, KH,
                            T_, D, dtype, splits, per_split, static_cast<cudaStream_t>(stream));
}

// The block combine of n slices' records into the output: rec holds slice
// s at rec + s * sstride floats, each (rows, D + 4) fp32 as the partials
// write it; out (rows, D) in dtype (0 = fp32, 1 = bf16).
extern "C" int decode_combine_launch(const void* rec, void* out, int n, int rows, int D,
                                     long long sstride, int dtype, void* stream) {
  if (n < 1 || rows < 0 || D <= 0 || sstride < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rec);
  const size_t rs = (size_t)D + 4, ss = (size_t)sstride;
  const size_t smem = sizeof(float) * n;
  if (dtype == 1)
    split::decode_combine_kernel<__nv_bfloat16><<<rows, 128, smem, s>>>(
        r + D, r + D + 1, r, static_cast<__nv_bfloat16*>(out), nullptr, n, D, rs, ss, rs, ss,
        LOG2E);
  else
    split::decode_combine_kernel<float><<<rows, 128, smem, s>>>(
        r + D, r + D + 1, r, static_cast<float*>(out), nullptr, n, D, rs, ss, rs, ss, LOG2E);
  return (int)cudaGetLastError();
}
