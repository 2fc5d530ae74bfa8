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
// with padded steps (t >= T) given dt = 0, chunks in sequence, y in x's
// dtype and the final state (B, H, P, N) in fp32.  Unlike the Pallas
// kernel, this one takes an initial state (B, H, P, N) fp32, as
// ssd_chunked_ref does; without one the scan starts from zero.
//
// What bounds it: operations, here.  Per chunk and head the function needs
// L (L + 1) (N + P) + 4 L P N flops (the pairs j <= i of C B^T and of its
// product with X, then C S_in^T and the state update) against reading x, dt,
// b, c and writing y once; at mamba2-780m's L = 128, P = 64, N = 128 that is
// about 75 flops per byte in bf16 and 37 in fp32.  On the tensor cores bf16
// would be bound by bytes (the ridge is about 295 flops per byte), but this
// kernel does its arithmetic on the CUDA cores in fp32, whose ridge is 20.
//
// What the design does about it: the TPU kernel carries the state across
// a sequential grid dimension in VMEM scratch.  Hopper's blocks run in no
// order, so one CTA of 256 threads owns a whole (b, h) and loops over its
// chunks, with the (P x N) state kept in shared memory from one chunk to
// the next.  Shared memory is the constraint: staging b, c, x, G and S in
// fp32 at L = 128, P = 64, N = 128 takes 256 KB, more than the 227 KB a
// block may use.  So (C B^T) . G is built 32 rows at a time (16 KB instead
// of 64 KB), and each 32-row block of y is finished before the next: the
// chunk's B and C (transposed), X, S and one row block take 216 KB.  Only
// the blocks of C B^T on or below the diagonal are computed.  Each thread
// computes 4 x 4 (or 4 x 2) output blocks from 16-byte shared loads.
//
// What it does not do yet: fill the card.  B * H CTAs (96 for mamba2-780m
// at B = 2) occupy 96 of 132 SMs, one CTA each, and the chunks of one
// (b, h) run in sequence.  Computing the chunk states in parallel and
// then running a short inter-chunk pass, and using the tensor cores for
// the three products, are the next steps.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC; bound through a plain C entry point.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;      // threads per CTA
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

template <typename T>
__global__ void __launch_bounds__(NT) ssd_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const T* __restrict__ bm, const T* __restrict__ cm, const float* __restrict__ init,
    T* __restrict__ y, float* __restrict__ final_state, int Tn, int H, int P, int N, int L) {
  const int LP = padded(L);   // chunk rows, padded to whole float4s (the pad has dt = 0)
  const int LS = LP + 4;      // row stride of the transposed B and C
  extern __shared__ __align__(16) float smem[];
  float* Ct = smem;                // N x LS: C of the chunk, transposed
  float* Bt = Ct + N * LS;         // N x LS: B of the chunk, transposed
  float* Xs = Bt + N * LS;         // LP x P: X of the chunk
  float* St = Xs + LP * P;         // N x P: the carried state, transposed
  float* Mt = St + N * P;          // LP x MS: RB rows of (C B^T) . G, transposed
  float* sv = Mt + LP * MS;        // LP: s = cumsum(a dt)
  float* dv = sv + LP;             // LP: dt (0 past T)
  float* wv = dv + LP;             // LP: exp(s_L - s_j) dt_j

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const float ah = a[h];
  const size_t bh = (size_t)b * H + h;
  for (int i = tid; i < N * P; i += NT) {
    const int n = i / P, p = i - n * P;
    St[i] = init != nullptr ? init[(bh * P + p) * N + n] : 0.f;
  }

  constexpr int VEC = Vec<T>::N;
  const int nvec = N / VEC, pvec = P / VEC;
  const int n_chunks = (Tn + L - 1) / L;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * L;
    __syncthreads();  // the previous chunk is consumed
    for (int j = tid; j < LP; j += NT) {
      const int t = t0 + j;
      dv[j] = (j < L && t < Tn) ? dt[((size_t)b * Tn + t) * H + h] : 0.f;
    }
    for (int i = tid; i < LP * nvec; i += NT) {  // rows fastest: conflict-free stores
      const int j = i % LP, c = (i / LP) * VEC;
      const int t = t0 + j;
      float fb[VEC], fc[VEC];
      if (j < L && t < Tn) {
        const size_t off = (((size_t)b * Tn + t) * H + h) * N + c;
        Vec<T>::load(bm + off, fb);
        Vec<T>::load(cm + off, fc);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) fb[e] = fc[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        Bt[(c + e) * LS + j] = fb[e];
        Ct[(c + e) * LS + j] = fc[e];
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
      for (int e = 0; e < VEC; ++e) Xs[j * P + c + e] = f[e];
    }
    __syncthreads();

    // s = cumsum(a dt): warp 0, each lane a contiguous segment, then a
    // warp scan of the segment totals.
    if (tid < 32) {
      const int seg = (LP + 31) / 32;
      const int j0 = tid * seg, j1 = min(j0 + seg, LP);
      float run = 0.f;
      for (int j = j0; j < j1; ++j) {
        run += ah * dv[j];
        sv[j] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += up;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
      for (int j = j0; j < j1; ++j) sv[j] += excl;
    }
    __syncthreads();
    const float sL = sv[LP - 1];
    for (int j = tid; j < LP; j += NT) wv[j] = expf(sL - sv[j]) * dv[j];

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
            const float4 cv = *reinterpret_cast<const float4*>(Ct + n * LS + i0);
            const float4 bv = *reinterpret_cast<const float4*>(Bt + n * LS + j0);
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
            const float g = j <= i ? expf(sv[i] - sv[j]) * dv[j] : 0.f;
            Mt[j * MS + (i - r0)] = acc[ii][jj] * g;
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
          const float4 mv = *reinterpret_cast<const float4*>(Mt + j * MS + ig * 4);
          const float2 xv = *reinterpret_cast<const float2*>(Xs + j * P + p0);
          const float ma[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            intra[ii][0] = fmaf(ma[ii], xv.x, intra[ii][0]);
            intra[ii][1] = fmaf(ma[ii], xv.y, intra[ii][1]);
          }
        }
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          const float4 cv = *reinterpret_cast<const float4*>(Ct + n * LS + i0);
          const float2 st = *reinterpret_cast<const float2*>(St + n * P + p0);
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
            const float e = expf(sv[i]);
            Vec<T>::store2(y + (((size_t)b * Tn + t) * H + h) * P + p0,
                           intra[ii][0] + e * inter[ii][0], intra[ii][1] + e * inter[ii][1]);
          }
        }
      }
      __syncthreads();  // Mt is rewritten by the next row block
    }

    // S_out = exp(s_L) S_in + sum_j B_j (x) (X_j w_j): blocks of 4 n x 4 p.
    const float decay = expf(sL);
    const int pq = P / 4;
    for (int mi = tid; mi < (N / 4) * pq; mi += NT) {
      const int n0 = (mi / pq) * 4, p0 = (mi % pq) * 4;
      float acc[4][4];
#pragma unroll
      for (int nn = 0; nn < 4; ++nn)
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) acc[nn][pp] = 0.f;
      for (int j = 0; j < LP; ++j) {
        const float4 xv = *reinterpret_cast<const float4*>(Xs + j * P + p0);
        const float w = wv[j];
        const float xw[4] = {xv.x * w, xv.y * w, xv.z * w, xv.w * w};
        float ba[4];
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) ba[nn] = Bt[(n0 + nn) * LS + j];
#pragma unroll
        for (int nn = 0; nn < 4; ++nn)
#pragma unroll
          for (int pp = 0; pp < 4; ++pp) acc[nn][pp] = fmaf(ba[nn], xw[pp], acc[nn][pp]);
      }
#pragma unroll
      for (int nn = 0; nn < 4; ++nn)
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          float* s = St + (n0 + nn) * P + p0 + pp;
          *s = decay * *s + acc[nn][pp];
        }
    }
  }
  __syncthreads();
  for (int i = tid; i < N * P; i += NT) {
    const int p = i / N, n = i - p * N;
    final_state[(bh * P + p) * N + n] = St[n * P + p];
  }
}

// Shared memory (bytes) one CTA takes for chunk L, head dim P, state dim N.
size_t smem_bytes(int L, int P, int N) {
  const size_t LP = padded(L);
  return sizeof(float) * (2 * (size_t)N * (LP + 4) + LP * P + (size_t)N * P + LP * MS + 3 * LP);
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* a, const void* b,
                   const void* c, const float* init, void* y, float* fs, int B, int Tn,
                   int H, int P, int N, int L, size_t smem, cudaStream_t stream) {
  auto kernel = ssd_scan_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(H, B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(b), static_cast<const T*>(c),
      init, static_cast<T*>(y), fs, Tn, H, P, N, L);
  return cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) one CTA takes for chunk L, head dim P, state dim N:
// the wrapper holds it against the card's limit before it launches.
extern "C" size_t ssd_scan_smem_bytes(int L, int P, int N) { return smem_bytes(L, P, N); }

// x (B, T, H, P) and b/c (B, T, H, N) of one dtype (0 = fp32, 1 = bf16);
// dt (B, T, H) and a (H,) fp32; init (B, H, P, N) fp32 or null; outputs
// y (B, T, H, P) in x's dtype and the final state (B, H, P, N) fp32; all
// contiguous.  P and N whole numbers of 16-byte vectors; 1 <= L.  Returns a
// cudaError_t code, 0 on success.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a, const void* b,
                               const void* c, const void* init, void* y, void* final_state,
                               int B, int Tn, int H, int P, int N, int L, int dtype,
                               void* stream) {
  const int itemsize = dtype == 0 ? 4 : 2;
  if (B < 0 || Tn < 0 || H < 0 || P <= 0 || N <= 0 || L <= 0 || (P * itemsize) % 16 != 0 ||
      (N * itemsize) % 16 != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return 0;
  const size_t smem = smem_bytes(L, P, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* in = static_cast<const float*>(init);
  float* fs = static_cast<float*>(final_state);
  cudaError_t e =
      dtype == 0
          ? launch<float>(x, dtf, af, b, c, in, y, fs, B, Tn, H, P, N, L, smem, s)
          : launch<__nv_bfloat16>(x, dtf, af, b, c, in, y, fs, B, Tn, H, P, N, L, smem, s);
  return (int)e;
}
