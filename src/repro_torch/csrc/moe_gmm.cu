// Grouped expert matmul (MoE GMM) for Hopper (sm_90a), fp32 and bf16.
//
// Replaces src/repro/kernels/moe_gmm.py::moe_gmm (the Pallas kernel body
// _gmm_kernel).  Rows of x (T, d_in) are sorted by expert; group_sizes (E,)
// says how many consecutive rows belong to each expert, and
//
//     out[r] = x[r] . w[expert(r)]      (w: (E, d_in, d_out))
//
// computed in fp32 and rounded once to x's dtype.  Rows are assigned to
// groups as the JAX oracle (ref.py::moe_gmm_ref) assigns them: group e spans
// [start_e, start_e + size_e) with start_e the exclusive prefix sum, clipped
// to T, and rows past the sizes' sum belong to the last expert.
//
// What bounds it: bytes.  At Qwen3-MoE's prefill (T = 32768 rows, E = 128,
// 2048 -> 768 in bf16) the function must read x (134 MB) and every
// non-empty expert's weights (403 MB) once and write the output (50 MB):
// 175 us at 3.35 TB/s, against 103 GFLOP, 104 us on the tensor cores.  At
// sorted decode (16 rows over up to 16 experts) it is the weights alone.
//
// What the design does about it: the Pallas wrapper scatters the rows into
// groups padded to its row block and gathers them back (moe_gmm.py:69-78,
// 109), which moves x and the output twice more.  Here the group sizes stay
// on the device and each CTA works out its own offsets: warp 0 walks the
// exclusive prefix sums of the group sizes and of their row tiles, 32
// experts at a time with warp shuffles, and finds the (expert, row tile)
// that its blockIdx.x names.  The grid is static, min(T, ceil(T / BM) + E)
// row tiles (each non-empty group adds at most one partial tile, and every
// tile holds a row) by ceil(d_out / BN) column tiles; a CTA past the last
// tile exits, rows past its group's end are read as zeros and not written,
// and empty groups own no tile.  The output is written in the sorted row
// order, in place: no scatter, no gather, no read of the sizes on the host.
// Two bodies:
//
// * bf16: the tensor cores.  A 64 x 128 output tile per CTA of 4 warps,
//   each warp 32 x 64, from mma.sync m16n8k16 (bf16 in, fp32 accumulate)
//   fed by ldmatrix from shared tiles whose rows are padded by 16 bytes
//   (conflict-free), as in flash_attention.cu.  32-deep slices of x and w
//   come in through cp.async, two stages deep, when d_in and d_out are whole
//   16-byte vectors; otherwise by element, zero-filled past the edges.
// * fp32: the CUDA cores in fp32 FMA (the reference's GMM tolerance is
//   2e-4).  A 64 x 64 output tile per CTA of 256 threads, each a 4 x 4
//   block, from 16-deep shared slices (x transposed).
//
// What it does not do yet: wgmma, TMA, a persistent schedule, or a variant
// for a few rows per expert (decode reads a whole 64-row tile's worth of
// shared memory traffic for one row).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC; bound through a plain C entry point.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

// This CTA's row tile: its expert (-1 when there is no tile) and its rows
// [row0, row1).
struct Tile {
  int expert, row0, row1;
};

// Inclusive prefix sum over the 32 lanes of a warp.
__device__ __forceinline__ int warp_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// The group that holds row tile `tile`: the tiles of expert e follow those
// of experts 0..e-1, and its group of len_e rows has ceil(len_e / BM) of
// them.  Every thread of the CTA calls it; warp 0 does the walk.
template <int BM>
__device__ Tile locate_tile(const int* __restrict__ group_sizes, int E, int T, int tile) {
  __shared__ int info[3];
  const int tid = threadIdx.x;
  if (tid == 0) info[0] = -1;
  __syncthreads();
  if (tid < 32) {
    int rows_before = 0, tiles_before = 0;  // over the experts already walked
    for (int base = 0; base < E; base += 32) {
      const int e = base + tid;
      const int size = e < E ? min(max(group_sizes[e], 0), T) : 0;
      const int rows_incl = warp_scan(size, tid);
      const int start = min(rows_before + rows_incl - size, T);
      const int end = e == E - 1 ? T : min(rows_before + rows_incl, T);
      const int ntiles = e < E ? (end - start + BM - 1) / BM : 0;
      const int tiles_incl = warp_scan(ntiles, tid);
      const int first = tiles_before + tiles_incl - ntiles;
      if (tile >= first && tile < first + ntiles) {  // one lane of one pass at most
        info[0] = e;
        info[1] = start + (tile - first) * BM;
        info[2] = min(end, start + (tile - first + 1) * BM);
      }
      rows_before = min(rows_before + __shfl_sync(FULL, rows_incl, 31), T);
      tiles_before += __shfl_sync(FULL, tiles_incl, 31);
    }
  }
  __syncthreads();
  return Tile{info[0], info[1], info[2]};
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int BM = 64;     // rows per CTA
constexpr int BN = 128;    // output columns per CTA
constexpr int BK = 32;     // depth of one shared slice
constexpr int NT = 128;    // 4 warps, 2 x 2, each 32 x 64
constexpr int AS = BK + 8; // row stride of the x slice (elements): a 16-byte pad
constexpr int WS = BN + 8; // row stride of the w slice

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                        const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3, const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(a));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row-major) * b (16 x 8, bf16, col-major)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// VEC: d_in and d_out are whole 16-byte vectors and x, w are 16-byte aligned.
template <bool VEC>
__global__ void __launch_bounds__(NT) gmm_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const int* __restrict__ group_sizes, __nv_bfloat16* __restrict__ out, int T, int E, int d_in,
    int d_out) {
  __shared__ __align__(16) __nv_bfloat16 Xs[2][BM * AS];
  __shared__ __align__(16) __nv_bfloat16 Ws[2][BK * WS];
  const Tile tile = locate_tile<BM>(group_sizes, E, T, blockIdx.x);
  if (tile.expert < 0) return;
  const int rows = tile.row1 - tile.row0;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;  // this warp's 32 x 64 block of the tile
  const int g = lane >> 2, t4 = lane & 3;   // fragment row group and column pair
  const int lm = lane >> 3, lr = lane & 7;  // ldmatrix: which 8 x 8 matrix, which of its rows
  const __nv_bfloat16* xb = x + (size_t)tile.row0 * d_in;
  const __nv_bfloat16* wb = w + (size_t)tile.expert * d_in * d_out;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  // Slice k0 .. k0 + BK of this tile's rows of x and of w's columns into stage s.
  auto load = [&](int s, int k0) {
    if (VEC) {
      for (int i = tid; i < BM * BK / 8; i += NT) {
        const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        const bool ok = r < rows && k0 + c < d_in;
        cp_async16(&Xs[s][r * AS + c], ok ? xb + (size_t)r * d_in + k0 + c : x, ok);
      }
      for (int i = tid; i < BK * BN / 8; i += NT) {
        const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
        const bool ok = k0 + r < d_in && n0 + c < d_out;
        cp_async16(&Ws[s][r * WS + c], ok ? wb + (size_t)(k0 + r) * d_out + n0 + c : w, ok);
      }
    } else {
      for (int i = tid; i < BM * BK; i += NT) {
        const int r = i / BK, c = i % BK;
        Xs[s][r * AS + c] = r < rows && k0 + c < d_in ? xb[(size_t)r * d_in + k0 + c] : zero;
      }
      for (int i = tid; i < BK * BN; i += NT) {
        const int r = i / BN, c = i % BN;
        Ws[s][r * WS + c] =
            k0 + r < d_in && n0 + c < d_out ? wb[(size_t)(k0 + r) * d_out + n0 + c] : zero;
      }
    }
    cp_async_commit();
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

  const int nk = (d_in + BK - 1) / BK;
  if (nk > 0) load(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk)
      load((kt + 1) & 1, (kt + 1) * BK);  // that stage was consumed in the last pass
    else
      cp_async_commit();  // an empty group, so that "all but the newest" is this slice
    cp_async_wait_1();
    __syncthreads();
    const __nv_bfloat16* xs = Xs[kt & 1];
    const __nv_bfloat16* ws = Ws[kt & 1];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(a[mi][0], a[mi][1], a[mi][2], a[mi][3],
                xs + (wm * 32 + mi * 16 + lr + 8 * (lm & 1)) * AS + kk * 16 + 8 * (lm >> 1));
#pragma unroll
      for (int nj = 0; nj < 8; nj += 2) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(b0, b1, b2, b3,
                      ws + (kk * 16 + lr + 8 * (lm & 1)) * WS + wn * 64 + nj * 8 + 8 * (lm >> 1));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][nj], a[mi], b0, b1);
          mma_bf16(acc[mi][nj + 1], a[mi], b2, b3);
        }
      }
    }
    __syncthreads();  // this stage is consumed before the next pass refills it
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = wm * 32 + mi * 16 + g + 8 * hf;
      if (r >= rows) continue;
      __nv_bfloat16* orow = out + (size_t)(tile.row0 + r) * d_out;
#pragma unroll
      for (int nj = 0; nj < 8; ++nj) {
        const int c = n0 + wn * 64 + nj * 8 + 2 * t4;
        const float v0 = acc[mi][nj][2 * hf], v1 = acc[mi][nj][2 * hf + 1];
        if (VEC) {  // d_out even: c and c + 1 are both in or both out
          if (c < d_out)
            *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (c < d_out) orow[c] = __float2bfloat16(v0);
          if (c + 1 < d_out) orow[c + 1] = __float2bfloat16(v1);
        }
      }
    }
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------
constexpr int F_BM = 64;
constexpr int F_BN = 64;
constexpr int F_BK = 16;
constexpr int F_NT = 256;         // 16 x 16 threads, each a 4 x 4 block
constexpr int F_XS = F_BM + 4;    // row stride of the transposed x slice (float4-aligned)
constexpr int F_WS = F_BN + 4;    // row stride of the w slice

__global__ void __launch_bounds__(F_NT) gmm_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const int* __restrict__ group_sizes,
    float* __restrict__ out, int T, int E, int d_in, int d_out) {
  __shared__ __align__(16) float Xt[F_BK * F_XS];  // x slice, transposed: k-major
  __shared__ __align__(16) float Ws[F_BK * F_WS];
  const Tile tile = locate_tile<F_BM>(group_sizes, E, T, blockIdx.x);
  if (tile.expert < 0) return;
  const int rows = tile.row1 - tile.row0;
  const int n0 = blockIdx.y * F_BN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* xb = x + (size_t)tile.row0 * d_in;
  const float* wb = w + (size_t)tile.expert * d_in * d_out;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d_in; k0 += F_BK) {
    for (int i = tid; i < F_BM * F_BK; i += F_NT) {  // neighbouring threads, neighbouring k
      const int r = i / F_BK, k = i % F_BK;
      Xt[k * F_XS + r] = r < rows && k0 + k < d_in ? xb[(size_t)r * d_in + k0 + k] : 0.f;
    }
    for (int i = tid; i < F_BK * F_BN; i += F_NT) {
      const int k = i / F_BN, c = i % F_BN;
      Ws[k * F_WS + c] =
          k0 + k < d_in && n0 + c < d_out ? wb[(size_t)(k0 + k) * d_out + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < F_BK; ++k) {
      const float4 xv = *reinterpret_cast<const float4*>(Xt + k * F_XS + ty * 4);
      const float4 wv = *reinterpret_cast<const float4*>(Ws + k * F_WS + tx * 4);
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
      const float wa[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xa[i], wa[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= rows) continue;
    float* orow = out + (size_t)(tile.row0 + r) * d_out;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c < d_out) orow[c] = acc[i][j];
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// x (T, d_in), w (E, d_in, d_out), out (T, d_out): contiguous, of one dtype
// (0 = fp32, 1 = bf16); group_sizes (E,) int32 on the device, read only by
// the kernel.  Returns a cudaError_t code, 0 on success.
extern "C" int moe_gmm_launch(const void* x, const void* w, const void* group_sizes, void* out,
                              int T, int E, int d_in, int d_out, int dtype, void* stream) {
  if (T < 0 || E <= 0 || d_in < 0 || d_out < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (T == 0 || d_out == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gs = static_cast<const int*>(group_sizes);
  const int bm = dtype == 0 ? F_BM : BM, bn = dtype == 0 ? F_BN : BN;
  // the static grid: every row tile a group can need, and no more than T
  const long long row_tiles = (T + bm - 1) / bm + (long long)E;
  dim3 grid((unsigned)(row_tiles < T ? row_tiles : T), (d_out + bn - 1) / bn);
  if (dtype == 0) {
    gmm_f32_kernel<<<grid, F_NT, 0, s>>>(static_cast<const float*>(x),
                                         static_cast<const float*>(w), gs,
                                         static_cast<float*>(out), T, E, d_in, d_out);
  } else {
    const bool vec = d_in % 8 == 0 && d_out % 8 == 0 && aligned16(x) && aligned16(w) &&
                     aligned16(out);
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
    if (vec)
      gmm_bf16_kernel<true><<<grid, NT, 0, s>>>(xb, wb, gs, ob, T, E, d_in, d_out);
    else
      gmm_bf16_kernel<false><<<grid, NT, 0, s>>>(xb, wb, gs, ob, T, E, d_in, d_out);
  }
  return (int)cudaGetLastError();
}
