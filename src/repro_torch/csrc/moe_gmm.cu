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
// decode it is the routed experts' weights alone: Qwen3-MoE served at B = 4
// sends 32 token replicas to ~29 of its 128 experts, 91.5 MB a launch at
// 2048 -> 768 or 768 -> 2048 (27.3 us), against 0.1 GFLOP.
//
// What the design does about it: the Pallas wrapper scatters the rows into
// groups padded to its row block and gathers them back (moe_gmm.py:69-78,
// 109), which moves x and the output twice more.  Here the group sizes stay
// on the device and every CTA works out the offsets itself from their
// exclusive prefix sums (and those of the row tiles), 32 experts at a time
// with warp shuffles.  Rows of a tile past its group's end are read,
// multiplied and never written; empty groups own no tile.  The output is
// written in the sorted row order, in place: no scatter, no gather, no read
// of the sizes on the host.  Five bodies, chosen by the caller
// (kernels/moe_gmm.py::body_for):
//
// * wgmma (bf16; d_in and d_out whole 16-byte vectors; x, w, out 16-byte
//   aligned; at most MAX_EXPERTS experts): a persistent grid of one CTA per
//   SM walks the (row tile, column tile) list expert by expert, the column
//   tiles of one 128-row tile next to each other, so that an expert's rows
//   of x and its weights come from device memory about once and from L2
//   after that.  (A grid with the row tiles fastest sweeps all of x once per
//   column tile: six times at Qwen3's 2048 -> 768.)  Each CTA has a producer
//   warpgroup, one thread of which keeps a 4-stage ring of 64-deep slices
//   filled by TMA (x through a 2-D map over (T, d_in), w through a 3-D map
//   over (E, d_in, d_out), both 128-byte swizzled, zero past the edges),
//   and two consumer warpgroups, each computing 64 rows of the 128 x 128
//   output tile with wgmma m64n128k16 from shared memory (w N-major: the
//   transpose bit).  A consumer warpgroup whose 64 rows all lie past its
//   group's end skips the products.
// * decode (bf16, the same widths and alignment; at most 64 rows, and not
//   for the input gradient): the few-rows body.  At decode a group holds a
//   few rows and the weights are all the bytes, so the wgmma body's 128 x
//   128 tiles fit it badly: a tile streams 512 KB of one expert through one
//   ring for 1-4 useful rows, and ~29 experts x 6 column tiles make two
//   rounds of 132 SMs where 1.3 would do.  Here A and B swap: an expert's
//   output columns fill wgmma's 64-row M side and the group's rows a narrow
//   N of 8 (m64n8k16), so the weights stream through the tensor cores once.
//   A CTA owns one non-empty group and 128 output columns (two 64-wide
//   boxes a stage, so each weight row is read 256 contiguous bytes at a
//   time: at 2048 -> 768, one box of 128 bytes a stage was 10 % slower),
//   or a few such slices where the groups x slices would pass two CTAs an
//   SM (a slice a CTA, with no slices looped, was 5 % slower at 768 ->
//   2048); empty groups own none.  A producer warp keeps a ring of 80 KB
//   of weights (five stages) and 8-row x boxes (from L2) filled by TMA; one
//   consumer warpgroup issues the products, a slice in flight while the
//   next issues, and writes each output element once, rounded once.  A
//   group of more than 8 rows is walked in 8-row chunks, each a pass over
//   its weights (decode at up to 8 tokens never has one).  At Qwen3's
//   served decode it reads the routed weights at ~2.4 TB/s (36-38 us
//   against 26.3, L2 flushed clean; rings of 48-96 KB and 1-3 CTAs an SM
//   read the same), the wgmma body at ~2.0 (42-48 us).
// * mma (bf16, the same widths and alignment): a 64 x 128 output tile per
//   CTA of 4 warps, each warp 32 x 64, from mma.sync m16n8k16 fed by
//   ldmatrix from shared tiles whose rows are padded by 16 bytes, 32-deep
//   slices through a two-stage cp.async ring, on a static grid of
//   min(T, ceil(T / 64) + E) row tiles by ceil(d_out / 128) column tiles
//   (a CTA past the last tile exits).
// * mma_elem (bf16, any widths): the mma body with element loads,
//   zero-filled past the edges (ragged widths such as 999 -> 777).
// * fp32: the CUDA cores in fp32 FMA (the reference's GMM tolerance is
//   2e-4).  A 64 x 64 output tile per CTA of 256 threads, each a 4 x 4
//   block, from 16-deep shared slices (x transposed), on the mma body's grid.
//
// The gradient (kernels/moe_gmm_bwd.py; the Pallas kernel has none, the
// reference differentiates moe_gmm_ref with XLA):
//
// * dx = dy . w[e]^T runs on these bodies with trans_w set: w (E, d_out,
//   d_in) as stored is read as each block's transpose, with no transposed
//   copy.  wgmma takes w's slices K-major (one 64 x 128 TMA box a stage)
//   with B's transpose bit off; mma stages them n-major and loads B with
//   ldmatrix without .trans; fp32 stages them transposed.
// * dw[e] = x_e^T . dy_e is a kernel of its own (gmm_wgrad_*), every
//   expert's dw written whole (zeros for an empty group), each group's rows
//   found on the device from the sizes.  Bound by bytes at Qwen3-MoE's
//   shapes: x (134 MB) and dy (50 MB) read once and every expert's dw
//   written once (403 MB, 120 of the 175 us).  Bodies:
//   - wgmma (bf16, the forward's widths, alignment and expert count): a
//     persistent grid of one CTA per SM walks the (expert, d_in tile,
//     d_out tile) list expert by expert, so that x_e and dy_e come from
//     device memory about once and from L2 after that.  A tile is 128 x
//     256 of dw (x_e crosses L2 d_out / 256 times and dy_e d_in / 128
//     times: a quarter less than at 128 x 128, and half the epilogues).  A
//     producer warpgroup keeps a 3-stage ring of 64-row slices filled by
//     TMA (x over (T, d_in), dy over (T, d_out), 128-byte swizzled); two
//     consumer warpgroups each sum 64 x 256 on wgmma m64n256k16 with both
//     operands MN-major (d_in and d_out are the contiguous dimensions: A's
//     transpose bit as well as B's), one slice's products in flight while
//     the next issues.  A slice starts at any row: the group's last slice
//     issues only the k-steps its rows reach, and the rows of its last
//     k-step past the group's end are zeroed in both operands in shared
//     memory (fenced for the async proxy), so that the next expert's rows
//     never enter the sum.  The epilogue rounds to bf16 into a swizzled
//     shared tile that a TMA store (3-D over (E, d_in, d_out)) writes while
//     the next tile's slices load.  No split over rows and no atomics: a
//     repeat is bit for bit, and a skewed routing (every row in one expert)
//     leaves one tile's loop over all of them.
//   - mma (bf16, whole 16-byte vectors, aligned): a grid of (d_in x d_out
//     tiles, E), each CTA summing a 64 x 128 tile over its group's rows in
//     fp32 (x's slice is A transposed: ldmatrix .trans) through a two-stage
//     cp.async ring of 32-row slices, so short groups never fill the ring;
//     mma_elem the same with element loads (any widths); fp32 on the CUDA
//     cores.
//
// What it does not do yet: gate and up in one launch (decode reads x twice
// and pays two launches), a TMA store of the forward's output tile, or dw's
// split over rows for a skewed routing.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC -I csrc; bound through a plain C entry point.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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
constexpr int WT = BK + 8; // row stride of a transposed w slice (n-major)

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::ldsm_x4;
using hopper::ldsm_x4_trans;
using hopper::mma_bf16;

// VEC: d_in and d_out are whole 16-byte vectors and x, w are 16-byte aligned.
// TW: w is (E, d_out, d_in) and each expert's block is read as its
// transpose (the input gradient: dy . w[e]^T), staged n-major.
template <bool VEC, bool TW>
__global__ void __launch_bounds__(NT) gmm_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const int* __restrict__ group_sizes, __nv_bfloat16* __restrict__ out, int T, int E, int d_in,
    int d_out) {
  __shared__ __align__(16) __nv_bfloat16 Xs[2][BM * AS];
  __shared__ __align__(16) __nv_bfloat16 Ws[2][TW ? BN * WT : BK * WS];
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
      if (TW) {
        for (int i = tid; i < BN * BK / 8; i += NT) {
          const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
          const bool ok = n0 + r < d_out && k0 + c < d_in;
          cp_async16(&Ws[s][r * WT + c], ok ? wb + (size_t)(n0 + r) * d_in + k0 + c : w, ok);
        }
      } else {
        for (int i = tid; i < BK * BN / 8; i += NT) {
          const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
          const bool ok = k0 + r < d_in && n0 + c < d_out;
          cp_async16(&Ws[s][r * WS + c], ok ? wb + (size_t)(k0 + r) * d_out + n0 + c : w, ok);
        }
      }
    } else {
      for (int i = tid; i < BM * BK; i += NT) {
        const int r = i / BK, c = i % BK;
        Xs[s][r * AS + c] = r < rows && k0 + c < d_in ? xb[(size_t)r * d_in + k0 + c] : zero;
      }
      for (int i = tid; i < BK * BN; i += NT) {
        if (TW) {
          const int r = i / BK, c = i % BK;
          Ws[s][r * WT + c] =
              n0 + r < d_out && k0 + c < d_in ? wb[(size_t)(n0 + r) * d_in + k0 + c] : zero;
        } else {
          const int r = i / BN, c = i % BN;
          Ws[s][r * WS + c] =
              k0 + r < d_in && n0 + c < d_out ? wb[(size_t)(k0 + r) * d_out + n0 + c] : zero;
        }
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
    hopper::cp_async_wait<1>();
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
        if (TW)
          ldsm_x4(b0, b1, b2, b3,
                  ws + (wn * 64 + nj * 8 + lr + 8 * (lm >> 1)) * WT + kk * 16 + 8 * (lm & 1));
        else
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

template <bool TW>
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
      if (TW) {  // neighbouring threads, neighbouring k of w's rows
        const int k = i % F_BK, c = i / F_BK;
        Ws[k * F_WS + c] =
            k0 + k < d_in && n0 + c < d_out ? wb[(size_t)(n0 + c) * d_in + k0 + k] : 0.f;
      } else {
        const int k = i / F_BN, c = i % F_BN;
        Ws[k * F_WS + c] =
            k0 + k < d_in && n0 + c < d_out ? wb[(size_t)(k0 + k) * d_out + n0 + c] : 0.f;
      }
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


// ---------------------------------------------------------------------------
// the weight gradient: dw[e] = x_e^T . dy_e, one (d_in, d_out) sum per expert
// ---------------------------------------------------------------------------
// Rows [start, end) of expert e's group, as locate_tile assigns them; warp 0
// does the walk, every thread of the CTA calls it.
__device__ void group_rows(const int* __restrict__ group_sizes, int E, int T, int e, int& start,
                           int& end) {
  __shared__ int info[2];
  const int tid = threadIdx.x;
  if (tid < 32) {
    int rows_before = 0;
    for (int base = 0; base < E && base <= e; base += 32) {
      const int g = base + tid;
      const int size = g < E ? min(max(group_sizes[g], 0), T) : 0;
      const int rows_incl = warp_scan(size, tid);
      if (g == e) {
        info[0] = min(rows_before + rows_incl - size, T);
        info[1] = e == E - 1 ? T : min(rows_before + rows_incl, T);
      }
      rows_before = min(rows_before + __shfl_sync(FULL, rows_incl, 31), T);
    }
  }
  __syncthreads();
  start = info[0];
  end = info[1];
}

// bf16 on mma.sync: a BM (d_in) x BN (d_out) tile of dw[e] per CTA of 4
// warps, each 32 x 64, summed in fp32 over the group's rows in BK-deep
// slices (x's slice k-major is A transposed, dy's is B), through a
// two-stage cp.async ring; rows past the group's end load as 0, so an empty
// group writes zeros.  Grid (d_in tiles x d_out tiles, E).
constexpr int XT = BM + 8;  // row stride of the x slice (d_in wide)

template <bool VEC>
__global__ void __launch_bounds__(NT) gmm_wgrad_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
    const int* __restrict__ group_sizes, __nv_bfloat16* __restrict__ dw, int T, int E, int d_in,
    int d_out) {
  __shared__ __align__(16) __nv_bfloat16 Xs[2][BK * XT];
  __shared__ __align__(16) __nv_bfloat16 Ds[2][BK * WS];
  const int e = blockIdx.y;
  int start, end;
  group_rows(group_sizes, E, T, e, start, end);
  const int tiles_n = (d_out + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * BM, n0 = (blockIdx.x % tiles_n) * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t4 = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  auto load = [&](int s, int r0) {
    if (VEC) {
      for (int i = tid; i < BK * BM / 8; i += NT) {
        const int r = i / (BM / 8), c = (i % (BM / 8)) * 8;
        const bool ok = r0 + r < end && m0 + c < d_in;
        cp_async16(&Xs[s][r * XT + c], ok ? x + (size_t)(r0 + r) * d_in + m0 + c : x, ok);
      }
      for (int i = tid; i < BK * BN / 8; i += NT) {
        const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
        const bool ok = r0 + r < end && n0 + c < d_out;
        cp_async16(&Ds[s][r * WS + c], ok ? dy + (size_t)(r0 + r) * d_out + n0 + c : dy, ok);
      }
    } else {
      for (int i = tid; i < BK * BM; i += NT) {
        const int r = i / BM, c = i % BM;
        Xs[s][r * XT + c] = r0 + r < end && m0 + c < d_in ? x[(size_t)(r0 + r) * d_in + m0 + c]
                                                         : zero;
      }
      for (int i = tid; i < BK * BN; i += NT) {
        const int r = i / BN, c = i % BN;
        Ds[s][r * WS + c] =
            r0 + r < end && n0 + c < d_out ? dy[(size_t)(r0 + r) * d_out + n0 + c] : zero;
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
      for (int q = 0; q < 4; ++q) acc[mi][nj][q] = 0.f;

  const int nk = (end - start + BK - 1) / BK;
  if (nk > 0) load(0, start);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk)
      load((kt + 1) & 1, start + (kt + 1) * BK);
    else
      cp_async_commit();
    hopper::cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* xs = Xs[kt & 1];
    const __nv_bfloat16* ds = Ds[kt & 1];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)  // A (m, k) = x[k][m]: the transposed slice
        ldsm_x4_trans(a[mi][0], a[mi][1], a[mi][2], a[mi][3],
                      xs + (kk * 16 + lr + 8 * (lm >> 1)) * XT + wm * 32 + mi * 16 + 8 * (lm & 1));
#pragma unroll
      for (int nj = 0; nj < 8; nj += 2) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(b0, b1, b2, b3,
                      ds + (kk * 16 + lr + 8 * (lm & 1)) * WS + wn * 64 + nj * 8 + 8 * (lm >> 1));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][nj], a[mi], b0, b1);
          mma_bf16(acc[mi][nj + 1], a[mi], b2, b3);
        }
      }
    }
    __syncthreads();
  }

  __nv_bfloat16* we = dw + (size_t)e * d_in * d_out;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = m0 + wm * 32 + mi * 16 + g + 8 * hf;
      if (m >= d_in) continue;
      __nv_bfloat16* row = we + (size_t)m * d_out;
#pragma unroll
      for (int nj = 0; nj < 8; ++nj) {
        const int c = n0 + wn * 64 + nj * 8 + 2 * t4;
        const float v0 = acc[mi][nj][2 * hf], v1 = acc[mi][nj][2 * hf + 1];
        if (VEC) {
          if (c < d_out) *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (c < d_out) row[c] = __float2bfloat16(v0);
          if (c + 1 < d_out) row[c + 1] = __float2bfloat16(v1);
        }
      }
    }
}

// fp32 on the CUDA cores: a 64 x 64 tile of dw[e] per CTA of 256 threads,
// each a 4 x 4 block, over 16-row slices.  Grid (d_in tiles x d_out tiles, E).
__global__ void __launch_bounds__(F_NT) gmm_wgrad_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ dy, const int* __restrict__ group_sizes,
    float* __restrict__ dw, int T, int E, int d_in, int d_out) {
  __shared__ __align__(16) float Xs[F_BK * F_XS];  // x slice: row-major, d_in along the row
  __shared__ __align__(16) float Ds[F_BK * F_WS];
  const int e = blockIdx.y;
  int start, end;
  group_rows(group_sizes, E, T, e, start, end);
  const int tiles_n = (d_out + F_BN - 1) / F_BN;
  const int m0 = (blockIdx.x / tiles_n) * F_BM, n0 = (blockIdx.x % tiles_n) * F_BN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int r0 = start; r0 < end; r0 += F_BK) {
    for (int i = tid; i < F_BK * F_BM; i += F_NT) {
      const int k = i / F_BM, c = i % F_BM;
      Xs[k * F_XS + c] = r0 + k < end && m0 + c < d_in ? x[(size_t)(r0 + k) * d_in + m0 + c] : 0.f;
    }
    for (int i = tid; i < F_BK * F_BN; i += F_NT) {
      const int k = i / F_BN, c = i % F_BN;
      Ds[k * F_WS + c] =
          r0 + k < end && n0 + c < d_out ? dy[(size_t)(r0 + k) * d_out + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < F_BK; ++k) {
      const float4 xv = *reinterpret_cast<const float4*>(Xs + k * F_XS + ty * 4);
      const float4 dv = *reinterpret_cast<const float4*>(Ds + k * F_WS + tx * 4);
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
      const float da[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xa[i], da[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* we = dw + (size_t)e * d_in * d_out;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= d_in) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c < d_out) we[(size_t)m * d_out + c] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on wgmma, fed by TMA: a persistent, warp-specialised grid
// ---------------------------------------------------------------------------
namespace wg {

constexpr int BM = 128;            // rows per output tile: two consumer warpgroups of 64
constexpr int BN = 128;            // columns per output tile: two 64-wide column blocks of w
constexpr int BK = 64;             // depth of one slice (one 128-byte swizzle row of x)
constexpr int STAGES = 4;          // slices in flight
constexpr int THREADS = 384;       // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int X_BYTES = BM * BK * 2;
constexpr int W_BLOCK = BK * 128;  // one 64-wide column block of a w slice (bytes)
constexpr int W_BYTES = BK * BN * 2;
constexpr int STAGE_BYTES = X_BYTES + W_BYTES;
constexpr int MAX_EXPERTS = 1024;  // the per-expert tables live in shared memory

size_t smem_bytes(int E) {
  return 1024 /* alignment */ + (size_t)STAGES * STAGE_BYTES + 2 * STAGES * sizeof(uint64_t) +
         3 * sizeof(int) * (size_t)E;
}

// The expert that owns row tile `rt`: the first e with tiles_end[e] > rt.
__device__ __forceinline__ int expert_of(const int* tiles_end, int E, int rt) {
  int lo = 0, hi = E - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (tiles_end[mid] > rt) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// TW: w is (E, d_out, d_in), read as each block's transpose: its slices
// arrive K-major (one 64 x 128 box a stage) and B's transpose bit is 0.
template <bool TW>
__global__ void __launch_bounds__(THREADS, 1) gmm_wgmma_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
    const int* __restrict__ group_sizes, __nv_bfloat16* __restrict__ out, int T, int E,
    int d_in, int d_out) {
  extern __shared__ __align__(16) uint8_t wg_smem[];  // aligned here to 1024 bytes
  uint8_t* smem = wg_smem + ((1024 - (hopper::smem_addr(wg_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  int* tiles_end = reinterpret_cast<int*>(empty + STAGES);  // inclusive prefix of row tiles
  int* row_start = tiles_end + E;
  int* row_end = row_start + E;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2 * 128);  // every consumer thread releases a slice
    }
    hopper::mbar_fence_init();
  }
  if (tid < 32) {  // the groups' rows and row tiles, 32 experts a pass
    int rows_before = 0, tiles_before = 0;
    for (int base = 0; base < E; base += 32) {
      const int e = base + tid;
      const int size = e < E ? min(max(group_sizes[e], 0), T) : 0;
      const int rows_incl = warp_scan(size, tid);
      const int start = min(rows_before + rows_incl - size, T);
      const int end = e == E - 1 ? T : min(rows_before + rows_incl, T);
      const int ntiles = e < E ? (end - start + BM - 1) / BM : 0;
      const int tiles_incl = warp_scan(ntiles, tid);
      if (e < E) {
        tiles_end[e] = tiles_before + tiles_incl;
        row_start[e] = start;
        row_end[e] = end;
      }
      rows_before = min(rows_before + __shfl_sync(FULL, rows_incl, 31), T);
      tiles_before += __shfl_sync(FULL, tiles_incl, 31);
    }
  }
  __syncthreads();

  const int col_tiles = (d_out + BN - 1) / BN;
  const int total = tiles_end[E - 1] * col_tiles;  // expert-major, column tiles fastest
  const int nk = (d_in + BK - 1) / BK;

  // The role of this thread's warpgroup, uniform across each warp as the
  // compiler can see, so that it sizes each role's registers by setmaxnreg.
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == 2) {  // producer warpgroup: one thread issues every load
    hopper::regs_dealloc<40>();
    if (tid == 2 * 128) {
      hopper::tma_prefetch_map(&xmap);
      hopper::tma_prefetch_map(&wmap);
      int it = 0;
      for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
        const int rt = tile / col_tiles, n0 = (tile - rt * col_tiles) * BN;
        const int e = expert_of(tiles_end, E, rt);
        const int row0 = row_start[e] + (rt - (e ? tiles_end[e - 1] : 0)) * BM;
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % STAGES;
          hopper::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          uint8_t* st = smem + s * STAGE_BYTES;
          hopper::mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
          hopper::tma_load_2d(st, &xmap, &full[s], kb * BK, row0);
          if (TW) {
            hopper::tma_load_3d(st + X_BYTES, &wmap, &full[s], kb * BK, n0, e);
          } else {
#pragma unroll
            for (int c = 0; c < BN / 64; ++c)
              hopper::tma_load_3d(st + X_BYTES + c * W_BLOCK, &wmap, &full[s], n0 + 64 * c,
                                  kb * BK, e);
          }
        }
      }
    }
  } else {  // consumer warpgroups
    hopper::regs_alloc<232>();
    const int wgi = tid >> 7, t = tid & 127, lane = t & 31;
    const int rbase = wgi * 64 + (t >> 5) * 16 + (lane >> 2);  // this thread's first row
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int it = 0;
    for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
      const int rt = tile / col_tiles, n0 = (tile - rt * col_tiles) * BN;
      const int e = expert_of(tiles_end, E, rt);
      const int row0 = row_start[e] + (rt - (e ? tiles_end[e - 1] : 0)) * BM;
      const int rows = min(row_end[e] - row0, BM);
      const bool active = wgi * 64 < rows;
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const int s = it % STAGES;
        hopper::mbar_wait(&full[s], (it / STAGES) & 1);
        if (active) {
          const uint8_t* st = smem + s * STAGE_BYTES;
          hopper::fence_regs(acc);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            const uint64_t da = hopper::desc_sw128(st + wgi * 64 * 128 + kk * 32, 16, 1024);
            if (TW) {
              const uint64_t db = hopper::desc_sw128(st + X_BYTES + kk * 32, 16, 1024);
              hopper::wgmma_ss<BN, 0>(acc, da, db, kb > 0 || kk > 0);
            } else {
              const uint64_t db = hopper::desc_sw128(st + X_BYTES + kk * 16 * 128, W_BLOCK, 1024);
              hopper::wgmma_ss<BN, 1>(acc, da, db, kb > 0 || kk > 0);
            }
          }
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(acc);
        }
        hopper::mbar_arrive(&empty[s]);
      }
      if (active) {  // round once to bf16, store the rows of this group
#pragma unroll
        for (int i = 0; i < BN / 2; i += 2) {
          const int r = rbase + 8 * ((i >> 1) & 1);
          const int c = n0 + (i >> 2) * 8 + (lane & 3) * 2;
          if (r < rows && c < d_out)  // d_out is even: c and c + 1 are both in or both out
            *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row0 + r) * d_out + c) =
                __floats2bfloat162_rn(acc[i], acc[i + 1]);
        }
      }
    }
  }
}

cudaError_t launch(const void* x, const void* w, const int* gs, void* out, int T, int E, int d_in,
                   int d_out, bool tw, cudaStream_t stream) {
  if (d_in == 0) return cudaMemsetAsync(out, 0, (size_t)T * d_out * 2, stream);
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[2] = {(cuuint64_t)d_in, (cuuint64_t)T};
  const cuuint64_t xstrides[1] = {(cuuint64_t)d_in * 2};
  const cuuint32_t xbox[2] = {64, BM};
  // w's rows: d_in of d_out (the forward), or d_out of d_in (tw); the box
  // is 64 wide along the contiguous dimension either way
  const cuuint64_t wdims[3] = {(cuuint64_t)(tw ? d_in : d_out), (cuuint64_t)(tw ? d_out : d_in),
                               (cuuint64_t)E};
  const cuuint64_t wstrides[2] = {(cuuint64_t)(tw ? d_in : d_out) * 2,
                                  (cuuint64_t)d_in * d_out * 2};
  const cuuint32_t wbox[3] = {64, (cuuint32_t)(tw ? BN : BK), 1};
  cudaError_t e = hopper::encode_bf16_map(&xmap, x, 2, xdims, xstrides, xbox);
  if (e == cudaSuccess) e = hopper::encode_bf16_map(&wmap, w, 3, wdims, wstrides, wbox);
  if (e != cudaSuccess) return e;
  const size_t smem = smem_bytes(E);
  auto kernel = tw ? gmm_wgmma_kernel<true> : gmm_wgmma_kernel<false>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  // one CTA per SM, or fewer when there are fewer tiles than SMs
  const long long tiles = ((T + BM - 1) / BM + (long long)E) * ((d_out + BN - 1) / BN);
  const int sms = hopper::sm_count();
  if (sms == 0) return cudaErrorInvalidDevice;
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, THREADS, smem, stream>>>(xmap, wmap, gs, static_cast<__nv_bfloat16*>(out), T, E,
                                          d_in, d_out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the weight gradient on wgmma: dw[e] = x_e^T . dy_e, a persistent grid
// ---------------------------------------------------------------------------
// The (expert, d_in tile, d_out tile) list, expert by expert, d_out tiles
// fastest; a tile is 128 x 256 of dw.  A stage holds one 64-row slice of
// the group: x's 128 columns of d_in as two 64 x 64 boxes (A, MN-major:
// d_in is contiguous; consumer warpgroup c multiplies box c) and dy's 256
// columns of d_out as four boxes (B, MN-major).  A slice starts at any row;
// the group's last slice issues only the k-steps its rows reach, and the
// consumers zero the rows of its boxes that lie past the group's end in
// the last k-step, so that rows of the next expert never enter the sum.
// Each consumer keeps one slice's products in flight while it issues the
// next, rounds its 64 x 256 half of the tile to bf16 into a swizzled
// shared tile, and one of its threads stores that by TMA (a 3-D map over
// (E, d_in, d_out): nothing past d_in or d_out is written) while the next
// tile's slices load.
constexpr int DW_BN = 256;                              // d_out columns of a tile
constexpr int DW_STAGES = 3;
constexpr int DW_BOX = BK * 64 * 2;                     // one 64-row x 64-column box (bytes)
constexpr int DW_DY = 2 * DW_BOX;                       // dy's boxes follow x's two
constexpr int DW_STAGE = (2 + DW_BN / 64) * DW_BOX;
constexpr int DW_OUT = 64 * DW_BN * 2;                  // one consumer's half tile, bf16

size_t dw_smem_bytes(int E) {
  return 1024 + (size_t)DW_STAGES * DW_STAGE + 2 * DW_OUT + 2 * DW_STAGES * sizeof(uint64_t) +
         2 * sizeof(int) * (size_t)E;
}

__global__ void __launch_bounds__(THREADS, 1) gmm_wgrad_wgmma_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap dymap,
    const __grid_constant__ CUtensorMap dwmap, const int* __restrict__ group_sizes, int T,
    int E, int d_in, int d_out) {
  extern __shared__ __align__(16) uint8_t wg_smem[];  // aligned here to 1024 bytes
  uint8_t* smem = wg_smem + ((1024 - (hopper::smem_addr(wg_smem) & 1023)) & 1023);
  uint8_t* outs = smem + DW_STAGES * DW_STAGE;        // two DW_OUT tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(outs + 2 * DW_OUT);
  uint64_t* empty = full + DW_STAGES;
  int* row_start = reinterpret_cast<int*>(empty + DW_STAGES);
  int* row_end = row_start + E;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < DW_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2 * 128);
    }
    hopper::mbar_fence_init();
  }
  if (tid < 32) {  // each group's rows, 32 experts a pass
    int rows_before = 0;
    for (int base = 0; base < E; base += 32) {
      const int e = base + tid;
      const int size = e < E ? min(max(group_sizes[e], 0), T) : 0;
      const int rows_incl = warp_scan(size, tid);
      if (e < E) {
        row_start[e] = min(rows_before + rows_incl - size, T);
        row_end[e] = e == E - 1 ? T : min(rows_before + rows_incl, T);
      }
      rows_before = min(rows_before + __shfl_sync(FULL, rows_incl, 31), T);
    }
  }
  __syncthreads();

  const int tiles_m = (d_in + BM - 1) / BM, tiles_n = (d_out + DW_BN - 1) / DW_BN;
  const int per_expert = tiles_m * tiles_n;
  const int total = E * per_expert;

  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == 2) {  // producer warpgroup: one thread issues every load
    hopper::regs_dealloc<40>();
    if (tid == 2 * 128) {
      hopper::tma_prefetch_map(&xmap);
      hopper::tma_prefetch_map(&dymap);
      int it = 0;
      for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
        const int e = tile / per_expert, r = tile - e * per_expert;
        const int m0 = (r / tiles_n) * BM, n0 = (r % tiles_n) * DW_BN;
        const int start = row_start[e], end = row_end[e];
        for (int r0 = start; r0 < end; r0 += BK, ++it) {
          const int s = it % DW_STAGES;
          hopper::mbar_wait(&empty[s], ((it / DW_STAGES) & 1) ^ 1);
          uint8_t* st = smem + s * DW_STAGE;
          hopper::mbar_arrive_expect_tx(&full[s], DW_STAGE);
#pragma unroll
          for (int c = 0; c < 2; ++c)
            hopper::tma_load_2d(st + c * DW_BOX, &xmap, &full[s], m0 + 64 * c, r0);
#pragma unroll
          for (int c = 0; c < DW_BN / 64; ++c)
            hopper::tma_load_2d(st + DW_DY + c * DW_BOX, &dymap, &full[s], n0 + 64 * c, r0);
        }
      }
    }
  } else {  // consumer warpgroups: rows [64 wgi, 64 wgi + 64) of each dw tile
    hopper::regs_alloc<232>();
    const int wgi = tid >> 7, t = tid & 127, lane = t & 31;
    const int rbase = (t >> 5) * 16 + (lane >> 2);  // this thread's first row of the half
    uint8_t* out = outs + wgi * DW_OUT;
    float acc[DW_BN / 2];
#pragma unroll
    for (int i = 0; i < DW_BN / 2; ++i) acc[i] = 0.f;
    int it = 0;
    for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
      const int e = tile / per_expert, r = tile - e * per_expert;
      const int m0 = (r / tiles_n) * BM, n0 = (r % tiles_n) * DW_BN;
      const int start = row_start[e], end = row_end[e];
      if (start == end) {  // an empty group: zeros
#pragma unroll
        for (int i = 0; i < DW_BN / 2; ++i) acc[i] = 0.f;
      }
      int held = -1;  // the stage whose products are still in flight
      for (int r0 = start; r0 < end; r0 += BK, ++it) {
        const int s = it % DW_STAGES;
        hopper::mbar_wait(&full[s], (it / DW_STAGES) & 1);
        uint8_t* st = smem + s * DW_STAGE;
        uint8_t* xs = st + wgi * DW_BOX;
        const int rows = min(end - r0, BK);
        const int ksteps = (rows + 15) >> 4;
        if (rows & 15) {
          // rows [rows, 16 ksteps) of the last k-step lie past the group (the
          // next expert's, or TMA's zeros past T): each consumer zeroes them
          // in its x box and in half of dy's boxes, so that neither operand
          // carries the next expert's values into the sum
          const int zero_rows = 16 * ksteps - rows;
          for (int i = t; i < zero_rows * 8; i += 128) {
            const int off = (rows + (i >> 3)) * 128 + (i & 7) * 16;
            *reinterpret_cast<uint4*>(xs + off) = make_uint4(0, 0, 0, 0);
#pragma unroll
            for (int c = 0; c < DW_BN / 128; ++c)
              *reinterpret_cast<uint4*>(st + DW_DY + (wgi * DW_BN / 128 + c) * DW_BOX + off) =
                  make_uint4(0, 0, 0, 0);
          }
          hopper::fence_proxy_async_smem();
          hopper::named_barrier(3, 256);  // both consumers: dy's boxes are shared
        }
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          if (kk < ksteps) {
            // A: x's box, d_in contiguous; B: dy's boxes, d_out contiguous
            const uint64_t da = hopper::desc_sw128(xs + kk * 16 * 128, DW_BOX, 1024);
            const uint64_t db = hopper::desc_sw128(st + DW_DY + kk * 16 * 128, DW_BOX, 1024);
            hopper::wgmma_ss<DW_BN, 1, 1>(acc, da, db, r0 > start || kk > 0);
          }
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // the last slice's products are done: release its stage
        hopper::fence_regs(acc);
        if (held >= 0) hopper::mbar_arrive(&empty[held]);
        held = s;
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (held >= 0) hopper::mbar_arrive(&empty[held]);
      // epilogue: wait until this half's last store has read its tile, round
      // once to bf16 into the swizzled tile (64 x 64 boxes), store by TMA
      if (t == 0) hopper::tma_store_wait_read<0>();
      hopper::named_barrier(1 + wgi, 128);
#pragma unroll
      for (int i = 0; i < DW_BN / 2; i += 2) {
        const int row = rbase + 8 * ((i >> 1) & 1);
        const int col = (i >> 2) * 8 + (lane & 3) * 2;  // 0 .. DW_BN - 1
        const int box = col >> 6, cb = (col & 63) * 2;  // byte within the box's row
        const int chunk = (cb >> 4) ^ (row & 7);
        *reinterpret_cast<uint32_t*>(out + box * DW_BOX + row * 128 + chunk * 16 + (cb & 15)) =
            hopper::pack_bf16(acc[i], acc[i + 1]);
      }
      hopper::fence_proxy_async_smem();
      hopper::named_barrier(1 + wgi, 128);
      if (t == 0) {
        const int mr = m0 + 64 * wgi;
        if (mr < d_in) {
#pragma unroll
          for (int c = 0; c < DW_BN / 64; ++c)
            if (n0 + 64 * c < d_out)
              hopper::tma_store_3d(&dwmap, out + c * DW_BOX, n0 + 64 * c, mr, e);
        }
        hopper::tma_store_commit();
      }
    }
    if (t == 0) hopper::tma_store_wait<0>();
  }
}

cudaError_t launch_wgrad(const void* x, const void* dy, const int* gs, void* dw, int T, int E,
                         int d_in, int d_out, cudaStream_t stream) {
  CUtensorMap xmap, dymap, dwmap;
  const cuuint32_t box2[2] = {64, BK};
  const cuuint64_t xdims[2] = {(cuuint64_t)d_in, (cuuint64_t)T};
  const cuuint64_t xstrides[1] = {(cuuint64_t)d_in * 2};
  const cuuint64_t ddims[2] = {(cuuint64_t)d_out, (cuuint64_t)T};
  const cuuint64_t dstrides[1] = {(cuuint64_t)d_out * 2};
  const cuuint64_t wdims[3] = {(cuuint64_t)d_out, (cuuint64_t)d_in, (cuuint64_t)E};
  const cuuint64_t wstrides[2] = {(cuuint64_t)d_out * 2, (cuuint64_t)d_in * d_out * 2};
  const cuuint32_t box3[3] = {64, 64, 1};
  // no rows: every group is empty (and there is no x or dy to map)
  if (T == 0) return cudaMemsetAsync(dw, 0, (size_t)E * d_in * d_out * 2, stream);
  cudaError_t e = hopper::encode_bf16_map(&xmap, x, 2, xdims, xstrides, box2);
  if (e == cudaSuccess) e = hopper::encode_bf16_map(&dymap, dy, 2, ddims, dstrides, box2);
  if (e == cudaSuccess) e = hopper::encode_bf16_map(&dwmap, dw, 3, wdims, wstrides, box3);
  if (e != cudaSuccess) return e;
  const size_t smem = dw_smem_bytes(E);
  e = cudaFuncSetAttribute(gmm_wgrad_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  const long long tiles = (long long)E * ((d_in + BM - 1) / BM) * ((d_out + DW_BN - 1) / DW_BN);
  const int sms = hopper::sm_count();
  if (sms == 0) return cudaErrorInvalidDevice;
  const int grid = (int)(tiles < sms ? tiles : sms);
  gmm_wgrad_wgmma_kernel<<<grid, THREADS, smem, stream>>>(xmap, dymap, dwmap, gs, T, E, d_in,
                                                          d_out);
  return cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------------------
// bf16 on wgmma for a few rows (decode): A and B swapped
// ---------------------------------------------------------------------------
// out[rows of e]^T (64 columns x 8 rows) = w[e][:, n0:n0+64]^T . x[rows of e]^T:
// 64 output columns are wgmma's M (A: w's slice, d_out contiguous, so
// MN-major), a group's rows its N = 8 (B: x's rows, K-major).  The grid is
// (a slot per group that can be non-empty, a group of `per` consecutive
// column slices of BN): locate_tile finds the slot's group, empty groups
// own no slot and a slot past the last non-empty group exits.  A producer
// warp keeps a ring of 64-deep slices filled by TMA (w's MT boxes of 64 x
// 64, and the group's 8 rows of x, 1 KB, from L2); one consumer warpgroup
// issues MT m64n8k16 products a k-step and keeps a slice's products in
// flight while the next one issues.  A group of more than 8 rows (T is at
// most ROWS) is walked in 8-row chunks, each a pass over its weights: at
// decode's batch sizes a group holds at most one row a token, so one pass.
// Each output element is written by one thread of one CTA, rounded once.
namespace dec {

constexpr int ROWS = 64;               // most rows (T) the body takes
constexpr int CH = 8;                  // rows a chunk: wgmma's N
constexpr int MT = 2;                  // 64-column tiles a slice (wgmma M blocks)
constexpr int BN = 64 * MT;            // output columns a slice
constexpr int BK = 64;                 // depth of a slice (one 128-byte swizzle row of x)
constexpr int W_BOX = BK * 64 * 2;     // one 64 x 64 box of w
constexpr int W_BYTES = MT * W_BOX;    // w's boxes of a slice
constexpr int X_BYTES = CH * BK * 2;   // x's box of a slice
constexpr int STAGE_BYTES = W_BYTES + X_BYTES;
constexpr int RING = 80 * 1024;        // weight bytes in flight a CTA, two CTAs an SM
constexpr int STAGES = RING / W_BYTES;
constexpr int CTAS_PER_SM = 2;
constexpr int THREADS = 160;           // consumer warpgroup 0 and producer warp 4

size_t smem_bytes() { return 1024 + (size_t)STAGES * STAGE_BYTES + 2 * STAGES * sizeof(uint64_t); }

__global__ void __launch_bounds__(THREADS) gmm_decode_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
    const int* __restrict__ group_sizes, __nv_bfloat16* __restrict__ out, int T, int E,
    int d_in, int d_out, int per) {
  extern __shared__ __align__(16) uint8_t dec_smem[];  // aligned here to 1024 bytes
  uint8_t* smem = dec_smem + ((1024 - (hopper::smem_addr(dec_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 128);  // every consumer thread releases a slice
    }
    hopper::mbar_fence_init();
  }
  const Tile tile = locate_tile<ROWS>(group_sizes, E, T, blockIdx.x);  // syncs the CTA
  if (tile.expert < 0) return;
  const int rows = tile.row1 - tile.row0;
  const int chunks = (rows + CH - 1) / CH;
  const int first = blockIdx.y * per * BN;
  const int last = min(d_out, first + per * BN);
  const int nk = (d_in + BK - 1) / BK;

  if (tid >= 128) {  // producer warp: one thread issues every load
    if (tid == 128) {
      hopper::tma_prefetch_map(&xmap);
      hopper::tma_prefetch_map(&wmap);
      int it = 0;
      for (int n0 = first; n0 < last; n0 += BN)
        for (int c = 0; c < chunks; ++c)
          for (int kb = 0; kb < nk; ++kb, ++it) {
            const int s = it % STAGES;
            hopper::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
            uint8_t* st = smem + s * STAGE_BYTES;
            hopper::mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
#pragma unroll
            for (int m = 0; m < MT; ++m)
              hopper::tma_load_3d(st + m * W_BOX, &wmap, &full[s], n0 + 64 * m, kb * BK,
                                  tile.expert);
            hopper::tma_load_2d(st + W_BYTES, &xmap, &full[s], kb * BK, tile.row0 + c * CH);
          }
    }
    return;
  }
  // consumer warpgroup: this thread's output columns n0 + 64 m + col and
  // n0 + 64 m + col + 8, rows 2 (lane % 4) and 2 (lane % 4) + 1 of a chunk
  const int lane = tid & 31;
  const int col = (tid >> 5) * 16 + (lane >> 2), row = (lane & 3) * 2;
  int it = 0;
  for (int n0 = first; n0 < last; n0 += BN)
    for (int c = 0; c < chunks; ++c) {
      float acc[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][i] = 0.f;
      int held = -1;  // the stage whose products are still in flight
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const int s = it % STAGES;
        hopper::mbar_wait(&full[s], (it / STAGES) & 1);
        const uint8_t* st = smem + s * STAGE_BYTES;
#pragma unroll
        for (int m = 0; m < MT; ++m) hopper::fence_regs(acc[m]);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t db = hopper::desc_sw128(st + W_BYTES + kk * 32, 16, 1024);
#pragma unroll
          for (int m = 0; m < MT; ++m)
            hopper::wgmma_m64n8k16_ss<0, 1>(
                acc[m], hopper::desc_sw128(st + m * W_BOX + kk * 16 * 128, W_BOX, 1024), db, 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // the last slice's products are done: release its stage
#pragma unroll
        for (int m = 0; m < MT; ++m) hopper::fence_regs(acc[m]);
        if (held >= 0) hopper::mbar_arrive(&empty[held]);
        held = s;
      }
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < MT; ++m) hopper::fence_regs(acc[m]);
      if (held >= 0) hopper::mbar_arrive(&empty[held]);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = c * CH + row + (i & 1), n = n0 + 64 * m + col + 8 * (i >> 1);
          if (r < rows && n < d_out)
            out[(size_t)(tile.row0 + r) * d_out + n] = __float2bfloat16(acc[m][i]);
        }
    }
}

cudaError_t launch(const void* x, const void* w, const int* gs, void* out, int T, int E, int d_in,
                   int d_out, cudaStream_t stream) {
  if (d_in == 0) return cudaMemsetAsync(out, 0, (size_t)T * d_out * 2, stream);
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[2] = {(cuuint64_t)d_in, (cuuint64_t)T};
  const cuuint64_t xstrides[1] = {(cuuint64_t)d_in * 2};
  const cuuint32_t xbox[2] = {BK, CH};
  const cuuint64_t wdims[3] = {(cuuint64_t)d_out, (cuuint64_t)d_in, (cuuint64_t)E};
  const cuuint64_t wstrides[2] = {(cuuint64_t)d_out * 2, (cuuint64_t)d_in * d_out * 2};
  const cuuint32_t wbox[3] = {64, BK, 1};
  cudaError_t e = hopper::encode_bf16_map(&xmap, x, 2, xdims, xstrides, xbox);
  if (e == cudaSuccess) e = hopper::encode_bf16_map(&wmap, w, 3, wdims, wstrides, wbox);
  if (e != cudaSuccess) return e;
  const size_t smem = smem_bytes();
  e = cudaFuncSetAttribute(gmm_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  const int sms = hopper::sm_count();
  if (sms == 0) return cudaErrorInvalidDevice;
  // a slot for every group that can be non-empty (at most min(T, E)); each
  // CTA takes `per` column slices, so that the grid is about one wave
  const int slots = T < E ? T : E, slices = (d_out + BN - 1) / BN;
  const long long target = (long long)CTAS_PER_SM * sms;
  long long want = ((long long)slots * slices + target - 1) / target;
  const int per = (int)(want < 1 ? 1 : want > slices ? slices : want);
  const dim3 grid((unsigned)slots, (slices + per - 1) / per);
  gmm_decode_kernel<<<grid, THREADS, smem, stream>>>(xmap, wmap, gs,
                                                     static_cast<__nv_bfloat16*>(out), T, E,
                                                     d_in, d_out, per);
  return cudaGetLastError();
}

}  // namespace dec

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Dynamic shared memory of the wgmma body over E experts.
extern "C" size_t moe_gmm_wgmma_smem_bytes(int E) { return wg::smem_bytes(E); }

// x (T, d_in), w (E, d_in, d_out) or, with trans_w, (E, d_out, d_in) read
// as each block's transpose (the input gradient dy . w[e]^T: x is dy, out
// is dx), out (T, d_out): contiguous, of one dtype (0 = fp32, 1 = bf16);
// group_sizes (E,) int32 on the device, read only by the kernel.  body: 0 =
// fp32, 1 = mma_elem, 2 = mma, 3 = wgmma, 4 = decode (see the note at the
// top); a body that cannot take these inputs is refused.  Returns a
// cudaError_t code, 0 on success.
extern "C" int moe_gmm_launch(const void* x, const void* w, const void* group_sizes, void* out,
                              int T, int E, int d_in, int d_out, int dtype, int body, int trans_w,
                              void* stream) {
  if (T < 0 || E <= 0 || d_in < 0 || d_out < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const bool vec = d_in % 8 == 0 && d_out % 8 == 0 && aligned16(x) && aligned16(w) &&
                   aligned16(out);
  const bool ok = body == 0 ? dtype == 0
                : body == 1 ? dtype == 1
                : body == 2 ? dtype == 1 && vec
                : body == 3 ? dtype == 1 && vec && E <= wg::MAX_EXPERTS
                : body == 4 ? dtype == 1 && vec && T <= dec::ROWS && !trans_w
                : false;
  if (!ok) return (int)cudaErrorInvalidValue;
  if (T == 0 || d_out == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gs = static_cast<const int*>(group_sizes);
  const bool tw = trans_w != 0;
  if (body == 3) return (int)wg::launch(x, w, gs, out, T, E, d_in, d_out, tw, s);
  if (body == 4) return (int)dec::launch(x, w, gs, out, T, E, d_in, d_out, s);
  const int bm = dtype == 0 ? F_BM : BM, bn = dtype == 0 ? F_BN : BN;
  // the static grid: every row tile a group can need, and no more than T
  const long long row_tiles = (T + bm - 1) / bm + (long long)E;
  dim3 grid((unsigned)(row_tiles < T ? row_tiles : T), (d_out + bn - 1) / bn);
  if (body == 0) {
    auto kernel = tw ? gmm_f32_kernel<true> : gmm_f32_kernel<false>;
    kernel<<<grid, F_NT, 0, s>>>(static_cast<const float*>(x), static_cast<const float*>(w), gs,
                                 static_cast<float*>(out), T, E, d_in, d_out);
  } else {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
    auto kernel = body == 2 ? (tw ? gmm_bf16_kernel<true, true> : gmm_bf16_kernel<true, false>)
                            : (tw ? gmm_bf16_kernel<false, true> : gmm_bf16_kernel<false, false>);
    kernel<<<grid, NT, 0, s>>>(xb, wb, gs, ob, T, E, d_in, d_out);
  }
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the weight gradient's wgmma body over E experts.
extern "C" size_t moe_gmm_wgrad_wgmma_smem_bytes(int E) { return wg::dw_smem_bytes(E); }

// The weight gradient: x (T, d_in) and dy (T, d_out) sorted by expert, dw
// (E, d_in, d_out) written whole (zeros for an empty group), all contiguous
// and of one dtype (0 = fp32, 1 = bf16); group_sizes as above.  body: 0 =
// fp32, 1 = mma_elem, 2 = mma (d_in and d_out whole 16-byte vectors, x, dy
// and dw 16-byte aligned), 3 = wgmma (as mma, and at most MAX_EXPERTS
// experts).  Returns a cudaError_t code, 0 on success.
extern "C" int moe_gmm_wgrad_launch(const void* x, const void* dy, const void* group_sizes,
                                    void* dw, int T, int E, int d_in, int d_out, int dtype,
                                    int body, void* stream) {
  if (T < 0 || E <= 0 || d_in < 0 || d_out < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const bool vec = d_in % 8 == 0 && d_out % 8 == 0 && aligned16(x) && aligned16(dy) &&
                   aligned16(dw);
  const bool ok = body == 0 ? dtype == 0
                : body == 1 ? dtype == 1
                : body == 2 ? dtype == 1 && vec
                : body == 3 ? dtype == 1 && vec && E <= wg::MAX_EXPERTS
                : false;
  if (!ok) return (int)cudaErrorInvalidValue;
  if (d_in == 0 || d_out == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gs = static_cast<const int*>(group_sizes);
  if (body == 3) return (int)wg::launch_wgrad(x, dy, gs, dw, T, E, d_in, d_out, s);
  if (body == 0) {
    const dim3 grid(((d_in + F_BM - 1) / F_BM) * ((d_out + F_BN - 1) / F_BN), E);
    gmm_wgrad_f32_kernel<<<grid, F_NT, 0, s>>>(static_cast<const float*>(x),
                                               static_cast<const float*>(dy), gs,
                                               static_cast<float*>(dw), T, E, d_in, d_out);
  } else {
    const dim3 grid(((d_in + BM - 1) / BM) * ((d_out + BN - 1) / BN), E);
    auto kernel = body == 2 ? gmm_wgrad_bf16_kernel<true> : gmm_wgrad_bf16_kernel<false>;
    kernel<<<grid, NT, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                               static_cast<const __nv_bfloat16*>(dy), gs,
                               static_cast<__nv_bfloat16*>(dw), T, E, d_in, d_out);
  }
  return (int)cudaGetLastError();
}
