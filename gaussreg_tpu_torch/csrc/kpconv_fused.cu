// Fused KPConv aggregation (K2):
//   out[r, d] = sum_{k, c} bf16( sum_h infl[r, h, k] * nf[r, h, c] ) * W[k, c, d]
//
// Replaces the Pallas TPU kernel gaussreg_tpu/ops/kpconv_kernel.py:
// _fused_apply_impl (_kernel), with its rounding points: bf16 x bf16
// products (exact in f32) summed over the neighbor slots h in f32, the sum
// rounded to bf16, then contracted with the bf16 weights in f32. Unlike the
// TPU kernel (C % 64 == 0, C <= 256) it takes every width of the backbone;
// the wrapper pads C and D to multiples of 16 with zeros (exact).
//
// Design: a block owns 16 rows (one MMA tile) and walks the input channels
// in chunks of 32 (16 when C % 32 != 0). Both products run on the bf16
// tensor cores (nvcuda::wmma 16x16x16, f32 accumulators):
//   1. per row r, weighted_r (K x chunk) = infl_r^T (K x H) . nf_r (H x chunk),
//      with K padded to 16 and H to a multiple of 16 by zeros in shared
//      memory; each 16x16 result is rounded to bf16 into a (16, K*chunk)
//      shared tile (the per-element rounding keeps the numerics when the
//      channels are chunked);
//   2. out (16 x 16) += weighted (16 x K*chunk) . W[:, chunk, tile]
//      (K*chunk x 16) for one 16-column output tile per warp, B read from
//      global memory (L2-resident across blocks). A grid row of blocks
//      covers 8 tiles (128 columns); wider outputs take more grid rows.
// Only the order of the f32 summations differs from the reference.
//
// Bound on the card: at the level-0 (C, D) = (32, 32) conv (R = 61440,
// H = 35, K = 15) the kernel reads nf (138 MB) and infl (65 MB) once and
// does 2*R*H*K*C + 2*R*K*C*D = 4.0 GFLOP, so it is bound by memory
// bandwidth (~61 us at 3.35 TB/s); so are the wider, shorter levels. This
// version stages through shared memory with plain loads and synchronous
// wmma; TMA and wgmma pipelines are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kRows = 16;           // rows per block: one MMA tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kKp = 16;             // kernel points padded to one MMA tile

__host__ __device__ inline size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

struct Smem {
  size_t infl, nf, wt, scratch, total;
  __host__ __device__ Smem(int hp, int kk, int cc) {
    infl = 0;
    nf = align128(infl + (size_t)kRows * hp * kKp * 2);
    wt = align128(nf + (size_t)kRows * hp * cc * 2);
    scratch = align128(wt + (size_t)kRows * kk * cc * 2);
    total = scratch + (size_t)kWarps * 256 * 4;
  }
};

__global__ void __launch_bounds__(kThreads)
kpconv_fused_kernel(const __nv_bfloat16* __restrict__ nf,
                    const __nv_bfloat16* __restrict__ infl,
                    const __nv_bfloat16* __restrict__ w,
                    float* __restrict__ out, int num_rows, int h, int kk,
                    int c, int d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int hp = (h + 15) / 16 * 16;
  const int cc = (c % 32 == 0) ? 32 : 16;
  const Smem lay(hp, kk, cc);
  __nv_bfloat16* infl_s = reinterpret_cast<__nv_bfloat16*>(smem + lay.infl);
  __nv_bfloat16* nf_s = reinterpret_cast<__nv_bfloat16*>(smem + lay.nf);
  __nv_bfloat16* wt_s = reinterpret_cast<__nv_bfloat16*>(smem + lay.wt);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* scr = reinterpret_cast<float*>(smem + lay.scratch) + warp * 256;

  const int tid = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * kRows;
  const int nrows = (int)min((long long)kRows, num_rows - r0);
  const int ldw = kk * cc;
  const int ntiles = d / 16;
  const int n_tile = blockIdx.y * kWarps + warp;  // this warp's output tile
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

  // influences of the block's rows, zero-padded to (16, hp, 16)
  for (int i = tid; i < kRows * hp * kKp; i += kThreads) {
    const int k = i % kKp;
    const int rh = i / kKp;
    const int r = rh / hp;
    const int hh = rh - r * hp;
    infl_s[i] = (r < nrows && hh < h && k < kk)
                    ? infl[((size_t)(r0 + r) * h + hh) * kk + k]
                    : zero;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.0f);

  const int vecs = cc / 8;  // 16-byte vectors per staged (row, h) slice
  for (int c0 = 0; c0 < c; c0 += cc) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < kRows * hp * vecs; i += kThreads) {
      const int v = i % vecs;
      const int rh = i / vecs;
      const int r = rh / hp;
      const int hh = rh - r * hp;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < nrows && hh < h) {
        val = *reinterpret_cast<const uint4*>(nf + ((size_t)(r0 + r) * h + hh) * c + c0 + v * 8);
      }
      reinterpret_cast<uint4*>(nf_s)[i] = val;
    }
    __syncthreads();

    // 1. weighted sums, one (row, 16-channel tile) job per warp at a time
    const int ct = cc / 16;
    for (int job = warp; job < kRows * ct; job += kWarps) {
      const int r = job / ct;
      const int nt = job - r * ct;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> wacc;
      wmma::fill_fragment(wacc, 0.0f);
      for (int h0 = 0; h0 < hp; h0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(a, infl_s + (size_t)(r * hp + h0) * kKp, kKp);
        wmma::load_matrix_sync(b, nf_s + (size_t)(r * hp + h0) * cc + nt * 16, cc);
        wmma::mma_sync(wacc, a, b, wacc);
      }
      wmma::store_matrix_sync(scr, wacc, 16, wmma::mem_row_major);
      __syncwarp();
      for (int i = lane; i < 256; i += 32) {
        const int k = i >> 4;
        if (k < kk) wt_s[r * ldw + k * cc + nt * 16 + (i & 15)] = __float2bfloat16_rn(scr[i]);
      }
      __syncwarp();
    }
    __syncthreads();

    // 2. out[:, this warp's tile] += weighted . W[:, chunk, tile]
    if (n_tile < ntiles) {
      for (int k = 0; k < kk; ++k) {
        for (int s = 0; s < ct; ++s) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(a, wt_s + k * cc + s * 16, ldw);
          wmma::load_matrix_sync(b, w + ((size_t)k * c + c0 + s * 16) * d + n_tile * 16, d);
          wmma::mma_sync(acc, a, b, acc);
        }
      }
    }
  }

  if (n_tile < ntiles) {
    wmma::store_matrix_sync(scr, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 256; i += 32) {
      const int r = i >> 4;
      if (r < nrows) out[(size_t)(r0 + r) * d + n_tile * 16 + (i & 15)] = scr[i];
    }
  }
}

}  // namespace

extern "C" int gaussreg_kpconv_fused(const void* nf, const void* infl,
                                     const void* w, float* out, int num_rows,
                                     int h, int kk, int c, int d,
                                     void* stream) {
  if (num_rows <= 0 || h <= 0 || kk <= 0 || kk > kKp || c <= 0 || c % 16 != 0 ||
      d <= 0 || d % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Smem lay((h + 15) / 16 * 16, kk, (c % 32 == 0) ? 32 : 16);
  if (lay.total > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kpconv_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  // x: 16-row tiles; y: groups of kWarps 16-column output tiles (each group
  // recomputes the block's weighted sums, a small share of the work, so
  // that wide outputs spread over more SMs)
  const dim3 grid((num_rows + kRows - 1) / kRows, (d / 16 + kWarps - 1) / kWarps);
  kpconv_fused_kernel<<<grid, kThreads, lay.total, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(nf),
      static_cast<const __nv_bfloat16*>(infl),
      static_cast<const __nv_bfloat16*>(w), out, num_rows, h, kk, c, d);
  return (int)cudaGetLastError();
}
