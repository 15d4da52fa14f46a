// Tile rasterizer backward (K5): per (tile, pair) the gradient of the loss
// with respect to the pair's 6 quadratic coefficients and its r, g, b and
// depth, one private 16-float row per pair, over the chunks the forward
// composited.
//
// Replaces the Pallas TPU kernel gaussreg_tpu/gs/rasterizer/kernels.py:
// _backward_kernel (via _rasterize_bwd_impl). Kept from it, because it is
// the function: tile t's chunks 0 .. offs[t+1] - offs[t] of its range, each
// pair's gradient taken with the T and prefix colour the forward had before
// it; the suffix colour sums come as <d, final> - <d, prefix>:
//   d_alpha = e T_j - (v - u) / (1 - alpha) - dT_final T_final / (1 - alpha)
// with e = <colour, d_rgbd>, u the inclusive prefix of e * alpha * T_j and
// v = <d_rgbd, final rgbd>; d_power = d_alpha * raw inside the band
// 1/255 <= raw <= 0.99 and 0 outside; d_coef = sum over pixels of
// phi * d_power, d_colour = sum over pixels of d_rgbd * alpha * T_j. Rows go
// to the compacted range [offs[t], offs[t+1]) of the output, private per
// tile, so the per-gaussian sum (segment_accumulate.cu) adds them in a fixed
// order and two runs give the same bits. The MXU forms of the Pallas body
// (triangular prefix products, one-hot layouts) are not carried over.
//
// Design: one block per compacted chunk, not per tile. The forward saved
// every walked chunk's starting T and prefix colour (rasterize_common.cuh),
// so chunk k of a tile needs nothing of chunks 0 .. k-1: the ~4 300 pairs
// of the heaviest tile of a fine-step view spread over its ~35 chunks, and
// a view's ~1 100 chunks over the card, where one block per tile left that
// tile alone on one SM. Block b finds its tile by a binary search of
// `offs`; blocks past offs[-1] return at once, so the grid is the buffer's
// capacity and the host reads nothing. A block has 256 threads of four
// pixels each (a warp covers four rows of a 32 x 32 tile; the four are
// independent chains that hide each other's latency), at most 128 rows
// staged in shared memory, and registers capped so that three blocks fit
// on an SM. Per pair a thread sums its four pixels' ten
// values, the warp reduces them by recursive halving (12 shuffles for the
// ten sums, where a butterfly per value takes 50) and ten lanes write the
// warp's partials to shared memory; a warp none of whose pixels the pair
// reaches writes zeros. After the chunk each (pair, value) is summed over
// the warps in warp order: no atomics, one fixed order. The output buffer
// arrives zeroed: channels 6, 7, 12..15, foreign rows of boundary blocks and
// blocks past the compacted end are never written.
//
// d_alpha's quotient is the approximate __fdividef: IEEE division made the
// kernel ~50 % slower on the fine step and moved its result no more than
// flipping the last bit of the gradient rows does.
//
// Bound on the card: ~52 f32 operations per pair and pixel over the walked
// chunks (the forward's recomputation, one division, ten products and ten
// additions of the pixel sums), far above the bytes (64 per pair row read
// and written, 28 per pixel read, 20 per pixel and saved chunk), so
// operations bound it.

#include "rasterize_common.cuh"

// Switches of the timing study (gaussreg_tpu_torch/tools/raster_variants.py);
// the port builds the defaults.
#ifndef RASTER_BWD_MIN_BLOCKS
#define RASTER_BWD_MIN_BLOCKS 3  // resident blocks per SM the registers must allow
#endif

namespace {

using namespace raster;

constexpr int kVals = 10;    // 6 coefficient + 4 colour gradients per pair
constexpr int kPix = 4;      // pixels per thread
constexpr int kMaxWarps = 1024 / (32 * kPix);
constexpr unsigned kFull = 0xffffffffu;

// Which of the ten warp totals lane `lane` holds after warp_halving_sum,
// or -1 (its partner lane ^ 1 holds the same total, or it holds padding).
__device__ __forceinline__ int halving_owner(int lane) {
  const int s1 = (lane >> 4) & 1, s2 = (lane >> 3) & 1;
  const int s3 = (lane >> 2) & 1, s4 = (lane >> 1) & 1;
  const int ci = s3 ? (s4 == 0 ? 2 : -1) : s4;
  const int ai = ci < 0 ? -1 : (s2 ? (ci < 2 ? 3 + ci : -1) : ci);
  return (ai < 0 || (lane & 1)) ? -1 : s1 * 5 + ai;
}

// Sum each of the ten values over the warp's 32 lanes by recursive halving:
// each round a lane keeps one half of its values (padded with a zero where
// the count is odd), sends the other half to its partner and adds what the
// partner sent: 10 -> 5 -> 3 -> 2 -> 1 values over xor distances 16, 8, 4,
// 2, then one full exchange at distance 1. Lane l ends with the total of
// value halving_owner(l).
__device__ __forceinline__ float warp_halving_sum(const float (&v)[kVals], int lane) {
  bool hi = lane & 16;
  float a[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float keep = hi ? v[5 + i] : v[i], send = hi ? v[i] : v[5 + i];
    a[i] = keep + __shfl_xor_sync(kFull, send, 16);
  }
  hi = lane & 8;
  float c[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float up = i < 2 ? a[3 + i] : 0.0f;
    const float keep = hi ? up : a[i], send = hi ? a[i] : up;
    c[i] = keep + __shfl_xor_sync(kFull, send, 8);
  }
  hi = lane & 4;
  float d[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float up = i < 1 ? c[2 + i] : 0.0f;
    const float keep = hi ? up : c[i], send = hi ? c[i] : up;
    d[i] = keep + __shfl_xor_sync(kFull, send, 4);
  }
  hi = lane & 2;
  float e = (hi ? d[1] : d[0]) + __shfl_xor_sync(kFull, hi ? d[0] : d[1], 2);
  return e + __shfl_xor_sync(kFull, e, 1);
}

__global__ void __launch_bounds__(256, RASTER_BWD_MIN_BLOCKS)
rasterize_bwd_kernel(const float* __restrict__ gdata,
                     const int* __restrict__ sorted_gid,
                     const int* __restrict__ starts,
                     const int* __restrict__ offs,
                     const float* __restrict__ ct_planes,
                     const float* __restrict__ state,
                     float* __restrict__ grad_rows, int num_tiles, int cap,
                     int ntx, int nty, int tile_w, int tile_h) {
  __shared__ __align__(16) PairRow rows[kChunk];
  __shared__ float partial[kMaxWarps][kChunk][kVals];
  const int cb = blockIdx.x;  // compacted chunk
  if (cb >= offs[num_tiles]) return;
  // the tile: offs[tile] <= cb < offs[tile + 1] (offs[0] = 0)
  int tile = 0, hi_t = num_tiles;
  while (hi_t - tile > 1) {
    const int mid = (tile + hi_t) >> 1;
    if (offs[mid] <= cb) {
      tile = mid;
    } else {
      hi_t = mid;
    }
  }
  const int k = cb - offs[tile];
  const Segment seg = tile_segment(starts, tile, cap);
  const int2 own = chunk_rows(seg, k);
  const int n = own.y - own.x;
  stage_rows_async(rows, gdata, sorted_gid, own.x, own.y);

  const int npix = tile_w * tile_h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int num_warps = blockDim.x >> 5;
  const size_t plane = (size_t)nty * tile_h * ntx * tile_w;
  const float* s = k > 0 ? state + state_offset(seg, tile, k, npix) : nullptr;
  Pixel pix[kPix];
  float t[kPix], vp[kPix], d_r[kPix], d_g[kPix], d_b[kPix], d_d[kPix], c[kPix];
  bool live[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int p = (warp * kPix + i) * 32 + lane;
    live[i] = p < npix;
    const int q = live[i] ? p : 0;
    pix[i] = pixel_at(tile, ntx, tile_w, tile_h, q);
    const size_t at = plane_index(tile, ntx, tile_w, tile_h, q);
    d_r[i] = ct_planes[at];
    d_g[i] = ct_planes[plane + at];
    d_b[i] = ct_planes[2 * plane + at];
    d_d[i] = ct_planes[3 * plane + at];
    // v + dT_final T_final, the numerator's constant part
    c[i] = ct_planes[6 * plane + at] + ct_planes[4 * plane + at] * ct_planes[5 * plane + at];
    if (s != nullptr) {
      t[i] = s[q];
      vp[i] = d_r[i] * s[npix + q] + d_g[i] * s[2 * npix + q] + d_b[i] * s[3 * npix + q] +
              d_d[i] * s[4 * npix + q];
    } else {
      t[i] = 1.0f;
      vp[i] = 0.0f;
    }
  }
  const int owner = halving_owner(lane);
  __pipeline_wait_prior(0);
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    const PairRow row = rows[j];
    float raw[kPix];
    bool any = false;
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      raw[i] = expf(fminf(pair_power(row, pix[i]), 0.0f));
      any |= live[i] && raw[i] >= kAlphaMin;
    }
    float total = 0.0f;
    if (__any_sync(kFull, any)) {
      float vals[kVals];
#pragma unroll
      for (int v = 0; v < kVals; ++v) vals[v] = 0.0f;
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        if (live[i] && raw[i] >= kAlphaMin) {
          const float alpha = fminf(raw[i], kAlphaMax);
          const float one_m = 1.0f - alpha;
          const float w = alpha * t[i];
          const float e = row.q2.x * d_r[i] + row.q2.y * d_g[i] + row.q2.z * d_b[i] +
                          row.q2.w * d_d[i];
          const float u = vp[i] + e * w;
          const float d_alpha = e * t[i] - __fdividef(c[i] - u, one_m);
          // d raw / d power = raw inside the band (alpha == raw there)
          const float d_power = raw[i] <= kAlphaMax ? d_alpha * raw[i] : 0.0f;
          vals[0] += d_power;
          vals[1] += d_power * pix[i].x;
          vals[2] += d_power * pix[i].y;
          vals[3] += d_power * pix[i].xx;
          vals[4] += d_power * pix[i].xy;
          vals[5] += d_power * pix[i].yy;
          vals[6] += d_r[i] * w;
          vals[7] += d_g[i] * w;
          vals[8] += d_b[i] * w;
          vals[9] += d_d[i] * w;
          vp[i] = u;
          t[i] *= one_m;
        }
      }
      total = warp_halving_sum(vals, lane);
    }
    if (owner >= 0) partial[warp][j][owner] = total;
  }
  __syncthreads();
  // each (pair, value) summed over the warps in warp order
  float* out = grad_rows + ((size_t)cb * kChunk + (own.x - (seg.b0 + k) * kChunk)) * kNchan;
  for (int i = threadIdx.x; i < n * kVals; i += blockDim.x) {
    const int j = i / kVals, v = i - j * kVals;
    float sum = 0.0f;
    for (int w = 0; w < num_warps; ++w) sum += partial[w][j][v];
    out[(size_t)j * kNchan + (v < 6 ? v : v + 2)] = sum;
  }
}

}  // namespace

// One block per compacted chunk of the buffer (bwd_blocks); `state` is the
// forward's chunk-start state of the same render.
extern "C" int gaussreg_rasterize_bwd(const float* gdata, const int* sorted_gid,
                                      const int* starts, const int* offs,
                                      const float* ct_planes, const float* state,
                                      float* grad_rows, int bwd_blocks, int cap,
                                      int ntx, int nty, int tile_w, int tile_h,
                                      void* stream) {
  const int npix = tile_w * tile_h;
  if (ntx <= 0 || nty <= 0 || npix <= 0 || npix > 1024 || npix % 32 != 0 ||
      cap < 0 || bwd_blocks <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = (npix + 32 * kPix - 1) / (32 * kPix) * 32;
  rasterize_bwd_kernel<<<bwd_blocks, threads, 0, (cudaStream_t)stream>>>(
      gdata, sorted_gid, starts, offs, ct_planes, state, grad_rows, ntx * nty, cap, ntx,
      nty, tile_w, tile_h);
  return (int)cudaGetLastError();
}
