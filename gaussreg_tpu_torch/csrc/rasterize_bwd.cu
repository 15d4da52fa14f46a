// Tile rasterizer backward (K5): per (tile, pair) the gradient of the loss
// with respect to the pair's 6 quadratic coefficients and its r, g, b and
// depth, one private 16-float row per pair, over the chunks the forward
// composited.
//
// Replaces the Pallas TPU kernel gaussreg_tpu/gs/rasterizer/kernels.py:
// _backward_kernel (via _rasterize_bwd_impl). Kept from it, because it is
// the function: tile t walks chunks 0 .. offs[t+1] - offs[t] of its range in
// forward order, recomputing T; the suffix colour sums come as
// <d, final> - <d, prefix>:
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
// Design: one block per tile, one thread per pixel, the chunk's rows staged
// in shared memory as in the forward. Every per-pair value is a sum over the
// tile's pixels: 10 values are reduced within each warp by shuffles (a warp
// none of whose pixels the pair reaches skips the arithmetic), lane 0 writes
// the warp's partials to shared memory, and after 16 pairs 160 threads each
// add one (pair, channel) over the warps in warp order and write it out. Two
// partial buffers alternate, so the block synchronizes once per 16 pairs.
// The output buffer arrives zeroed: channels 6, 7, 12..15, foreign rows of
// boundary blocks and blocks past the compacted end are never written.
//
// Bound on the card: ~53 f32 operations per pair and pixel over the walked
// chunks (the forward's recomputation, two divisions, ten products and ten
// additions of the pixel sums), far
// above the bytes (64 per pair row read and written, 28 per pixel read), so
// operations bound it; this version spends most of its time in the 50 warp
// shuffles per pair instead.

#include "rasterize_common.cuh"

namespace {

using namespace raster;

constexpr int kVals = 10;    // 6 coefficient + 4 colour gradients per pair
constexpr int kGroup = 16;   // pairs per block-wide reduction
constexpr int kMaxWarps = 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(1024)
rasterize_bwd_kernel(const float* __restrict__ gdata,
                     const int* __restrict__ sorted_gid,
                     const int* __restrict__ starts,
                     const int* __restrict__ offs,
                     const float* __restrict__ ct_planes,
                     float* __restrict__ grad_rows, int cap, int ntx, int nty,
                     int tile_w, int tile_h) {
  __shared__ PairRow rows[kChunk];
  __shared__ float partial[2][kMaxWarps][kGroup][kVals];
  const int tile = blockIdx.x;
  const Segment seg = tile_segment(starts, tile, cap);
  const int out_base = offs[tile];
  const int num_chunks = offs[tile + 1] - out_base;
  const Pixel pix = pixel_of_thread(tile, ntx, tile_w, tile_h);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int num_warps = blockDim.x >> 5;

  const int tx = tile % ntx, ty = tile / ntx;
  const int px = threadIdx.x % tile_w, py = threadIdx.x / tile_w;
  const size_t plane = (size_t)nty * tile_h * ntx * tile_w;
  const size_t at = (size_t)(ty * tile_h + py) * (ntx * tile_w) + tx * tile_w + px;
  const float d_r = ct_planes[at], d_g = ct_planes[plane + at];
  const float d_b = ct_planes[2 * plane + at], d_d = ct_planes[3 * plane + at];
  const float ct_t = ct_planes[4 * plane + at] * ct_planes[5 * plane + at];
  const float v = ct_planes[6 * plane + at];

  float t = 1.0f, vp = 0.0f;  // transmittance and <d, prefix> so far
  int parity = 0;
  for (int k = 0; k < num_chunks; ++k) {
    const int base = (seg.b0 + k) * kChunk;
    const int lo = max(seg.c0, base), hi = min(seg.c1, base + kChunk);
    const int n = hi - lo;
    __syncthreads();  // the previous chunk's rows are no longer read
    stage_rows(rows, gdata, sorted_gid, lo, hi);
    __syncthreads();
    // first output row of this chunk's own pairs in the compacted buffer
    float* out = grad_rows + ((size_t)(out_base + k) * kChunk + (lo - base)) * kNchan;
    for (int j0 = 0; j0 < n; j0 += kGroup) {
      const int group = min(kGroup, n - j0);
      float(*part)[kGroup][kVals] = partial[parity];
      for (int jj = 0; jj < group; ++jj) {
        const PairRow row = rows[j0 + jj];
        const float raw = expf(fminf(pair_power(row, pix), 0.0f));
        const bool hit = raw >= kAlphaMin;
        float vals[kVals];
#pragma unroll
        for (int c = 0; c < kVals; ++c) vals[c] = 0.0f;
        if (__any_sync(kFull, hit)) {
          if (hit) {
            const float alpha = fminf(raw, kAlphaMax);
            const float one_m = 1.0f - alpha;
            const float w = alpha * t;
            const float e = row.q2.x * d_r + row.q2.y * d_g + row.q2.z * d_b +
                            row.q2.w * d_d;
            const float u = vp + e * w;
            const float d_alpha = e * t - (v - u) / one_m - ct_t / one_m;
            // d raw / d power = raw inside the band (alpha == raw there)
            const float d_power = raw <= kAlphaMax ? d_alpha * raw : 0.0f;
            vals[0] = d_power;
            vals[1] = d_power * pix.x;
            vals[2] = d_power * pix.y;
            vals[3] = d_power * pix.xx;
            vals[4] = d_power * pix.xy;
            vals[5] = d_power * pix.yy;
            vals[6] = d_r * w;
            vals[7] = d_g * w;
            vals[8] = d_b * w;
            vals[9] = d_d * w;
            vp = u;
            t *= one_m;
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
            for (int c = 0; c < kVals; ++c) {
              vals[c] += __shfl_xor_sync(kFull, vals[c], o);
            }
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int c = 0; c < kVals; ++c) part[warp][jj][c] = vals[c];
        }
      }
      __syncthreads();
      // 160 (pair, channel) sums over the warps, in warp order. The next
      // group writes the other buffer; the barrier after it orders these
      // reads before this buffer is written again.
      for (int i = threadIdx.x; i < group * kVals; i += blockDim.x) {
        const int jj = i / kVals, c = i - jj * kVals;
        float sum = 0.0f;
        for (int w = 0; w < num_warps; ++w) sum += part[w][jj][c];
        out[(size_t)(j0 + jj) * kNchan + (c < 6 ? c : c + 2)] = sum;
      }
      parity ^= 1;
    }
  }
}

}  // namespace

extern "C" int gaussreg_rasterize_bwd(const float* gdata, const int* sorted_gid,
                                      const int* starts, const int* offs,
                                      const float* ct_planes, float* grad_rows,
                                      int cap, int ntx, int nty, int tile_w,
                                      int tile_h, void* stream) {
  const int npix = tile_w * tile_h;
  if (ntx <= 0 || nty <= 0 || npix <= 0 || npix > 1024 || npix % 32 != 0 ||
      cap < 0) {
    return (int)cudaErrorInvalidValue;
  }
  rasterize_bwd_kernel<<<ntx * nty, npix, 0, (cudaStream_t)stream>>>(
      gdata, sorted_gid, starts, offs, ct_planes, grad_rows, cap, ntx, nty,
      tile_w, tile_h);
  return (int)cudaGetLastError();
}
