// Tile rasterizer forward (K4): front-to-back alpha compositing of every
// tile's (tile, depth)-sorted gaussian pairs into r, g, b, expected depth
// and final transmittance, and the per-tile count `kend` of 128-pair chunks
// composited before every pixel of the tile fell under T = 1e-4.
//
// Replaces the Pallas TPU kernel gaussreg_tpu/gs/rasterizer/kernels.py:
// _forward_kernel (via _rasterize_fwd_impl). That kernel turns the recurrence
// into MXU products (exponent as an (8, K) x (8, NPIX) product, transmittance
// as a triangular (K, K) product of log1p(-alpha), colours as a (4, K)
// product) over a channel-major copy of the pair rows. None of that is the
// function; what is kept: the exponent's polynomial form and f32 rounding
// (rasterize_common.cuh), the unaligned pair layout walked in 128-aligned
// blocks with foreign rows skipped, and the early exit, which is
// chunk-granular and tile-wide (a per-pixel stop would change `kend`, the
// saturation depths built on it and which pairs carry gradient).
//
// Design: one block per tile, one thread per pixel (32 x 32 = 1024 threads),
// 128 pair rows at a time staged in shared memory straight from
// gdata[sorted_gid[...]] (48 of a row's 64 bytes), every thread reading the
// same row at once (a broadcast, no bank conflict), a sequential
// T *= 1 - alpha per pixel in registers. After each chunk
// __syncthreads_and(T < 1e-4) decides the tile-wide exit.
//
// Bound on the card: ~25 f32 operations per pair and pixel over the chunks
// actually walked against 64 bytes per pair row and 20 bytes per pixel
// written: at 1024 pixels per pair the operations bound it (67 TFLOP/s f32)
// by two orders of magnitude over the bytes. This version issues them as
// separately rounded multiplies and adds and leaves pixels outside a
// gaussian's footprint idle (divergence); it does not use the tensor cores.

#include "rasterize_common.cuh"

namespace {

using namespace raster;

__global__ void __launch_bounds__(1024)
rasterize_fwd_kernel(const float* __restrict__ gdata,
                     const int* __restrict__ sorted_gid,
                     const int* __restrict__ starts, float* __restrict__ planes,
                     int* __restrict__ kend, int cap, int ntx, int nty,
                     int tile_w, int tile_h) {
  __shared__ PairRow rows[kChunk];
  const int tile = blockIdx.x;
  const Segment seg = tile_segment(starts, tile, cap);
  const Pixel pix = pixel_of_thread(tile, ntx, tile_w, tile_h);

  float t = 1.0f, r = 0.0f, g = 0.0f, b = 0.0f, d = 0.0f;
  int k = 0;
  while (k < seg.num_chunks) {
    const int base = (seg.b0 + k) * kChunk;
    const int lo = max(seg.c0, base), hi = min(seg.c1, base + kChunk);
    __syncthreads();  // the previous chunk's rows are no longer read
    stage_rows(rows, gdata, sorted_gid, lo, hi);
    __syncthreads();
    for (int j = 0; j < hi - lo; ++j) {
      const PairRow row = rows[j];
      const float raw = expf(fminf(pair_power(row, pix), 0.0f));
      if (raw >= kAlphaMin) {
        const float alpha = fminf(raw, kAlphaMax);
        const float w = alpha * t;
        r += row.q2.x * w;
        g += row.q2.y * w;
        b += row.q2.z * w;
        d += row.q2.w * w;
        t *= 1.0f - alpha;
      }
    }
    ++k;
    // chunk-granular, tile-wide exit: stop once the tile's max T < 1e-4
    if (__syncthreads_and(t < kTEps)) break;
  }

  const int tx = tile % ntx, ty = tile / ntx;
  const int px = threadIdx.x % tile_w, py = threadIdx.x / tile_w;
  const size_t plane = (size_t)nty * tile_h * ntx * tile_w;
  const size_t at = (size_t)(ty * tile_h + py) * (ntx * tile_w) + tx * tile_w + px;
  planes[at] = r;
  planes[plane + at] = g;
  planes[2 * plane + at] = b;
  planes[3 * plane + at] = d;
  planes[4 * plane + at] = t;
  if (threadIdx.x == 0) kend[tile] = k;
}

}  // namespace

extern "C" int gaussreg_rasterize_fwd(const float* gdata, const int* sorted_gid,
                                      const int* starts, float* planes,
                                      int* kend, int cap, int ntx, int nty,
                                      int tile_w, int tile_h, void* stream) {
  const int npix = tile_w * tile_h;
  if (ntx <= 0 || nty <= 0 || npix <= 0 || npix > 1024 || npix % 32 != 0 ||
      cap < 0) {
    return (int)cudaErrorInvalidValue;
  }
  rasterize_fwd_kernel<<<ntx * nty, npix, 0, (cudaStream_t)stream>>>(
      gdata, sorted_gid, starts, planes, kend, cap, ntx, nty, tile_w, tile_h);
  return (int)cudaGetLastError();
}
