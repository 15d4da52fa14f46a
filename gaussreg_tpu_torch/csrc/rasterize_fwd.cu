// Tile rasterizer forward (K4): front-to-back alpha compositing of every
// tile's (tile, depth)-sorted gaussian pairs into r, g, b, expected depth
// and final transmittance, and the per-tile count `kend` of 128-pair chunks
// composited before every pixel of the tile fell under T = 1e-4. For a
// render that will be differentiated it also saves the chunk-start state
// (rasterize_common.cuh) from which the backward walks each chunk on its own.
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
// Design: a tile's pixels are split over a thread-block cluster of P blocks
// (P = 8 at 32 x 32 tiles: 128 threads, one pixel each, four rows per
// block), so the heaviest tile, which on the fine step's views walks some
// 4 500 pairs against a median of ~320, runs on P SMs instead of one. Each
// block stages every chunk's 128 rows (48 of a row's 64 bytes) in shared
// memory with cp.async, the next chunk's while the current one composites
// (two buffers); every thread reads the same row at once (a broadcast), and
// T *= 1 - alpha runs per pixel in registers. Splitting pixels alone does
// not shorten a heavy tile's walk: a block of few warps then waits on the
// latency of each pair's chain (exponent, exp, the update). So each thread
// takes the exponents of eight pairs at once and applies their updates in
// order without a branch, which hides that latency behind independent work.
// The exit stays tile-wide: after each chunk but the last, each block
// publishes whether all of its pixels are under T_EPS, the cluster
// synchronizes, and every block reads the P flags through distributed
// shared memory, so all stop after the same chunk. T never rises, so this
// is exactly the one-block decision.
//
// Bound on the card: ~25 f32 operations per pair and pixel over the chunks
// actually walked against 64 bytes per pair row, 20 bytes per pixel written
// and 20 per pixel and saved chunk: at 1024 pixels per pair the operations
// bound it (67 TFLOP/s f32) by two orders of magnitude over the bytes. This
// version issues them as separately rounded multiplies and adds, also for
// the pixels a gaussian misses (alpha = 0); it does not use the tensor
// cores.

#include <cooperative_groups.h>

#include "rasterize_common.cuh"

// Switches of the timing study (gaussreg_tpu_torch/tools/raster_variants.py);
// the port builds the defaults.
#ifndef RASTER_FWD_ILP
#define RASTER_FWD_ILP 8  // pairs whose exponents are taken together
#endif

namespace {

using namespace raster;
namespace cg = cooperative_groups;

__global__ void __launch_bounds__(1024)
rasterize_fwd_kernel(const float* __restrict__ gdata,
                     const int* __restrict__ sorted_gid,
                     const int* __restrict__ starts, float* __restrict__ planes,
                     int* __restrict__ kend, float* __restrict__ state, int cap,
                     int ntx, int nty, int tile_w, int tile_h) {
  __shared__ __align__(16) PairRow rows[2][kChunk];
  __shared__ int below[2];  // this block's "all pixels under T_EPS", by chunk parity
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / csize;
  const int npix = tile_w * tile_h;
  const int p = rank * blockDim.x + threadIdx.x;  // this thread's pixel in the tile
  const Segment seg = tile_segment(starts, tile, cap);
  const Pixel pix = pixel_at(tile, ntx, tile_w, tile_h, p);

  float t = 1.0f, r = 0.0f, g = 0.0f, b = 0.0f, d = 0.0f;
  int k = 0;
  if (seg.num_chunks > 0) {
    const int2 own = chunk_rows(seg, 0);
    stage_rows_async(rows[0], gdata, sorted_gid, own.x, own.y);
  }
  while (k < seg.num_chunks) {
    const int2 own = chunk_rows(seg, k);
    const int n = own.y - own.x;
    PairRow* chunk = rows[k & 1];
    // prefetch chunk k + 1 into the buffer chunk k - 1 used: every thread
    // passed the barrier after reading it
    if (k + 1 < seg.num_chunks) {
      const int2 next = chunk_rows(seg, k + 1);
      stage_rows_async(rows[(k + 1) & 1], gdata, sorted_gid, next.x, next.y);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    if (state != nullptr && k > 0) {
      float* s = state + state_offset(seg, tile, k, npix) + p;
      s[0] = t;
      s[npix] = r;
      s[2 * npix] = g;
      s[3 * npix] = b;
      s[4 * npix] = d;
    }
    // the exponents of RASTER_FWD_ILP pairs at once, then their updates in
    // order without a branch: the exponents are independent work that hides
    // each other's latency, the recurrence through T and the colours is a
    // multiply-add per pair. A pair under the cut (or past the chunk's end)
    // gets alpha = 0, and t * 1 and colour + c * 0 leave every bit as a
    // skipped update would (the rows are finite)
    for (int j0 = 0; j0 < n; j0 += RASTER_FWD_ILP) {
      float alpha[RASTER_FWD_ILP];
#pragma unroll
      for (int u = 0; u < RASTER_FWD_ILP; ++u) {
        const float raw = expf(fminf(pair_power(chunk[min(j0 + u, n - 1)], pix), 0.0f));
        alpha[u] = j0 + u < n && raw >= kAlphaMin ? fminf(raw, kAlphaMax) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < RASTER_FWD_ILP; ++u) {
        const float4 colour = chunk[min(j0 + u, n - 1)].q2;
        const float w = alpha[u] * t;
        r += colour.x * w;
        g += colour.y * w;
        b += colour.z * w;
        d += colour.w * w;
        t *= 1.0f - alpha[u];
      }
    }
    ++k;
    if (k == seg.num_chunks) break;  // the last chunk: kend is num_chunks either way
    // chunk-granular, tile-wide exit: stop once the tile's max T < 1e-4.
    // The cluster barrier also orders this chunk's reads of the row buffer
    // before the next prefetch writes it again.
    const int mine = __syncthreads_and(t < kTEps);
    if (threadIdx.x == 0) below[k & 1] = mine;
    cluster.sync();
    int flag = 1;
    if (threadIdx.x < csize) flag = *cluster.map_shared_rank(&below[k & 1], (int)threadIdx.x);
    if (__syncthreads_and(flag)) break;
  }
  __pipeline_wait_prior(0);  // a prefetch issued before the exit lands
  cluster.sync();            // no block leaves while another may read its memory

  const size_t plane = (size_t)nty * tile_h * ntx * tile_w;
  const size_t at = plane_index(tile, ntx, tile_w, tile_h, p);
  planes[at] = r;
  planes[plane + at] = g;
  planes[2 * plane + at] = b;
  planes[3 * plane + at] = d;
  planes[4 * plane + at] = t;
  if (rank == 0 && threadIdx.x == 0) kend[tile] = k;
}

}  // namespace

// `state` may be null (a render that is not differentiated saves none);
// otherwise it holds (num_blocks + num_tiles) * 5 * tile_w * tile_h floats.
// `cluster` blocks share a tile; the launch is refused (and its error
// returned) where the card cannot place such a cluster.
extern "C" int gaussreg_rasterize_fwd(const float* gdata, const int* sorted_gid,
                                      const int* starts, float* planes, int* kend,
                                      float* state, int cap, int ntx, int nty,
                                      int tile_w, int tile_h, int cluster,
                                      void* stream) {
  const int npix = tile_w * tile_h;
  if (ntx <= 0 || nty <= 0 || npix <= 0 || npix > 1024 || npix % 32 != 0 ||
      cap < 0 || cluster <= 0 || npix % cluster != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ntx * nty * cluster);
  cfg.blockDim = dim3(npix / cluster);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, rasterize_fwd_kernel, gdata, sorted_gid,
                                             starts, planes, kend, state, cap, ntx, nty,
                                             tile_w, tile_h);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
