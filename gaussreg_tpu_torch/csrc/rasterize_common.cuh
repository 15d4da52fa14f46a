// Shared pieces of the tile rasterizer's forward (rasterize_fwd.cu, K4) and
// backward (rasterize_bwd.cu, K5): the constants of the function, a tile's
// clamped pair range, the staging of one chunk's gaussian rows in shared
// memory, and the per-pixel exponent.
#pragma once

#include <cuda_runtime.h>

namespace raster {

constexpr int kChunk = 128;  // pairs per chunk: 128-aligned blocks of the pair array
constexpr int kNchan = 16;   // floats per gaussian row
constexpr float kAlphaMin = (float)(1.0 / 255.0);
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

// The 12 floats of a gaussian row the kernels read:
// q0 = (a0, ax, ay, axx), q1 = (axy, ayy, 0, 0), q2 = (r, g, b, depth).
struct PairRow {
  float4 q0, q1, q2;
};

// Per-pixel quadratic basis at the pixel centre (+0.5).
struct Pixel {
  float x, y, xx, xy, yy;
};

__device__ __forceinline__ Pixel pixel_of_thread(int tile, int ntx, int tile_w,
                                                 int tile_h) {
  const int tx = tile % ntx, ty = tile / ntx;
  const int px = threadIdx.x % tile_w, py = threadIdx.x / tile_w;
  Pixel p;
  p.x = (float)(px + tx * tile_w) + 0.5f;
  p.y = (float)(py + ty * tile_h) + 0.5f;
  p.xx = __fmul_rn(p.x, p.x);
  p.xy = __fmul_rn(p.x, p.y);
  p.yy = __fmul_rn(p.y, p.y);
  return p;
}

// power = a0 + ax x + ay y + axx x^2 + axy xy + ayy y^2, summed in this order
// with every product and sum rounded to f32. In global pixel coordinates the
// terms cancel heavily (axx x^2 reaches 1e4 and more while the sum is of
// order 1), so a fused multiply-add, which skips the product's rounding,
// moves the result by far more than an ulp of the sum: the intrinsics keep
// nvcc from contracting, and the plain PyTorch version rounds alike.
__device__ __forceinline__ float pair_power(const PairRow& r, const Pixel& p) {
  float s = __fadd_rn(r.q0.x, __fmul_rn(r.q0.y, p.x));
  s = __fadd_rn(s, __fmul_rn(r.q0.z, p.y));
  s = __fadd_rn(s, __fmul_rn(r.q0.w, p.xx));
  s = __fadd_rn(s, __fmul_rn(r.q1.x, p.xy));
  s = __fadd_rn(s, __fmul_rn(r.q1.y, p.yy));
  return s;
}

// Tile t owns elements [c0, c1) of the sorted pair array (clamped to its
// capacity); its chunks are the 128-aligned blocks b0, b0 + 1, ... that
// cover the range.
struct Segment {
  int c0, c1, b0, num_chunks;
};

__device__ __forceinline__ Segment tile_segment(const int* __restrict__ starts,
                                                int tile, int cap) {
  Segment s;
  s.c0 = min(starts[tile], cap);
  s.c1 = min(starts[tile + 1], cap);
  s.b0 = s.c0 / kChunk;
  s.num_chunks = s.c1 > s.c0 ? (s.c1 - 1) / kChunk - s.b0 + 1 : 0;
  return s;
}

// Stage the tile's own rows [lo, hi) of one block: one 16-byte load per
// thread and row part, straight from gdata[sorted_gid[...]]. The caller
// synchronizes before (readers of the previous chunk) and after.
__device__ __forceinline__ void stage_rows(PairRow* rows,
                                           const float* __restrict__ gdata,
                                           const int* __restrict__ sorted_gid,
                                           int lo, int hi) {
  float4* dst = reinterpret_cast<float4*>(rows);
  for (int i = threadIdx.x; i < (hi - lo) * 3; i += blockDim.x) {
    const int row = i / 3, part = i - row * 3;
    const int gid = sorted_gid[lo + row];
    dst[i] = reinterpret_cast<const float4*>(gdata + (size_t)gid * kNchan)[part];
  }
}

}  // namespace raster
