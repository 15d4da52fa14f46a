// Shared pieces of the tile rasterizer's forward (rasterize_fwd.cu, K4) and
// backward (rasterize_bwd.cu, K5): the constants of the function, a tile's
// clamped pair range, the staging of one chunk's gaussian rows in shared
// memory, the per-pixel exponent, and the layout of the chunk-start state
// the forward saves for the backward.
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace raster {

constexpr int kChunk = 128;  // pairs per chunk: 128-aligned blocks of the pair array
constexpr int kNchan = 16;   // floats per gaussian row
constexpr float kAlphaMin = (float)(1.0 / 255.0);
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr int kStateChan = 5;  // T, r, g, b, depth before a chunk

// The 12 floats of a gaussian row the kernels read:
// q0 = (a0, ax, ay, axx), q1 = (axy, ayy, 0, 0), q2 = (r, g, b, depth).
struct PairRow {
  float4 q0, q1, q2;
};

// Per-pixel quadratic basis at the pixel centre (+0.5).
struct Pixel {
  float x, y, xx, xy, yy;
};

// Pixel p (row-major inside the tile) of `tile`.
__device__ __forceinline__ Pixel pixel_at(int tile, int ntx, int tile_w, int tile_h,
                                          int p) {
  const int tx = tile % ntx, ty = tile / ntx;
  const int px = p % tile_w, py = p / tile_w;
  Pixel q;
  q.x = (float)(px + tx * tile_w) + 0.5f;
  q.y = (float)(py + ty * tile_h) + 0.5f;
  q.xx = __fmul_rn(q.x, q.x);
  q.xy = __fmul_rn(q.x, q.y);
  q.yy = __fmul_rn(q.y, q.y);
  return q;
}

// Index of pixel p of `tile` in one (nty * tile_h, ntx * tile_w) plane.
__device__ __forceinline__ size_t plane_index(int tile, int ntx, int tile_w,
                                              int tile_h, int p) {
  const int tx = tile % ntx, ty = tile / ntx;
  const int px = p % tile_w, py = p / tile_w;
  return (size_t)(ty * tile_h + py) * (ntx * tile_w) + tx * tile_w + px;
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

// The tile's own element range [lo, hi) inside its chunk k.
__device__ __forceinline__ int2 chunk_rows(const Segment& s, int k) {
  const int base = (s.b0 + k) * kChunk;
  return make_int2(max(s.c0, base), min(s.c1, base + kChunk));
}

// Chunk-start state: before walked chunk k >= 1 of tile t the forward
// stores, per pixel, T and the composited r, g, b and depth (chunk 0 starts
// from T = 1 and colour 0 and is not stored). Slot b0(t) + t + k - 1 is
// unique: tile t + 1 starts at or after tile t's last block, so its first
// slot lies past tile t's last one, and every slot is below
// num_blocks + num_tiles. Layout [slot][channel][pixel of the tile].
__device__ __forceinline__ size_t state_offset(const Segment& s, int tile, int k,
                                               int npix) {
  return (size_t)(s.b0 + tile + k - 1) * kStateChan * npix;
}

// Stage the tile's own rows [lo, hi) of one block: one 16-byte copy per
// thread and row part, straight from gdata[sorted_gid[...]], issued with
// cp.async and committed as one batch of the calling thread (an empty batch
// where it has no copies). The caller waits (__pipeline_wait_prior) and
// synchronizes before reading, and synchronizes readers of the previous
// contents before issuing.
__device__ __forceinline__ void stage_rows_async(PairRow* rows,
                                                 const float* __restrict__ gdata,
                                                 const int* __restrict__ sorted_gid,
                                                 int lo, int hi) {
  float4* dst = reinterpret_cast<float4*>(rows);
  for (int i = threadIdx.x; i < (hi - lo) * 3; i += blockDim.x) {
    const int row = i / 3, part = i - row * 3;
    const int gid = sorted_gid[lo + row];
    __pipeline_memcpy_async(
        dst + i, reinterpret_cast<const float4*>(gdata + (size_t)gid * kNchan) + part,
        sizeof(float4));
  }
  __pipeline_commit();
}

}  // namespace raster
