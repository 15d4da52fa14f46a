// Fused window-search selection (K1): d2 + run-bound validity + k-min +
// original-id extraction for the grid radius search.
//
// Replaces the Pallas TPU kernel gaussreg_tpu/ops/fused_select.py:
// window_select_idx (_kernel). Same function, per query row p:
//   d2[w]   = (x[w]-qx)^2 + (y[w]-qy)^2 + (z[w]-qz)^2, evaluated as
//             (dx*dx + dy*dy) + dz*dz in round-to-nearest with no FMA
//             contraction, exactly as the plain version and the reference
//   valid   = ls[run] <= off < le[run]  (run = w / wspan, off = w % wspan),
//             compared as integers (the TPU kernel expands the bounds with a
//             bf16 one-hot matmul, which is exact only for bounds <= 256)
//   output  = the `limit` smallest valid d2, ascending, ties to the smaller
//             flat (run-major) position, with widx[position]. Once the valid
//             candidates are exhausted the TPU kernel emits (FLT_MAX,
//             widx[0]); so does this one.
//
// Design: one warp per query row. Each candidate becomes a unique 64-bit
// key (float_bits(d2) << 32) | position (d2 >= 0, so its bits order like
// the float; masked candidates carry FLT_MAX's bits). Shared memory holds
// the d2 bits only (the position is the index: nruns*wspan*4 bytes per
// warp, 9 KB at 9 x 256). The candidate pass is unrolled 4 ways so each
// lane keeps 12 loads in flight, and each lane keeps its four smallest keys
// in registers; the `limit` selection rounds then cost a warp shuffle each,
// with a re-scan of one lane's keys only when that lane has won four times
// (warp_select.cuh). The unique position gives the exact tie order.
//
// Bound on the card: the four (P, W) window planes are read once, so at the
// level-0 self search (P = 61440, W = 2304) the kernel moves ~2.27 GB and
// is bound by memory bandwidth (~0.68 ms at 3.35 TB/s).

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "warp_select.cuh"

namespace {

constexpr uint32_t kMaskedBits = 0x7F7FFFFFu;  // bits of FLT_MAX
constexpr int kMaxSmem = 200 * 1024;

__global__ void window_select_kernel(
    const float* __restrict__ q, int q_stride,
    const int* __restrict__ lsle,
    const float* __restrict__ wx, const float* __restrict__ wy,
    const float* __restrict__ wz, const int* __restrict__ widx,
    float* __restrict__ out_d2, int* __restrict__ out_idx,
    int num_rows, int nruns, int wspan, int limit) {
  extern __shared__ uint32_t smem_bits[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= num_rows) return;  // no block-wide barrier below
  const int w = nruns * wspan;
  uint32_t* bits_s = smem_bits + (size_t)warp * w;  // key = bits << 32 | pos

  const float qx = q[row * q_stride + 0];
  const float qy = q[row * q_stride + 1];
  const float qz = q[row * q_stride + 2];
  const int* bounds = lsle + row * 2 * nruns;
  const size_t base = (size_t)row * w;

  warp_select::LaneTop4 top;
#pragma unroll 4
  for (int pos = lane; pos < w; pos += 32) {
    const int run = pos / wspan;
    const int off = pos - run * wspan;
    const float dx = __fsub_rn(wx[base + pos], qx);
    const float dy = __fsub_rn(wy[base + pos], qy);
    const float dz = __fsub_rn(wz[base + pos], qz);
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                               __fmul_rn(dz, dz));
    const bool valid = off >= bounds[run] && off < bounds[nruns + run];
    const uint32_t bits = valid ? __float_as_uint(d2) : kMaskedBits;
    bits_s[pos] = bits;
    top.insert(((unsigned long long)bits << 32) | (unsigned)pos);
  }
  __syncwarp();

  const auto key_at = [bits_s](int pos) {
    return ((unsigned long long)bits_s[pos] << 32) | (unsigned)pos;
  };
  const int fill_idx = widx[base];
  int j = 0;
  for (; j < limit; ++j) {
    const unsigned long long best = warp_select::next_smallest(top, lane, w, key_at);
    if (best == warp_select::kNone || (uint32_t)(best >> 32) == kMaskedBits) break;
    if (lane == 0) {
      const int pos = (int)(best & 0xffffffffu);
      out_d2[row * limit + j] = __uint_as_float((uint32_t)(best >> 32));
      out_idx[row * limit + j] = widx[base + pos];
    }
  }
  for (int jj = j + lane; jj < limit; jj += 32) {
    out_d2[row * limit + jj] = FLT_MAX;
    out_idx[row * limit + jj] = fill_idx;
  }
}

}  // namespace

extern "C" int gaussreg_window_select(
    const float* q, int q_stride, const int* lsle, const float* wx,
    const float* wy, const float* wz, const int* widx, float* out_d2,
    int* out_idx, int num_rows, int nruns, int wspan, int limit,
    void* stream) {
  const long long w = (long long)nruns * wspan;
  const long long row_bytes = w * 4;
  if (num_rows <= 0 || w <= 0 || limit <= 0 || row_bytes > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  int warps = 8;
  while (warps > 1 && warps * row_bytes > kMaxSmem) --warps;
  const size_t smem = (size_t)warps * row_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      window_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (num_rows + warps - 1) / warps;
  window_select_kernel<<<blocks, warps * 32, smem, (cudaStream_t)stream>>>(
      q, q_stride, lsle, wx, wy, wz, widx, out_d2, out_idx, num_rows, nruns,
      wspan, limit);
  return (int)cudaGetLastError();
}
