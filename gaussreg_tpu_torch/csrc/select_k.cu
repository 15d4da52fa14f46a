// Row-wise k smallest (K3): values ascending and their flat positions.
//
// Replaces the Pallas TPU kernel gaussreg_tpu/ops/select_k.py:
// select_min_k (_select_kernel), which extracts the row minimum k times with
// ties to the smaller position (the order of lax.top_k(-x, k)). Inputs are
// finite; here they are the negated LGR matching scores, so mostly negative.
//
// Design: one warp per row, as in window_select.cu. Each element becomes a
// unique 64-bit key (ordered_bits(x) << 32) | position, where ordered_bits
// maps the float to a uint32 with the same order (flip every bit of a
// negative float, set the sign bit of a non-negative one; -0.0 is first
// folded into +0.0, which the reference treats as equal). The selection
// rounds are those of warp_select.cuh. The value written is the input
// element at the winning position, so it is bit-exact.
//
// Bound on the card: each input element is read once; at the LGR shape
// (R = 32768, W = 128, k = 3) that is 16.8 MB, ~5 us at 3.35 TB/s, so the
// kernel is bound by memory bandwidth and, at this size, by launch latency.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_select.cuh"

namespace {

constexpr int kMaxSmem = 200 * 1024;

__device__ __forceinline__ uint32_t ordered_bits(float v) {
  const uint32_t u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void select_min_k_kernel(const float* __restrict__ x,
                                    float* __restrict__ vals,
                                    int* __restrict__ pos_out, int num_rows,
                                    int w, int k) {
  extern __shared__ unsigned long long smem_keys[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= num_rows) return;  // no block-wide barrier below
  unsigned long long* keys = smem_keys + (size_t)warp * w;
  const float* xr = x + (size_t)row * w;

  warp_select::LaneTop4 top;
  for (int pos = lane; pos < w; pos += 32) {
    const unsigned long long key =
        ((unsigned long long)ordered_bits(xr[pos]) << 32) | (unsigned)pos;
    keys[pos] = key;
    top.insert(key);
  }
  __syncwarp();

  const auto key_at = [keys](int pos) { return keys[pos]; };
  for (int j = 0; j < k; ++j) {
    const unsigned long long best = warp_select::next_smallest(top, lane, w, key_at);
    if (lane == 0) {
      const int pos = (int)(best & 0xffffffffu);
      vals[row * k + j] = xr[pos];
      pos_out[row * k + j] = pos;
    }
  }
}

}  // namespace

extern "C" int gaussreg_select_min_k(const float* x, float* vals, int* pos,
                                     int num_rows, int w, int k,
                                     void* stream) {
  const long long row_bytes = (long long)w * 8;
  if (num_rows <= 0 || w <= 0 || k <= 0 || k > w || row_bytes > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  int warps = 8;
  while (warps > 1 && warps * row_bytes > kMaxSmem) --warps;
  const size_t smem = (size_t)warps * row_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      select_min_k_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (num_rows + warps - 1) / warps;
  select_min_k_kernel<<<blocks, warps * 32, smem, (cudaStream_t)stream>>>(
      x, vals, pos, num_rows, w, k);
  return (int)cudaGetLastError();
}
