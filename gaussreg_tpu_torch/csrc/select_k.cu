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
//
// Second entry, gaussreg_kth_largest_rows_cols: the mutual-top-k thresholds
// of local-to-global registration, gaussreg_tpu/models/matching.py:354-359,
// which call select_min_k twice, on the negated scores and on their
// negated transpose, and keep only the k-th value of each row. It takes the
// (P, W, W) scores as they are and writes, for each patch, the k-th largest
// value of every row and of every column: one read of the scores, no
// negation pass, no transpose copy, one launch.
//
// Design: one block per patch. Its threads stage the W x W tile in shared
// memory with 16-byte cp.async (one read of device memory). Then thread
// t < W walks row t and thread W + t walks column t, each keeping its k
// largest (value, position) pairs sorted in registers; ties go to the
// smaller position, and +0.0 equals -0.0, which is the order of
// select_min_k on the negated scores. The value written is the input
// element at the k-th place, so it is exact. A column thread reads
// consecutive words across its warp; a row thread starts its walk at its
// lane's column, so a warp's 32 reads fall in 32 banks when W is a multiple
// of 32. Limits: W <= 192 (the tile in shared memory, 2W threads) and
// k <= 4 (the register list).
// Bound: P*W*W*4 bytes read and 2*P*W*4 written, 17.0 MB at P = 256,
// W = 128: ~5.1 us at 3.35 TB/s.

#include <cuda_runtime.h>
#include <math.h>
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

constexpr int kFusedMaxW = 192;
constexpr int kFusedMaxK = 4;

// The K largest (value, position) pairs seen, best first.
template <int K>
struct LineTopK {
  float v[K];
  int p[K];

  __device__ __forceinline__ LineTopK() {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      v[i] = -INFINITY;
      p[i] = INT32_MAX;
    }
  }

  __device__ __forceinline__ static bool before(float a, int pa, float b, int pb) {
    return a > b || (a == b && pa < pb);
  }

  __device__ __forceinline__ void insert(float x, int pos) {
    if (!before(x, pos, v[K - 1], p[K - 1])) return;
    v[K - 1] = x;
    p[K - 1] = pos;
#pragma unroll
    for (int i = K - 1; i > 0; --i) {
      if (before(v[i], p[i], v[i - 1], p[i - 1])) {
        const float tv = v[i];
        const int tp = p[i];
        v[i] = v[i - 1];
        p[i] = p[i - 1];
        v[i - 1] = tv;
        p[i - 1] = tp;
      }
    }
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}

template <int K>
__global__ void kth_largest_rows_cols_kernel(const float* __restrict__ scores,
                                             float* __restrict__ row_thr,
                                             float* __restrict__ col_thr, int w) {
  extern __shared__ __align__(16) float tile[];
  const int n = w * w;
  const float* src = scores + (size_t)blockIdx.x * n;
  if ((n & 3) == 0 && ((uintptr_t)src & 15) == 0) {
    for (int i = threadIdx.x * 4; i < n; i += blockDim.x * 4) cp_async16(tile + i, src + i);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) cp_async4(tile + i, src + i);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int t = threadIdx.x;
  LineTopK<K> top;
  if (t < w) {  // row t, from column (lane mod w) on
    const float* row = tile + (size_t)t * w;
    int c = (t & 31) % w;
    for (int i = 0; i < w; ++i) {
      top.insert(row[c], c);
      c = c + 1 == w ? 0 : c + 1;
    }
    row_thr[(size_t)blockIdx.x * w + t] = top.v[K - 1];
  } else if (t < 2 * w) {  // column t - w, rows in order
    const int c = t - w;
    for (int r = 0; r < w; ++r) top.insert(tile[r * w + c], r);
    col_thr[(size_t)blockIdx.x * w + c] = top.v[K - 1];
  }
}

template <int K>
int launch_kth_largest(const float* scores, float* row_thr, float* col_thr, int p, int w,
                       cudaStream_t stream) {
  const int smem = w * w * (int)sizeof(float);
  static int attr_bytes = 0;  // the limit already set (raised only, once per size)
  if (smem > attr_bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        kth_largest_rows_cols_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_bytes = smem;
  }
  const int threads = (2 * w + 31) / 32 * 32;
  kth_largest_rows_cols_kernel<K><<<p, threads, smem, stream>>>(scores, row_thr, col_thr, w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gaussreg_kth_largest_rows_cols(const float* scores, float* row_thr,
                                              float* col_thr, int p, int w, int k,
                                              void* stream) {
  if (p <= 0 || w <= 0 || w > kFusedMaxW || k <= 0 || k > kFusedMaxK || k > w) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 1: return launch_kth_largest<1>(scores, row_thr, col_thr, p, w, s);
    case 2: return launch_kth_largest<2>(scores, row_thr, col_thr, p, w, s);
    case 3: return launch_kth_largest<3>(scores, row_thr, col_thr, p, w, s);
    default: return launch_kth_largest<4>(scores, row_thr, col_thr, p, w, s);
  }
}

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
