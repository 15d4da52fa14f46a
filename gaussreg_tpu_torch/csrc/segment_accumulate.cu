// Per-gaussian gradient accumulation (K6): out[g] = sum of rows[i] where
// gid[i] == g, an exact f32 sum in a fixed order.
//
// Replaces the Pallas TPU kernel gaussreg_tpu/gs/rasterizer/accumulate.py:
// segment_accumulate (_accum_kernel), which reduces runs of equal ids as a
// one-hot (512, 128) MXU product per 128-row block. The function is a
// segment sum. As there, the ids are sorted (stably) and the runs located
// with searchsorted outside the kernel; the kernel gets the sort's index
// (`order`) and the run bounds per output row.
//
// Design: a half-warp per output row, one lane per channel. It walks the
// row's run [bounds[g], bounds[g+1]) in sorted order, gathers each source row
// through `order` (16 lanes read one 64-byte row: one coalesced segment) and
// adds in f32. The order of addition is the stable sort's, so two runs give
// the same bits and the result equals a sequential scatter-add. Every output
// element is written, empty runs as zero.
//
// Bound on the card: bytes. Each source row is read once (64 B) and each
// output row written once (64 B), plus 4 B of index per source row and of
// bound per output row, at 3.35 TB/s. The gather is row-granular (64 B of a
// 128 B line), and runs are short (a gaussian touches a few tiles), so the
// walk is latency-bound rather than at the memory rate.

#include <cuda_runtime.h>

namespace {

constexpr int kNchan = 16;

__global__ void segment_accumulate_kernel(const float* __restrict__ rows,
                                          const int* __restrict__ order,
                                          const int* __restrict__ bounds,
                                          float* __restrict__ out, int num_out) {
  const long long gt = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long g = gt / kNchan;
  const int c = (int)(gt % kNchan);
  if (g >= num_out) return;
  const int r0 = bounds[g], r1 = bounds[g + 1];
  float acc = 0.0f;
  for (int i = r0; i < r1; ++i) {
    acc += rows[(size_t)order[i] * kNchan + c];
  }
  out[g * kNchan + c] = acc;
}

}  // namespace

extern "C" int gaussreg_segment_accumulate(const float* rows, const int* order,
                                           const int* bounds, float* out,
                                           int num_out, void* stream) {
  if (num_out <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long total = (long long)num_out * kNchan;
  const int blocks = (int)((total + threads - 1) / threads);
  segment_accumulate_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      rows, order, bounds, out, num_out);
  return (int)cudaGetLastError();
}
