// Per-gaussian gradient accumulation (K6): out[row_gid[r]] = the sum of the
// compacted gradient rows of row r's (tile, pair) slots, in slot order.
//
// Replaces the Pallas TPU kernel gaussreg_tpu/gs/rasterizer/accumulate.py:
// segment_accumulate (_accum_kernel), which reduces runs of equal ids as a
// one-hot (512, 128) MXU product per 128-row block after sorting the ids.
// The function is a segment sum. Here the runs come from the binning's sort
// itself: its inverse permutation (`slot_pos`, one int32 per (row, slot),
// built once per differentiated render) gives each pair's sorted position
// p. The pair's tile t is found by a binary search of `starts` in shared
// memory; its compacted row is (offs[t] - starts[t] / 128) * 128 + p when
// its chunk was walked (p / 128 - starts[t] / 128 < offs[t+1] - offs[t]).
// A row's tiles rise with its slot index, so the rows are added in the
// order of their compacted rows, as a stable sort of the ids and a
// sequential scatter-add would add them: the result is repeatable and
// equal to the old sort-based path bit for bit. No sort runs in the
// backward.
//
// Design: a half-warp per gaussian row, one lane per channel. Lane s reads
// slot s of the row's table (16 slots = one 64-byte load) and resolves its
// compacted row; the half-warp then walks the 16 slots in order, a shuffle
// broadcasts each row index, every lane starts its 16 predicated 4-byte
// gathers (each gathered row is one coalesced 64-byte segment) before it
// adds them in slot order. Each block does four rows per half-warp, so
// starts/offs are staged once per 64 rows.
//
// Bound on the card: bytes. The gathered rows (64 B per walked pair), the
// table (4 B per slot), row_gid, starts and offs read once, and the
// (G + 1) x 64 B output written once, at 3.35 TB/s. The gather is
// row-granular (64 B of a 128 B line) and a gaussian's rows are scattered
// over the buffer, so the loads are latency-bound: 16 of them are in flight
// per lane.

#include <cuda_runtime.h>

namespace {

constexpr int kNchan = 16;
constexpr int kThreads = 256;
constexpr int kHalfWarps = kThreads / 16;
constexpr int kRowsPerHalfWarp = 4;
constexpr int kChunk = 128;

__global__ void __launch_bounds__(kThreads)
accumulate_pairs_kernel(const float* __restrict__ grad_rows,
                        const int* __restrict__ slot_pos,
                        const int* __restrict__ row_gid,
                        const int* __restrict__ starts,
                        const int* __restrict__ offs, float* __restrict__ out,
                        int n_rows, int mt, int num_tiles, int cap) {
  extern __shared__ int smem[];
  int* s_starts = smem;
  int* s_offs = smem + num_tiles + 1;
  for (int i = threadIdx.x; i <= num_tiles; i += kThreads) {
    s_starts[i] = starts[i];
    s_offs[i] = offs[i];
  }
  __syncthreads();
  const int limit = min(s_starts[num_tiles], cap);
  const int lane = threadIdx.x & 15;
  const int hw = threadIdx.x >> 4;

  // every lane of the warp runs the same trip counts: the shuffles below
  // take the full mask
  for (int i = 0; i < kRowsPerHalfWarp; ++i) {
    const long long r =
        ((long long)blockIdx.x * kRowsPerHalfWarp + i) * kHalfWarps + hw;
    const bool live = r < n_rows;
    float acc = 0.0f;
    for (int s0 = 0; s0 < mt; s0 += 16) {
      int row = -1;
      const int s = s0 + lane;
      if (live && s < mt) {
        const int p = slot_pos[r * mt + s];
        if (p >= 0 && p < limit) {
          // the tile whose range [starts[t], starts[t+1]) holds p: the last
          // t with starts[t] <= p (starts[0] = 0 <= p < starts[num_tiles])
          int lo = 0, hi = num_tiles;
          while (hi - lo > 1) {
            const int mid = (lo + hi) >> 1;
            if (s_starts[mid] <= p) lo = mid; else hi = mid;
          }
          const int blk0 = s_starts[lo] / kChunk;
          if (p / kChunk - blk0 < s_offs[lo + 1] - s_offs[lo]) {
            row = (s_offs[lo] - blk0) * kChunk + p;
          }
        }
      }
      float v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int rj = __shfl_sync(0xffffffffu, row, j, 16);
        v[j] = rj >= 0 ? __ldg(grad_rows + (size_t)rj * kNchan + lane) : 0.0f;
      }
      // in slot order; an invalid slot adds +0.0, which leaves the sum's
      // bits as they are (it starts at +0.0 and never becomes -0.0)
#pragma unroll
      for (int j = 0; j < 16; ++j) acc += v[j];
    }
    if (live) out[(size_t)row_gid[r] * kNchan + lane] = acc;
  }
}

}  // namespace

// out (num_out x 16 floats) is zeroed here first: rows that no table row
// names (the sentinel, gaussians outside the live set) stay zero.
extern "C" int gaussreg_accumulate_pairs(const float* grad_rows,
                                         const int* slot_pos,
                                         const int* row_gid, const int* starts,
                                         const int* offs, float* out,
                                         int num_out, int n_rows, int mt,
                                         int num_tiles, int cap, void* stream) {
  if (num_out <= 0 || n_rows < 0 || mt < 0 || num_tiles <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)num_out * kNchan * sizeof(float),
                                    (cudaStream_t)stream);
  if (err != cudaSuccess || n_rows == 0 || mt == 0) return (int)err;
  const size_t smem = 2 * (size_t)(num_tiles + 1) * sizeof(int);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        accumulate_pairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int per_block = kHalfWarps * kRowsPerHalfWarp;
  const int blocks = (n_rows + per_block - 1) / per_block;
  accumulate_pairs_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      grad_rows, slot_pos, row_gid, starts, offs, out, n_rows, mt, num_tiles,
      cap);
  return (int)cudaGetLastError();
}
