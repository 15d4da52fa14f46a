// Fused window-search selection (K1): d2 + run-bound validity + k-min +
// original-id extraction for the grid radius search.
//
// Replaces the Pallas TPU kernel gaussreg_tpu/ops/fused_select.py:
// window_select_idx (_kernel). Same function, per query row p, over the
// candidates (run r < nruns, offset o < wspan) at the run-major position
// r * wspan + o:
//   d2      = (x-qx)^2 + (y-qy)^2 + (z-qz)^2, evaluated as
//             (dx*dx + dy*dy) + dz*dz in round-to-nearest with no FMA
//             contraction, exactly as the plain version and the reference
//   valid   = ls[r] <= o < le[r], compared as integers (the TPU kernel
//             expands the bounds with a bf16 one-hot matmul, which is exact
//             only for bounds <= 256)
//   output  = the `limit` smallest valid d2, ascending, ties to the smaller
//             position, with the original id at that position. Once the
//             valid candidates are exhausted the TPU kernel emits (FLT_MAX,
//             id at position 0); so does this one (also for a valid d2 of
//             FLT_MAX, which the plain version's fill takes alike).
//
// One kernel reads every candidate in place: candidate (p, r, o) lies at
// row b * r_tot + wrow[p, r] of the (B, r_tot, cw) x/y/z planes and id
// plane, plus o, with b = p / rows_per_batch.
// - The grid search (ops/fused_select.py window_select_runs) passes its
//   sorted planes and the padded order plane of ops/neighbors.py: the
//   window of a run starts at the plane row that holds its first entry and
//   spans wspan / cw rows. wrow <= nrow and r_tot = nrow + window_rows
//   (neighbors.py _grid_runs), so a window never runs past the padded
//   planes, and valid offsets lie below le <= wspan. The kernel traps on a
//   window outside the planes (wrow < 0 or wrow + wspan / cw > r_tot), so
//   a bad wrow fails loudly rather than reading out of bounds.
// - The gathered (P, nruns * wspan) planes (window_select_idx, the JAX
//   twin's signature) are the case B = 1, cw = wspan, r_tot = P * nruns,
//   wrow[p, r] = p * nruns + r.
// Positions are run-major (r * wspan + o), as those of the gathered
// planes, so both give the same tie order and the same output.
//
// Design: one warp per row, four rows per block, no shared memory. Only the
// valid candidates are read: the runs' valid spans, laid end to end, are
// the row's units, and lane t takes units t, t + 32, ... (a cursor steps
// it from run to run; its loads of x, y and z, kUnits units at a time, are
// in flight together). d2 and validity are computed in registers, and the
// key (bits(d2) << 32) | position (d2 >= 0, so its bits order like the
// float) goes to the threshold filter of threshold_filter.cuh, shared with
// K3: a queue of L keys per lane (L by limit, as K3 chooses it), rounds of
// two redux.sync minima, and a lane that runs dry having dropped keys
// refilled by the whole warp, which re-reads that lane's candidates (from
// L1/L2) and recomputes their d2. The unique position gives the exact tie
// order. No staged row, so residency does not depend on W and no width is
// refused.
//
// Bound on the card: in place, the queries, run bounds and window rows,
// the sorted planes once per batch (about 1 MB at level 0: they stay in
// the 50 MB L2) and the (P, limit) outputs; 8 f32 operations per valid
// candidate. The candidates' reads come from L2, 16 bytes each.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "threshold_filter.cuh"

namespace {

using namespace threshold_filter;

constexpr unsigned long long kStop = 0x7F7FFFFFull << 32;  // FLT_MAX's bits: no more valid
constexpr int kBlockWarps = 4;

// The keys of one query row's window candidates (see the header comment).
struct WindowSource {
  static constexpr int kUnits = 4;  // units a lane loads at once: 12 loads in flight
  static constexpr int kPer = 1;
  struct Value {
    float x, y, z;
    unsigned pos;
  };
  // A lane's place in the run spans: units [end - len, end) of run `run`
  // lie at plane offsets addr + u and positions pos + u.
  struct Cursor {
    int run = -1, end = 0, pos = 0;
    long long addr = 0;
  };

  const float* __restrict__ x;
  const float* __restrict__ y;
  const float* __restrict__ z;
  const int* __restrict__ ids;
  const int* __restrict__ bounds;  // the row's ls[nruns] | le[nruns]
  const int* __restrict__ wrow;    // the row's first window rows
  long long base;                  // b * r_tot * cw: the row's batch
  int cw, nruns, wspan;            // cw: the planes' row width
  int last_row;                    // r_tot - wspan / cw: the last window start
  float qx, qy, qz;

  __device__ __forceinline__ long long run_base(int r) const {
    return base + (long long)__ldg(wrow + r) * cw;
  }
  // run r's valid offsets [lo, lo + len), as the plain version's compares give them
  __device__ __forceinline__ int lo(int r) const { return max(__ldg(bounds + r), 0); }
  __device__ __forceinline__ int len(int r, int l) const {
    return max(min(__ldg(bounds + nruns + r), wspan) - l, 0);
  }

  // The row's valid candidates (uniform over the warp). Traps on a
  // window outside the planes.
  __device__ __forceinline__ int units(int lane) const {
    int n = 0;
    for (int r = lane; r < nruns; r += 32) {
      const int w = __ldg(wrow + r);
      if (w < 0 || w > last_row) __trap();
      n += len(r, lo(r));
    }
    return __reduce_add_sync(kFull, n);
  }

  __device__ __forceinline__ Value load(Cursor& c, int u0, int d) const {
    const int u = u0 + d;
    while (u >= c.end) {
      ++c.run;
      const int l = lo(c.run);
      c.addr = run_base(c.run) + l - c.end;
      c.pos = c.run * wspan + l - c.end;
      c.end += len(c.run, l);
    }
    const long long a = c.addr + u;
    return {__ldg(x + a), __ldg(y + a), __ldg(z + a), (unsigned)(c.pos + u)};
  }

  __device__ __forceinline__ unsigned long long key(const Value& v, int, int) const {
    const float dx = __fsub_rn(v.x, qx);
    const float dy = __fsub_rn(v.y, qy);
    const float dz = __fsub_rn(v.z, qz);
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                               __fmul_rn(dz, dz));
    return ((unsigned long long)__float_as_uint(d2) << 32) | v.pos;
  }

  // The original id at a run-major position.
  __device__ __forceinline__ int id_at(unsigned pos) const {
    const int r = (int)(pos / (unsigned)wspan);
    return __ldg(ids + run_base(r) + (pos - (unsigned)r * wspan));
  }
};

template <int L>
__global__ void __launch_bounds__(kBlockWarps * 32)
window_select_kernel(const float* __restrict__ q, int q_stride, const int* __restrict__ lsle,
                     const int* __restrict__ wrow, const float* __restrict__ x,
                     const float* __restrict__ y, const float* __restrict__ z,
                     const int* __restrict__ ids, float* __restrict__ out_d2,
                     int* __restrict__ out_idx, int num_rows, int rows_per_batch, int r_tot,
                     int cw, int nruns, int wspan, int limit) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kBlockWarps + (threadIdx.x >> 5);
  if (row >= num_rows) return;  // uniform over the warp; no block barrier below
  const float* qr = q + row * q_stride;
  const WindowSource src{x, y, z, ids, lsle + row * 2 * nruns, wrow + row * nruns,
                         (row / rows_per_batch) * r_tot * (long long)cw, cw, nruns, wspan,
                         r_tot - wspan / cw, __ldg(qr), __ldg(qr + 1), __ldg(qr + 2)};
  const int units = src.units(lane);
  LaneQueue<L> queue;
  queue.reset();
  scan_lane<L>(src, 0, units, lane, queue);
  float* d2r = out_d2 + row * limit;
  int* idxr = out_idx + row * limit;
  const int taken = take_smallest<L>(queue, src, units, lane, limit, kStop,
                                     [&](int i, unsigned long long key) {
                                       d2r[i] = __uint_as_float((uint32_t)(key >> 32));
                                       idxr[i] = src.id_at((unsigned)key);
                                     });
  if (taken < limit) {
    const int fill = src.id_at(0);
    for (int i = taken + lane; i < limit; i += 32) {
      d2r[i] = FLT_MAX;
      idxr[i] = fill;
    }
  }
}

template <int L>
int launch(const float* q, int q_stride, const int* lsle, const int* wrow, const float* x,
           const float* y, const float* z, const int* ids, float* out_d2, int* out_idx,
           int num_rows, int rows_per_batch, int r_tot, int cw, int nruns, int wspan, int limit,
           cudaStream_t stream) {
  const unsigned blocks = (unsigned)((num_rows + kBlockWarps - 1) / kBlockWarps);
  window_select_kernel<L><<<blocks, kBlockWarps * 32, 0, stream>>>(
      q, q_stride, lsle, wrow, x, y, z, ids, out_d2, out_idx, num_rows, rows_per_batch, r_tot, cw,
      nruns, wspan, limit);
  return (int)cudaGetLastError();
}

}  // namespace

// The entry (see the header comment): wrow (num_rows, nruns), x/y/z/ids
// the (B, r_tot, cw) planes, num_rows = B * rows_per_batch, wspan a
// multiple of cw. Lane queues as K3 takes them: L = 4 up to limit kSmallQueueMaxK, 8 up to kMidQueueMaxK, then
// kLargeQueue.
extern "C" int gaussreg_window_select(const float* q, int q_stride, const int* lsle,
                                      const int* wrow, const float* x, const float* y,
                                      const float* z, const int* ids, float* out_d2,
                                      int* out_idx, int num_rows, int rows_per_batch, int r_tot,
                                      int cw, int nruns, int wspan, int limit, void* stream) {
  if (!wrow || num_rows <= 0 || nruns <= 0 || wspan <= 0 || limit <= 0 || q_stride < 3 ||
      (long long)nruns * wspan > 0x7fffffffll || rows_per_batch <= 0 ||
      num_rows % rows_per_batch != 0 || r_tot <= 0 || cw <= 0 || wspan % cw != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (limit <= kSmallQueueMaxK)
    return launch<4>(q, q_stride, lsle, wrow, x, y, z, ids, out_d2, out_idx, num_rows,
                     rows_per_batch, r_tot, cw, nruns, wspan, limit, s);
  if (limit <= kMidQueueMaxK)
    return launch<8>(q, q_stride, lsle, wrow, x, y, z, ids, out_d2, out_idx, num_rows,
                     rows_per_batch, r_tot, cw, nruns, wspan, limit, s);
  return launch<kLargeQueue>(q, q_stride, lsle, wrow, x, y, z, ids, out_d2, out_idx, num_rows,
                             rows_per_batch, r_tot, cw, nruns, wspan, limit, s);
}
