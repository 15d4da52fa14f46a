// Row-wise k smallest (K3): values ascending and their flat positions.
//
// Replaces the Pallas TPU kernel gaussreg_tpu/ops/select_k.py:
// select_min_k (_select_kernel), which extracts the row minimum k times with
// ties to the smaller position (the order of lax.top_k(-x, k)). Inputs are
// finite. Every entry compares unique 64-bit keys
// (ordered_bits(x) << 32) | position, where ordered_bits maps the float to a
// uint32 with the same order (flip every bit of a negative float, set the
// sign bit of a non-negative one; -0.0 is first folded into +0.0, which the
// reference treats as equal). The value written is the input element at the
// winning position, so every entry is bit-exact.
//
// Bound on the card: the (R, W) input read once and the (R, k) values and
// positions written: at the brute-force search's (1024, 30 720) blocks
// 125.8 MB, 37.6 us at 3.35 TB/s; at the LGR shape (32 768, 128) 16.8 MB.
//
// Entry gaussreg_select_min_k_filter (k <= 128, any width; the routes
// select_min_k and select_min_k_wide of ops/select_k.py): a threshold
// filter over a row streamed once from device memory, after FAISS's
// WarpSelect (Johnson, Douze and Jegou, "Billion-scale similarity search
// with GPUs", 2017), with the merge done by warp reductions:
// - a row, or a slice of one, belongs to one warp, and nothing of it is
//   staged in shared memory, so there is no width limit. Lane t reads
//   columns t, t + 32, ... (4-byte loads, 4 * kUnroll in flight), or for
//   k <= 4 on 16-byte aligned rows float4s t, t + 32, ... (kVecUnroll in
//   flight): 16-byte loads put four neighbouring columns in one lane, and
//   winners that sit together (a sentinel plateau, points in spatial
//   order) would then empty one lane's queue again and again;
// - each lane keeps the L smallest keys it has seen sorted in registers
//   (its thread queue; L = 4 up to kSmallQueueMaxK, else 8); a key is
//   compared once with the queue's last key and almost every key stops
//   there;
// - the warp then takes its smallest keys in rounds: two redux.sync minima
//   (the keys' high words, then the low words of the lanes holding that
//   high word) give the warp's smallest queue head, and the lane that
//   owned it pops it. A lane that pops its last key having dropped keys is
//   refilled by the whole warp: every lane reads every 32nd of that lane's
//   columns (one load latency, not a walk of the lane's share) and L
//   rounds hand it its next L keys above the last one popped. So the
//   result is exact for any data;
// - narrow rows: one warp per row, four rows per block, k rounds. Wide
//   rows (the entry's `wide`): one block of kBlockWarps = 4 warps per row,
//   in one launch; each warp takes a slice and runs ceil(k / 4) rounds;
//   the largest of the slices' last keys bounds the row's k-th key (the
//   slices' keys so far are 4 * ceil(k / 4) >= k keys), so each warp then
//   stops at its first key above that bound; each key of the slices'
//   sorted lists finds its rank among them by binary searches in shared
//   memory, and ranks under k are written. No scratch buffer, no second
//   launch. ops/select_k.py picks the form by rows, width and k
//   (`route`; tools/select_variants.py sweeps both forms over them).
// The value written is rebuilt from the key's ordered bits (a zero is
// read back from the row, for its sign).
// Cost: per key a make-key, a 64-bit compare and, rarely, a queue insert;
// per row k (narrow) or about 4 * ceil(k / 4) (wide) rounds of two
// reductions.
//
// Entries gaussreg_select_min_k_rounds and gaussreg_select_min_k_rounds_wide
// (k > 128, the routes select_min_k_rounds and select_min_k_rounds_wide):
// the k selection rounds of warp_select.cuh over a row's keys staged in
// shared memory (one warp per row; W * 8 bytes of keys up to kMaxSmem,
// W <= 25 600), and past that width the same per 2048-column chunk
// (stage 1: one warp per (row, chunk)), then over the row's nchunks * k
// chunk winners (stage 2: one warp per row), the JAX package's two-stage
// top_k (ops/neighbors.py:400-408). The winners of the row are among the
// winners of their chunks, and the keys carry the row's flat positions, so
// the order and the ties are those of one pass. A chunk narrower than k
// pads its list with the empty key, which sorts after every real key. The
// chunk winners go to a scratch buffer that the wrapper allocates
// (R * nchunks * k keys). Each round is a 64-bit butterfly and a lane
// whose four registers run dry re-scans its keys: the rounds, not the
// bytes, bound these entries.
//
// Entry gaussreg_kth_largest_rows_cols: the mutual-top-k thresholds
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

__device__ __forceinline__ unsigned long long make_key(float v, unsigned pos) {
  return ((unsigned long long)ordered_bits(v) << 32) | pos;
}

// ---- the filter entry (k <= kFilterMaxK) ----

constexpr unsigned kFull = 0xffffffffu;
constexpr int kFilterMaxK = 128;
constexpr int kSmallQueueMaxK = 48;  // L = 4 up to here, else 8
constexpr int kUnroll = 2;           // 4-byte loads in flight per lane: 4 * kUnroll
constexpr int kVecUnroll = 2;        // 16-byte loads in flight per lane
constexpr int kVecMaxK = 4;          // 16-byte loads up to this k (with L = 4 = kVecMaxK)
constexpr int kBlockWarps = 4;       // a block's warps: four narrow rows or one wide row

// A lane's thread queue: the L smallest keys it was offered, ascending
// (kNone past them), and how many it was offered (counted by the caller):
// more than L means some were dropped, all larger than k[L - 1].
template <int L>
struct LaneQueue {
  unsigned long long k[L];
  int seen;

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int i = 0; i < L; ++i) k[i] = warp_select::kNone;
    seen = 0;
  }

  __device__ __forceinline__ void offer(unsigned long long key) {
    if (key < k[L - 1]) {  // the filter: most keys stop here
      unsigned long long t = key;
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const unsigned long long lo = t < k[i] ? t : k[i];
        t = t < k[i] ? k[i] : t;
        k[i] = lo;
      }
    }
  }

  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int i = 0; i + 1 < L; ++i) k[i] = k[i + 1];
    k[L - 1] = warp_select::kNone;
  }
};

// A lane's loads of one batch: kVecUnroll float4 (kVec: units are float4
// indices) or 4 * kUnroll floats (units are columns), at units u, u + 32,
// ... of a row, below u1.
template <bool kVec>
struct Batch {
  static constexpr int kUnits = kVec ? kVecUnroll : 4 * kUnroll;
  float v[kVec ? 4 * kVecUnroll : 4 * kUnroll];

  __device__ __forceinline__ void load(const float* __restrict__ xr, int u, int u1) {
    if (kVec) {
      const float4* x4 = reinterpret_cast<const float4*>(xr);
#pragma unroll
      for (int i = 0; i < kVecUnroll; ++i) {
        float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
        if (u + 32 * i < u1) t = __ldg(x4 + u + 32 * i);
        v[4 * i] = t.x;
        v[4 * i + 1] = t.y;
        v[4 * i + 2] = t.z;
        v[4 * i + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kUnits; ++i) v[i] = u + 32 * i < u1 ? __ldg(xr + u + 32 * i) : 0.f;
    }
  }

  // Offer the batch's keys to q.
  template <int L>
  __device__ __forceinline__ void offer(int u, int u1, LaneQueue<L>& q) const {
    constexpr int kPer = kVec ? 4 : 1;
#pragma unroll
    for (int i = 0; i < kUnits; ++i) {
      if (u + 32 * i >= u1) continue;
      q.seen += kPer;
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        q.offer(make_key(v[kPer * i + j], (unsigned)((u + 32 * i) * kPer + j)));
    }
  }
};

// Offer this lane's keys of units [u0, u1) of row xr to q (lane t takes
// units u0 + t, u0 + t + 32, ...). kVec: 16-byte loads, units are float4
// indices (xr 16-byte aligned).
template <int L, bool kVec>
__device__ __forceinline__ void scan_lane(const float* __restrict__ xr, int u0, int u1,
                                          int lane, LaneQueue<L>& q) {
  for (int u = u0 + lane; u < u1; u += 32 * Batch<kVec>::kUnits) {
    Batch<kVec> b;
    b.load(xr, u, u1);
    b.template offer<L>(u, u1, q);
  }
}

// Number of keys of the ascending list a[0, n) below key.
__device__ __forceinline__ int count_below(const unsigned long long* a, int n,
                                           unsigned long long key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The input element behind a key: its ordered bits mapped back, but a zero
// read from the row (the key folded -0.0 into +0.0).
__device__ __forceinline__ float key_value(unsigned long long key, const float* xr) {
  const unsigned u = (unsigned)(key >> 32);
  const unsigned bits = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return bits ? __uint_as_float(bits) : xr[(unsigned)key];
}

// The warp's smallest key (kNone when every lane holds kNone): two
// redux.sync minima, over the high words and then over the low words of
// the lanes that hold that high word.
__device__ __forceinline__ unsigned long long warp_min_key(unsigned long long key) {
  const unsigned hi = (unsigned)(key >> 32);
  const unsigned mh = __reduce_min_sync(kFull, hi);
  const unsigned ml = __reduce_min_sync(kFull, hi == mh ? (unsigned)key : 0xffffffffu);
  return ((unsigned long long)mh << 32) | ml;
}

// Lane `src` ran dry having dropped keys: the warp re-reads src's share of
// columns [u0, u1) (columns u0 + src + 32 t), each lane every 32nd of them,
// so one load latency instead of src's whole walk, and hands src its next
// L keys above `floor` (L rounds) and their count. (Only the 4-byte loads
// reach here: with 16-byte loads no lane can run dry.)
template <int L>
__device__ __forceinline__ void refill(LaneQueue<L>& q, const float* __restrict__ xr, int u0,
                                       int u1, int lane, int src, unsigned long long floor) {
  constexpr int kLoads = 4;
  LaneQueue<L> part;
  part.reset();
  for (int u = u0 + src + 32 * lane; u < u1; u += kLoads * 32 * 32) {
    float v[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int ui = u + 32 * 32 * i;
      v[i] = ui < u1 ? __ldg(xr + ui) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int ui = u + 32 * 32 * i;
      if (ui >= u1) continue;
      const unsigned long long key = make_key(v[i], (unsigned)ui);
      if (key > floor) {
        ++part.seen;
        part.offer(key);
      }
    }
  }
  const int seen = __reduce_add_sync(kFull, part.seen);
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const unsigned long long best = warp_min_key(part.k[0]);
    if (best != warp_select::kNone && part.k[0] == best) part.pop();
    if (lane == src) q.k[i] = best;
  }
  if (lane == src) q.seen = seen;
}

// One round: the warp's smallest queue head (kNone when every queue is
// empty), popped by the lane that owned it. A lane that ran dry having
// dropped keys (all above the popped one) is refilled, unless `last`.
template <int L, bool kVec>
__device__ __forceinline__ unsigned long long next_key(LaneQueue<L>& q, const float* xr, int u0,
                                                       int u1, int lane, bool last) {
  const unsigned long long best = warp_min_key(q.k[0]);
  const bool won = best != warp_select::kNone && q.k[0] == best;
  if (won) q.pop();
  // 16-byte loads are taken only for k <= kVecMaxK = L: a lane pops at
  // most k keys, so it runs dry at most in the last round
  if constexpr (!kVec) {
    const unsigned dry =
        __ballot_sync(kFull, won && !last && q.k[0] == warp_select::kNone && q.seen > L);
    if (dry) refill<L>(q, xr, u0, u1, lane, __ffs(dry) - 1, best);
  }
  return best;
}

// A block of kBlockWarps warps: four narrow rows, a warp each, or (kWide)
// one row, a slice per warp.
template <int L, bool kVec, bool kWide>
__global__ void __launch_bounds__(kBlockWarps * 32)
select_filter_kernel(const float* __restrict__ x, float* __restrict__ vals,
                     int* __restrict__ pos_out, int num_rows, int w, int k) {
  constexpr int wpr = kWide ? kBlockWarps : 1;
  constexpr int rows_per_block = kBlockWarps / wpr;
  __shared__ unsigned long long lists[kBlockWarps][kFilterMaxK];
  __shared__ unsigned long long bounds[kBlockWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int units = kVec ? w >> 2 : w;  // of the row
  unsigned long long* list = lists[warp];
  const int part = warp % wpr;
  const long long row = (long long)blockIdx.x * rows_per_block + warp / wpr;
  const bool active = row < num_rows;  // uniform over the warp
  const float* xr = x + (size_t)row * w;
  // this warp's slice [u0, u1) of the row
  const int u0 = units / wpr * part + min(part, units % wpr);
  const int u1 = u0 + units / wpr + (part < units % wpr);
  LaneQueue<L> q;
  q.reset();
  if (active) scan_lane<L, kVec>(xr, u0, u1, lane, q);
  // A slice's first m = ceil(k / wpr) keys, over the row's slices, are
  // wpr * m >= k keys: the largest of the slices' m-th keys bounds the
  // row's k-th, and a slice stops at its first key above that bound.
  const int m = (k + wpr - 1) / wpr;
  int j = 0;
  if (active) {
    for (; j < m; ++j) {
      const unsigned long long best = next_key<L, kVec>(q, xr, u0, u1, lane, j + 1 == k);
      if (lane == 0) list[j] = best;
    }
  }
  if (!kWide) {
    __syncwarp();
    if (active) {
      for (int i = lane; i < k; i += 32) {
        const unsigned long long key = list[i];
        vals[row * k + i] = key_value(key, xr);
        pos_out[row * k + i] = (int)(unsigned)key;
      }
    }
    return;
  }
  if (lane == 0) bounds[warp] = active ? list[m - 1] : 0ull;
  __syncthreads();
  if (active) {
    unsigned long long bound = 0;
    for (int o = warp - part; o < warp - part + wpr; ++o) bound = max(bound, bounds[o]);
    for (; j < k; ++j) {
      const unsigned long long best = next_key<L, kVec>(q, xr, u0, u1, lane, j + 1 == k);
      if (best > bound) break;  // uniform over the warp
      if (lane == 0) list[j] = best;
    }
    for (int i = j + lane; i < k; i += 32) list[i] = warp_select::kNone;
  }
  // Merge the slices' lists: a key's rank is its place in its own list
  // plus the keys below it in the row's other lists (keys are unique).
  __syncthreads();
  const int per_row = wpr * k;
  for (int e = threadIdx.x; e < rows_per_block * per_row; e += blockDim.x) {
    const int rb = e / per_row, own = (e % per_row) / k, i = e % k;
    const long long r = (long long)blockIdx.x * rows_per_block + rb;
    const unsigned long long key = lists[rb * wpr + own][i];
    if (r >= num_rows || key == warp_select::kNone) continue;
    int rank = i;
    for (int o = 0; o < wpr; ++o)
      if (o != own) rank += count_below(lists[rb * wpr + o], k, key);
    if (rank < k) {
      vals[r * k + rank] = key_value(key, x + (size_t)r * w);
      pos_out[r * k + rank] = (int)(unsigned)key;
    }
  }
}

template <int L, bool kVec>
int launch_filter(const float* x, float* vals, int* pos, int num_rows, int w, int k, bool wide,
                  cudaStream_t stream) {
  const int rows_per_block = wide ? 1 : kBlockWarps;
  const unsigned blocks = (unsigned)((num_rows + rows_per_block - 1) / rows_per_block);
  if (wide)
    select_filter_kernel<L, kVec, true><<<blocks, kBlockWarps * 32, 0, stream>>>(
        x, vals, pos, num_rows, w, k);
  else
    select_filter_kernel<L, kVec, false><<<blocks, kBlockWarps * 32, 0, stream>>>(
        x, vals, pos, num_rows, w, k);
  return (int)cudaGetLastError();
}

// ---- the rounds entries (k > kFilterMaxK) ----

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

constexpr int kWideChunk = 2048;

// Stage 1 of the wide mode: the k smallest keys of each kWideChunk-column
// chunk of each row, kNone past the chunk's width.
__global__ void chunk_min_k_kernel(const float* __restrict__ x,
                                   unsigned long long* __restrict__ cand,
                                   int num_rows, int w, int nchunks, int k) {
  extern __shared__ unsigned long long smem_keys[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (item >= (long long)num_rows * nchunks) return;  // no block-wide barrier below
  const long long row = item / nchunks;
  const int c0 = (int)(item % nchunks) * kWideChunk;
  const int cw = min(kWideChunk, w - c0);
  unsigned long long* keys = smem_keys + (size_t)warp * kWideChunk;
  const float* xr = x + (size_t)row * w + c0;

  warp_select::LaneTop4 top;
  for (int i = lane; i < cw; i += 32) {
    const unsigned long long key =
        ((unsigned long long)ordered_bits(xr[i]) << 32) | (unsigned)(c0 + i);
    keys[i] = key;
    top.insert(key);
  }
  __syncwarp();

  const auto key_at = [keys](int i) { return keys[i]; };
  unsigned long long* out = cand + (size_t)item * k;
  for (int j = 0; j < k; ++j) {  // j < cw is the same on every lane
    const unsigned long long best =
        j < cw ? warp_select::next_smallest(top, lane, cw, key_at) : warp_select::kNone;
    if (lane == 0) out[j] = best;
  }
}

// Stage 2: the k smallest of a row's ncand chunk winners; the values are
// read back from x at the winning positions.
__global__ void merge_min_k_kernel(const float* __restrict__ x,
                                   const unsigned long long* __restrict__ cand,
                                   float* __restrict__ vals, int* __restrict__ pos_out,
                                   int num_rows, int w, int ncand, int k) {
  extern __shared__ unsigned long long smem_keys[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= num_rows) return;
  unsigned long long* keys = smem_keys + (size_t)warp * ncand;
  const unsigned long long* cr = cand + (size_t)row * ncand;

  warp_select::LaneTop4 top;
  for (int i = lane; i < ncand; i += 32) {
    const unsigned long long key = cr[i];
    keys[i] = key;
    top.insert(key);
  }
  __syncwarp();

  const auto key_at = [keys](int i) { return keys[i]; };
  for (int j = 0; j < k; ++j) {
    const unsigned long long best = warp_select::next_smallest(top, lane, ncand, key_at);
    if (lane == 0) {
      const int pos = (int)(best & 0xffffffffu);
      vals[row * k + j] = x[(size_t)row * w + pos];
      pos_out[row * k + j] = pos;
    }
  }
}

// Warps per block for per-warp shared memory of `bytes` (at most 8).
int warps_for(long long bytes) {
  int warps = 8;
  while (warps > 1 && warps * bytes > kMaxSmem) --warps;
  return warps;
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

extern "C" int gaussreg_select_min_k_rounds(const float* x, float* vals, int* pos,
                                            int num_rows, int w, int k, void* stream) {
  const long long row_bytes = (long long)w * 8;
  if (num_rows <= 0 || w <= 0 || k <= 0 || k > w || row_bytes > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  const int warps = warps_for(row_bytes);
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

// The wide mode: `cand` is scratch of num_rows * ceil(w / kWideChunk) * k
// keys. Refuses widths the first entry takes, and k whose chunk winners
// do not fit in shared memory.
extern "C" int gaussreg_select_min_k_rounds_wide(const float* x, float* vals, int* pos,
                                                 unsigned long long* cand, int num_rows,
                                                 int w, int k, void* stream) {
  const int nchunks = (w + kWideChunk - 1) / kWideChunk;
  const long long cand_bytes = (long long)nchunks * k * 8;
  if (num_rows <= 0 || (long long)w * 8 <= kMaxSmem || k <= 0 || k > w ||
      cand_bytes > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int warps1 = warps_for((long long)kWideChunk * 8);
  const size_t smem1 = (size_t)warps1 * kWideChunk * 8;
  cudaError_t err = cudaFuncSetAttribute(
      chunk_min_k_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)num_rows * nchunks;
  chunk_min_k_kernel<<<(unsigned)((items + warps1 - 1) / warps1), warps1 * 32, smem1, s>>>(
      x, cand, num_rows, w, nchunks, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int ncand = nchunks * k;
  const int warps2 = warps_for(cand_bytes);
  const size_t smem2 = (size_t)warps2 * cand_bytes;
  err = cudaFuncSetAttribute(merge_min_k_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return (int)err;
  merge_min_k_kernel<<<(num_rows + warps2 - 1) / warps2, warps2 * 32, smem2, s>>>(
      x, cand, vals, pos, num_rows, w, ncand, k);
  return (int)cudaGetLastError();
}

// The filter entry: k <= 128, any width; `wide` nonzero takes a block of
// kBlockWarps warps per row, else one warp per row.
//
// 16-byte loads put four neighbouring columns in one lane. Winners that
// sit together (a sentinel plateau, points in spatial order) then empty a
// lane's queue and force refills, so the loads are 4 bytes (neighbouring
// columns in neighbouring lanes) unless no lane can run dry: k <= L.
extern "C" int gaussreg_select_min_k_filter(const float* x, float* vals, int* pos,
                                            int num_rows, int w, int k, int wide,
                                            void* stream) {
  if (num_rows <= 0 || w <= 0 || k <= 0 || k > w || k > kFilterMaxK) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= kVecMaxK && (w & 3) == 0 && ((uintptr_t)x & 15) == 0)
    return launch_filter<4, true>(x, vals, pos, num_rows, w, k, wide != 0, s);
  if (k <= kSmallQueueMaxK) return launch_filter<4, false>(x, vals, pos, num_rows, w, k, wide != 0, s);
  return launch_filter<8, false>(x, vals, pos, num_rows, w, k, wide != 0, s);
}
