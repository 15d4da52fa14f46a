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
//
// Second entry, gaussreg_segment_accumulate: the TPU kernel's own
// signature, out[g] = the sum of rows[i] with gid[i] == g for g in
// [0, num_out), added in row order (a sequential scatter-add's bits); ids
// outside [0, num_out) are dropped, an empty run writes +0.0. The JAX
// function sorts the ids outside its kernel (lax.sort, is_stable); a general
// sort is the wrong tool here: the ids lie in a known range and the runs are
// short. So the entry is a counting sort over [0, num_out] with the run
// order restored afterwards, four kernels and one memset on the caller's
// stream, all scratch from the wrapper (no library sort, no search):
//   1. count: one atomicAdd per live row into count[gid];
//   2. scan: an exclusive scan of the num_out + 1 counts gives each run
//      [start[g], start[g+1]); one pass with decoupled look-back (a tile
//      of 2048 counts per block, tiles taken in launch order from an atomic
//      counter, each publishing its total and then its inclusive prefix in
//      one 64-bit status word; warp 0 sums 32 predecessors per step);
//   3. place: each live row takes a slot of its run by an atomic
//      decrement of its count and writes its row index there, so a run's
//      indices land in any order;
//   4. order and sum: a half-warp takes 8 consecutive outputs, a lane per
//      channel; one coalesced load gives their runs, which lie back to back
//      in the order list. When they are all short and hold at most 32 rows
//      together (the common case: most outputs of a fine step's rows are
//      empty or hold a few), their row indices are loaded at once (two per
//      lane), tagged with their output and sorted by one bitonic shuffle
//      network on (output, row), so each run comes out in row order; the
//      lanes then load up to 16 rows at a time and walk them in that order,
//      writing an output's sum where its run ends. Otherwise each run of at
//      most 32 rows is sorted and summed alone, the next run's indices
//      loaded meanwhile. A run past 32 rows goes to the whole block after
//      the short ones: up to 2048 rows, a bitonic sort in shared memory;
//      past that, the block walks gid in row order and compacts the run's
//      rows tile by tile, so a run of any length (every row on one id) is
//      right at O(R) reads. A long run's rows are staged 256 at a time in
//      two shared-memory buffers: warps 1-7 load the next 256 while one
//      half-warp adds the current ones in order. The registers
//      are capped for four resident blocks per SM (64 a thread), which
//      measured faster than the compiler's 118 (tools/accumulate_variants.py).
// Since each run is sorted by row index before it is added, the result does
// not depend on the order the atomics took: repeatable, and equal bit for
// bit to a sequential scatter-add in row order.
// Bound: bytes. The rows (64 B each) and ids read once, the num_out x 64 B
// output written once. The counts, starts and order list (~4 B per id and
// per row, each written and read once or twice) add about a quarter; the
// row gather is row-granular, as in the first entry. What holds it: the
// sum's dependent loads (starts, then indices, then rows) with few rows per
// half-warp, and four dependent launches, each a few microseconds.

#include <climits>
#include <cstdint>

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

// ---- the generic entry ----

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = kThreads / 32;
constexpr int kScanItems = 8;
constexpr int kScanTile = kThreads * kScanItems;  // counts per scan tile (the wrapper's SCAN_TILE)
constexpr int kRegRun = 32;                       // runs sorted in a half-warp's registers
constexpr int kSortCap = 2048;                    // runs sorted in a block's shared memory
constexpr int kStage = 256;                       // rows of a long run staged per step
constexpr unsigned long long kAggregate = 1ull << 32;  // status: the tile's own total
constexpr unsigned long long kPrefix = 2ull << 32;     // status: the inclusive prefix

// Exclusive scan of v over the block (kThreads threads, all of which call
// it); total: the block's sum. s_warp: kWarps ints of shared memory.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int t = s_warp[w];
    before += w < warp ? t : 0;
    sum += t;
  }
  __syncthreads();  // s_warp is free for the next scan
  total = sum;
  return before + x - v;
}

__global__ void __launch_bounds__(kThreads)
count_ids_kernel(const int* __restrict__ gid, int* __restrict__ count, int num_out, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int g = __ldg(gid + i);
  if ((unsigned)g < (unsigned)num_out) atomicAdd(count + g, 1);
}

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// start[i] = count[0] + ... + count[i - 1] for i < m, one tile per block.
__global__ void __launch_bounds__(kThreads)
scan_counts_kernel(const int* __restrict__ count, int* __restrict__ start,
                   unsigned long long* status, int* tile_counter, int m) {
  __shared__ int s_warp[kWarps];
  __shared__ int s_tile, s_prefix;
  if (threadIdx.x == 0) s_tile = atomicAdd(tile_counter, 1);
  __syncthreads();
  const int tile = s_tile;  // every tile before it is held by a running block
  const long long base = (long long)tile * kScanTile + threadIdx.x * kScanItems;
  int v[kScanItems], sum = 0;
#pragma unroll
  for (int q = 0; q < kScanItems; ++q) {
    v[q] = base + q < m ? count[base + q] : 0;
    sum += v[q];
  }
  int total;
  const int excl = block_exclusive_scan(sum, s_warp, total);
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int prefix = 0;
    if (tile == 0) {
      if (lane == 0) store_status(status, kPrefix | (unsigned)total);
    } else {
      if (lane == 0) store_status(status + tile, kAggregate | (unsigned)total);
      for (int end = tile - 1;; end -= 32) {  // lane l reads tile end - l
        const int t = end - lane;
        unsigned long long st = t >= 0 ? load_status(status + t) : kPrefix;
        while (__any_sync(kFull, (st >> 32) == 0)) {  // a predecessor has not published
          if ((st >> 32) == 0) st = load_status(status + t);
        }
        const unsigned prefixed = __ballot_sync(kFull, (st >> 32) == 2);
        const int last = prefixed ? __ffs(prefixed) - 1 : 31;  // the nearest prefix
        int val = lane <= last ? (int)(unsigned)st : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) val += __shfl_xor_sync(kFull, val, o);
        prefix += val;
        if (prefixed) break;
      }
      if (lane == 0) store_status(status + tile, kPrefix | (unsigned)(prefix + total));
    }
    if (lane == 0) s_prefix = prefix;
  }
  __syncthreads();
  int run = s_prefix + excl;
#pragma unroll
  for (int q = 0; q < kScanItems; ++q) {
    if (base + q < m) start[base + q] = run;
    run += v[q];
  }
}

// Each live row writes its index into a slot of its run; count[g] counts
// down to 0 (the next call's memset zeroes it again).
__global__ void __launch_bounds__(kThreads)
place_rows_kernel(const int* __restrict__ gid, const int* __restrict__ start,
                  int* __restrict__ count, int* __restrict__ order, int num_out, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int g = __ldg(gid + i);
  if ((unsigned)g < (unsigned)num_out) order[start[g] + atomicSub(count + g, 1) - 1] = i;
}

__device__ __forceinline__ int keep(int x, int other, bool keep_min) {
  return keep_min ? min(x, other) : max(x, other);
}

// Ascending bitonic sort of a half-warp's 32 keys: a at position lane, b at
// position 16 + lane. The half-warp's 16 lanes (hmask) call it together.
__device__ __forceinline__ void sort32_half_warp(int& a, int& b, int lane, unsigned hmask) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j == 16) {  // partners: the two keys of one lane
        const int lo = min(a, b);
        b = max(a, b);
        a = lo;
      } else {
        const int pa = __shfl_xor_sync(hmask, a, j, 16);
        const int pb = __shfl_xor_sync(hmask, b, j, 16);
        const bool lower = (lane & j) == 0;
        a = keep(a, pa, lower == ((lane & k) == 0));
        b = keep(b, pb, lower == (((lane + 16) & k) == 0));
      }
    }
  }
}

// acc + rows[r_0] + ... + rows[r_{cnt-1}] (this lane's channel), where r_j
// is `key` on lane j of the half-warp; cnt <= 16. The half-warp calls it.
__device__ __forceinline__ float add_keyed_rows(const float* __restrict__ rows, int key,
                                                int cnt, int lane, unsigned hmask, float acc) {
  float v[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int r = __shfl_sync(hmask, key, j, 16);
    v[j] = j < cnt ? __ldg(rows + (size_t)r * kNchan + lane) : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (j < cnt) acc += v[j];
  return acc;
}

// A long run's sum over the block: rows[keys[0]], ..., rows[keys[cnt-1]]
// added in order by threads 0-15 (one channel each) onto acc, kStage rows
// at a time from shared memory, while warps 1-7 stage the next kStage rows
// in the other buffer. Every thread calls it.
constexpr int kLoaders = kThreads - 32;
constexpr int kQuads = kNchan / 4;  // 16-byte pieces of a row
constexpr int kLoadSteps = (kStage * kQuads + kLoaders - 1) / kLoaders;

// Rows keys[c0], ..., keys[c0 + m - 1] into buf, by warps 1-7: all keys
// first, then all 16-byte loads, then the stores (a store to shared memory
// could alias a later key, so interleaved they would run one at a time).
__device__ __forceinline__ void stage_rows(const float4* __restrict__ rows4, const int* keys,
                                           int c0, int m, float4* buf) {
  const int t = threadIdx.x - 32;
  int key[kLoadSteps];
#pragma unroll
  for (int it = 0; it < kLoadSteps; ++it) {
    const int e = it * kLoaders + t;
    key[it] = e < m * kQuads ? keys[c0 + e / kQuads] : -1;
  }
  float4 v[kLoadSteps];
#pragma unroll
  for (int it = 0; it < kLoadSteps; ++it)
    if (key[it] >= 0) v[it] = __ldg(rows4 + (size_t)key[it] * kQuads + (it * kLoaders + t) % kQuads);
#pragma unroll
  for (int it = 0; it < kLoadSteps; ++it)
    if (key[it] >= 0) buf[it * kLoaders + t] = v[it];
}

__device__ float add_staged_rows(const float* __restrict__ rows, const int* keys, int cnt,
                                 float (*s_rows)[kStage][kNchan], float acc) {
  const int stages = (cnt + kStage - 1) / kStage;
  if (stages == 0) return acc;
  const float4* rows4 = reinterpret_cast<const float4*>(rows);
  if (threadIdx.x >= 32)
    stage_rows(rows4, keys, 0, min(kStage, cnt), reinterpret_cast<float4*>(s_rows[0]));
  __syncthreads();
  for (int c = 0; c < stages; ++c) {
    if (threadIdx.x >= 32) {
      const int c1 = (c + 1) * kStage;
      if (c1 < cnt)
        stage_rows(rows4, keys, c1, min(kStage, cnt - c1),
                   reinterpret_cast<float4*>(s_rows[(c + 1) & 1]));
    } else if (threadIdx.x < kNchan) {
      const float(*buf)[kNchan] = s_rows[c & 1];
      const int m = min(kStage, cnt - c * kStage);
#pragma unroll 8
      for (int r = 0; r < m; ++r) acc += buf[r][threadIdx.x];
    }
    __syncthreads();
  }
  return acc;
}

#ifndef SEGACC_SUM_MIN_BLOCKS  // resident blocks per SM the registers are capped for
#define SEGACC_SUM_MIN_BLOCKS 4
#endif
#ifndef SEGACC_OUTS  // output rows per half-warp
#define SEGACC_OUTS 8
#endif
constexpr int kOuts = SEGACC_OUTS;
constexpr int kBlockOuts = kHalfWarps * kOuts;
// lanes hold the outputs' runs; 4 bits of output above the row keep a key
// (output << kKeyRowBits) | row positive, for n <= kKeyRows
static_assert(kOuts >= 1 && kOuts <= 16, "one lane per output, at most 16");
constexpr int kKeyRowBits = 27;
constexpr int kKeyRowMask = (1 << kKeyRowBits) - 1;
constexpr int kKeyRows = 1 << kKeyRowBits;

__global__ void __launch_bounds__(kThreads, SEGACC_SUM_MIN_BLOCKS)
sum_runs_kernel(const float* __restrict__ rows, const int* __restrict__ gid,
                const int* __restrict__ start, const int* __restrict__ order,
                float* __restrict__ out, int num_out, int n) {
  __shared__ int s_keys[kSortCap];
  __shared__ __align__(16) float s_rows[2][kStage][kNchan];
  __shared__ int s_long[kBlockOuts];
  __shared__ int s_nlong;
  __shared__ int s_warp[kWarps];
  if (threadIdx.x == 0) s_nlong = 0;
  __syncthreads();

  // short runs: a half-warp takes kOuts outputs; lane k holds output
  // g0 + k's run [s, s + len), read in one coalesced load (past num_out:
  // s = start[num_out], len = 0)
  const int lane = threadIdx.x & 15, half = threadIdx.x & 16;
  const unsigned hmask = 0xffffu << half;
  const long long g0 = (long long)blockIdx.x * kBlockOuts + (threadIdx.x >> 4) * kOuts;
  const bool mine = lane < kOuts && g0 + lane < num_out;
  int s = 0, len = 0;
  if (lane < kOuts) {
    s = start[mine ? g0 + lane : num_out];
    if (mine) len = start[g0 + lane + 1] - s;
  }
  if (len > kRegRun) s_long[atomicAdd(&s_nlong, 1)] = (int)(g0 + lane);
  unsigned empty = __ballot_sync(hmask, mine && len == 0) >> half & 0xffffu;
  for (; empty; empty &= empty - 1)  // empty runs: +0.0
    out[(size_t)(g0 + __ffs(empty) - 1) * kNchan + lane] = 0.0f;
  const int first = __shfl_sync(hmask, s, 0, 16);
  const int total = __shfl_sync(hmask, s + len, kOuts - 1, 16) - first;
  if (__ballot_sync(hmask, len > kRegRun) == 0 && total <= 2 * 16 && n <= kKeyRows) {
    // all the half-warp's runs at once: its rows' indices lie in
    // order[first, first + total), run by run; one sort on (output, row)
    // orders each run by row, then the lanes walk the rows in that order
    const int pa = lane, pb = lane + 16;
    int a = INT_MAX, b = INT_MAX;
    if (pa < total) a = order[first + pa];
    if (pb < total) b = order[first + pb];
    // the output of position p: the last k with s_k - first <= p
    int ka = 0, kb = 0;
#pragma unroll
    for (int k = 1; k < kOuts; ++k) {
      const int sk = __shfl_sync(hmask, s, k, 16) - first;
      const bool live = g0 + k < num_out;
      ka += live && sk <= pa;
      kb += live && sk <= pb;
    }
    if (pa < total) a |= ka << kKeyRowBits;
    if (pb < total) b |= kb << kKeyRowBits;
    if (total > 1) sort32_half_warp(a, b, lane, hmask);
    int cur = -1;
    float acc = 0.0f;
    for (int h = 0; h < 2 && 16 * h < total; ++h) {
      const int key = h ? b : a, cnt = total - 16 * h;
      float v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int r = __shfl_sync(hmask, key, j, 16) & kKeyRowMask;
        v[j] = j < cnt ? __ldg(rows + (size_t)r * kNchan + lane) : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int kj = __shfl_sync(hmask, key, j, 16) >> kKeyRowBits;
        if (j < cnt) {
          if (kj != cur) {  // the next output's run starts: the last one is summed
            if (cur >= 0) out[(size_t)(g0 + cur) * kNchan + lane] = acc;
            cur = kj;
            acc = 0.0f;
          }
          acc += v[j];
        }
      }
    }
    if (cur >= 0) out[(size_t)(g0 + cur) * kNchan + lane] = acc;
  } else {
    // run by run; the next run's keys load while the current one is summed
    unsigned todo = __ballot_sync(hmask, len > 0 && len <= kRegRun) >> half & 0xffffu;
    int k = todo ? __ffs(todo) - 1 : -1;
    int cl = __shfl_sync(hmask, len, k & 15, 16);
    const int cs = __shfl_sync(hmask, s, k & 15, 16);
    int a = k >= 0 && lane < cl ? order[cs + lane] : INT_MAX;
    int b = k >= 0 && lane + 16 < cl ? order[cs + 16 + lane] : INT_MAX;
    while (k >= 0) {
      todo &= todo - 1;
      const int kn = todo ? __ffs(todo) - 1 : -1;
      const int ns = __shfl_sync(hmask, s, kn & 15, 16), nl = __shfl_sync(hmask, len, kn & 15, 16);
      const int an = kn >= 0 && lane < nl ? order[ns + lane] : INT_MAX;
      const int bn = kn >= 0 && lane + 16 < nl ? order[ns + 16 + lane] : INT_MAX;
      if (cl > 1) sort32_half_warp(a, b, lane, hmask);
      float acc = add_keyed_rows(rows, a, cl, lane, hmask, 0.0f);
      if (cl > 16) acc = add_keyed_rows(rows, b, cl - 16, lane, hmask, acc);
      out[(size_t)(g0 + k) * kNchan + lane] = acc;
      k = kn;
      cl = nl;
      a = an;
      b = bn;
    }
  }
  __syncthreads();

  // long runs: the whole block each
  const int nlong = s_nlong;
  for (int q = 0; q < nlong; ++q) {
    const int gl = s_long[q];
    const int sl = start[gl], ll = start[gl + 1] - sl;
    float lacc = 0.0f;
    if (ll <= kSortCap) {
      int p2 = 2 * kRegRun;
      while (p2 < ll) p2 <<= 1;
      for (int i = threadIdx.x; i < p2; i += kThreads) s_keys[i] = i < ll ? order[sl + i] : INT_MAX;
      __syncthreads();
      for (int k = 2; k <= p2; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
          for (int i = threadIdx.x; i < p2; i += kThreads) {
            const int l = i ^ j;
            if (l > i) {
              const int x = s_keys[i], y = s_keys[l];
              if ((x > y) == ((i & k) == 0)) {
                s_keys[i] = y;
                s_keys[l] = x;
              }
            }
          }
          __syncthreads();
        }
      }
      lacc = add_staged_rows(rows, s_keys, ll, s_rows, lacc);
    } else {
      // past the sort's capacity: the run's rows in row order, a tile of
      // gid at a time (at most R / 2049 such runs, each reading gid once)
      for (int base = 0; base < n; base += kScanTile) {
        const int i0 = base + threadIdx.x * kScanItems;
        int hit = 0;
#pragma unroll
        for (int it = 0; it < kScanItems; ++it)
          if (i0 + it < n && __ldg(gid + i0 + it) == gl) hit |= 1 << it;
        int hits;
        int pos = block_exclusive_scan(__popc(hit), s_warp, hits);
#pragma unroll
        for (int it = 0; it < kScanItems; ++it)
          if (hit >> it & 1) s_keys[pos++] = i0 + it;
        __syncthreads();
        lacc = add_staged_rows(rows, s_keys, hits, s_rows, lacc);
      }
    }
    if (threadIdx.x < kNchan) out[(size_t)gl * kNchan + threadIdx.x] = lacc;
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

// scratch: scratch_len int32, at least 2 * tiles + 2 + 2 * (num_out + 1) + n
// with tiles = ceil((num_out + 1) / 2048): the scan's status words and tile
// counter, the counts, the starts and the order list. out needs no fill.
extern "C" int gaussreg_segment_accumulate(const float* rows, const int* gid, float* out,
                                           int* scratch, long long scratch_len, int num_out,
                                           int n, void* stream) {
  if (num_out <= 0 || num_out == 0x7fffffff || n < 0) return (int)cudaErrorInvalidValue;
  const int m = num_out + 1;
  const int tiles = (m + kScanTile - 1) / kScanTile;
  const long long zeroed = 2LL * tiles + 2 + m;
  if (scratch_len < zeroed + m + n || reinterpret_cast<uintptr_t>(rows) % 16)
    return (int)cudaErrorInvalidValue;  // a long run stages rows in 16-byte pieces
  const cudaStream_t st = (cudaStream_t)stream;
  auto* status = reinterpret_cast<unsigned long long*>(scratch);
  int* tile_counter = scratch + 2 * tiles;
  int* count = tile_counter + 2;
  int* start = count + m;
  int* order = start + m;
  cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)zeroed * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const int row_blocks = (n + kThreads - 1) / kThreads;
  if (n > 0) {
    count_ids_kernel<<<row_blocks, kThreads, 0, st>>>(gid, count, num_out, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  scan_counts_kernel<<<tiles, kThreads, 0, st>>>(count, start, status, tile_counter, m);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (n > 0) {
    place_rows_kernel<<<row_blocks, kThreads, 0, st>>>(gid, start, count, order, num_out, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  sum_runs_kernel<<<(num_out + kBlockOuts - 1) / kBlockOuts, kThreads, 0, st>>>(
      rows, gid, start, order, out, num_out, n);
  return (int)cudaGetLastError();
}
