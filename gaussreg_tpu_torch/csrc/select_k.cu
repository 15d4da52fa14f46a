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
// Entry gaussreg_select_min_k_filter (any 0 < k <= W, any width; the routes
// select_min_k and select_min_k_wide of ops/select_k.py): the threshold
// filter of threshold_filter.cuh (lane queues in registers, rounds of two
// redux.sync minima, a lane refilled by the whole warp; shared with K1,
// window_select.cu) over a row streamed once from device memory:
// - a row, or a slice of one, belongs to one warp, and nothing of it is
//   staged in shared memory, so there is no width limit. Lane t reads
//   columns t, t + 32, ... (4-byte loads, 4 * kUnroll in flight), or for
//   k <= 4 on 16-byte aligned rows float4s t, t + 32, ... (kVecUnroll in
//   flight): 16-byte loads put four neighbouring columns in one lane, and
//   winners that sit together (a sentinel plateau, points in spatial
//   order) would then empty one lane's queue again and again;
// - narrow rows: one warp per row, four rows per block, k rounds; round j's
//   key waits in lane j % 32 and the warp stores 32 keys at once, so the
//   form keeps no list and takes any k. Wide rows (the entry's `wide`):
//   one block of kBlockWarps = 4 warps per row, in one launch; each warp
//   takes a slice and runs ceil(k / 4) rounds; the largest of the slices'
//   last keys bounds the row's k-th key (the slices' keys so far are
//   4 * ceil(k / 4) >= k keys), so each warp then stops at its first key
//   above that bound; each key of the slices' sorted lists (4 * k * 8
//   bytes of dynamic shared memory, so k <= kWideMaxK = 6 400) finds its
//   rank among them by binary searches, and ranks under k are written. No
//   scratch buffer, no second launch. ops/select_k.py picks the form by
//   rows, width and k (`route`; tools/select_variants.py sweeps both forms
//   over them).
// The value written is rebuilt from the key's ordered bits (a zero is
// read back from the row, for its sign).
// Cost: per key a make-key, a 64-bit compare and, rarely, a queue insert
// of L compare-exchanges; per row k (narrow) or about 4 * ceil(k / 4)
// (wide) rounds of two reductions and a pop of L register moves, and per
// refill a re-read of the lane's share and up to L rounds. A lane pops
// about k / 32 keys, so past k = 192 a longer queue trades refills for
// dearer inserts and pops (kMidQueueMaxK, kLargeQueue in the header:
// tools/select_variants.py times builds of copies at each length).
//
// Entry gaussreg_select_min_k_radix (the route select_min_k_radix of
// ops/select_k.py, for large k where the row and its keys fit in kMaxSmem
// of shared memory): K3's second design. The filter pays about k rounds a
// row and, past k = 128, refills that re-read a lane's share, so for
// large k it lost to torch.topk at every swept width
// (tools/select_variants.py). One block per row: the row's ordered bits
// staged in shared memory (one read of device memory, the top digit
// counted on the way); the k-th smallest key found digit by digit from
// 8-bit histograms in shared memory (four passes over the value bits,
// then passes over the positions of the values equal to it only while
// ties straddle the k-th place); the k keys at or below it gathered by
// warp-aggregated slots; a bitonic sort of them in shared memory; the
// first k written. Cost per row: four passes over W words of shared
// memory (atomics for the keys still in play) and about
// kp log2(kp)^2 / 4 compare-exchanges (kp = k rounded up to a power of
// two), whatever the data but for ties. Its shared memory (4 W + 8 kp
// bytes) sets how many blocks an SM holds, so the block takes 512
// threads past 16 384 columns where that holds more threads at once.
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

#include <type_traits>

#include "threshold_filter.cuh"

namespace {

using namespace threshold_filter;

__device__ __forceinline__ uint32_t ordered_bits(float v) {
  const uint32_t u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long make_key(float v, unsigned pos) {
  return ((unsigned long long)ordered_bits(v) << 32) | pos;
}

// ---- the filter entry (the filter itself: threshold_filter.cuh) ----

constexpr int kUnroll = 2;           // 4-byte loads in flight per lane: 4 * kUnroll
constexpr int kVecUnroll = 2;        // 16-byte loads in flight per lane
constexpr int kVecMaxK = 4;          // 16-byte loads up to this k (with L = 4 = kVecMaxK)
constexpr int kBlockWarps = 4;       // a block's warps: four narrow rows or one wide row
constexpr int kMaxSmem = 200 * 1024;
constexpr int kWideMaxK = kMaxSmem / (kBlockWarps * 8);  // the wide form's lists

// The keys of a float row: unit u is column u (kVec false), or the float4
// of columns 4u ... 4u + 3 (kVec: 16-byte loads, the row 16-byte aligned).
template <bool kVec>
struct RowSource {
  static constexpr int kUnits = kVec ? kVecUnroll : 4 * kUnroll;
  static constexpr int kPer = kVec ? 4 : 1;
  using Value = typename std::conditional<kVec, float4, float>::type;
  struct Cursor {};
  const float* __restrict__ xr;

  __device__ __forceinline__ Value load(Cursor&, int u, int d) const {
    if constexpr (kVec) return __ldg(reinterpret_cast<const float4*>(xr) + u + d);
    else return __ldg(xr + u + d);
  }

  __device__ __forceinline__ unsigned long long key(const Value& v, int u, int j) const {
    if constexpr (kVec) return make_key((&v.x)[j], (unsigned)(u * 4 + j));
    else return make_key(v, (unsigned)u);
  }
};

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

// Narrow rows: a block of kBlockWarps warps, a row each (take_smallest:
// round j's key waits in lane j % 32 until the warp stores 32 keys at once).
template <int L, bool kVec>
__global__ void __launch_bounds__(kBlockWarps * 32)
select_narrow_kernel(const float* __restrict__ x, float* __restrict__ vals,
                     int* __restrict__ pos_out, int num_rows, int w, int k) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kBlockWarps + (threadIdx.x >> 5);
  if (row >= num_rows) return;  // uniform over the warp; no block barrier below
  const float* xr = x + (size_t)row * w;
  const RowSource<kVec> src{xr};
  const int units = kVec ? w >> 2 : w;
  LaneQueue<L> q;
  q.reset();
  scan_lane<L>(src, 0, units, lane, q);
  // k <= W: the rounds never run out of keys, so no stop below kNone
  take_smallest<L>(q, src, units, lane, k, kNone, [&](int i, unsigned long long key) {
    vals[row * k + i] = key_value(key, xr);
    pos_out[row * k + i] = (int)(unsigned)key;
  });
}

// Wide rows: a block of kBlockWarps warps per row, a slice each; the
// slices' lists (kBlockWarps * k keys) in dynamic shared memory.
template <int L, bool kVec>
__global__ void __launch_bounds__(kBlockWarps * 32)
select_wide_kernel(const float* __restrict__ x, float* __restrict__ vals,
                   int* __restrict__ pos_out, int w, int k) {
  extern __shared__ unsigned long long lists[];
  __shared__ unsigned long long bounds[kBlockWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = blockIdx.x;
  const float* xr = x + (size_t)row * w;
  const RowSource<kVec> src{xr};
  const int units = kVec ? w >> 2 : w;  // of the row
  unsigned long long* list = lists + (size_t)warp * k;
  // this warp's slice [u0, u1) of the row
  const int u0 = units / kBlockWarps * warp + min(warp, units % kBlockWarps);
  const int u1 = u0 + units / kBlockWarps + (warp < units % kBlockWarps);
  LaneQueue<L> q;
  q.reset();
  scan_lane<L>(src, u0, u1, lane, q);
  // A slice's first m = ceil(k / kBlockWarps) keys, over the row's slices,
  // are >= k keys: the largest of the slices' m-th keys bounds the row's
  // k-th, and a slice stops at its first key above that bound.
  const int m = (k + kBlockWarps - 1) / kBlockWarps;
  int j = 0;
  for (; j < m; ++j) {
    const unsigned long long best = next_key<L>(q, src, u0, u1, lane, j + 1 == k);
    if (lane == 0) list[j] = best;
  }
  if (lane == 0) bounds[warp] = list[m - 1];
  __syncthreads();
  unsigned long long bound = 0;
  for (int o = 0; o < kBlockWarps; ++o) bound = max(bound, bounds[o]);
  for (; j < k; ++j) {
    const unsigned long long best = next_key<L>(q, src, u0, u1, lane, j + 1 == k);
    if (best > bound) break;  // uniform over the warp
    if (lane == 0) list[j] = best;
  }
  for (int i = j + lane; i < k; i += 32) list[i] = kNone;
  // Merge the slices' lists: a key's rank is its place in its own list
  // plus the keys below it in the other lists (keys are unique).
  __syncthreads();
  for (int e = threadIdx.x; e < kBlockWarps * k; e += blockDim.x) {
    const int own = e / k;
    const unsigned long long key = lists[e];
    if (key == kNone) continue;
    int rank = e - own * k;
    for (int o = 0; o < kBlockWarps; ++o)
      if (o != own) rank += count_below(lists + (size_t)o * k, k, key);
    if (rank < k) {
      vals[row * k + rank] = key_value(key, xr);
      pos_out[row * k + rank] = (int)(unsigned)key;
    }
  }
}

template <int L, bool kVec>
int launch_filter(const float* x, float* vals, int* pos, int num_rows, int w, int k, bool wide,
                  cudaStream_t stream) {
  if (!wide) {
    const unsigned blocks = (unsigned)((num_rows + kBlockWarps - 1) / kBlockWarps);
    select_narrow_kernel<L, kVec><<<blocks, kBlockWarps * 32, 0, stream>>>(x, vals, pos,
                                                                           num_rows, w, k);
    return (int)cudaGetLastError();
  }
  const int smem = kBlockWarps * k * 8;
  static int attr_bytes = 0;  // the limit already set (raised only, once per size)
  if (smem > attr_bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        select_wide_kernel<L, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_bytes = smem;
  }
  select_wide_kernel<L, kVec><<<(unsigned)num_rows, kBlockWarps * 32, smem, stream>>>(
      x, vals, pos, w, k);
  return (int)cudaGetLastError();
}

// ---- the radix entry ----

constexpr int kRadixBins = 256;         // 8-bit digits
constexpr int kRadixWideCols = 16384;   // 512 threads a block may pay past this width
constexpr int kRadixLoads = 4;          // loads in flight per thread while staging

// The dynamic shared memory of a radix block: the row's ordered bits
// (padded to 16 bytes), then kp keys.
__host__ __device__ __forceinline__ long long radix_smem_bytes(int w, int kp) {
  return (long long)((w + 3) & ~3) * 4 + (long long)kp * 8;
}

// Stage row xr's ordered bits in shared memory and count their top digits
// in this warp's histogram: kRadixLoads 16-byte loads in flight per
// thread on 16-byte aligned rows, 4 * kRadixLoads 4-byte loads otherwise.
template <int kThreads>
__device__ __forceinline__ void stage_row(const float* __restrict__ xr, int w, uint32_t* bits,
                                          int* hist) {
  if ((w & 3) == 0 && ((uintptr_t)xr & 15) == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    uint4* b4 = reinterpret_cast<uint4*>(bits);
    const int n = w >> 2;
    for (int i0 = threadIdx.x; i0 < n; i0 += kRadixLoads * kThreads) {
      float4 v[kRadixLoads];
#pragma unroll
      for (int j = 0; j < kRadixLoads; ++j) {
        const int i = i0 + j * kThreads;
        v[j] = i < n ? __ldg(x4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < kRadixLoads; ++j) {
        if (i0 + j * kThreads >= n) continue;
        const uint4 b = make_uint4(ordered_bits(v[j].x), ordered_bits(v[j].y),
                                   ordered_bits(v[j].z), ordered_bits(v[j].w));
        b4[i0 + j * kThreads] = b;
        atomicAdd(hist + (b.x >> 24), 1);
        atomicAdd(hist + (b.y >> 24), 1);
        atomicAdd(hist + (b.z >> 24), 1);
        atomicAdd(hist + (b.w >> 24), 1);
      }
    }
  } else {
    constexpr int kPer = 4 * kRadixLoads;
    for (int i0 = threadIdx.x; i0 < w; i0 += kPer * kThreads) {
      float v[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int i = i0 + j * kThreads;
        v[j] = i < w ? __ldg(xr + i) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (i0 + j * kThreads >= w) continue;
        const uint32_t b = ordered_bits(v[j]);
        bits[i0 + j * kThreads] = b;
        atomicAdd(hist + (b >> 24), 1);
      }
    }
  }
}

// Warp 0 of a radix block: the digit whose bin holds the rank-th key
// (1-based) of the histogram summed over the block's warps; writes the
// digit, the rank within its bin and the bin's count to out[0..2].
template <int kWarps>
__device__ __forceinline__ void radix_find(int (*hist)[kRadixBins], int rank, int lane, int* out) {
  constexpr int kPer = kRadixBins / 32;
  int c[kPer], sum = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    c[j] = 0;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) c[j] += hist[wp][lane * kPer + j];
    sum += c[j];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  int below = incl - sum;
  if (below < rank && rank <= incl) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (below < rank && rank <= below + c[j]) {
        out[0] = lane * kPer + j;
        out[1] = rank - below;
        out[2] = c[j];
      }
      below += c[j];
    }
  }
}

// One block per row. The row's ordered bits are staged in shared memory;
// 8-bit digit histograms (one per warp, in shared memory) find the k-th
// smallest key: four passes over the value bits (the first counted while
// staging) give its value T, the rank r it needs among the n values equal
// to T and n; if r < n, passes over the positions of the values equal to
// T give the r-th smallest position P, digit by digit until the rest of a
// digit's bin is taken whole (if r = n, every one of them is). Exactly k
// keys lie at or below (T, P): a pass writes them, in no order, to shared
// memory, a bitonic sort of kp = 2^ceil(log2 k) keys (padded with kNone)
// orders them, and the block writes the first k.
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
select_radix_kernel(const float* __restrict__ x, float* __restrict__ vals,
                    int* __restrict__ pos_out, int w, int k, int kp) {
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(16) unsigned long long radix_smem[];
  __shared__ int hist[kWarps][kRadixBins];
  __shared__ int found[3];
  __shared__ int taken;
  uint32_t* bits = reinterpret_cast<uint32_t*>(radix_smem);
  unsigned long long* cand = radix_smem + ((w + 3) & ~3) / 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row = blockIdx.x;
  const float* xr = x + (size_t)row * w;
  for (int i = tid; i < kWarps * kRadixBins; i += kThreads) (&hist[0][0])[i] = 0;
  if (tid == 0) taken = 0;
  __syncthreads();
  stage_row<kThreads>(xr, w, bits, hist[warp]);
  __syncthreads();

  // The digits of (T, P), most significant first: four of the value, then
  // those of the positions below w.
  uint32_t value = 0, vmask = 0, place = 0, pmask = 0;
  uint32_t fill = 0xffffffffu;  // the position bits below the last digit found
  int rank = k, count = w;
  int pos_bits = 0;
  while ((1ll << pos_bits) < w) ++pos_bits;
  const int pos_digits = (pos_bits + 7) / 8;
  for (int d = 0; d < 4 + pos_digits; ++d) {
    const bool on_value = d < 4;
    if (!on_value && rank == count) break;  // every key equal to T is taken (uniform)
    const int shift = on_value ? 24 - 8 * d : 8 * (pos_digits - 1 - (d - 4));
    if (d > 0) {  // the top digits were counted while staging
      for (int i = tid; i < kWarps * kRadixBins; i += kThreads) (&hist[0][0])[i] = 0;
      __syncthreads();
      for (int i = tid; i < w; i += kThreads) {
        const uint32_t b = bits[i];
        if (on_value ? (b & vmask) == value : b == value && ((uint32_t)i & pmask) == place)
          atomicAdd(&hist[warp][((on_value ? b : (uint32_t)i) >> shift) & 255u], 1);
      }
      __syncthreads();
    }
    if (warp == 0) radix_find<kWarps>(hist, rank, lane, found);
    __syncthreads();
    const uint32_t digit = (uint32_t)found[0] << shift;
    if (on_value) {
      value |= digit;
      vmask |= 255u << shift;
    } else {
      place |= digit;
      pmask |= 255u << shift;
      fill = (1u << shift) - 1;
    }
    rank = found[1];
    count = found[2];
  }
  const unsigned long long kth = ((unsigned long long)value << 32) | (place | fill);

  // The k keys at or below kth, by warp-aggregated slots.
  for (int i0 = 0; i0 < w; i0 += kThreads) {
    const int i = i0 + tid;
    const unsigned long long key = i < w ? ((unsigned long long)bits[i] << 32) | (unsigned)i
                                         : kNone;
    const bool sel = key <= kth;
    const unsigned ballot = __ballot_sync(kFull, sel);
    int base = 0;
    if (lane == 0 && ballot) base = atomicAdd(&taken, __popc(ballot));
    base = __shfl_sync(kFull, base, 0);
    if (sel) cand[base + __popc(ballot & ((1u << lane) - 1))] = key;
  }
  for (int i = k + tid; i < kp; i += kThreads) cand[i] = kNone;
  __syncthreads();

  // Bitonic sort of the kp keys, ascending.
  for (int size = 2; size <= kp; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < kp / 2; t += kThreads) {
        const int lo = 2 * t - (t & (stride - 1));
        const unsigned long long a = cand[lo], b = cand[lo + stride];
        if ((a > b) == ((lo & size) == 0)) {
          cand[lo] = b;
          cand[lo + stride] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < k; i += kThreads) {
    const unsigned long long key = cand[i];
    vals[row * k + i] = key_value(key, xr);
    pos_out[row * k + i] = (int)(unsigned)key;
  }
}

// Raise select_radix_kernel<kThreads>'s dynamic shared memory limit to
// smem (once per size).
template <int kThreads>
int radix_allow(int smem) {
  static int attr_bytes = 0;  // the limit already set
  if (smem > attr_bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        select_radix_kernel<kThreads>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_bytes = smem;
  }
  return 0;
}

// Threads of select_radix_kernel<kThreads> that one SM holds at once.
template <int kThreads>
int radix_resident(int smem) {
  int blocks = 0;
  if (radix_allow<kThreads>(smem) != 0 ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, select_radix_kernel<kThreads>,
                                                    kThreads, smem) != cudaSuccess)
    return 0;
  return blocks * kThreads;
}

template <int kThreads>
int launch_radix(const float* x, float* vals, int* pos, int num_rows, int w, int k, int kp,
                 int smem, cudaStream_t stream) {
  const int rc = radix_allow<kThreads>(smem);
  if (rc != 0) return rc;
  select_radix_kernel<kThreads><<<(unsigned)num_rows, kThreads, smem, stream>>>(x, vals, pos, w,
                                                                                k, kp);
  return (int)cudaGetLastError();
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

// The filter entry: any 0 < k <= W, any width; `wide` nonzero takes a block
// of kBlockWarps warps per row (k <= kWideMaxK), else one warp per row.
//
// 16-byte loads put four neighbouring columns in one lane. Winners that
// sit together (a sentinel plateau, points in spatial order) then empty a
// lane's queue and force refills, so the loads are 4 bytes (neighbouring
// columns in neighbouring lanes) unless no lane can run dry: k <= L.
extern "C" int gaussreg_select_min_k_filter(const float* x, float* vals, int* pos,
                                            int num_rows, int w, int k, int wide,
                                            void* stream) {
  if (num_rows <= 0 || w <= 0 || k <= 0 || k > w || (wide && k > kWideMaxK)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const bool wd = wide != 0;
  if (k <= kVecMaxK && (w & 3) == 0 && ((uintptr_t)x & 15) == 0)
    return launch_filter<4, true>(x, vals, pos, num_rows, w, k, wd, s);
  if (k <= kSmallQueueMaxK) return launch_filter<4, false>(x, vals, pos, num_rows, w, k, wd, s);
  if (k <= kMidQueueMaxK) return launch_filter<8, false>(x, vals, pos, num_rows, w, k, wd, s);
  return launch_filter<kLargeQueue, false>(x, vals, pos, num_rows, w, k, wd, s);
}

// The radix entry: any 0 < k <= W whose row and sorted keys fit in
// kMaxSmem of shared memory (radix_smem_bytes); one block per row, of 256
// threads, or of 512 past kRadixWideCols columns where an SM then holds
// more threads at once (a block's shared memory leaves room for few
// blocks; where 512 costs a block per SM it lost: tools/select_variants.py).
extern "C" int gaussreg_select_min_k_radix(const float* x, float* vals, int* pos, int num_rows,
                                           int w, int k, void* stream) {
  if (num_rows <= 0 || w <= 0 || k <= 0 || k > w) return (int)cudaErrorInvalidValue;
  int kp = 1;
  while (kp < k) kp <<= 1;
  const long long smem = radix_smem_bytes(w, kp);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (w > kRadixWideCols && radix_resident<512>((int)smem) > radix_resident<256>((int)smem))
    return launch_radix<512>(x, vals, pos, num_rows, w, k, kp, (int)smem, s);
  return launch_radix<256>(x, vals, pos, num_rows, w, k, kp, (int)smem, s);
}
