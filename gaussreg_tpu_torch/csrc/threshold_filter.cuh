// The threshold filter: a warp's smallest unique 64-bit keys of a row
// streamed once, with no staged copy of the row. Shared by K3
// (select_k.cu: the keys of a float row) and K1 (window_select.cu: the
// keys of a query's window candidates, computed from the points).
//
// After FAISS's WarpSelect (Johnson, Douze and Jegou, "Billion-scale
// similarity search with GPUs", 2017), with the merge done by warp
// reductions:
// - a row's keys are numbered by units u in [u0, u1); lane t reads units
//   t, t + 32, ... and offers their keys to its thread queue, the L
//   smallest keys it has seen sorted in registers (L = 4 up to
//   kSmallQueueMaxK, 8 up to kMidQueueMaxK, kLargeQueue past it); a key is
//   compared once with the queue's last key and almost every key stops
//   there;
// - the warp then takes its smallest keys in rounds: two redux.sync minima
//   (the keys' high words, then the low words of the lanes holding that
//   high word) give the warp's smallest queue head, and the lane that owned
//   it pops it. A lane that pops its last key having dropped keys is
//   refilled by the whole warp: every lane reads every 32nd of that lane's
//   units (one load latency, not a walk of the lane's share), keeps the
//   smallest kRefillQueue above the last key popped, and rounds hand the
//   lane its next keys, up to L, stopping early where a lane of the refill
//   runs dry having dropped keys. So the result is exact for any data.
//
// A key source (the template parameter Src) gives a unit's key:
//   Src::kUnits        units a lane loads before it offers their keys;
//   Src::kPer          keys per unit (more than 1: a unit is a vector load;
//                      such a source is taken only where no lane can run
//                      dry, so it is never refilled);
//   Src::Value         what a unit's load gives (value-initialised for
//                      units past the end);
//   Src::Cursor        a lane's state across its loads (default built),
//                      for which units come in increasing order;
//   s.load(c, u, d)    the load of unit u + d, where d is a constant of the
//                      unrolled scan (a row source adds it to the address
//                      of unit u, so the loads of a batch share one address);
//   s.key(v, u, j)     the j-th key of the unit; keys are unique.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace threshold_filter {

constexpr unsigned long long kNone = ~0ull;  // the empty key, after every real key
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmallQueueMaxK = 48;  // L = 4 up to here
constexpr int kMidQueueMaxK = 192;   // L = 8 up to here
constexpr int kLargeQueue = 16;      // L past kMidQueueMaxK
constexpr int kRefillQueue = 8;      // a refill's per-lane queue (at most L)

// A lane's thread queue: the L smallest keys it was offered, ascending
// (kNone past them), and how many it was offered (counted by the caller):
// more than L means some were dropped, all larger than k[L - 1].
template <int L>
struct LaneQueue {
  unsigned long long k[L];
  int seen;

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int i = 0; i < L; ++i) k[i] = kNone;
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
    k[L - 1] = kNone;
  }
};

// Offer this lane's keys of units [u0, u1) to q (lane t takes units
// u0 + t, u0 + t + 32, ...), Src::kUnits loads in flight.
template <int L, class Src>
__device__ __forceinline__ void scan_lane(const Src& s, int u0, int u1, int lane,
                                          LaneQueue<L>& q) {
  typename Src::Cursor c{};
  for (int u = u0 + lane; u < u1; u += 32 * Src::kUnits) {
    typename Src::Value v[Src::kUnits];
#pragma unroll
    for (int i = 0; i < Src::kUnits; ++i)
      v[i] = u + 32 * i < u1 ? s.load(c, u, 32 * i) : typename Src::Value{};
#pragma unroll
    for (int i = 0; i < Src::kUnits; ++i) {
      if (u + 32 * i >= u1) continue;
      q.seen += Src::kPer;
#pragma unroll
      for (int j = 0; j < Src::kPer; ++j) q.offer(s.key(v[i], u + 32 * i, j));
    }
  }
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
// units [u0, u1) (units u0 + src + 32 t), each lane every 32nd of them, so
// one load latency instead of src's whole walk; each lane keeps its P
// smallest keys above `floor`, and rounds hand src its next keys, L of
// them unless a lane of the refill runs dry having dropped keys first (its
// next key might then be below the other lanes' heads). src's count is
// left above L exactly when its share holds keys past those handed.
template <int L, class Src>
__device__ __forceinline__ void refill(LaneQueue<L>& q, const Src& s, int u0, int u1, int lane,
                                       int src, unsigned long long floor) {
  constexpr int kLoads = 4;
  constexpr int P = L < kRefillQueue ? L : kRefillQueue;
  LaneQueue<P> part;
  part.reset();
  typename Src::Cursor c{};
  for (int u = u0 + src + 32 * lane; u < u1; u += kLoads * 32 * 32) {
    typename Src::Value v[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int ui = u + 32 * 32 * i;
      v[i] = ui < u1 ? s.load(c, ui, 0) : typename Src::Value{};
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int ui = u + 32 * 32 * i;
      if (ui >= u1) continue;
      const unsigned long long key = s.key(v[i], ui, 0);
      if (key > floor) {
        ++part.seen;
        part.offer(key);
      }
    }
  }
  const int seen = __reduce_add_sync(kFull, part.seen);
  int given = L;  // uniform over the warp
#pragma unroll
  for (int i = 0; i < L; ++i) {
    if (i < given) {
      const unsigned long long best = warp_min_key(part.k[0]);
      const bool won = best != kNone && part.k[0] == best;
      if (won) part.pop();
      if (lane == src) q.k[i] = best;
      if (P < L && __any_sync(kFull, won && part.k[0] == kNone && part.seen > P)) given = i + 1;
    }
  }
  if (lane == src) q.seen = seen + (L - given);
}

// One round: the warp's smallest queue head (kNone when every queue is
// empty), popped by the lane that owned it. A lane that ran dry having
// dropped keys (all above the popped one) is refilled, unless `last`.
template <int L, class Src>
__device__ __forceinline__ unsigned long long next_key(LaneQueue<L>& q, const Src& s, int u0,
                                                       int u1, int lane, bool last) {
  const unsigned long long best = warp_min_key(q.k[0]);
  const bool won = best != kNone && q.k[0] == best;
  if (won) q.pop();
  // a source of several keys a unit is taken only where a lane pops at
  // most L keys, so it runs dry at most in the last round
  if constexpr (Src::kPer == 1) {
    const unsigned dry = __ballot_sync(kFull, won && !last && q.k[0] == kNone && q.seen > L);
    if (dry) refill<L>(q, s, u0, u1, lane, __ffs(dry) - 1, best);
  }
  return best;
}

// The warp's k smallest keys of units [0, units) below `stop`, ascending,
// in rounds: round j's key waits in lane j % 32 until the warp has 32 of
// them (or the last), then lane t calls emit(i, key) for slot i = the
// group's first + t. Returns how many keys were taken (k, or fewer where
// the keys below `stop` ran out; uniform over the warp). A caller that
// never stops passes kNone, a constant, so that the test compiles away.
template <int L, class Src, class Emit>
__device__ __forceinline__ int take_smallest(LaneQueue<L>& q, const Src& s, int units, int lane,
                                             int k, unsigned long long stop, Emit emit) {
  unsigned long long mine = kNone;
  int j = 0;
  for (; j < k; ++j) {
    const unsigned long long best = next_key<L>(q, s, 0, units, lane, j + 1 == k);
    // uniform over the warp; a stop of kNone (K3: k <= W keys exist) folds away
    if (stop != kNone && best >= stop) break;
    if (lane == (j & 31)) mine = best;
    if ((j & 31) == 31 || j + 1 == k) {
      const int i = (j & ~31) + lane;
      if (i <= j) emit(i, mine);
    }
  }
  if (j < k && (j & 31) != 0) {  // stopped inside a group: store what it holds
    const int i = (j & ~31) + lane;
    if (i < j) emit(i, mine);
  }
  return j;
}

}  // namespace threshold_filter
