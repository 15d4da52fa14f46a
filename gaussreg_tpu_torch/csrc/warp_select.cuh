// Warp-wide selection of the smallest unique 64-bit keys, used by
// window_select.cu (K1).
//
// Each lane owns the keys at positions lane, lane + 32, ... of its row and
// keeps the four smallest of them sorted in registers. A selection round
// takes the warp-wide minimum of the lanes' smallest keys (a
// __shfl_xor_sync butterfly); the lane that owned the winner drops it and,
// only when its four are used up, re-scans its keys for the next four above
// the winner. Keys are unique (the position sits in the low 32 bits), so the
// rounds return the keys in ascending order and ties in position order.

#pragma once

#include <stdint.h>

namespace warp_select {

constexpr unsigned long long kNone = ~0ull;

struct LaneTop4 {
  unsigned long long k0 = kNone, k1 = kNone, k2 = kNone, k3 = kNone;

  __device__ __forceinline__ void insert(unsigned long long key) {
    unsigned long long t = key;
    unsigned long long a = t < k0 ? t : k0;
    t = t < k0 ? k0 : t;
    k0 = a;
    a = t < k1 ? t : k1;
    t = t < k1 ? k1 : t;
    k1 = a;
    a = t < k2 ? t : k2;
    t = t < k2 ? k2 : t;
    k2 = a;
    k3 = t < k3 ? t : k3;
  }
};

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long other = __shfl_xor_sync(0xffffffffu, v, o);
    v = other < v ? other : v;
  }
  return v;
}

// One selection round: returns the warp's smallest remaining key (kNone
// when every lane is exhausted) and advances the lane that owned it.
// key_at(pos) rebuilds the key at a position of this lane's row.
template <class KeyAt>
__device__ __forceinline__ unsigned long long next_smallest(LaneTop4& top, int lane, int w,
                                                            KeyAt key_at) {
  const unsigned long long best = warp_min(top.k0);
  if (best != kNone && top.k0 == best) {
    top.k0 = top.k1;
    top.k1 = top.k2;
    top.k2 = top.k3;
    top.k3 = kNone;
    if (top.k0 == kNone) {
      for (int pos = lane; pos < w; pos += 32) {
        const unsigned long long k = key_at(pos);
        if (k > best) top.insert(k);
      }
    }
  }
  return best;
}

}  // namespace warp_select
