// Frozen copy of the exact bucket-pruned furthest point sampling of the
// repository's native host library (native/gaussreg_native.cpp), which the
// benchmark's traffic generator (portbench/gen/synthetic.py) uses. Built at
// first use into portbench/_build/ by portbench/gen/fps.py.

#include <cstdint>
#include <limits>
#include <cstring>
#include <cmath>
#include <vector>
#include <unordered_map>
#include <algorithm>
#include <random>

extern "C" {

// Exact FPS with bucket pruning (QuickFPS-style): points are grid-bucketed;
// a bucket whose bbox is farther from the newly selected point than its
// cached max min-distance cannot change, so its O(bucket) update is skipped.
// Exact result, typically 10-100x faster than the naive loop.
int gaussreg_bucket_fps(const float* points, int64_t n, int64_t k,
                        uint64_t seed, int64_t* out_indices) {
  if (k <= 0 || n <= 0 || k > n) return -1;
  const int64_t target_buckets = std::max<int64_t>(1, n / 128);
  const int grid =
      std::max(1, (int)std::floor(std::cbrt((double)target_buckets)));
  float mn[3] = {points[0], points[1], points[2]};
  float mx[3] = {points[0], points[1], points[2]};
  for (int64_t j = 1; j < n; ++j)
    for (int c = 0; c < 3; ++c) {
      mn[c] = std::min(mn[c], points[3 * j + c]);
      mx[c] = std::max(mx[c], points[3 * j + c]);
    }
  float inv[3];
  for (int c = 0; c < 3; ++c) {
    float ext = mx[c] - mn[c];
    inv[c] = ext > 0 ? (float)grid / (ext * 1.0001f) : 0.f;
  }
  auto bucket_of = [&](int64_t j) -> int64_t {
    int64_t ix = (int64_t)((points[3 * j] - mn[0]) * inv[0]);
    int64_t iy = (int64_t)((points[3 * j + 1] - mn[1]) * inv[1]);
    int64_t iz = (int64_t)((points[3 * j + 2] - mn[2]) * inv[2]);
    return (ix * grid + iy) * grid + iz;
  };

  struct Bucket {
    std::vector<int64_t> pts;
    float bb_min[3], bb_max[3];
    float maxd2 = std::numeric_limits<float>::infinity();
    int64_t arg = -1;
  };
  std::unordered_map<int64_t, Bucket> map;
  map.reserve(target_buckets * 2);
  for (int64_t j = 0; j < n; ++j) {
    Bucket& b = map[bucket_of(j)];
    if (b.pts.empty()) {
      for (int c = 0; c < 3; ++c)
        b.bb_min[c] = b.bb_max[c] = points[3 * j + c];
    } else {
      for (int c = 0; c < 3; ++c) {
        b.bb_min[c] = std::min(b.bb_min[c], points[3 * j + c]);
        b.bb_max[c] = std::max(b.bb_max[c], points[3 * j + c]);
      }
    }
    b.pts.push_back(j);
  }
  std::vector<Bucket> buckets;
  buckets.reserve(map.size());
  for (auto& kv : map) buckets.push_back(std::move(kv.second));
  const int64_t nb = (int64_t)buckets.size();

  std::vector<float> d2(n, std::numeric_limits<float>::infinity());
  std::mt19937_64 rng(seed);
  int64_t cur = (int64_t)(rng() % (uint64_t)n);
  out_indices[0] = cur;

  for (int64_t i = 1; i < k; ++i) {
    const float cx = points[3 * cur], cy = points[3 * cur + 1],
                cz = points[3 * cur + 2];
    float best = -1.f;
    int64_t best_j = -1;
    for (int64_t bi = 0; bi < nb; ++bi) {
      Bucket& b = buckets[bi];
      // min squared distance from c to the bucket bbox
      float dm2 = 0.f;
      const float q[3] = {cx, cy, cz};
      for (int c = 0; c < 3; ++c) {
        float d = 0.f;
        if (q[c] < b.bb_min[c]) d = b.bb_min[c] - q[c];
        else if (q[c] > b.bb_max[c]) d = q[c] - b.bb_max[c];
        dm2 += d * d;
      }
      if (dm2 < b.maxd2) {
        // bucket may change: update d2 and recompute its max
        float bmax = -1.f;
        int64_t barg = -1;
        for (int64_t j : b.pts) {
          const float dx = points[3 * j] - cx;
          const float dy = points[3 * j + 1] - cy;
          const float dz = points[3 * j + 2] - cz;
          const float nd = dx * dx + dy * dy + dz * dz;
          if (nd < d2[j]) d2[j] = nd;
          if (d2[j] > bmax) {
            bmax = d2[j];
            barg = j;
          }
        }
        b.maxd2 = bmax;
        b.arg = barg;
      }
      if (b.maxd2 > best) {
        best = b.maxd2;
        best_j = b.arg;
      }
    }
    cur = best_j;
    out_indices[i] = cur;
  }
  return 0;
}

}  // extern "C"
