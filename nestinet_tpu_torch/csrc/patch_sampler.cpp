// Native patch-sampling engine for the PCPNet data pipeline.
//
// Replaces the per-patch Python hot loop (reference:
// utils/pcpnet_dataset.py:286-343 — scipy cKDTree ball query +
// numpy subsample + pad/center/scale per patch, single threaded) with a
// C++ kd-tree and an OpenMP-parallel batch sampler that emits
// fixed-shape, zero-padded [n_rads * n_out, 3] patches directly.
//
// C ABI (consumed via ctypes from nestinet_tpu_torch/data/native.py):
//   void* pk_build(const float* pts, int64 n);
//   void  pk_free(void* handle);
//   int64 pk_count_ball(void* handle, const float* center, float radius);
//   void  pk_sample_patches(void* handle,
//                           const int64* center_idx, int64 n_centers,
//                           const float* radii, int n_rads,
//                           int n_out, uint64 seed,
//                           int center_mode,   // 0=point 1=mean 2=none
//                           float* out_pts,    // [n_centers, n_rads*n_out, 3]
//                           int32* out_neff);  // [n_centers, n_rads]
//
// Determinism: each (center, scale) pair derives its RNG stream from
// (seed, center_index, scale) via splitmix64, so results are independent
// of thread scheduling.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

struct KDTree {
  // Flat kd-tree over 3D points; nodes splits at median, leaves hold
  // small index ranges.
  struct Node {
    float split;
    int axis;        // -1 for leaf
    int32_t left;    // node index
    int32_t right;   // node index
    int32_t begin;   // leaf range into order[]
    int32_t end;
  };

  std::vector<float> pts;       // [n, 3]
  std::vector<int32_t> order;   // permutation of point ids
  std::vector<Node> nodes;
  int64_t n = 0;

  static constexpr int kLeafSize = 16;

  void build(const float* data, int64_t count) {
    n = count;
    pts.assign(data, data + 3 * count);
    order.resize(count);
    for (int64_t i = 0; i < count; ++i) order[i] = static_cast<int32_t>(i);
    nodes.reserve(2 * count / kLeafSize + 8);
    build_range(0, static_cast<int32_t>(count), 0);
  }

  int32_t build_range(int32_t begin, int32_t end, int depth) {
    int32_t id = static_cast<int32_t>(nodes.size());
    nodes.push_back({});
    if (end - begin <= kLeafSize) {
      nodes[id] = {0.f, -1, -1, -1, begin, end};
      return id;
    }
    // pick widest axis
    float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
    for (int32_t i = begin; i < end; ++i) {
      const float* p = &pts[3 * order[i]];
      for (int d = 0; d < 3; ++d) {
        lo[d] = std::min(lo[d], p[d]);
        hi[d] = std::max(hi[d], p[d]);
      }
    }
    int axis = 0;
    float width = hi[0] - lo[0];
    for (int d = 1; d < 3; ++d) {
      if (hi[d] - lo[d] > width) {
        width = hi[d] - lo[d];
        axis = d;
      }
    }
    int32_t mid = (begin + end) / 2;
    std::nth_element(
        order.begin() + begin, order.begin() + mid, order.begin() + end,
        [&](int32_t a, int32_t b) { return pts[3 * a + axis] < pts[3 * b + axis]; });
    float split = pts[3 * order[mid] + axis];
    int32_t left = build_range(begin, mid, depth + 1);
    int32_t right = build_range(mid, end, depth + 1);
    nodes[id] = {split, axis, left, right, -1, -1};
    return id;
  }

  // Append indices of all points within radius of center.
  void query_ball(const float* center, float radius,
                  std::vector<int32_t>& out) const {
    const float r2 = radius * radius;
    // iterative stack of (node, accumulated min distance bound)
    int32_t stack[128];
    int top = 0;
    stack[top++] = 0;
    while (top > 0) {
      const Node& nd = nodes[stack[--top]];
      if (nd.axis < 0) {
        for (int32_t i = nd.begin; i < nd.end; ++i) {
          const float* p = &pts[3 * order[i]];
          float dx = p[0] - center[0];
          float dy = p[1] - center[1];
          float dz = p[2] - center[2];
          if (dx * dx + dy * dy + dz * dz <= r2) out.push_back(order[i]);
        }
        continue;
      }
      float delta = center[nd.axis] - nd.split;
      // near child always; far child only if the splitting plane is
      // within radius.
      int32_t near = delta <= 0.f ? nd.left : nd.right;
      int32_t far = delta <= 0.f ? nd.right : nd.left;
      if (std::fabs(delta) <= radius) stack[top++] = far;
      stack[top++] = near;
    }
  }
};

// splitmix64: cheap, high-quality stateless stream derivation.
inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed ? seed : 0x853c49e6748fea9bULL) {}
  uint64_t next() {
    s = splitmix64(s);
    return s;
  }
  // uniform integer in [0, bound)
  uint32_t below(uint32_t bound) {
    return static_cast<uint32_t>((next() >> 11) % bound);
  }
};

}  // namespace

extern "C" {

void* pk_build(const float* pts, int64_t n) {
  auto* tree = new KDTree();
  tree->build(pts, n);
  return tree;
}

void pk_free(void* handle) { delete static_cast<KDTree*>(handle); }

int64_t pk_count_ball(void* handle, const float* center, float radius) {
  auto* tree = static_cast<KDTree*>(handle);
  std::vector<int32_t> idx;
  tree->query_ball(center, radius, idx);
  return static_cast<int64_t>(idx.size());
}

void pk_sample_patches(void* handle, const int64_t* center_idx,
                       int64_t n_centers, const float* radii, int n_rads,
                       int n_out, uint64_t seed, int center_mode,
                       float* out_pts, int32_t* out_neff) {
  auto* tree = static_cast<KDTree*>(handle);
  const float* pts = tree->pts.data();

#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic, 8)
#endif
  for (int64_t c = 0; c < n_centers; ++c) {
    std::vector<int32_t> idx;
    const int64_t ci = center_idx[c];
    const float* center = &pts[3 * ci];
    float* patch_base = out_pts + c * static_cast<int64_t>(n_rads) * n_out * 3;
    // zero the whole patch once (padding discipline)
    std::memset(patch_base, 0,
                sizeof(float) * static_cast<size_t>(n_rads) * n_out * 3);

    for (int s = 0; s < n_rads; ++s) {
      const float rad = radii[s];
      idx.clear();
      tree->query_ball(center, rad, idx);

      int count = static_cast<int>(
          std::min<int64_t>(n_out, static_cast<int64_t>(idx.size())));
      out_neff[c * n_rads + s] = count;

      if (count < static_cast<int>(idx.size())) {
        // partial Fisher-Yates: choose `count` of idx without replacement
        Rng rng(splitmix64(seed ^ (0x9e37ULL * static_cast<uint64_t>(ci) +
                                   static_cast<uint64_t>(s))));
        const int m = static_cast<int>(idx.size());
        for (int i = 0; i < count; ++i) {
          int j = i + static_cast<int>(rng.below(static_cast<uint32_t>(m - i)));
          std::swap(idx[i], idx[j]);
        }
      }

      float* dst = patch_base + static_cast<int64_t>(s) * n_out * 3;
      float mean[3] = {0.f, 0.f, 0.f};
      if (center_mode == 1) {  // 'mean'
        for (int i = 0; i < count; ++i) {
          const float* p = &pts[3 * idx[i]];
          mean[0] += p[0];
          mean[1] += p[1];
          mean[2] += p[2];
        }
        if (count > 0) {
          mean[0] /= count;
          mean[1] /= count;
          mean[2] /= count;
        }
      } else if (center_mode == 0) {  // 'point'
        mean[0] = center[0];
        mean[1] = center[1];
        mean[2] = center[2];
      }
      const float inv_rad = 1.0f / rad;
      for (int i = 0; i < count; ++i) {
        const float* p = &pts[3 * idx[i]];
        dst[3 * i + 0] = (p[0] - mean[0]) * inv_rad;
        dst[3 * i + 1] = (p[1] - mean[1]) * inv_rad;
        dst[3 * i + 2] = (p[2] - mean[2]) * inv_rad;
      }
    }
  }
}

}  // extern "C"
