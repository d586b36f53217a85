// Native host-side BVH builder.
//
// Equivalent of the reference's C++ BVH construction
// (src/scene/bvh.cpp:54-177).  The device traversal consumes flat arrays, so
// this builder emits exactly the binary SAH BVH layout of accel/bvh.py,
// which ops/intersect.py and ops/traverse.py walk.  The NumPy builder in
// accel/bvh.py remains as behavioral oracle and fallback; this library
// exists because host build time is the serial bottleneck for large scenes
// (SAH partitioning is O(N log N) with heavy constant factors in Python).
//
// C ABI only — loaded via ctypes (no pybind11 in this environment).

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

struct Box {
  float mn[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
  float mx[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void expand(const float* lo, const float* hi) {
    for (int a = 0; a < 3; ++a) {
      mn[a] = std::min(mn[a], lo[a]);
      mx[a] = std::max(mx[a], hi[a]);
    }
  }
  float area() const {
    float d0 = std::max(mx[0] - mn[0], 0.f);
    float d1 = std::max(mx[1] - mn[1], 0.f);
    float d2 = std::max(mx[2] - mn[2], 0.f);
    return d0 * d1 + d1 * d2 + d2 * d0;
  }
};

struct BuildCtx {
  const float* box_min;  // (N, 3)
  const float* box_max;
  std::vector<float> centroid;  // (N, 3)
  std::vector<int32_t> order;
  // output, emitted in DFS order
  std::vector<float> node_min, node_max;
  std::vector<int32_t> node_left, node_right, node_start, node_count;
  int max_depth = 0;
  int max_leaf = 4;
};

constexpr int kBins = 16;

int emit_node(BuildCtx& ctx, int lo, int hi, int depth) {
  Box bb;
  for (int i = lo; i < hi; ++i) {
    const int32_t p = ctx.order[i];
    bb.expand(ctx.box_min + 3 * p, ctx.box_max + 3 * p);
  }
  const int slot = static_cast<int>(ctx.node_left.size());
  for (int a = 0; a < 3; ++a) {
    ctx.node_min.push_back(bb.mn[a]);
  }
  for (int a = 0; a < 3; ++a) {
    ctx.node_max.push_back(bb.mx[a]);
  }
  ctx.node_left.push_back(-1);
  ctx.node_right.push_back(-1);
  ctx.node_start.push_back(lo);
  ctx.node_count.push_back(0);
  ctx.max_depth = std::max(ctx.max_depth, depth);

  const int count = hi - lo;
  if (count <= ctx.max_leaf) {
    ctx.node_count[slot] = count;
    return slot;
  }

  // binned SAH split
  float c_lo[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
  float c_hi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
  for (int i = lo; i < hi; ++i) {
    const float* c = ctx.centroid.data() + 3 * ctx.order[i];
    for (int a = 0; a < 3; ++a) {
      c_lo[a] = std::min(c_lo[a], c[a]);
      c_hi[a] = std::max(c_hi[a], c[a]);
    }
  }

  float best_cost = FLT_MAX;
  int best_axis = -1, best_bin = -1;
  for (int axis = 0; axis < 3; ++axis) {
    const float extent = c_hi[axis] - c_lo[axis];
    if (extent <= 1e-12f) continue;
    const float scale = kBins / extent;
    Box bins[kBins];
    int counts[kBins] = {0};
    for (int i = lo; i < hi; ++i) {
      const int32_t p = ctx.order[i];
      int b = static_cast<int>((ctx.centroid[3 * p + axis] - c_lo[axis]) * scale);
      b = std::min(b, kBins - 1);
      bins[b].expand(ctx.box_min + 3 * p, ctx.box_max + 3 * p);
      counts[b]++;
    }
    Box right[kBins];
    Box acc;
    for (int b = kBins - 1; b >= 0; --b) {
      acc.expand(bins[b].mn, bins[b].mx);
      right[b] = acc;
    }
    Box left;
    int lcnt = 0;
    for (int b = 0; b < kBins - 1; ++b) {
      left.expand(bins[b].mn, bins[b].mx);
      lcnt += counts[b];
      const int rcnt = count - lcnt;
      if (lcnt == 0 || rcnt == 0) continue;
      const float cost = left.area() * lcnt + right[b + 1].area() * rcnt;
      if (cost < best_cost) {
        best_cost = cost;
        best_axis = axis;
        best_bin = b;
      }
    }
  }

  int mid;
  if (best_axis < 0) {
    mid = lo + count / 2;
  } else {
    const float scale = kBins / (c_hi[best_axis] - c_lo[best_axis]);
    auto it = std::stable_partition(
        ctx.order.begin() + lo, ctx.order.begin() + hi, [&](int32_t p) {
          int b = static_cast<int>(
              (ctx.centroid[3 * p + best_axis] - c_lo[best_axis]) * scale);
          return std::min(b, kBins - 1) <= best_bin;
        });
    mid = static_cast<int>(it - ctx.order.begin());
    if (mid == lo || mid == hi) mid = lo + count / 2;
  }

  const int l = emit_node(ctx, lo, mid, depth + 1);
  ctx.node_left[slot] = l;
  const int r = emit_node(ctx, mid, hi, depth + 1);
  ctx.node_right[slot] = r;
  return slot;
}

}  // namespace

extern "C" {

// Binary SAH BVH.  Caller allocates outputs for up to 2*N nodes.
// Returns the number of nodes emitted; *out_max_depth gets the tree depth.
int lf_build_bvh(const float* box_min, const float* box_max, int n,
                 int max_leaf, float* node_min, float* node_max,
                 int32_t* node_left, int32_t* node_right, int32_t* node_start,
                 int32_t* node_count, int32_t* prim_order,
                 int32_t* out_max_depth) {
  BuildCtx ctx;
  ctx.box_min = box_min;
  ctx.box_max = box_max;
  ctx.max_leaf = max_leaf;
  ctx.centroid.resize(3 * n);
  for (int i = 0; i < 3 * n; ++i) {
    ctx.centroid[i] = 0.5f * (box_min[i] + box_max[i]);
  }
  ctx.order.resize(n);
  std::iota(ctx.order.begin(), ctx.order.end(), 0);
  const size_t cap = std::max(2 * n, 1);
  ctx.node_min.reserve(3 * cap);
  ctx.node_max.reserve(3 * cap);

  emit_node(ctx, 0, n, 1);

  const int m = static_cast<int>(ctx.node_left.size());
  std::memcpy(node_min, ctx.node_min.data(), sizeof(float) * 3 * m);
  std::memcpy(node_max, ctx.node_max.data(), sizeof(float) * 3 * m);
  std::memcpy(node_left, ctx.node_left.data(), sizeof(int32_t) * m);
  std::memcpy(node_right, ctx.node_right.data(), sizeof(int32_t) * m);
  std::memcpy(node_start, ctx.node_start.data(), sizeof(int32_t) * m);
  std::memcpy(node_count, ctx.node_count.data(), sizeof(int32_t) * m);
  std::memcpy(prim_order, ctx.order.data(), sizeof(int32_t) * n);
  *out_max_depth = ctx.max_depth;
  return m;
}

}  // extern "C"
