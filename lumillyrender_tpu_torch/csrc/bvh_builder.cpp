// Native SAH treelet BVH builder producing the flattened threaded layout of
// lumillyrender_tpu_torch/accel (same output contract as accel/sah.py's
// build_ranges, which is the plain version and test oracle for this file).
// A copy of the JAX package's native/bvh_builder.cpp, range builder only,
// so that the port needs nothing outside its package; loaded by
// accel/native.py with ctypes.
//
// Cost model parity with the reference renderer's builder (bvh.rs:69-127):
// per node, for each axis, stable-sort leaf AABBs by centroid, sweep
// prefix/suffix merged surface areas, evaluate
//     T = 2*T_aabb + (A(S1)*N1 + A(S2)*N2) * T_tri / A(S)
// at every split, first-minimum tie-break, axis-major. Splitting stops at
// max_leaf primitives. Emission is DFS preorder with miss links (cursor
// traversal).
//
// Exposed via a C ABI for ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr double kTAabb = 1.0;
constexpr double kTTri = 2.0;

struct V3 {
  double x, y, z;
};

inline V3 vmin(const V3& a, const V3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline V3 vmax(const V3& a, const V3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
inline double surface_area(const V3& mn, const V3& mx) {
  const double sx = mx.x - mn.x, sy = mx.y - mn.y, sz = mx.z - mn.z;
  return 2.0 * (sx * sy + sy * sz + sz * sx);
}

struct Builder {
  const V3* mins;
  const V3* maxs;
  const V3* cents;
  float* node_min;
  float* node_max;
  int32_t* node_miss;
  int32_t next_index = 0;

  std::vector<int32_t> ids;        // permutation buffer, partitioned in place
  std::vector<int32_t> scratch;    // per-axis sort buffer
  std::vector<int32_t> best_order; // winning-axis order for the current node
  std::vector<double> s1_area;     // prefix surface areas
  std::vector<double> s2_area;     // suffix surface areas

  // Chooses the SAH split for ids[lo..hi); leaves ids sorted by the winning
  // axis. Returns split offset (elements in the left child) and writes the
  // node bounds.
  int choose_split(int lo, int hi, V3* out_min, V3* out_max) {
    const int n = hi - lo;
    double best_cost = std::numeric_limits<double>::infinity();
    int best_axis = -1, best_split = -1;
    V3 pmin{}, pmax{};
    for (int axis = 0; axis < 3; ++axis) {
      // Every axis sorts from the node's INCOMING order (`ids` is not
      // touched until the winner is known): with exact centroid ties the
      // stable order would otherwise depend on earlier axes, diverging from
      // the numpy oracle builder.
      scratch.assign(ids.begin() + lo, ids.begin() + hi);
      std::stable_sort(scratch.begin(), scratch.end(),
                       [&](int32_t a, int32_t b) {
                         const double ca = (&cents[a].x)[axis];
                         const double cb = (&cents[b].x)[axis];
                         return ca < cb;
                       });
      // prefix: union of [0..=i]
      V3 mn = mins[scratch[0]], mx = maxs[scratch[0]];
      for (int i = 0; i < n; ++i) {
        mn = vmin(mn, mins[scratch[i]]);
        mx = vmax(mx, maxs[scratch[i]]);
        s1_area[i] = surface_area(mn, mx);
      }
      pmin = mn;
      pmax = mx;
      const double s_a = s1_area[n - 1];
      // suffix: union of [i..n)
      mn = mins[scratch[n - 1]];
      mx = maxs[scratch[n - 1]];
      for (int i = n - 1; i >= 0; --i) {
        mn = vmin(mn, mins[scratch[i]]);
        mx = vmax(mx, maxs[scratch[i]]);
        s2_area[i] = surface_area(mn, mx);
      }
      for (int i = 0; i + 1 < n; ++i) {
        const double n1 = i + 1, n2 = n - i - 1;
        const double cost =
            2.0 * kTAabb + (s1_area[i] * n1 + s2_area[i + 1] * n2) * kTTri / s_a;
        if (cost < best_cost) {  // strict: first minimum wins, axis-major
          best_cost = cost;
          best_axis = axis;
          best_split = i + 1;
        }
      }
      if (axis == best_axis) {
        best_order.assign(scratch.begin(), scratch.end());
      }
    }
    (void)best_axis;
    std::copy(best_order.begin(), best_order.end(), ids.begin() + lo);
    *out_min = pmin;  // union is order-independent; last axis pass is fine
    *out_max = pmax;
    return best_split;
  }

  void store_bounds(int idx, const V3& mn, const V3& mx) {
    node_min[idx * 3 + 0] = static_cast<float>(mn.x);
    node_min[idx * 3 + 1] = static_cast<float>(mn.y);
    node_min[idx * 3 + 2] = static_cast<float>(mn.z);
    node_max[idx * 3 + 0] = static_cast<float>(mx.x);
    node_max[idx * 3 + 1] = static_cast<float>(mx.y);
    node_max[idx * 3 + 2] = static_cast<float>(mx.z);
  }
};

// Range-leaf (treelet) variant: leaves hold [leaf_start, leaf_start+count)
// ranges of the SAH-sorted permutation. Same split criterion; splitting
// stops at max_leaf prims. Two-phase: preorder emission recording subtree
// sizes, then a miss-link fix-up walk (mirrors accel/sah.py build_ranges).
struct RangeBuilder : Builder {
  int32_t* leaf_start;
  int32_t* leaf_count;
  std::vector<int32_t> subtree;  // node count per subtree
  int max_leaf = 16;

  int emit_sized(int lo, int hi) {
    const int idx = next_index++;
    subtree.push_back(0);
    if (hi - lo <= max_leaf) {
      leaf_start[idx] = lo;
      leaf_count[idx] = hi - lo;
      V3 mn = mins[ids[lo]], mx = maxs[ids[lo]];
      for (int i = lo; i < hi; ++i) {
        mn = vmin(mn, mins[ids[i]]);
        mx = vmax(mx, maxs[ids[i]]);
      }
      store_bounds(idx, mn, mx);
      subtree[idx] = 1;
      return 1;
    }
    leaf_start[idx] = -1;
    leaf_count[idx] = 0;
    V3 mn, mx;
    const int split = choose_split(lo, hi, &mn, &mx);
    store_bounds(idx, mn, mx);
    const int l = emit_sized(lo, lo + split);
    const int r = emit_sized(lo + split, hi);
    subtree[idx] = 1 + l + r;
    return subtree[idx];
  }

  void fix_miss_links() {
    struct Frame {
      int32_t node, miss;
    };
    std::vector<Frame> stack;
    stack.push_back({0, -1});
    while (!stack.empty()) {
      const Frame f = stack.back();
      stack.pop_back();
      node_miss[f.node] = f.miss;
      if (leaf_start[f.node] < 0) {
        const int32_t left = f.node + 1;
        const int32_t right = left + subtree[left];
        stack.push_back({right, f.miss});
        stack.push_back({left, right});
      }
    }
  }
};

}  // namespace

extern "C" {

// Treelet build. Output arrays sized for the worst case (2p-1 nodes);
// returns the actual node count, or -1 on error. `perm` receives the
// SAH-sorted primitive permutation (length p).
int32_t lumilly_bvh_build_ranges(int32_t p, int32_t max_leaf,
                                 const double* mins, const double* maxs,
                                 const double* cents, float* node_min,
                                 float* node_max, int32_t* node_miss,
                                 int32_t* leaf_start, int32_t* leaf_count,
                                 int32_t* perm) {
  if (p <= 0 || max_leaf <= 0) return -1;
  RangeBuilder b;
  b.mins = reinterpret_cast<const V3*>(mins);
  b.maxs = reinterpret_cast<const V3*>(maxs);
  b.cents = reinterpret_cast<const V3*>(cents);
  b.node_min = node_min;
  b.node_max = node_max;
  b.node_miss = node_miss;
  b.leaf_start = leaf_start;
  b.leaf_count = leaf_count;
  b.max_leaf = max_leaf;
  b.ids.resize(p);
  for (int32_t i = 0; i < p; ++i) b.ids[i] = i;
  b.scratch.reserve(p);
  b.s1_area.resize(p);
  b.s2_area.resize(p);
  b.subtree.reserve(2 * p - 1);
  b.emit_sized(0, p);
  b.fix_miss_links();
  std::memcpy(perm, b.ids.data(), sizeof(int32_t) * p);
  return b.next_index;
}

}
