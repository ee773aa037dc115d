// The per-thread stackless walk of the threaded treelet BVH, walk_tris_rows:
// the nearest-triangle kernel's (bvh.cu) and the BVH bounce's up to K = 32
// (bounce_bvh.cu). Its slab test is also the warp walk's
// (bvh_warp_walk.cuh).
//
// Replaces the TPU walk lumillyrender_tpu/ops/pallas_bvh.py::run_walk and
// its leaf test _leaf_test. The TPU kernel walks a 2048-ray packet behind
// one cursor, because Mosaic reads tables only with a scalar index; on
// Hopper every thread keeps its own cursor, so a ray visits only its own
// boxes. Its plain version is ops/intersect.py::_walk_tris, whose result it
// gives bit for bit:
//   * slab test of the cursor's box against the ray's own best t; a hit
//     inner node goes to cur + 1, anything else to the node's miss link;
//   * a hit leaf tests its slots in ascending order (padding slots,
//     prim < 0, never win) with a strict <;
//   * the walk stops when the cursor is -1 or best t <= t_stop, checked
//     between node steps.
// A zero direction component gives an infinite inverse, and inf * 0 (an
// origin on a box plane) a NaN: PyTorch's minimum/maximum propagate it and
// the box misses, while fminf/fmaxf would drop it, so the NaN is tested
// explicitly.
//
// Tables (ops/cuda_bvh.py::pack_bvh), read from global memory (6.8 MB for
// the 82k-triangle welcome-geo, resident in the 50 MB L2; ~82 MB for the
// 1M-triangle terrain at K=128, which is not):
//   nodes  (N, 8) float32: min 3 | max 3 | miss | leaf (links exact as floats)
//   leaves (L, 12, K) float32, component-major: p0 3 | e1 3 | e2 3 | n 3
//   ids    (L, 2, K) int32: prim | material row
//   counts (L,) int32: each leaf's last slot with prim >= 0, plus one
#pragma once

#include <type_traits>

#include "common.cuh"

struct BvhTables {
  const float* nodes;
  const float* leaves;
  const int32_t* ids;
  int k;
};

struct TriHit {
  float t;
  int prim;  // -1: no triangle beat t_init
  int mat;
  V3 n;
};

// The slab test of node row (r0, r1) = (min xyz, max x | max yz, miss, leaf)
// against a ray: true when the ray meets the box ahead (tmin <= tmax,
// tmax >= EPS, no NaN), with the entry distance in `tmin`. The caller
// compares tmin with its own best t.
__device__ __forceinline__ bool slab_hit(float4 r0, float4 r1, V3 o, float ix, float iy,
                                         float iz, float& tmin) {
  const float tax = (r0.x - o.x) * ix, tbx = (r0.w - o.x) * ix;
  const float tay = (r0.y - o.y) * iy, tby = (r1.x - o.y) * iy;
  const float taz = (r0.z - o.z) * iz, tbz = (r1.y - o.z) * iz;
  const bool nan = isnan(tax) || isnan(tbx) || isnan(tay) || isnan(tby) || isnan(taz) ||
                   isnan(tbz);
  tmin = fmaxf(fmaxf(fminf(tax, tbx), fminf(tay, tby)), fminf(taz, tbz));
  const float tmax = fminf(fminf(fmaxf(tax, tbx), fmaxf(tay, tby)), fmaxf(taz, tbz));
  return !nan && tmin <= tmax && tmax >= LLR_EPS;
}

// V consecutive slots of one leaf row: one 16-byte load at V = 4 (the row
// and the slot 16-byte aligned), else V scalar loads.
template <int V, typename T>
__device__ __forceinline__ void load_slots(const T* p, T (&v)[V]) {
  if constexpr (V == 4) {
    if constexpr (std::is_same<T, float>::value) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
      const int4 q = __ldg(reinterpret_cast<const int4*>(p));
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    }
  } else {
#pragma unroll
    for (int s = 0; s < V; ++s) v[s] = __ldg(p + s);
  }
}

// The best hit of walk_tris_rows so far: the leaf and slot are kept for
// the shade outputs, read once at the end.
struct RowHit {
  float t;
  int prim, leaf, slot;
};

// Slots [0, count) of leaf `leaf` (K its width, or b.k where K = 0), V at
// a time: per group the prim row and the nine geometry rows are loaded at
// once, then the V slots are tested in ascending order with a strict <.
// The group past `count` holds padding only (prim < 0, never a hit); the
// first group is loaded before `count` is known, so its loads overlap the
// count's. Padding inside [0, count) is skipped by prim < 0.
template <int K, int V>
__device__ __forceinline__ void leaf_rows(const BvhTables& b, int leaf, int count, V3 o, V3 d,
                                          RowHit& h) {
  const int k = K > 0 ? K : b.k;
  const float* L = b.leaves + (size_t)leaf * 12 * k;
  const int32_t* P = b.ids + (size_t)leaf * 2 * k;
  int j = 0;
#pragma unroll 1
  do {
    int pr[V];
    float c[9][V];
    load_slots<V>(P + j, pr);
#pragma unroll
    for (int r = 0; r < 9; ++r) load_slots<V>(L + r * k + j, c[r]);
#pragma unroll
    for (int s = 0; s < V; ++s) {
      float t;
      if (tri_test(o, d, v3(c[0][s], c[1][s], c[2][s]), v3(c[3][s], c[4][s], c[5][s]),
                   v3(c[6][s], c[7][s], c[8][s]), t) &&
          pr[s] >= 0 && t < h.t) {
        h.t = t;
        h.prim = pr[s];
        h.leaf = leaf;
        h.slot = j + s;
      }
    }
    j += V;
  } while (j < count);
}

// Nearest triangle strictly closer than t_init, with its material row and
// face normal where kShade; prim = -1 (t = t_init) when none is. Each lane
// steps its own cursor until it reaches a leaf it must test or ends, and
// the lanes of a warp then test their leaves together
// (while-while: a warp runs one leaf loop for all its pending lanes, not
// one for each node step at which some lane meets a leaf); a leaf's rows
// are read by leaf_rows up to its last valid slot (`counts`). The root's
// row comes from the caller (`root0`, `root1`), loaded once for many rays.
// Bit-equal to _walk_tris: each ray tests its leaves in the plain walk's
// order against the same best t, slot by slot in ascending order with a
// strict < (the first of equal minima, then a strict < against the best
// t), and t_stop is checked only between node steps.
template <int K, int V, bool kShade>
__device__ __forceinline__ TriHit walk_tris_rows(const BvhTables& b, const int32_t* counts,
                                                 float4 root0, float4 root1, V3 o, V3 d,
                                                 float t_init, float t_stop) {
  RowHit h{t_init, -1, -1, -1};
  const float ix = 1.0f / d.x, iy = 1.0f / d.y, iz = 1.0f / d.z;
  int cur = 0;
  while (cur >= 0 && h.t > t_stop) {
    int pend = -1;  // the leaf this lane has to test
    do {
      float4 r0 = root0, r1 = root1;  // min xyz, max x | max yz, miss, leaf
      if (cur != 0) {
        const float4* row = reinterpret_cast<const float4*>(b.nodes + 8 * (size_t)cur);
        r0 = __ldg(row);
        r1 = __ldg(row + 1);
      }
      float tmin;
      const bool box = slab_hit(r0, r1, o, ix, iy, iz, tmin) && tmin < h.t;
      const int miss = (int)r1.z, leaf = (int)r1.w;
      if (box && leaf >= 0) pend = leaf;
      cur = (box && leaf < 0) ? cur + 1 : miss;
    } while (pend < 0 && cur >= 0);
    if (pend >= 0) leaf_rows<K, V>(b, pend, __ldg(counts + pend), o, d, h);
  }
  TriHit out{h.t, h.prim, -1, v3(0.f, 0.f, 0.f)};
  if (kShade && h.prim >= 0) {
    const int k = K > 0 ? K : b.k;
    const float* L = b.leaves + (size_t)h.leaf * 12 * k + h.slot;
    out.mat = __ldg(b.ids + (size_t)h.leaf * 2 * k + k + h.slot);
    out.n = v3(__ldg(L + 9 * k), __ldg(L + 10 * k), __ldg(L + 11 * k));
  }
  return out;
}
