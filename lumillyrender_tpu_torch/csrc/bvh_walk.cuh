// The per-thread stackless walk of the threaded treelet BVH, shared by the
// standalone nearest-triangle kernel (bvh.cu) and the BVH bounce
// (bounce_bvh.cu), at any leaf width K; its slab test is also the warp
// walk's (bvh_warp_walk.cuh).
//
// Replaces the TPU walk lumillyrender_tpu/ops/pallas_bvh.py::run_walk and
// its leaf test _leaf_test. The TPU kernel walks a 2048-ray packet behind
// one cursor, because Mosaic reads tables only with a scalar index; on
// Hopper every thread keeps its own cursor, so a ray visits only its own
// boxes. Its plain version is ops/intersect.py::_walk_tris, which this walk
// follows operation for operation:
//   * slab test of the cursor's box against the ray's own best t; a hit
//     inner node goes to cur + 1, anything else to the node's miss link;
//   * a hit leaf tests its K slots in ascending order (padding slots,
//     prim < 0, skipped) with a strict <;
//   * the walk stops when the cursor is -1 or best t <= t_stop.
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
#pragma once

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

template <bool kShade>
__device__ __forceinline__ void leaf_test(const BvhTables& b, int leaf, V3 o, V3 d, TriHit& h) {
  const int k = b.k;
  const float* L = b.leaves + (size_t)leaf * 12 * k;
  const int32_t* ids = b.ids + (size_t)leaf * 2 * k;
  for (int j = 0; j < k; ++j) {
    const int pr = ids[j];
    if (pr < 0) continue;
    const V3 p0 = v3(L[j], L[k + j], L[2 * k + j]);
    const V3 e1 = v3(L[3 * k + j], L[4 * k + j], L[5 * k + j]);
    const V3 e2 = v3(L[6 * k + j], L[7 * k + j], L[8 * k + j]);
    float t;
    if (tri_test(o, d, p0, e1, e2, t) && t < h.t) {
      h.t = t;
      h.prim = pr;
      if (kShade) {
        h.mat = ids[k + j];
        h.n = v3(L[9 * k + j], L[10 * k + j], L[11 * k + j]);
      }
    }
  }
}

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

// Nearest triangle strictly closer than t_init; prim = -1 (t = t_init) when
// none is.
template <bool kShade>
__device__ __forceinline__ TriHit walk_tris(const BvhTables& b, V3 o, V3 d, float t_init,
                                            float t_stop) {
  TriHit h{t_init, -1, -1, v3(0.f, 0.f, 0.f)};
  const float ix = 1.0f / d.x, iy = 1.0f / d.y, iz = 1.0f / d.z;
  int cur = 0;
  while (cur >= 0 && h.t > t_stop) {
    const float4* row = reinterpret_cast<const float4*>(b.nodes + 8 * (size_t)cur);
    const float4 r0 = __ldg(row), r1 = __ldg(row + 1);  // min xyz, max x | max yz, miss, leaf
    float tmin;
    const bool box = slab_hit(r0, r1, o, ix, iy, iz, tmin) && tmin < h.t;
    const int miss = (int)r1.z, leaf = (int)r1.w;
    if (box && leaf >= 0) leaf_test<kShade>(b, leaf, o, d, h);
    cur = (box && leaf < 0) ? cur + 1 : miss;
  }
  return h;
}
