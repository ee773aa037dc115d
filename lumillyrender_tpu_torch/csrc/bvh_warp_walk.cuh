// The BVH walk of the BVH bounce (bounce_bvh.cu, kernel 4): every ray keeps
// its own node cursor, as in walk_tris_rows (bvh_walk.cuh), but the lanes
// of a warp test each leaf together.
//
// Replaces, inside kernel 4, the TPU walk lumillyrender_tpu/ops/
// pallas_bvh.py::run_walk and its leaf test _leaf_test. Its plain version
// is ops/intersect.py::_walk_tris.
//
// Why: on terrain-1m (K = 128 leaves, 82 MB of tables, past the 50 MB L2)
// a ray tests ~1.5 leaves of 128 slots. In a per-thread walk each lane runs
// its own leaf's 128 slots serially while the rest of its warp waits or
// runs another leaf, and each of the ten loads per slot (component-major
// rows 4K bytes apart) touches up to 32 sectors across the warp, ~320 B of
// sectors per triangle test for the 40 B it uses.
//
// The design (the lanes that call at one query site, `mask`):
//   * while-while: each lane steps its own cursor as walk_tris_rows does
//     (slab_hit against its own best t, the t_stop check between node
//     steps) until it reaches a leaf it must test, or ends;
//   * service: while any lane has a pending leaf, the warp takes the lowest
//     such lane's leaf; the requesters are the lanes pending on that leaf.
//     For each requester in lane order, its o, d and best t are broadcast
//     (__shfl_sync) and the mask's lanes test the leaf's slots together:
//     the lane of rank r in the mask tests slots r, r + m, r + 2m, ... (m
//     lanes; at K = 128 and a full warp, slots lane, lane + 32, lane + 64,
//     lane + 96) in ascending order with a strict < against that best t.
//     Each slot is read straight from the tables (L2, or L1 for the next
//     requester of the same leaf): neighbouring lanes read neighbouring
//     slots, so each of the ten loads is one 128-byte line for the warp.
//     All ten rows of a slot are loaded at once, padding (prim < 0) too:
//     skipping a padding slot's geometry after its prim read saved 4% at
//     full width on terrain-1m but cost 9-20% on the narrow stages, where
//     the extra dependent load is latency (H100, tools/torch_bounce_ab.py);
//   * reduction: two warp reductions (redux.sync, __reduce_min_sync) give
//     the smallest t (positive floats order as their bits) and then the
//     smallest slot among the lanes that hold it; the requester keeps
//     (t, leaf, slot). Its prim, material row and face normal are read
//     once, at the end, from the tables.
// No shared memory: nothing is staged, so no two groups of one warp's lanes
// can overwrite each other's leaf, whatever the mask. Correct for any mask;
// bounce_body.cuh asks both queries at points outside the lanes' branches,
// so in the BVH bounce the mask is every lane of the warp still running.
// A lane that asks nothing (`ask` false: a dead lane, or one without a
// shadow ray) has no cursor and helps test the others' leaves.
//
// Bit-equal to walk_tris_rows and to _walk_tris: tri_test makes the same
// operations per triangle, so every t has the same bits. "Smaller t, then
// smaller slot" is _walk_tris's torch.min(t, dim=1) (the first of equal
// minima) followed by its strict < against the best t, and walk_tris_rows'
// serial strict < in ascending slot order keeps the same slot. Each ray
// tests the same leaves in the same order (a leaf is tested before its
// lane steps on, against the best t of all its earlier leaves), and t_stop
// is checked only between node steps.
#pragma once

#include "bvh_walk.cuh"

// Nearest triangle strictly closer than t_init for the lanes that `ask`,
// with its material row and face normal; prim = -1 (t = t_init) when none
// is. Every lane of the calling group must call it.
__device__ __forceinline__ TriHit walk_tris_warp(const BvhTables& b, bool ask, V3 o, V3 d,
                                                 float t_init, float t_stop) {
  const unsigned mask = __activemask();
  const int lane = threadIdx.x & 31;
  const int rank = __popc(mask & ((1u << lane) - 1u));
  const int lanes = __popc(mask);
  const int k = b.k;
  const float ix = 1.0f / d.x, iy = 1.0f / d.y, iz = 1.0f / d.z;
  float best_t = t_init;
  int best_leaf = -1, best_slot = -1;
  int cur = ask ? 0 : -1;
  int pend = -1;  // the leaf this lane waits to have tested
  while (true) {
    while (pend < 0 && cur >= 0 && best_t > t_stop) {
      const float4* row = reinterpret_cast<const float4*>(b.nodes + 8 * (size_t)cur);
      const float4 r0 = __ldg(row), r1 = __ldg(row + 1);
      float tmin;
      const bool box = slab_hit(r0, r1, o, ix, iy, iz, tmin) && tmin < best_t;
      const int miss = (int)r1.z, leaf = (int)r1.w;
      if (box && leaf >= 0) pend = leaf;
      cur = (box && leaf < 0) ? cur + 1 : miss;
    }
    const unsigned want = __ballot_sync(mask, pend >= 0);
    if (want == 0) break;
    const int leaf = __shfl_sync(mask, pend, __ffs(want) - 1);
    const float* L = b.leaves + (size_t)leaf * 12 * k;
    const int32_t* prim = b.ids + (size_t)leaf * 2 * k;
    for (unsigned req = __ballot_sync(mask, pend == leaf); req != 0; req &= req - 1) {
      const int q = __ffs(req) - 1;
      const V3 oq = v3(__shfl_sync(mask, o.x, q), __shfl_sync(mask, o.y, q),
                       __shfl_sync(mask, o.z, q));
      const V3 dq = v3(__shfl_sync(mask, d.x, q), __shfl_sync(mask, d.y, q),
                       __shfl_sync(mask, d.z, q));
      float bt = __shfl_sync(mask, best_t, q);
      int bs = -1;
#pragma unroll 4
      for (int j = rank; j < k; j += lanes) {
        const int pr = __ldg(prim + j);
        const V3 p0 = v3(__ldg(L + j), __ldg(L + k + j), __ldg(L + 2 * k + j));
        const V3 e1 = v3(__ldg(L + 3 * k + j), __ldg(L + 4 * k + j), __ldg(L + 5 * k + j));
        const V3 e2 = v3(__ldg(L + 6 * k + j), __ldg(L + 7 * k + j), __ldg(L + 8 * k + j));
        float t;
        if (tri_test(oq, dq, p0, e1, e2, t) && pr >= 0 && t < bt) {
          bt = t;
          bs = j;
        }
      }
      // A hit's t >= EPS > 0, so its bits order as the floats do; no hit
      // sorts last.
      const unsigned key = bs >= 0 ? __float_as_uint(bt) : 0xffffffffu;
      const unsigned t_min = __reduce_min_sync(mask, key);
      if (t_min != 0xffffffffu) {
        const unsigned s_min = __reduce_min_sync(mask, key == t_min ? (unsigned)bs : 0xffffffffu);
        if (lane == q) {
          best_t = __uint_as_float(t_min);
          best_leaf = leaf;
          best_slot = (int)s_min;
        }
      }
    }
    if (pend == leaf) pend = -1;
  }
  TriHit h{best_t, -1, -1, v3(0.f, 0.f, 0.f)};
  if (best_slot >= 0) {
    const float* L = b.leaves + (size_t)best_leaf * 12 * k + best_slot;
    const int32_t* ids = b.ids + (size_t)best_leaf * 2 * k + best_slot;
    h.prim = __ldg(ids);
    h.mat = __ldg(ids + k);
    h.n = v3(__ldg(L + 9 * k), __ldg(L + 10 * k), __ldg(L + 11 * k));
  }
  return h;
}
