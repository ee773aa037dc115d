// One whole bounce per lane on a BVH scene (bounce_body.cuh with the
// sphere pre-pass and the warp-cooperative BVH walk of bvh_warp_walk.cuh,
// for the primary ray and the NEE shadow ray). One thread per lane.
//
// Replaces the TPU kernel lumillyrender_tpu/ops/pallas_bounce.py::
// _bounce_kernel_bvh (sphere pre-pass _sphere_pass, packet walk
// pallas_bvh.run_walk, and make_step_bvh's IBL epilogue, which runs here in
// the kernel). Its plain version is integrator/wavefront.py::
// plain_bounce_step on a BVH scene, whose intersection is
// ops/intersect.py::intersect_bvh with the plain walk.
//
// Bound on an H100: operations at full width. The state is 106 B/lane each
// way as in bounce.cu, but each live lane walks tens to hundreds of nodes
// (~25 flops each) and tests a few leaves (~54 flops per triangle) for its
// primary ray and again for its shadow ray, counted by chip_smoke.py from
// the plain walk of the same launch. The design: each lane keeps its own
// node cursor (no packet union of boxes, which the TPU needed), and the
// warp tests each leaf together, one requester at a time, each lane its
// share of the K slots, read as whole 128-byte lines (bvh_warp_walk.cuh):
// at K = 128 (terrain-1m, 82 MB of tables past the 50 MB L2) a leaf is
// read once per request instead of ~10 scattered sectors per slot per
// thread, and a request costs K/32 slots a lane instead of K serial slots
// on one lane while its warp waits. The node and leaf tables stay in
// global memory (6.8 MB for welcome-geo, held by the L2); the shading code
// is shared with bounce.cu.
//
// The walk by leaf width, decided in llr_bounce_bvh: K > 32 takes the warp
// walk; K <= 32 the per-thread walk of the nearest-triangle kernel
// (walk_tris_rows, bvh_walk.cuh: scalar slots, each leaf up to its last
// valid slot, while-while), each lane testing its own leaf's slots. At
// K = 32 a warp request gives each lane one slot, and
// the per-request broadcasts and reductions cost more than the serial loop
// saves: on an H100 (NVIDIA H100 80GB HBM3, 700 W; tools/torch_bounce_ab.py,
// medians of 9 launches in turns) welcome-geo (K = 32, tables in the L2)
// took 0.627 ms per 2,072,576-lane launch with the warp walk against 0.470
// ms with the earlier per-thread walk (all K slots, one node step between
// leaf tests), and 0.252 ms with walk_tris_rows (0.284 with its rows read
// four slots a 16-byte load, more registers; PERF.md §6.11), while
// terrain-1m (K = 128) took 10.33 ms with the warp walk against 42.09.
//
// Intersection contract (ops/intersect.py::intersect_bvh): spheres first,
// from t_init, then a triangle wins only when strictly closer, so a sphere
// wins a tie.
#include "bounce_body.cuh"
#include "bvh_warp_walk.cuh"

// Leaf widths from which the warp walk serves the BVH bounce.
constexpr int kWarpWalkMinK = 33;

// The per-thread walk (K <= 32): each lane that asks walks alone, with the
// nearest-triangle kernel's walk (walk_tris_rows, bvh_walk.cuh), scalar
// slots, each leaf up to its last valid slot. K = 32 has an instance of
// its own: on welcome-geo it took 0.874x / 0.883x / 0.941x / 0.931x the
// runtime-K instance's time at the four stage widths, in turns on an H100
// (tools/torch_bounce_ab.py; PERF.md §6.11).
template <int K>
struct BvhIsect {
  BvhTables b;
  const int32_t* counts;
  const float* sph;
  int ns;
  static constexpr bool kWarpQueries = false;
  static constexpr int kLog2Group = 0;  // one thread per lane

  __device__ Hit operator()(V3 o, V3 d, float t_init, float t_stop) const {
    float best_t = t_init;
    int kind = 0, best_m = -1;  // kind: 0 miss, 1 triangle, 2 sphere
    V3 best_f = v3(0.f, 0.f, 0.f);
    fold_spheres(sph, ns, o, d, best_t, kind, best_m, best_f);
    if (b.nodes != nullptr) {  // null: no triangles, an empty BVH
      const float4* root = reinterpret_cast<const float4*>(b.nodes);
      const TriHit w = walk_tris_rows<K, 1, true>(b, counts, __ldg(root), __ldg(root + 1), o, d,
                                                  best_t, t_stop);
      if (w.prim >= 0) {
        best_t = w.t;
        kind = 1;
        best_m = w.mat;
        best_f = w.n;
      }
    }
    return make_hit(o, d, best_t, kind != 0, kind == 1, best_m, best_f);
  }
};

// The warp walk (K > 32): every lane of the warp still running calls it
// (bounce_body.cuh); a lane that does not `ask` helps test the others'
// leaves.
struct BvhWarpIsect {
  BvhTables b;
  const float* sph;
  int ns;
  static constexpr bool kWarpQueries = true;
  static constexpr int kLog2Group = 0;

  __device__ Hit operator()(bool ask, V3 o, V3 d, float t_init, float t_stop) const {
    float best_t = t_init;
    int kind = 0, best_m = -1;  // kind: 0 miss, 1 triangle, 2 sphere
    V3 best_f = v3(0.f, 0.f, 0.f);
    if (ask) fold_spheres(sph, ns, o, d, best_t, kind, best_m, best_f);
    if (b.nodes != nullptr) {  // null: no triangles, an empty BVH
      const TriHit w = walk_tris_warp(b, ask, o, d, best_t, t_stop);
      if (w.prim >= 0) {
        best_t = w.t;
        kind = 1;
        best_m = w.mat;
        best_f = w.n;
      }
    }
    return make_hit(o, d, best_t, kind != 0, kind == 1, best_m, best_f);
  }
};

extern "C" int llr_bounce_bvh(const float* o_in, const float* d_in, const float* thr_in,
                              const float* acc_in, const uint8_t* alive_in,
                              const int32_t* lane_in, float* o_out, float* d_out, float* thr_out,
                              float* acc_out, uint8_t* alive_out, float* rays_out,
                              const float* nodes, const float* leaves, const int32_t* ids,
                              const int32_t* counts, int k,
                              const float* sph, int ns, const float* mats,
                              const float* mats_eval, int nm, const float* lights, int nl,
                              float total_area, int n, int bounce, const uint32_t* args,
                              int flags, float rr_scale, const float* ibl, int ibl_w, int ibl_h,
                              int simple, void* stream) {
  const Scene sc{sph, ns, mats, mats_eval, nm, lights, nl, total_area, args, ibl, ibl_w, ibl_h,
                 simple != 0};
  const BvhTables b{nodes, leaves, ids, k};
  if (args == nullptr || reinterpret_cast<uintptr_t>(args) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (k >= kWarpWalkMinK) {
    return launch_bounce<FAM_ALL>(o_in, d_in, thr_in, acc_in, alive_in, lane_in, o_out, d_out,
                                  thr_out, acc_out, alive_out, rays_out, sc,
                                  BvhWarpIsect{b, sph, ns}, n, bounce, flags, rr_scale,
                                  stream);
  }
  if (k == 32) {
    return launch_bounce<FAM_ALL>(o_in, d_in, thr_in, acc_in, alive_in, lane_in, o_out, d_out,
                                  thr_out, acc_out, alive_out, rays_out, sc,
                                  BvhIsect<32>{b, counts, sph, ns}, n, bounce, flags,
                                  rr_scale, stream);
  }
  return launch_bounce<FAM_ALL>(o_in, d_in, thr_in, acc_in, alive_in, lane_in, o_out, d_out,
                                thr_out, acc_out, alive_out, rays_out, sc,
                                BvhIsect<0>{b, counts, sph, ns}, n, bounce, flags,
                                rr_scale, stream);
}
