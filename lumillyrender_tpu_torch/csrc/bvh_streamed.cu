// Nearest triangle per ray through a BVH of leaves of any width K that
// divides 128: the warp-packet walk of packet_walk.cuh with the streamed
// schedule (kAsync): only the node rows are read as the walk goes; each hit
// leaf is copied with cp.async into one of two shared-memory slots of the
// warp while the walk goes on, and tested when the next leaf is found
// (the last one after the loop). Writes t and prim, and with `want_shade`
// the winner's material row and face normal.
//
// Replaces the TPU kernel lumillyrender_tpu/ops/pallas_bvh.py::
// _kernel_streamed (the node table resident in VMEM, each visited leaf
// treelet fetched by async DMA, one copy in flight, flushed before its
// buffer is reused and after the loop; entry intersect_tris_pallas with
// streamed=True, gate supported_streamed). On the card it serves a K=128
// BVH that ops/cuda_bvh.py::wide_admitted does not admit (the 1.5M-triangle
// terrain) and any caller that asks for streamed=True. Its plain version is
// ops/intersect.py::_walk_tris, which it equals bit for bit (packet_walk.cuh
// says why the deferred leaf test keeps that). Route: cp.async
// (cp.async.cg.shared.global, 16 B, commit_group / wait_group), not TMA
// with an mbarrier: a leaf is 10 rows of K floats, a copy each thread can
// issue in a few instructions.
//
// Bound on an H100: operations, as bvh_wide.cu: 32 B in and 8 B out per ray
// (24 more with the shade outputs), each distinct visited leaf read once,
// ~25 flops per slab test and ~54 per triangle test of the plain walk on
// the same rays. Shared memory: two slots of 10 x 128 x 4 B per warp, 40 KB
// per block of 128 threads (static: under the 48 KB that needs no opt-in).
#include "packet_walk.cuh"

extern "C" int llr_bvh_streamed(const float* o, const float* d, const float* t_init,
                                const float* t_stop, const float* nodes, const float* leaves,
                                const int32_t* ids, int k, int n, float* out_t,
                                int32_t* out_prim, int32_t* out_mat, float* out_n,
                                void* stream) {
  return packet::launch<true>(o, d, t_init, t_stop, nodes, leaves, ids, k, n, out_t, out_prim,
                              out_mat, out_n, stream);
}
