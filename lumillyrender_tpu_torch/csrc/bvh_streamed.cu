// Nearest triangle per ray through a BVH of leaves of any width K that
// divides 128: the AOV walk of bvh_aov_walk.cuh, the same kernel as
// bvh_wide.cu's (every ray keeps its own node cursor, the lanes of a warp
// test each leaf together, each slot read straight from the tables). Writes
// t and prim, and with `want_shade` the winner's material row and face
// normal.
//
// Replaces the TPU kernel lumillyrender_tpu/ops/pallas_bvh.py::
// _kernel_streamed (the node table resident in VMEM, each visited leaf
// treelet fetched by async DMA, one copy in flight, flushed before its
// buffer is reused and after the loop; entry intersect_tris_pallas with
// streamed=True, gate supported_streamed). On the card it serves a K=128
// BVH that ops/cuda_bvh.py::wide_admitted does not admit (the 1.5M-triangle
// terrain) and any caller that asks for streamed=True. Its plain version is
// ops/intersect.py::_walk_tris, which it equals bit for bit.
//
// The TPU kernel's async leaf fetch has no counterpart here: reading each
// slot straight from L2/L1 beat a cp.async-staged schedule at every K
// (PERF.md §6.9).
//
// Bound on an H100: operations, as bvh_wide.cu: 32 B in and 8 B out per ray
// (24 more with the shade outputs), each distinct visited leaf read once,
// ~25 flops per slab test and ~54 per triangle test of the plain walk on
// the same rays.
#include "bvh_aov_walk.cuh"

extern "C" int llr_bvh_streamed(const float* o, const float* d, const float* t_init,
                                const float* t_stop, const float* nodes, const float* leaves,
                                const int32_t* ids, int k, int n, float* out_t,
                                int32_t* out_prim, int32_t* out_mat, float* out_n,
                                void* stream) {
  return aov::launch(o, d, t_init, t_stop, nodes, leaves, ids, k, n, out_t, out_prim, out_mat,
                     out_n, stream);
}
