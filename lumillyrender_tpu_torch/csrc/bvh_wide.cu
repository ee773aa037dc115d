// Nearest triangle per ray through a BVH of 128-wide leaves: every ray keeps
// its own node cursor and the lanes of a warp test each leaf together, each
// slot read straight from the tables (the AOV walk of bvh_aov_walk.cuh: the
// BVH bounce's walk_tris_warp without the sphere fold, which the AOV route
// does in PyTorch first). Writes t and prim, and with `want_shade` the
// winner's material row and face normal.
//
// Replaces the TPU kernel lumillyrender_tpu/ops/pallas_bvh_wide.py::_kernel
// (leaf_test, precull, the epilogue's row reduction; entry
// intersect_tris_wide), the query behind intersect_bvh on a K=128 BVH that
// ops/cuda_bvh.py::wide_admitted admits (the AOV integrators on the
// 1M-triangle terrain). Its plain version is ops/intersect.py::_walk_tris,
// which it equals bit for bit (bvh_warp_walk.cuh says why).
//
// What the TPU's tile needed and this does not carry over: rays on
// sublanes behind one cursor (Mosaic cannot index per lane), the per-chunk
// pre-cull (to avoid vector-to-scalar syncs) and the per-lane best hit with
// its row reduction. Per-lane cursors visit only a ray's own boxes and
// spread each leaf's slots over the warp, 4 a lane (PERF.md §6.9).
//
// Bound on an H100: operations. Each ray reads 32 B (o, d, t_init, t_stop)
// and writes 8 B (24 more with the shade outputs); every distinct leaf the
// launch visits is read from device memory once (5,120 B with its prim
// row; the ~82 MB of tables at 1M triangles do not fit the 50 MB L2). The
// work is ~25 flops per slab test and ~54 per triangle test of the plain
// walk on the same rays, counted by chip_smoke.py with count_work().
#include "bvh_aov_walk.cuh"

extern "C" int llr_bvh_wide(const float* o, const float* d, const float* t_init,
                            const float* t_stop, const float* nodes, const float* leaves,
                            const int32_t* ids, int k, int n, float* out_t, int32_t* out_prim,
                            int32_t* out_mat, float* out_n, void* stream) {
  if (k != aov::kMaxK) return (int)cudaErrorInvalidValue;
  return aov::launch(o, d, t_init, t_stop, nodes, leaves, ids, k, n, out_t, out_prim, out_mat,
                     out_n, stream);
}
