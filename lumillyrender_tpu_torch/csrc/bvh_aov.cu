// The nearest-triangle kernel of the AOV queries on the huge meshes, one
// library with two entry points: llr_bvh_wide (kernel 7, leaves 128 wide)
// and llr_bvh_streamed (kernel 6, any K that divides 128). Both launch one
// kernel: one thread per ray, 128 threads per block, and the body is the
// BVH bounce's warp walk (bvh_warp_walk.cuh::walk_tris_warp, which says why
// it is bit-equal to ops/intersect.py::_walk_tris). Every ray keeps its own
// node cursor; the lanes that reach a leaf are served one at a time, the
// warp testing the requester's ray against the leaf's K slots together
// (the lane of rank r tests slots r, r + 32, ...), each slot read straight
// from the tables (L2, or L1 for the next requester of the same leaf),
// neighbouring lanes on neighbouring slots. No shared memory. Writes t and
// prim, and with `want_shade` the winner's material row and face normal.
//
// Threads past the last ray call the walk too, asking nothing: they help
// test, and the warp's mask, hence the slot split, stays the full warp.
//
// Replaces the TPU kernels lumillyrender_tpu/ops/pallas_bvh_wide.py::
// _kernel (leaf_test, precull, the epilogue's row reduction; entry
// intersect_tris_wide), the query behind intersect_bvh on a K=128 BVH that
// ops/cuda_bvh.py::wide_admitted admits (the AOV integrators on the
// 1M-triangle terrain), and lumillyrender_tpu/ops/pallas_bvh.py::
// _kernel_streamed (the node table resident in VMEM, each visited leaf
// treelet fetched by async DMA; entry intersect_tris_pallas with
// streamed=True), which serves a K=128 BVH past the wide cap (the
// 1.5M-triangle terrain) and any caller that asks for streamed=True. Their
// plain version is ops/intersect.py::_walk_tris.
//
// What the TPU's tiles needed and this does not carry over: rays on
// sublanes behind one cursor (Mosaic cannot index per lane), the per-chunk
// pre-cull, the per-lane best hit with its row reduction, and the async
// leaf fetch. Per-lane cursors visit only a ray's own boxes and spread each
// leaf's slots over the warp, 4 a lane at K = 128; one walk at every K
// beat a warp-packet walk and a cp.async-staged schedule at K = 128, 32
// and 2 (PERF.md §6.1-6.9).
//
// Bound on an H100: operations. Each ray reads 32 B (o, d, t_init, t_stop)
// and writes 8 B (16 more with the shade outputs); every distinct leaf the
// launch visits is read from device memory once (5,120 B with its prim
// row at K = 128; the ~82 MB of tables at 1M triangles do not fit the
// 50 MB L2). The work is ~25 flops per slab test and ~54 per triangle test
// of the plain walk on the same rays, counted by chip_smoke.py with
// count_work().
//
// Tables (ops/cuda_bvh.py::pack_bvh): nodes (N, 8), leaves (L, 12, K),
// ids (L, 2, K).
#include "bvh_warp_walk.cuh"

namespace aov {

constexpr int kMaxK = 128;
constexpr int kBlock = 128;

// Writes t and prim, and with kShade the winner's material row and face
// normal.
template <bool kShade>
__global__ void __launch_bounds__(kBlock) kernel(
    const float* __restrict__ o, const float* __restrict__ d, const float* __restrict__ t_init,
    const float* __restrict__ t_stop, BvhTables b, int n, float* __restrict__ out_t,
    int32_t* __restrict__ out_prim, int32_t* __restrict__ out_mat, float* __restrict__ out_n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool ask = i < n;
  const int j = ask ? i : 0;
  const TriHit h = walk_tris_warp(b, ask, load3(o, j), load3(d, j), t_init[j], t_stop[j]);
  if (!ask) return;
  out_t[i] = h.t;
  out_prim[i] = h.prim;
  if (kShade) {
    out_mat[i] = h.mat;
    store3(out_n, i, h.n);
  }
}

inline int launch(const float* o, const float* d, const float* t_init, const float* t_stop,
                  const float* nodes, const float* leaves, const int32_t* ids, int k, int n,
                  float* out_t, int32_t* out_prim, int32_t* out_mat, float* out_n,
                  void* stream) {
  const BvhTables b{nodes, leaves, ids, k};
  const int grid = (n + kBlock - 1) / kBlock;
  if (k < 1 || k > kMaxK || kMaxK % k != 0) return (int)cudaErrorInvalidValue;
  if (grid > 0) {
    if (out_mat != nullptr) {
      kernel<true><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
          o, d, t_init, t_stop, b, n, out_t, out_prim, out_mat, out_n);
    } else {
      kernel<false><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
          o, d, t_init, t_stop, b, n, out_t, out_prim, nullptr, nullptr);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace aov

extern "C" int llr_bvh_wide(const float* o, const float* d, const float* t_init,
                            const float* t_stop, const float* nodes, const float* leaves,
                            const int32_t* ids, int k, int n, float* out_t, int32_t* out_prim,
                            int32_t* out_mat, float* out_n, void* stream) {
  if (k != aov::kMaxK) return (int)cudaErrorInvalidValue;
  return aov::launch(o, d, t_init, t_stop, nodes, leaves, ids, k, n, out_t, out_prim, out_mat,
                     out_n, stream);
}

extern "C" int llr_bvh_streamed(const float* o, const float* d, const float* t_init,
                                const float* t_stop, const float* nodes, const float* leaves,
                                const int32_t* ids, int k, int n, float* out_t,
                                int32_t* out_prim, int32_t* out_mat, float* out_n,
                                void* stream) {
  return aov::launch(o, d, t_init, t_stop, nodes, leaves, ids, k, n, out_t, out_prim, out_mat,
                     out_n, stream);
}
