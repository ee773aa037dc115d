// Nearest triangle per ray through the BVH, one thread per ray
// (walk_tris_rows, bvh_walk.cuh): t and prim, and with `want_shade` the
// winner's material row and face normal.
//
// Replaces the TPU kernel lumillyrender_tpu/ops/pallas_bvh.py::_kernel
// (run_walk + _leaf_test), the query behind intersect_bvh on BVH scenes
// whose leaves are not 128 wide (the AOV integrators on welcome-geo). Its
// plain version is ops/intersect.py::_walk_tris, which it equals bit for
// bit.
//
// Bound on an H100: the rays' bytes. Each ray reads o, d, t_init, t_stop
// (32 B) and writes t, prim (8 B; 16 more with the shade outputs). On
// welcome-geo's camera rays (K = 32, 6.8 MB of tables held by the L2) a
// ray makes 1.75 node visits and 3.3 triangle tests on average, two thirds
// of them missing the root box, so the operations bound is a third of the
// bytes bound. What held the per-thread walk back was latency: its leaf
// test ran K serial slots of a runtime width, each a dependent prim load,
// a branch, nine scalar loads and the test, most of them only to find a
// padding slot, and a warp ran one leaf loop for each node step at which
// some lane met a leaf. The design (each element timed alone on an H100,
// PERF.md §6.11):
//   A. instances for K = 32 and K = 128, which fix the leaf's strides (any
//      other K takes a runtime-K instance);
//   B. at K = 128, a leaf's rows read four slots at a time, one 16-byte
//      load per row (the rows are component-major, ops/cuda_bvh.py::
//      pack_bvh), ten loads in flight per four slots; at K = 32, where a
//      leaf holds ~9 triangles, scalar slots (fewer registers) were
//      faster;
//   C. a leaf is read only up to its last valid slot (pack_bvh's `counts`);
//   F. while-while: a lane steps its cursor until it reaches a leaf, and
//      the pending lanes of a warp test their leaves together.
// One ray a thread, the root's row loaded beside the ray: two or four rays
// a thread, each next ray's inputs loaded during the current walk, lost at
// every width (more registers, fewer warps).
#include "bvh_walk.cuh"

namespace k3 {

constexpr int kBlock = 128;

template <int K, int V, bool kShade>
__global__ void __launch_bounds__(kBlock) kernel(
    const float* __restrict__ o, const float* __restrict__ d, const float* __restrict__ t_init,
    const float* __restrict__ t_stop, BvhTables b, const int32_t* __restrict__ counts, int n,
    float* __restrict__ out_t, int32_t* __restrict__ out_prim, int32_t* __restrict__ out_mat,
    float* __restrict__ out_n) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const float4* root = reinterpret_cast<const float4*>(b.nodes);
  const TriHit h = walk_tris_rows<K, V, kShade>(b, counts, __ldg(root), __ldg(root + 1),
                                                 load3(o, i), load3(d, i), t_init[i], t_stop[i]);
  out_t[i] = h.t;
  out_prim[i] = h.prim;
  if (kShade) {
    out_mat[i] = h.mat;
    store3(out_n, i, h.n);
  }
}

template <int K, int V>
int launch(const float* o, const float* d, const float* t_init, const float* t_stop,
           const BvhTables& b, const int32_t* counts, int n, float* out_t, int32_t* out_prim,
           int32_t* out_mat, float* out_n, cudaStream_t stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  if (grid > 0) {
    if (out_mat != nullptr) {
      kernel<K, V, true><<<grid, kBlock, 0, stream>>>(o, d, t_init, t_stop, b, counts, n, out_t,
                                                      out_prim, out_mat, out_n);
    } else {
      kernel<K, V, false><<<grid, kBlock, 0, stream>>>(o, d, t_init, t_stop, b, counts, n,
                                                       out_t, out_prim, nullptr, nullptr);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace k3

// The leaves and ids must be 16-byte aligned (ops/cuda_bvh.py checks them).
extern "C" int llr_bvh(const float* o, const float* d, const float* t_init, const float* t_stop,
                       const float* nodes, const float* leaves, const int32_t* ids,
                       const int32_t* counts, int k, int n, float* out_t, int32_t* out_prim,
                       int32_t* out_mat, float* out_n, void* stream) {
  const BvhTables b{nodes, leaves, ids, k};
  const cudaStream_t s = (cudaStream_t)stream;
  if (k < 1) return (int)cudaErrorInvalidValue;
  if (k == 32) {
    return k3::launch<32, 1>(o, d, t_init, t_stop, b, counts, n, out_t, out_prim, out_mat,
                             out_n, s);
  }
  if (k == 128) {
    return k3::launch<128, 4>(o, d, t_init, t_stop, b, counts, n, out_t, out_prim, out_mat,
                              out_n, s);
  }
  return k3::launch<0, 1>(o, d, t_init, t_stop, b, counts, n, out_t, out_prim, out_mat, out_n,
                          s);
}
