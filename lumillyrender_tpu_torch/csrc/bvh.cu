// Nearest triangle per ray through the BVH: one thread walks one ray
// (bvh_walk.cuh) and writes t and prim, and with `want_shade` the winner's
// material row and face normal.
//
// Replaces the TPU kernel lumillyrender_tpu/ops/pallas_bvh.py::_kernel
// (run_walk + _leaf_test), the query behind intersect_bvh on BVH scenes
// (the AOV integrators on the card). Its plain version is
// ops/intersect.py::_walk_tris.
//
// Bound on an H100: operations. Each ray reads o, d, t_init, t_stop (32 B)
// and writes t, prim (8 B; 24 more with the shade outputs), but walks tens
// to hundreds of nodes (~25 flops each) and tests a few leaves of 32
// triangles (~54 flops each): chip_smoke.py counts both from the plain walk
// on the same rays. The design: no packet (each thread follows only its
// own boxes), tables in global memory where the L2 holds them, the node row
// read as two 16-byte loads, and no stack (threaded miss links).
#include "bvh_walk.cuh"

template <bool kShade>
__global__ void __launch_bounds__(128) bvh_kernel(
    const float* __restrict__ o, const float* __restrict__ d, const float* __restrict__ t_init,
    const float* __restrict__ t_stop, BvhTables b, int n, float* __restrict__ out_t,
    int32_t* __restrict__ out_prim, int32_t* __restrict__ out_mat, float* __restrict__ out_n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const TriHit h = walk_tris<kShade>(b, load3(o, i), load3(d, i), t_init[i], t_stop[i]);
  out_t[i] = h.t;
  out_prim[i] = h.prim;
  if (kShade) {
    out_mat[i] = h.mat;
    store3(out_n, i, h.n);
  }
}

extern "C" int llr_bvh(const float* o, const float* d, const float* t_init, const float* t_stop,
                       const float* nodes, const float* leaves, const int32_t* ids, int k, int n,
                       float* out_t, int32_t* out_prim, int32_t* out_mat, float* out_n,
                       void* stream) {
  const BvhTables b{nodes, leaves, ids, k};
  const int block = 128;
  const int grid = (n + block - 1) / block;
  if (grid > 0) {
    if (out_mat != nullptr) {
      bvh_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
          o, d, t_init, t_stop, b, n, out_t, out_prim, out_mat, out_n);
    } else {
      bvh_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
          o, d, t_init, t_stop, b, n, out_t, out_prim, nullptr, nullptr);
    }
  }
  return (int)cudaGetLastError();
}
