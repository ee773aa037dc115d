// The nearest-triangle kernel of the AOV queries, behind both the wide-leaf
// entry point (bvh_wide.cu, kernel 7) and the streamed one (bvh_streamed.cu,
// kernel 6): one thread per ray, 128 threads per block, and the body is the
// BVH bounce's warp walk (bvh_warp_walk.cuh::walk_tris_warp, which says why
// it is bit-equal to ops/intersect.py::_walk_tris). Every ray keeps its own
// node cursor; the lanes that reach a leaf are served one at a time, the
// warp testing the requester's ray against the leaf's K slots together
// (the lane of rank r tests slots r, r + 32, ...), each slot read straight
// from the tables (L2, or L1 for the next requester of the same leaf),
// neighbouring lanes on neighbouring slots. No shared memory.
//
// Threads past the last ray call the walk too, asking nothing: they help
// test, and the warp's mask, hence the slot split, stays the full warp.
//
// One walk at every K: it beat a warp-packet walk and a cp.async-staged
// schedule at K=128, 32 and 2 (PERF.md §6.9).
//
// Tables (ops/cuda_bvh.py::pack_bvh): nodes (N, 8), leaves (L, 12, K),
// ids (L, 2, K); K divides 128.
#pragma once

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
