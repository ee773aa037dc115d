// The warp-packet walk of the threaded treelet BVH, shared by the wide-leaf
// kernel (bvh_wide.cu, kAsync = false) and the streamed kernel
// (bvh_streamed.cu, kAsync = true).
//
// A warp is the packet: its 32 rays share one node cursor. Every thread
// runs the slab test of the cursor's box against its own ray and best t
// (slab_hit, bvh_walk.cuh); the warp descends when __any_sync says any ray
// passed, which is the TPU kernels' conservative union. A hit leaf is
// staged once for the whole warp in the warp's own slot of shared memory
// (its nine geometry rows p0, e1, e2 and its prim row: 10 x K x 4 B, 5,120 B
// at K = 128), and each thread then tests its ray against the staged
// triangles in ascending slot order under a strict < (tri_test,
// common.cuh), so each ray keeps its own best hit and no reduction follows.
//
// Bit-equal to the per-lane plain walk (ops/intersect.py::_walk_tris): a
// thread tests a leaf only when its own slab test of that leaf passes
// against its best t at that moment, and a ray stays in the vote only while
// its best t is above t_stop. Boxes nest and the slab test rounds
// monotonically, so a ray fails every box under one it failed, and the
// leaves it tests, and their order, are the plain walk's. The winner of a
// shade query is kept as (leaf, slot), and its material row and face
// normal are read from the tables at the end.
//
// kAsync (the streamed schedule of pallas_bvh.py::_kernel_streamed): a leaf
// found by the walk is copied with cp.async (cp.async.cg.shared.global,
// 16 B; commit_group / wait_group) into one of two slots of the warp, and
// the walk goes on; when the next leaf is found, its copy is started into
// the other slot, the first copy is waited for, and the first leaf is
// tested; the last one after the loop. A thread keeps the entry distance of
// the leaf it has pending and, when the leaf is tested, tests it only if
// that distance is still below its best t (and its best t above t_stop):
// the same test the plain walk makes on the same best t, so the deferred
// test changes nothing but the schedule. Route recorded: cp.async, not TMA
// with an mbarrier.
//
// Tables (ops/cuda_bvh.py::pack_bvh): nodes (N, 8), leaves (L, 12, K),
// ids (L, 2, K). The copies need K % 4 == 0 for 16-byte chunks; other K
// (1, 2) copy 4 bytes at a time.
#pragma once

#include "bvh_walk.cuh"

namespace packet {

constexpr int kMaxK = 128;
constexpr int kWarps = 4;  // warps (packets) per block of 128 threads
constexpr int kSlot = 10 * kMaxK;  // words of one staged leaf
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy leaf `leaf`'s geometry rows and prim row into `slot`, spread over the
// warp's lanes: with plain loads, or with cp.async (then the caller commits
// and waits).
template <bool kAsync>
__device__ __forceinline__ void stage(const BvhTables& b, int leaf, float* slot, int lane) {
  const int k = b.k;
  const float* g = b.leaves + (size_t)leaf * 12 * k;
  const int32_t* p = b.ids + (size_t)leaf * 2 * k;
  int32_t* sp = reinterpret_cast<int32_t*>(slot + 9 * k);
  if ((k & 3) == 0) {
    const float4* g4 = reinterpret_cast<const float4*>(g);
    const int4* p4 = reinterpret_cast<const int4*>(p);
    float4* s4 = reinterpret_cast<float4*>(slot);
    int4* sp4 = reinterpret_cast<int4*>(sp);
    for (int c = lane; c < 9 * k / 4; c += 32) {
      if (kAsync) cp_async16(s4 + c, g4 + c);
      else s4[c] = __ldg(g4 + c);
    }
    for (int c = lane; c < k / 4; c += 32) {
      if (kAsync) cp_async16(sp4 + c, p4 + c);
      else sp4[c] = __ldg(p4 + c);
    }
  } else {
    for (int c = lane; c < 9 * k; c += 32) {
      if (kAsync) cp_async4(slot + c, g + c);
      else slot[c] = __ldg(g + c);
    }
    for (int c = lane; c < k; c += 32) {
      if (kAsync) cp_async4(sp + c, p + c);
      else sp[c] = __ldg(p + c);
    }
  }
}

struct Best {
  float t;
  int prim;  // -1: no triangle beat t_init
  int leaf, slot;  // the winner's place in the tables
};

// The staged leaf's triangles against one ray, in slot order, strict <.
__device__ __forceinline__ void test_slot(const float* s, int k, int leaf, V3 o, V3 d, Best& w) {
  const int32_t* pr = reinterpret_cast<const int32_t*>(s + 9 * k);
  for (int j = 0; j < k; ++j) {
    const int p = pr[j];
    if (p < 0) continue;
    const V3 p0 = v3(s[j], s[k + j], s[2 * k + j]);
    const V3 e1 = v3(s[3 * k + j], s[4 * k + j], s[5 * k + j]);
    const V3 e2 = v3(s[6 * k + j], s[7 * k + j], s[8 * k + j]);
    float t;
    if (tri_test(o, d, p0, e1, e2, t) && t < w.t) {
      w.t = t;
      w.prim = p;
      w.leaf = leaf;
      w.slot = j;
    }
  }
}

// One warp's walk. `in_range` is false for the threads past the last ray:
// they never pass a box but take part in every vote and copy. `slots` is
// the warp's shared memory: one slot, or two with kAsync.
template <bool kAsync>
__device__ __forceinline__ Best walk(const BvhTables& b, V3 o, V3 d, float t_init, float t_stop,
                                     bool in_range, float* slots) {
  const int lane = threadIdx.x & 31;
  const int k = b.k;
  Best w{t_init, -1, -1, 0};
  const float ix = 1.0f / d.x, iy = 1.0f / d.y, iz = 1.0f / d.z;
  int cur = 0;
  int pending = -1;  // kAsync: the leaf whose copy is in flight
  int buf = 0;  // kAsync: the slot the next copy goes to
  bool pend_box = false;  // kAsync: this ray met the pending leaf's box ...
  float pend_tmin = 0.f;  // ... entering it here
  while (cur >= 0) {
    const bool active = in_range && w.t > t_stop;
    if (!__any_sync(kFull, active)) break;
    const float4* row = reinterpret_cast<const float4*>(b.nodes + 8 * (size_t)cur);
    const float4 r0 = __ldg(row), r1 = __ldg(row + 1);
    float tmin;
    const bool box = slab_hit(r0, r1, o, ix, iy, iz, tmin);
    const bool ok = active && box && tmin < w.t;
    const bool any = __any_sync(kFull, ok);
    const int miss = (int)r1.z, leaf = (int)r1.w;
    if (any && leaf >= 0) {
      if (!kAsync) {
        stage<false>(b, leaf, slots, lane);
        __syncwarp();
        if (ok) test_slot(slots, k, leaf, o, d, w);
        __syncwarp();  // before the slot is staged again
      } else {
        stage<true>(b, leaf, slots + buf * kSlot, lane);
        cp_commit();
        if (pending >= 0) {
          cp_wait<1>();  // the pending leaf's copy, not the one just started
          __syncwarp();
          if (in_range && w.t > t_stop && pend_box && pend_tmin < w.t)
            test_slot(slots + (buf ^ 1) * kSlot, k, pending, o, d, w);
          __syncwarp();  // before the next copy overwrites that slot
        }
        pending = leaf;
        pend_box = box;
        pend_tmin = tmin;
        buf ^= 1;
      }
    }
    cur = (any && leaf < 0) ? cur + 1 : miss;
  }
  if (kAsync && pending >= 0) {
    cp_wait<0>();
    __syncwarp();
    if (in_range && w.t > t_stop && pend_box && pend_tmin < w.t)
      test_slot(slots + (buf ^ 1) * kSlot, k, pending, o, d, w);
  }
  return w;
}

// One thread per ray, a warp per packet, 128 threads per block. Writes t and
// prim, and with kShade the winner's material row and face normal.
template <bool kAsync, bool kShade>
__global__ void __launch_bounds__(128) kernel(
    const float* __restrict__ o, const float* __restrict__ d, const float* __restrict__ t_init,
    const float* __restrict__ t_stop, BvhTables b, int n, float* __restrict__ out_t,
    int32_t* __restrict__ out_prim, int32_t* __restrict__ out_mat, float* __restrict__ out_n) {
  __shared__ __align__(16) float smem[kWarps * (kAsync ? 2 : 1) * kSlot];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < n;
  const int j = in_range ? i : 0;
  float* slots = smem + (threadIdx.x >> 5) * (kAsync ? 2 : 1) * kSlot;
  const Best w = walk<kAsync>(b, load3(o, j), load3(d, j), t_init[j], t_stop[j], in_range, slots);
  if (!in_range) return;
  out_t[i] = w.t;
  out_prim[i] = w.prim;
  if (kShade) {
    const int k = b.k;
    int mat = -1;
    V3 nrm = v3(0.f, 0.f, 0.f);
    if (w.prim >= 0) {
      const float* L = b.leaves + (size_t)w.leaf * 12 * k;
      mat = b.ids[(size_t)w.leaf * 2 * k + k + w.slot];
      nrm = v3(L[9 * k + w.slot], L[10 * k + w.slot], L[11 * k + w.slot]);
    }
    out_mat[i] = mat;
    store3(out_n, i, nrm);
  }
}

template <bool kAsync>
int launch(const float* o, const float* d, const float* t_init, const float* t_stop,
           const float* nodes, const float* leaves, const int32_t* ids, int k, int n,
           float* out_t, int32_t* out_prim, int32_t* out_mat, float* out_n, void* stream) {
  const BvhTables b{nodes, leaves, ids, k};
  const int block = 32 * kWarps;
  const int grid = (n + block - 1) / block;
  if (k < 1 || k > kMaxK || kMaxK % k != 0) return (int)cudaErrorInvalidValue;
  if (grid > 0) {
    if (out_mat != nullptr) {
      kernel<kAsync, true><<<grid, block, 0, (cudaStream_t)stream>>>(
          o, d, t_init, t_stop, b, n, out_t, out_prim, out_mat, out_n);
    } else {
      kernel<kAsync, false><<<grid, block, 0, (cudaStream_t)stream>>>(
          o, d, t_init, t_stop, b, n, out_t, out_prim, nullptr, nullptr);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace packet
