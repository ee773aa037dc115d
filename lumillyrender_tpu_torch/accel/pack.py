"""Treelet packing: SAH range-leaves -> fixed-K contiguous blocks.

Host-side. Converts the native SAH builder's ranges (`accel/native.py`;
its plain version is `sah.build_ranges`) over a triangle table into the
`scene.data.Bvh` array set (numpy): node arrays plus (L, K, 3) triangle
blocks with -1-padded original prim ids. Degenerate zero triangles pad block
tails (a zero triangle's MT determinant is 0 -> always missed).

The BVH kernels (csrc/bvh_walk.cuh, csrc/bvh_warp_walk.cuh) read these arrays
repacked by `ops/cuda_bvh.py::pack_bvh`.
"""

from __future__ import annotations

import os

import numpy as np

from . import native

# The leaf width of a BVH built without `max_leaf`, read from LLR_TREELET_K
# at import as the JAX package reads it; `build_tri_bvh` reads the
# attribute at call time. The card's kernels serve any width (kernel 3's
# runtime-K instance, kernel 4's per-thread walk up to 32 and warp walk
# above); the AOV route's streamed walk takes a K that divides 128.
TREELET_K = int(os.environ.get("LLR_TREELET_K", "32"))

# Triangle count from which the scene compiler builds 128-wide leaves, as
# the JAX package's compiler does (LLR_WIDE_MIN_TRIS, read at import);
# `ops/intersect.py::bvh_route` routes such BVHs to the AOV walks. The
# compiler reads the attribute at call time.
WIDE_MIN_TRIS = int(os.environ.get("LLR_WIDE_MIN_TRIS", "650000"))


def build_tri_bvh(tri_p0, tri_e1, tri_e2, tri_n=None, tri_mat=None,
                  max_leaf: int | None = None):
    """Returns dict of numpy arrays matching scene.data.Bvh fields."""
    if max_leaf is None:
        max_leaf = TREELET_K
    t = tri_p0.shape[0]
    k = max_leaf
    if tri_n is None and t:
        n = np.cross(tri_e1, tri_e2)
        ln = np.linalg.norm(n, axis=1, keepdims=True)
        tri_n = n / np.where(ln > 0, ln, 1.0)
    if tri_mat is None:
        tri_mat = np.zeros(t, np.int32)
    if t == 0:
        return dict(
            node_min=np.zeros((1, 3), np.float32),
            node_max=np.zeros((1, 3), np.float32),
            node_miss=np.full((1,), -1, np.int32),
            node_leaf=np.full((1,), -1, np.int32),
            blk_p0=np.zeros((1, k, 3), np.float32),
            blk_e1=np.zeros((1, k, 3), np.float32),
            blk_e2=np.zeros((1, k, 3), np.float32),
            blk_n=np.zeros((1, k, 3), np.float32),
            blk_prim=np.full((1, k), -1, np.int32),
            blk_mat=np.full((1, k), -1, np.int32),
        )

    p1 = tri_p0 + tri_e1
    p2 = tri_p0 + tri_e2
    mins = np.minimum(np.minimum(tri_p0, p1), p2)
    maxs = np.maximum(np.maximum(tri_p0, p1), p2)
    centers = (mins + maxs) / 2.0

    rb = native.build_ranges(mins, maxs, centers, max_leaf)

    # Leaf b holds slots j < count of its range of the SAH permutation.
    leaves = np.nonzero(rb.leaf_start >= 0)[0]
    n_blocks = leaves.shape[0]
    start = rb.leaf_start[leaves].astype(np.int64)
    count = rb.leaf_count[leaves]
    slot = np.arange(k)
    used = slot[None, :] < count[:, None]  # (L, K)
    ids = rb.perm[np.where(used, start[:, None] + slot[None, :], 0)]

    def block(x, fill):
        out = np.full((n_blocks, k) + x.shape[1:], fill, x.dtype)
        out[used] = x[ids[used]]
        return out

    node_leaf = np.full(rb.node_miss.shape[0], -1, np.int32)
    node_leaf[leaves] = np.arange(n_blocks, dtype=np.int32)
    blk_p0 = block(tri_p0.astype(np.float32), 0.0)
    blk_e1 = block(tri_e1.astype(np.float32), 0.0)
    blk_e2 = block(tri_e2.astype(np.float32), 0.0)
    blk_n = block(tri_n.astype(np.float32), 0.0)
    blk_prim = block(np.arange(t, dtype=np.int32), -1)
    blk_mat = block(np.asarray(tri_mat, np.int32), -1)

    return dict(
        node_min=rb.node_min,
        node_max=rb.node_max,
        node_miss=rb.node_miss,
        node_leaf=node_leaf,
        blk_p0=blk_p0,
        blk_e1=blk_e1,
        blk_e2=blk_e2,
        blk_n=blk_n,
        blk_prim=blk_prim,
        blk_mat=blk_mat,
    )
