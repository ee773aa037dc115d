"""Treelet packing: SAH range-leaves -> fixed-K contiguous blocks.

Host-side. Converts `sah.build_ranges` output over a triangle table into the
`scene.data.Bvh` array set (numpy): node arrays plus (L, K, 3) triangle
blocks with -1-padded original prim ids. Degenerate zero triangles pad block
tails (a zero triangle's MT determinant is 0 -> always missed).

Only the numpy builder is used. The BVH kernels (csrc/bvh_walk.cuh) read
these arrays repacked by `ops/cuda_bvh.py::pack_bvh`.
"""

from __future__ import annotations

import numpy as np

from . import sah

TREELET_K = 32

# Triangle count past which the scene compiler builds 128-wide leaves (the
# compiled layout the BVH kernels will have to traverse).
WIDE_MIN_TRIS = 650000


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

    rb = sah.build_ranges(mins, maxs, centers, max_leaf)

    leaves = np.nonzero(rb.leaf_start >= 0)[0]
    n_blocks = leaves.shape[0]
    blk_p0 = np.zeros((n_blocks, k, 3), np.float32)
    blk_e1 = np.zeros((n_blocks, k, 3), np.float32)
    blk_e2 = np.zeros((n_blocks, k, 3), np.float32)
    blk_n = np.zeros((n_blocks, k, 3), np.float32)
    blk_prim = np.full((n_blocks, k), -1, np.int32)
    blk_mat = np.full((n_blocks, k), -1, np.int32)
    node_leaf = np.full(rb.node_miss.shape[0], -1, np.int32)
    for b, node in enumerate(leaves):
        lo = rb.leaf_start[node]
        n = rb.leaf_count[node]
        ids = rb.perm[lo : lo + n]
        blk_p0[b, :n] = tri_p0[ids]
        blk_e1[b, :n] = tri_e1[ids]
        blk_e2[b, :n] = tri_e2[ids]
        blk_n[b, :n] = tri_n[ids]
        blk_prim[b, :n] = ids
        blk_mat[b, :n] = tri_mat[ids]
        node_leaf[node] = b

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
