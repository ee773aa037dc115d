"""Hand-written BVHs with tied triangles in one leaf, and rays aimed at
the tie, for the parity tests of the BVH walks: tests/test_torch_bvh.py
(the plain walk and the JAX package's walk) and tests/test_torch_cuda.py
(the BVH bounce kernel on the card). numpy only."""

import numpy as np


# BVHs written by hand over new-cbox's 12 triangles (all Lambert; 10 and 11
# the light), with triangle 0 three times: at the first tie slot as itself
# and at two later ones as copies under prim ids 8 and 9, other materials
# (rows 1 and 2) and tilted normals. The slots are numbered over the whole
# leaf table and cut into leaves of width k: case -> (k, slots, tie slots,
# slots of triangles 1..11). At K=128 the BVH bounce's warp walk has the
# lane of rank r test slots r, r + 32, r + 64, r + 96 on a full warp:
# "k128" puts the ties in one lane's rounds (slots 5, 37, 101: that lane's
# serial strict < keeps the first), "k128x" in three lanes with the first
# slot in the highest lane (slots 2, 33, 96 in lanes 2, 1, 0: the second
# warp reduction, the smaller slot among equal t, keeps it). K <= 32 takes
# the per-thread walk; "k32x4" puts the ties in leaves 0, 1 and 3 of four
# under an inner root, with padding inside leaves 1-3 and at the end of
# leaves 0-2 (each leaf's valid count, ops/cuda_bvh.py::pack_bvh: 6, 9,
# 27, 32); "k8x16" cuts the same slots into sixteen leaves of 8 (a leaf
# width without an instance of its own in the per-thread kernel).
TIE_LAYOUTS = {
    "k128": (128, 128, (5, 37, 101), (0, 1, 2, 3, 4, 40, 64, 70, 90, 110, 127)),
    "k128x": (128, 128, (2, 33, 96), (0, 1, 3, 4, 5, 40, 64, 70, 90, 110, 127)),
    "k32": (32, 32, (5, 13, 29), (0, 1, 2, 3, 4, 8, 16, 20, 24, 30, 31)),
    "k32x4": (32, 128, (5, 37, 101), (0, 1, 2, 3, 4, 40, 64, 70, 90, 110, 127)),
    "k8x16": (8, 128, (5, 37, 101), (0, 1, 2, 3, 4, 40, 64, 70, 90, 110, 127)),
}


def tie_bvh(geom, case: str) -> dict:
    """The Bvh fields (numpy) of TIE_LAYOUTS[case] over `geom`, new-cbox's
    geometry. The nearest-hit rule (smaller t, then the earlier slot) must
    pick the first tie slot: prim 0, material row 0, triangle 0's normal."""
    k, total, ties, others = TIE_LAYOUTS[case]
    p0, e1, e2, nrm, mat = (getattr(geom, f).detach().cpu().numpy() for f in (
        "tri_p0", "tri_e1", "tri_e2", "tri_n", "tri_mat"))
    slot = {f: np.zeros((total, 3), np.float32) for f in ("p0", "e1", "e2", "n")}
    prim = np.full(total, -1, np.int32)
    smat = np.full(total, -1, np.int32)

    def put(s, tri, prim_id, normal, row):
        slot["p0"][s], slot["e1"][s], slot["e2"][s] = p0[tri], e1[tri], e2[tri]
        slot["n"][s], prim[s], smat[s] = normal, prim_id, row

    side = np.cross(nrm[0], [0.0, 0.0, 1.0] if abs(nrm[0][2]) < 0.9 else [1.0, 0.0, 0.0])
    for j, s in enumerate(ties):
        tilt = nrm[0] + 0.2 * j * side / np.linalg.norm(side)
        put(s, 0, (0, 8, 9)[j], (tilt / np.linalg.norm(tilt)).astype(np.float32),
            (mat[0], 1, 2)[j])
    for tri, s in enumerate(others, start=1):
        put(s, tri, tri, nrm[tri], mat[tri])
    n_leaves = total // k
    corners = np.stack([slot["p0"], slot["p0"] + slot["e1"], slot["p0"] + slot["e2"]], 1)

    def box(sl):
        c = corners[sl][prim[sl] >= 0].reshape(-1, 3)
        if not c.size:  # a leaf of padding only
            return corners[0, 0], corners[0, 0]
        return c.min(0), c.max(0)

    lo, hi = box(slice(0, total))
    if n_leaves == 1:
        node_min, node_max, miss, leaf = [lo], [hi], [-1], [0]
    else:
        node_min, node_max, miss, leaf = [lo], [hi], [-1], [-1]
        for b in range(n_leaves):
            blo, bhi = box(slice(b * k, (b + 1) * k))
            node_min.append(blo)
            node_max.append(bhi)
            miss.append(b + 2 if b + 1 < n_leaves else -1)
            leaf.append(b)
    return dict(
        node_min=np.array(node_min, np.float32), node_max=np.array(node_max, np.float32),
        node_miss=np.array(miss, np.int32), node_leaf=np.array(leaf, np.int32),
        **{f"blk_{f}": slot[f].reshape(n_leaves, k, 3) for f in ("p0", "e1", "e2", "n")},
        blk_prim=prim.reshape(n_leaves, k), blk_mat=smat.reshape(n_leaves, k))


def tie_rays(geom, n: int, seed: int):
    """n rays from seeded origins inside new-cbox's box: the even lanes aimed
    at triangle 0's centroid (the tie), the odd ones in uniform directions."""
    p0, e1, e2 = (getattr(geom, f).detach().cpu().numpy() for f in ("tri_p0", "tri_e1", "tri_e2"))
    corners = np.concatenate([p0, p0 + e1, p0 + e2])
    lo, hi = corners.min(0), corners.max(0)
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo + 0.05 * (hi - lo), hi - 0.05 * (hi - lo), size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    aim = p0[0] + (e1[0] + e2[0]) / 3.0
    d[::2] = aim - o[::2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def with_live_padding(arrays: dict, drop=()) -> dict:
    """tie_bvh's `arrays` with the slots in `drop` (numbered over the whole
    leaf table) made padding too, and every padding slot (prim -1) holding
    the first tie slot's triangle: a walk that took a padding slot for a
    triangle would hit it where the aimed rays hit the tie. The nearest-hit
    rule never takes a padding slot, so the result is the tie BVH's less
    the dropped triangles."""
    out = {f: v.copy() for f, v in arrays.items()}
    k = out["blk_prim"].shape[1]
    prim = out["blk_prim"].reshape(-1)
    prim[list(drop)] = -1
    out["blk_mat"].reshape(-1)[list(drop)] = -1
    first = int(np.argmax(prim == 0))
    pad = prim < 0
    for f in ("p0", "e1", "e2", "n"):
        rows = out[f"blk_{f}"].reshape(-1, 3)
        rows[pad] = rows[first]
        out[f"blk_{f}"] = rows.reshape(-1, k, 3)
    return out
