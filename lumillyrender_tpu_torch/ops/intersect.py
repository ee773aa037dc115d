"""Ray-scene intersection over SoA geometry: brute force and the BVH walk.

Parity: Möller-Trumbore triangles (`triangle.rs:69-100`), quadratic spheres
(`sphere.rs:42-63`), both with the reference's exact EPS semantics
(t < EPS -> miss, |det| < EPS -> miss).

`intersect_brute` streams the prim table in chunks: every chunk is one
dense (C, N) test, its first minimum is folded into the running best with
a strict `<`. That is the same winner as a sequential walk over the
triangles in ascending order and then the spheres in ascending order.

`intersect_bvh` is the JAX package's BVH contract: a brute sphere pre-pass
seeds the best t, and the triangle walk keeps a triangle only when it is
strictly closer, so a sphere wins a tie. `_walk_tris` is the plain version
of every BVH walk: a per-lane stackless walk of the threaded treelet BVH,
where every lane visits its own node sequence, in DFS order, and tests the
triangles of each hit leaf in slot order with a strict `<`. That is the
winner of the JAX package's XLA walk and packet kernels too: each of them
visits a superset of a lane's leaves in the same order under the same rule.

The port's one routing rule for BVHs (`bvh_route`), for `intersect`,
`intersect_shade` and `intersect_bvh` on any caller (the AOVs; the BVH
bounce kernel keeps its own walk: per thread up to K=32, the warp walk of
csrc/bvh_warp_walk.cuh above):

  =========================================  ===========================
  BVH                                        triangle walk (unsorted)
  =========================================  ===========================
  K=32 (or any K but 128)                    csrc/bvh.cu (per-thread)
  K=128, admitted as wide                    llr_bvh_wide (bvh_aov.cu)
  K=128, not admitted as wide                llr_bvh_streamed (bvh_aov.cu)
  any K dividing 128, `streamed=True`        llr_bvh_streamed (bvh_aov.cu)
  =========================================  ===========================

The wide and streamed entry points run one kernel (csrc/bvh_aov.cu, the
bounce's warp walk: every ray keeps its own cursor and the warp tests
each leaf together, each slot read from the tables); they keep the JAX
package's two names and their K checks. "Admitted as wide" is
`cuda_bvh.wide_admitted`, the JAX package's own decision
(`pallas_bvh_wide.supported`), kept so that a scene takes the same entry
point in both packages. `streamed=False` keeps a K=128 BVH off the
streamed walk (wide if admitted, else the per-thread walk). `reorder`
means one thing everywhere: True sorts the rays by `_ray_sort_key` before
the walk, None and False do not. The sort changes only the order in which
lanes are walked, never a lane's result. The JAX package sorts by default
before its packet walks; the port's walks give each ray its own cursor,
and on an H100 the sort of 2M rays costs more than it saves before any of
them (PERF.md §6.1-6.9, §6.11).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from ..constants import EPS, INF
from ..scene.data import Bvh, Geometry
from . import vec
from .table import take_rows

# Prims per dense test. Any size gives the same winner (first minimum in a
# chunk, strict < across chunks); this bounds the (C, N) temporaries.
CHUNK = 16

# Brute force serves scenes up to this many prims (tris + spheres). This is
# the JAX package's threshold off its accelerator; the card's own crossover
# is not measured yet.
BRUTE_MAX_PRIMS = 8192

class Hit(NamedTuple):
    t: torch.Tensor  # (N,) distance; >= INF means miss
    prim: torch.Tensor  # (N,) int32 prim id; -1 on miss


class ShadePoint(NamedTuple):
    position: torch.Tensor  # (N, 3)
    normal: torch.Tensor  # (N, 3) geometric outward normal
    mat: torch.Tensor  # (N,) int32 material row; -1 on miss
    hit: torch.Tensor  # (N,) bool


def _cols(a):
    """(C, 3) -> three (C, 1) columns."""
    return a[:, 0:1], a[:, 1:2], a[:, 2:3]


def _rows(a):
    """(N, 3) -> three (1, N) rows."""
    return a[None, :, 0], a[None, :, 1], a[None, :, 2]


def _mt(o3, d3, p0, e1, e2):
    """Möller-Trumbore on broadcastable components: o3, d3, p0, e1, e2 are
    (x, y, z) tuples. Returns (t, ok). Every kernel repeats these
    operations in this order."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    p0x, p0y, p0z = p0
    e1x, e1y, e1z = e1
    e2x, e2y, e2z = e2
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    det_ok = torch.abs(det) >= EPS
    inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
    ok = (
        det_ok
        & (u >= 0.0) & (u <= 1.0)
        & (v >= 0.0) & (u + v <= 1.0)
        & (t >= EPS)
    )
    return t, ok


def _tri_t(o, d, p0, e1, e2):
    """Möller-Trumbore of rays o,d (N,3) against triangles p0,e1,e2 (C,3)
    -> t (C, N) with misses as +INF."""
    t, ok = _mt(_rows(o), _rows(d), _cols(p0), _cols(e1), _cols(e2))
    return torch.where(ok, t, torch.full_like(t, INF))


def _fma(a, b, c):
    """a*b + c rounded once to float32 (through float64, where a*b is
    exact). The sphere discriminant cancels terms of order r^2 (1e10 for
    the 1e5-radius ground spheres of the scenes), so its rounding decides
    the hit distance; the JAX package's compiled step fuses this one
    multiply-add, and the CUDA kernel does too (`fmaf`)."""
    return (a.double() * b.double() + c.double()).float()


def _sph_t(o, d, c, r):
    """Sphere test of rays o,d (N,3) against centers c (C,3), radii r (C,)
    -> t (C, N) with misses as +INF. Note the reference's asymmetric
    comparisons: triangles miss at t < EPS, spheres select `t1 > EPS`."""
    ox, oy, oz = _rows(o)
    dx, dy, dz = _rows(d)
    cx, cy, cz = _cols(c)
    r1 = r[:, None]
    cox, coy, coz = ox - cx, oy - cy, oz - cz
    cod = cox * dx + coy * dy + coz * dz
    det = _fma(cod, cod, -(cox * cox + coy * coy + coz * coz)) + r1 * r1
    sq = torch.sqrt(torch.where(det > 0.0, det, torch.ones_like(det)))
    t1 = -cod - sq
    t2 = -cod + sq
    t = torch.where(t1 > EPS, t1, t2)
    ok = (det > 0.0) & (t > EPS)
    return torch.where(ok, t, torch.full_like(t, INF))


def _fold(o, d, geom: Geometry, best_t, payload=None, spheres_only=False):
    """Fold every prim into the running best. Returns (best_t, best_p) or,
    with `payload=True`, (best_t, best_p, best_mat, best_f) where best_f is
    the winner's face normal (triangles) or center (spheres)."""
    n = o.shape[0]
    nt = geom.tri_p0.shape[0]
    ns = geom.sph_c.shape[0]
    dev = o.device
    best_p = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_m = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_f = torch.zeros((n, 3), dtype=o.dtype, device=dev)

    def merge(t, base, mat, attr):
        nonlocal best_t, best_p, best_m, best_f
        tmin, j = torch.min(t, dim=0)
        upd = tmin < best_t
        best_t = torch.where(upd, tmin, best_t)
        best_p = torch.where(upd, (j + base).to(torch.int32), best_p)
        if payload:
            best_m = torch.where(upd, mat[j], best_m)
            best_f = torch.where(upd[:, None], attr[j], best_f)

    if not spheres_only:
        for s in range(0, nt, CHUNK):
            sl = slice(s, min(s + CHUNK, nt))
            t = _tri_t(o, d, geom.tri_p0[sl], geom.tri_e1[sl], geom.tri_e2[sl])
            merge(t, s, geom.tri_mat[sl], geom.tri_n[sl])
    for s in range(0, ns, CHUNK):
        sl = slice(s, min(s + CHUNK, ns))
        t = _sph_t(o, d, geom.sph_c[sl], geom.sph_r[sl])
        merge(t, nt + s, geom.sph_mat[sl], geom.sph_c[sl])
    if payload:
        return best_t, best_p, best_m, best_f
    return best_t, best_p


def intersect_brute(o, d, geom: Geometry) -> Hit:
    """Nearest hit over the whole prim table. o,d: (N,3)."""
    best_t = torch.full((o.shape[0],), INF, dtype=o.dtype, device=o.device)
    best_t, best_p = _fold(o, d, geom, best_t)
    best_p = torch.where(best_t < INF, best_p, torch.full_like(best_p, -1))
    return Hit(t=best_t, prim=best_p)


def _sphere_brute(o, d, geom: Geometry, best_t, best_p):
    """Fold all spheres into the running (best_t, best_p)."""
    t, p = _fold(o, d, geom, best_t, spheres_only=True)
    upd = p >= 0
    return t, torch.where(upd, p, best_p)


def _finish(o, d, nt: int, ns: int, best_t, best_p, best_m, best_f):
    """(Hit, ShadePoint) from a fold's winner: its t, prim, material row and
    face normal (triangles) or center (spheres). A lane whose query was
    not asked (cap -inf) gets its origin as position: o + d * -inf would
    put inf or NaN into the backward pass of every masked use of it."""
    hitmask = best_p >= 0
    hit = Hit(t=best_t, prim=torch.where(hitmask, best_p,
                                         torch.full_like(best_p, -1)))
    t_pos = torch.where(torch.isfinite(best_t), best_t, torch.zeros_like(best_t))
    pos = o + d * t_pos[..., None]
    if ns:
        sn = vec.safe_normalize(pos - best_f)
        normal = torch.where((best_p < nt)[..., None], best_f, sn)
    else:
        normal = best_f
    normal = torch.where(hitmask[..., None], normal,
                         normal.new_tensor([0.0, 0.0, 1.0]))
    mat = torch.where(hitmask, best_m, torch.full_like(best_m, -1))
    return hit, ShadePoint(position=pos, normal=normal, mat=mat, hit=hitmask)


def intersect_shade_brute(o, d, geom: Geometry, t_cap=None):
    """Nearest hit plus the winner's shade attributes. o,d: (N,3).

    `t_cap` (N,) caps the search: hits at t >= t_cap are misses (and the
    returned t is then t_cap). Returns (Hit, ShadePoint), the same as
    `intersect_brute` followed by `shade_point`."""
    best_t = (torch.full((o.shape[0],), INF, dtype=o.dtype, device=o.device)
              if t_cap is None else t_cap)
    best_t, best_p, best_m, best_f = _fold(o, d, geom, best_t, payload=True)
    return _finish(o, d, geom.tri_p0.shape[0], geom.sph_c.shape[0],
                   best_t, best_p, best_m, best_f)


# While `count_work()` is open: the node visits and triangle tests of every
# plain walk, summed over lanes.
_work: dict | None = None


@contextlib.contextmanager
def count_work():
    """Sum the node visits (slab tests) and triangle tests of every plain
    BVH walk run inside the block into the yielded dict, as
    {"visits": int, "tests": int or a 0-d tensor on the walk's device,
    "seen": None or a bool mask over the walked BVH's leaves, True for each
    leaf some lane tested}; the kernels' bounds count these."""
    global _work
    _work = {"visits": 0, "tests": 0, "seen": None}
    try:
        yield _work
    finally:
        _work = None


def _walk_tris(o, d, t_init, t_stop, bvh: Bvh, want_shade: bool):
    """Nearest triangle strictly closer than `t_init` per lane, walking the
    threaded BVH; the plain version of the CUDA walks csrc/bvh.cu and
    csrc/bvh_aov.cu, at any K.

    Each lane holds a node cursor (0 = root). A step runs the slab test of
    the cursor's box against the lane's own best t: a hit inner node moves
    the cursor to `cur + 1`, anything else to the node's `miss` link, and a
    hit leaf first tests its K triangle slots in ascending order with a
    strict `<` (padding slots, prim < 0, never win). A lane stops when its
    cursor is -1 or its best t is <= `t_stop` (occlusion queries; -INF
    never stops). A zero direction component gives an infinite inverse; a
    NaN from inf * 0 (an origin on a box plane) propagates through
    minimum/maximum and misses the box.

    Returns (t, prim[, mat, n (N,3)]): prim = -1 and t = t_init where no
    triangle beat t_init. Inside `count_work()` the walk adds its node
    visits and triangle tests to the open count.
    """
    n = o.shape[0]
    dev = o.device
    inv = 1.0 / d
    best_t = t_init.clone()
    best_p = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_m = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_n = torch.zeros((n, 3), dtype=o.dtype, device=dev)
    work = _work
    miss_of = bvh.node_miss.long()
    leaf_of = bvh.node_leaf.long()
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    live = torch.arange(n, device=dev)
    while True:
        cur = node[live]
        keep = (cur >= 0) & (best_t[live] > t_stop[live])
        live, cur = live[keep], cur[keep]
        if live.numel() == 0:
            break
        ol, il = o[live], inv[live]
        ta = (bvh.node_min[cur] - ol) * il
        tb = (bvh.node_max[cur] - ol) * il
        lo, hi = torch.minimum(ta, tb), torch.maximum(ta, tb)
        tmin = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
        tmax = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
        box = (tmin <= tmax) & (tmax >= EPS) & (tmin < best_t[live])
        leaf = leaf_of[cur]
        inner = leaf < 0
        node[live] = torch.where(box & inner, cur + 1, miss_of[cur])
        if work is not None:
            work["visits"] += live.numel()
        test = box & ~inner
        lanes, blk = live[test], leaf[test]
        if lanes.numel() == 0:
            continue
        prim = bvh.blk_prim[blk]  # (m, K)
        oc = o[lanes][:, None, :]
        dc = d[lanes][:, None, :]
        t, ok = _mt(
            (oc[..., 0], oc[..., 1], oc[..., 2]),
            (dc[..., 0], dc[..., 1], dc[..., 2]),
            *(tuple(x[..., c] for c in range(3))
              for x in (bvh.blk_p0[blk], bvh.blk_e1[blk], bvh.blk_e2[blk])),
        )
        t = torch.where(ok & (prim >= 0), t, torch.full_like(t, float("inf")))
        tmin_blk, j = torch.min(t, dim=1)  # the first of equal minima
        upd = tmin_blk < best_t[lanes]
        best_t[lanes] = torch.where(upd, tmin_blk, best_t[lanes])
        jj = j[:, None]
        best_p[lanes] = torch.where(upd, prim.gather(1, jj)[:, 0],
                                    best_p[lanes])
        if want_shade:
            best_m[lanes] = torch.where(
                upd, bvh.blk_mat[blk].gather(1, jj)[:, 0], best_m[lanes])
            best_n[lanes] = torch.where(upd[:, None], bvh.blk_n[blk, j],
                                        best_n[lanes])
        if work is not None:
            work["tests"] += (prim >= 0).sum()
            if work["seen"] is None:
                work["seen"] = torch.zeros(bvh.blk_prim.shape[0], dtype=torch.bool,
                                           device=dev)
            work["seen"][blk] = True
    return (best_t, best_p) + ((best_m, best_n) if want_shade else ())


def _spread3(x):
    """Spread the low 10 bits of x (int64) so bit i lands at bit 3i (Morton
    part1by2; the JAX package's `_spread3` on uint32)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _ray_sort_key(o, d, bvh: Bvh, bits: int = 6):
    """Packet-coherence sort key (int64), bit for bit the JAX package's:
    [direction octant (3 b) | Morton code of the origin's cell (3*bits b)]
    over the root box. Rays that leave one cell in one octant walk nearly
    the same nodes, so a warp of them shares its packet's boxes. The
    quantisation divides by a tensor (IEEE on both devices; see
    ops/sky.py::ibl_texel)."""
    lo = bvh.node_min[0]
    span = torch.clamp(bvh.node_max[0] - lo, min=1e-20)
    q = torch.clamp((o - lo) / span * float(1 << bits), 0.0,
                    float((1 << bits) - 1)).to(torch.int64)
    m = _spread3(q[:, 0]) | (_spread3(q[:, 1]) << 1) | (_spread3(q[:, 2]) << 2)
    octant = ((d[:, 0] > 0).long() * 4 + (d[:, 1] > 0).long() * 2
              + (d[:, 2] > 0).long())
    return (octant << (3 * bits)) | m


def sort_rays(o, d, bvh: Bvh):
    """(perm, inv): `perm` orders the lanes by `_ray_sort_key` (a stable
    sort, as `jnp.argsort` is), and `x[perm][inv]` is x again."""
    perm = torch.argsort(_ray_sort_key(o, d, bvh), stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return perm, inv


def bvh_route(bvh: Bvh, streamed: bool | None = None,
              reorder: bool | None = None) -> tuple[str, bool]:
    """(walk, sort) by the routing rule of this module's docstring: walk
    is "thread" (csrc/bvh.cu), "wide" (`llr_bvh_wide`) or "streamed"
    (`llr_bvh_streamed`, both csrc/bvh_aov.cu). On the card "wide" and
    "streamed" launch the same kernel: between those two, `streamed=` and
    the wide cap only choose its name. `sort` is `reorder is True`."""
    from . import cuda_bvh

    k = bvh.blk_p0.shape[1]
    if streamed:
        if k > 128 or 128 % k:
            raise ValueError(f"the streamed walk takes leaves of a K that "
                             f"divides 128, not {k}")
        walk = "streamed"
    elif k == cuda_bvh.WIDE_K:
        walk = ("wide" if cuda_bvh.wide_admitted(bvh)
                else "thread" if streamed is False else "streamed")
    else:
        walk = "thread"
    return walk, bool(reorder)


def _walk_routed(o, d, t_init, t_stop, bvh: Bvh, want_shade: bool,
                 streamed, reorder):
    """The triangle walk `bvh_route` picks, on the sorted lanes where it
    sorts; the results in the callers' lane order."""
    from . import cuda_bvh

    walk, sort = bvh_route(bvh, streamed, reorder)
    fn = {"thread": cuda_bvh.intersect_tris, "wide": cuda_bvh.intersect_tris_wide,
          "streamed": cuda_bvh.intersect_tris_streamed}[walk]
    tables = cuda_bvh.tables_of(bvh)
    if not sort:
        return fn(o, d, t_init, t_stop, tables, want_shade)
    perm, inv = sort_rays(o.detach(), d.detach(), bvh)
    outs = fn(o[perm], d[perm], t_init[perm], t_stop[perm], tables, want_shade)
    return tuple(x[inv] for x in outs)


def intersect_bvh(o, d, geom: Geometry, bvh: Bvh, want_shade: bool = False,
                  t_cap=None, occlusion: bool = False, plain: bool = False,
                  streamed: bool | None = None, reorder: bool | None = None):
    """Nearest hit through the BVH (the JAX package's `intersect_bvh`
    contract). o,d: (N,3).

    Spheres are folded by brute force first, from `t_cap` (INF when None);
    the triangle walk then keeps a triangle only when it is strictly closer
    than that best. `occlusion=True` lets a lane stop once any hit lies
    below `t_cap - 4*EPS`: such a hit settles a shadow verdict (|t - dist|
    <= EPS with t_cap = dist + 2*EPS) as occluded, so its t need not be the
    nearest. The walk is the one `bvh_route(bvh, streamed, reorder)` picks
    (a kernel for CUDA tensors, its plain version for CPU tensors; each
    differentiable through the plane equation) or, with `plain`, the plain
    walk `_walk_tris` on any device, unsorted.

    Returns Hit, or (Hit, ShadePoint) with `want_shade`."""
    n = o.shape[0]
    nt = geom.tri_p0.shape[0]
    ns = geom.sph_c.shape[0]
    dev = o.device
    cap = (torch.full((n,), INF, dtype=o.dtype, device=dev)
           if t_cap is None else t_cap)
    stop = (cap - 4.0 * EPS if occlusion
            else torch.full((n,), -INF, dtype=o.dtype, device=dev))
    best_t, best_p, best_m, best_f = _fold(o, d, geom, cap, payload=True,
                                           spheres_only=True)
    if nt:
        if plain:
            outs = _walk_tris(o, d, best_t.detach(), stop, bvh, want_shade)
        else:
            outs = _walk_routed(o, d, best_t.detach(), stop, bvh, want_shade,
                                streamed, reorder)
        won = outs[1] >= 0
        best_t = torch.where(won, outs[0], best_t)
        best_p = torch.where(won, outs[1], best_p)
        if want_shade:
            best_m = torch.where(won, outs[2], best_m)
            best_f = torch.where(won[:, None], outs[3], best_f)
    hit, sp = _finish(o, d, nt, ns, best_t, best_p, best_m, best_f)
    return (hit, sp) if want_shade else hit


def _use_brute(geom: Geometry, mode: str, bvh: Bvh | None = None) -> bool:
    """Brute force for `mode="brute"`, and for `"auto"` up to
    BRUTE_MAX_PRIMS prims; the BVH otherwise."""
    del bvh  # the threshold does not depend on the BVH layout here
    if mode == "brute":
        return True
    if mode != "auto":
        return False
    return geom.tri_p0.shape[0] + geom.sph_c.shape[0] <= BRUTE_MAX_PRIMS


def intersect(o, d, geom: Geometry, bvh: Bvh, mode: str = "auto",
              plain: bool = False, streamed: bool | None = None,
              reorder: bool | None = None) -> Hit:
    """Nearest hit: brute force or the BVH, as `_use_brute` picks."""
    if _use_brute(geom, mode, bvh):
        return intersect_brute(o, d, geom)
    return intersect_bvh(o, d, geom, bvh, plain=plain, streamed=streamed,
                         reorder=reorder)


def intersect_shade(o, d, geom: Geometry, bvh: Bvh, mode: str = "auto",
                    t_cap=None, occlusion: bool = False, plain: bool = False,
                    streamed: bool | None = None, reorder: bool | None = None):
    """(Hit, ShadePoint) fused; see `intersect_shade_brute` and
    `intersect_bvh` (brute force ignores `occlusion`: it tests every prim
    either way)."""
    if _use_brute(geom, mode, bvh):
        return intersect_shade_brute(o, d, geom, t_cap=t_cap)
    return intersect_bvh(o, d, geom, bvh, want_shade=True, t_cap=t_cap,
                         occlusion=occlusion, plain=plain, streamed=streamed,
                         reorder=reorder)


def shade_point(o, d, hit: Hit, geom: Geometry) -> ShadePoint:
    """Gather surface data at hit points (the reference's `Intersection`)."""
    nt = geom.tri_p0.shape[0]
    ns = geom.sph_c.shape[0]
    hitmask = hit.prim >= 0
    prim = torch.clamp(hit.prim, min=0)
    is_tri = (prim < nt)[..., None]
    pos = o + d * hit.t[..., None]

    normal = torch.zeros_like(pos)
    mat = torch.full_like(prim, -1)
    if nt:
        tid = torch.clamp(prim, 0, nt - 1)
        normal = torch.where(is_tri, take_rows(geom.tri_n, tid), normal)
        mat = torch.where(is_tri[:, 0], take_rows(geom.tri_mat, tid), mat)
    if ns:
        sid = torch.clamp(prim - nt, 0, ns - 1)
        sn = vec.safe_normalize(pos - take_rows(geom.sph_c, sid))
        normal = torch.where(is_tri, normal, sn)
        mat = torch.where(is_tri[:, 0], mat, take_rows(geom.sph_mat, sid))

    mat = torch.where(hitmask, mat, torch.full_like(mat, -1))
    # Miss lanes get a unit dummy normal so downstream math stays NaN-free.
    normal = torch.where(hitmask[..., None], normal,
                         normal.new_tensor([0.0, 0.0, 1.0]))
    return ShadePoint(position=pos, normal=normal, mat=mat, hit=hitmask)
