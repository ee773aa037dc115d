"""Ray-scene intersection over SoA geometry: brute force and the BVH walk.

Parity: Möller-Trumbore triangles (`triangle.rs:69-100`), quadratic spheres
(`sphere.rs:42-63`), both with the reference's exact EPS semantics
(t < EPS -> miss, |det| < EPS -> miss).

Every query is two halves: `search` finds each ray's winner with no
gradient (`Found`: its t, prim and material), and `evaluate` re-derives
the winner's t, position and normal from its prim, differentiable in the
rays, by the same test that found it. The `isect` recompute policies keep
the first half's result and run only the second again
(integrator/wavefront.py::Remat).

Brute force streams the prim table in chunks (`_fold`): every chunk is one
dense (C, N) test, its first minimum is folded into the running best with
a strict `<`. That is the same winner as a sequential walk over the
triangles in ascending order and then the spheres in ascending order.

The BVH follows the JAX package's contract: a brute sphere pre-pass
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
the walk, None and False do not, unless `LLR_REORDER` is "1" or "0"
(`reorder_of`, the JAX package's packet-walk precedence on every route).
`LLR_PALLAS=0` leaves the routing as it is (the port has no other walk)
and refuses `intersector="pallas"` (`check_pallas`). The sort changes
only the order in which lanes are walked, never a lane's result. The JAX package sorts by default
before its packet walks; the port's walks give each ray its own cursor,
and on an H100 the sort of 2M rays costs more than it saves before any of
them (PERF.md §6.1-6.9, §6.11).
"""

from __future__ import annotations

import contextlib
import os
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


def _sph(o3, d3, c3, r):
    """The sphere test on broadcastable components (o3, d3, c3 are (x, y,
    z) tuples, r the radii): (t, ok). Note the reference's asymmetric
    comparisons: triangles miss at t < EPS, spheres select `t1 > EPS`."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    cx, cy, cz = c3
    cox, coy, coz = ox - cx, oy - cy, oz - cz
    cod = cox * dx + coy * dy + coz * dz
    det = _fma(cod, cod, -(cox * cox + coy * coy + coz * coz)) + r * r
    sq = vec.sqrt(torch.where(det > 0.0, det, torch.ones_like(det)))
    t1 = -cod - sq
    t2 = -cod + sq
    t = torch.where(t1 > EPS, t1, t2)
    return t, (det > 0.0) & (t > EPS)


def _sph_t(o, d, c, r):
    """Sphere test of rays o,d (N,3) against centers c (C,3), radii r (C,)
    -> t (C, N) with misses as +INF."""
    t, ok = _sph(_rows(o), _rows(d), _cols(c), r[:, None])
    return torch.where(ok, t, torch.full_like(t, INF))


def _fold(o, d, geom: Geometry, best_t, spheres_only=False):
    """Fold every prim (or every sphere) into the running best t: (best_t,
    best_p, best_m), the winner's t, prim id and material row, with prim
    and material -1 where nothing beat the initial best_t."""
    n = o.shape[0]
    nt = geom.tri_p0.shape[0]
    ns = geom.sph_c.shape[0]
    dev = o.device
    best_p = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_m = torch.full((n,), -1, dtype=torch.int32, device=dev)

    def merge(t, base, mat):
        nonlocal best_t, best_p, best_m
        tmin, j = torch.min(t, dim=0)
        upd = tmin < best_t
        best_t = torch.where(upd, tmin, best_t)
        best_p = torch.where(upd, (j + base).to(torch.int32), best_p)
        best_m = torch.where(upd, mat[j], best_m)

    if not spheres_only:
        for s in range(0, nt, CHUNK):
            sl = slice(s, min(s + CHUNK, nt))
            merge(_tri_t(o, d, geom.tri_p0[sl], geom.tri_e1[sl], geom.tri_e2[sl]), s,
                  geom.tri_mat[sl])
    for s in range(0, ns, CHUNK):
        sl = slice(s, min(s + CHUNK, ns))
        merge(_sph_t(o, d, geom.sph_c[sl], geom.sph_r[sl]), nt + s, geom.sph_mat[sl])
    return best_t, best_p, best_m


def _sphere_brute(o, d, geom: Geometry, best_t, best_p):
    """Fold all spheres into the running (best_t, best_p)."""
    t, p, _ = _fold(o, d, geom, best_t, spheres_only=True)
    return t, torch.where(p >= 0, p, best_p)


def intersect_brute(o, d, geom: Geometry) -> Hit:
    """Nearest hit over the whole prim table. o,d: (N,3)."""
    return intersect(o, d, geom, None, "brute")


def intersect_shade_brute(o, d, geom: Geometry, t_cap=None):
    """Nearest hit plus the winner's shade attributes. o,d: (N,3).

    `t_cap` (N,) caps the search: hits at t >= t_cap are misses (and the
    returned t is then t_cap). Returns (Hit, ShadePoint), the same as
    `intersect_brute` followed by `shade_point`."""
    return intersect_shade(o, d, geom, None, "brute", t_cap=t_cap)


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


def _walk_tris(o, d, t_init, t_stop, bvh: Bvh, want_shade: bool, want_slot: bool = False):
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

    Returns (t, prim[, mat, n (N,3)][, slot]): prim = -1 and t = t_init
    where no triangle beat t_init; with `want_slot`, the winner's leaf slot
    (leaf * K + slot, int64; -1 where none), the row `evaluate` re-derives
    it from. Inside `count_work()` the walk adds its node visits and
    triangle tests to the open count.
    """
    n = o.shape[0]
    dev = o.device
    inv = 1.0 / d
    best_t = t_init.clone()
    best_p = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_m = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_n = torch.zeros((n, 3), dtype=o.dtype, device=dev)
    best_s = torch.full((n,), -1, dtype=torch.int64, device=dev)
    k = bvh.blk_prim.shape[1]
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
        if want_slot:
            best_s[lanes] = torch.where(upd, blk * k + j, best_s[lanes])
        if work is not None:
            work["tests"] += (prim >= 0).sum()
            if work["seen"] is None:
                work["seen"] = torch.zeros(bvh.blk_prim.shape[0], dtype=torch.bool,
                                           device=dev)
            work["seen"][blk] = True
    return ((best_t, best_p) + ((best_m, best_n) if want_shade else ())
            + ((best_s,) if want_slot else ()))


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


def reorder_of(reorder: bool | None) -> bool:
    """Whether a walk sorts its rays, by the JAX package's packet-walk
    precedence (`lumillyrender_tpu/ops/intersect.py:445-449`), read at call
    time: `LLR_REORDER` "0" or "1" first, then the `reorder` argument, then
    the port's default, no sort."""
    env = os.environ.get("LLR_REORDER", "auto")
    if env in ("0", "1"):
        return env == "1"
    return bool(reorder)


def bvh_route(bvh: Bvh, streamed: bool | None = None,
              reorder: bool | None = None) -> tuple[str, bool]:
    """(walk, sort) by the routing rule of this module's docstring: walk
    is "thread" (csrc/bvh.cu), "wide" (`llr_bvh_wide`) or "streamed"
    (`llr_bvh_streamed`, both csrc/bvh_aov.cu). On the card "wide" and
    "streamed" launch the same kernel: between those two, `streamed=` and
    the wide cap only choose its name. `sort` is `reorder_of(reorder)`."""
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
    return walk, reorder_of(reorder)


_ENTRY = {"thread": "bvh", "wide": "bvh_wide", "streamed": "bvh_streamed"}


def _walk_routed(o, d, t_init, t_stop, bvh: Bvh, want_shade: bool,
                 streamed, reorder):
    """The triangle walk `bvh_route` picks (`cuda_bvh.walk`, no gradient),
    on the sorted lanes where it sorts; the results in the callers' lane
    order."""
    from . import cuda_bvh

    walk, sort = bvh_route(bvh, streamed, reorder)
    tables = cuda_bvh.tables_of(bvh)
    if not sort:
        return cuda_bvh.walk(_ENTRY[walk], o, d, t_init, t_stop, tables, want_shade)
    perm, inv = sort_rays(o, d, bvh)
    outs = cuda_bvh.walk(_ENTRY[walk], o[perm], d[perm], t_init[perm], t_stop[perm],
                         tables, want_shade)
    return tuple(x[inv] for x in outs)


class Found(NamedTuple):
    """What a query's search found, with no gradient: the winner's t as
    the search computed it (the query's cap where nothing won), its prim
    id (triangles 0..T-1, spheres T + j, -1 where nothing won), its
    material row (-1 where nothing won, and on a BVH walk's triangles
    when the search was not asked for shading), and for a triangle its
    face normal as the search read it (zero otherwise) and the row it was
    tested from (`row`: the geometry's triangle under brute force, the
    BVH's leaf slot, leaf * K + slot, under the plain walk; -1 otherwise,
    and under a walk kernel, whose t is differentiated through the plane
    equation and needs no row)."""

    t: torch.Tensor  # (N,) float32
    prim: torch.Tensor  # (N,) int32
    mat: torch.Tensor  # (N,) int32
    n: torch.Tensor  # (N, 3) float32
    row: torch.Tensor  # (N,) int32


def _use_brute(geom: Geometry, mode: str, bvh: Bvh | None = None) -> bool:
    """Brute force for `mode="brute"`, and for `"auto"` up to
    BRUTE_MAX_PRIMS prims; the BVH otherwise ("bvh" and "pallas")."""
    del bvh  # the threshold does not depend on the BVH layout here
    if mode == "brute":
        return True
    if mode != "auto":
        return False
    return geom.tri_p0.shape[0] + geom.sph_c.shape[0] <= BRUTE_MAX_PRIMS


def pallas_enabled() -> bool:
    """False under `LLR_PALLAS=0`, read at call time: the JAX package then
    has no Pallas walk, so it refuses `intersector="pallas"` and its BVH
    scenes take the plain step (`cuda_bounce.step_mode`). The port has no
    second walk, so its routing (`bvh_route`) stays as it is: kernel 3 or
    7, the same nearest hit as the JAX package's XLA walk."""
    return os.environ.get("LLR_PALLAS", "1") != "0"


def check_pallas(bvh: Bvh):
    """Raise unless a walk kernel serves `bvh`'s leaves (a K that divides
    128), and under `LLR_PALLAS=0`, as the JAX package refuses a forced
    "pallas" intersector on a layout its kernels do not serve or with its
    Pallas walks turned off."""
    if not pallas_enabled():
        raise ValueError("intersector 'pallas' asks for a BVH walk kernel, and LLR_PALLAS=0 "
                         "turns them off; use 'auto' or 'bvh', or unset LLR_PALLAS")
    k = bvh.blk_p0.shape[1]
    if k > 128 or 128 % k:
        raise ValueError(f"intersector 'pallas' asks for a BVH walk kernel, and none "
                         f"serves leaves of K={k} (K must divide 128); use 'auto'")


def search(o, d, geom: Geometry, bvh: Bvh | None, mode: str = "auto", t_cap=None,
           occlusion: bool = False, plain: bool = False, streamed: bool | None = None,
           reorder: bool | None = None, want_shade: bool = True) -> Found:
    """The nearest hit of each ray o,d (N,3), found with no gradient:
    brute force or the BVH, as `_use_brute(geom, mode)` picks.

    The BVH follows the JAX package's `intersect_bvh` contract: the spheres
    are folded by brute force first, from `t_cap` (INF when None); the
    triangle walk then keeps a triangle only when it is strictly closer.
    `occlusion=True` lets a lane stop once any hit lies below `t_cap -
    4*EPS`: such a hit settles a shadow verdict (|t - dist| <= EPS with
    t_cap = dist + 2*EPS) as occluded, so its t need not be the nearest
    (brute force tests every prim either way). The walk is the one
    `bvh_route(bvh, streamed, reorder)` picks (a kernel for CUDA tensors,
    its plain version for CPU tensors) or, with `plain`, the plain walk
    `_walk_tris` on any device, unsorted. `mode="pallas"` is the routed
    walk whatever `plain` says: it raises for CPU tensors, where no kernel
    runs, and for leaves no walk kernel serves (`check_pallas`)."""
    n = o.shape[0]
    nt = geom.tri_p0.shape[0]
    dev = o.device
    if mode == "pallas":
        check_pallas(bvh)
        if dev.type != "cuda":
            raise ValueError("intersector 'pallas' runs the BVH walk kernels, which take "
                             f"CUDA tensors, not {dev}; use 'bvh' or 'auto' off the card")
        plain = False
    with torch.no_grad():
        cap = (torch.full((n,), INF, dtype=o.dtype, device=dev)
               if t_cap is None else t_cap.detach())
        if _use_brute(geom, mode, bvh):
            t, prim, mat = _fold(o, d, geom, cap)
            tri = (prim >= 0) & (prim < nt)
            nrm = take_rows(geom.tri_n, prim) if nt else torch.zeros_like(o)
            return Found(t, prim, mat, torch.where(tri[:, None], nrm, torch.zeros_like(nrm)),
                         torch.where(tri, prim, -1))
        t, prim, mat = _fold(o, d, geom, cap, spheres_only=True)
        nrm = torch.zeros_like(o)
        row = torch.full((n,), -1, dtype=torch.int32, device=dev)
        if nt:
            stop = (cap - 4.0 * EPS if occlusion
                    else torch.full((n,), -INF, dtype=o.dtype, device=dev))
            if plain:
                t_w, p_w, m_w, face, slot = _walk_tris(o, d, t, stop, bvh, True,
                                                       want_slot=True)
                slot = slot.to(torch.int32)
            else:
                from . import cuda_bvh

                outs = _walk_routed(o, d, t, stop, bvh, want_shade, streamed, reorder)
                t_w, p_w = outs[:2]
                m_w = outs[2] if want_shade else torch.full_like(mat, -1)
                face = (outs[3] if want_shade
                        else take_rows(cuda_bvh.tables_of(bvh)["tri_n"], p_w))
                slot = row
            won = p_w >= 0
            t = torch.where(won, t_w, t)
            prim = torch.where(won, p_w, prim)
            mat = torch.where(won, m_w, mat)
            nrm = torch.where(won[:, None], face, nrm)
            row = torch.where(won, slot, row)
        return Found(t, prim, mat, nrm, row)


def _xyz(a):
    """(N, 3) -> its three (N,) columns."""
    return a[:, 0], a[:, 1], a[:, 2]


def evaluate(o, d, geom: Geometry, found: Found, t_cap=None, plane: bool = False,
             want_shade: bool = True, bvh: Bvh | None = None):
    """The differentiable half of a query: (Hit, ShadePoint), or the Hit
    alone without `want_shade`, from its search's `found`, as functions of
    o, d and t_cap. Only the search is left out: the winner's t is
    re-derived from its prim by the test that found it, on the row it
    tested (`found.row` of the BVH's leaf rows where `bvh` is given, of the
    geometry's triangles otherwise), so it has the search's value and the
    gradient of the test. A triangle's is Moller-Trumbore (brute force and
    the plain walk) or, with `plane`, the plane-equation VJP of the BVH
    walk kernels (`cuda_bvh.plane_t`, the JAX package's custom VJP, on the
    face normal the search read), which keeps the search's t; a sphere's
    is its quadratic, and its normal follows the position. Where nothing won,
    t is `t_cap` (INF where None), and a lane whose query was not asked
    (cap -inf) gets its origin as position: o + d * -inf would put inf or
    NaN into the backward pass of every masked use of it."""
    nt = geom.tri_p0.shape[0]
    ns = geom.sph_c.shape[0]
    prim = found.prim
    t = found.t if t_cap is None else t_cap
    if nt:
        if bvh is None:
            tris = dict(p0=geom.tri_p0, e1=geom.tri_e1, e2=geom.tri_e2)
        else:
            tris = {k: getattr(bvh, f"blk_{k}").reshape(-1, 3) for k in ("p0", "e1", "e2")}
        tri = (prim >= 0) & (prim < nt)
        if plane:
            from . import cuda_bvh

            t_tri = cuda_bvh.plane_t(o, d, found.t, tri, found.n)
        else:
            t_tri, _ = _mt(_xyz(o), _xyz(d), *(_xyz(take_rows(tris[k], found.row))
                                               for k in ("p0", "e1", "e2")))
        t = torch.where(tri, t_tri, t)
    if ns:
        sph = prim >= nt
        c = take_rows(geom.sph_c, prim - nt)
        t_sph, _ = _sph(_xyz(o), _xyz(d), _xyz(c), take_rows(geom.sph_r, prim - nt))
        t = torch.where(sph, t_sph, t)
    hit = Hit(t=t, prim=prim)
    if not want_shade:
        return hit
    hitmask = prim >= 0
    t_pos = torch.where(torch.isfinite(t), t, torch.zeros_like(t))
    pos = o + d * t_pos[..., None]
    normal = found.n
    if ns:
        normal = torch.where(sph[..., None], vec.safe_normalize(pos - c), normal)
    normal = torch.where(hitmask[..., None], normal, vec.unit(2, normal))
    return hit, ShadePoint(position=pos, normal=normal, mat=found.mat, hit=hitmask)


def _evaluation(geom: Geometry, mode: str, bvh, plain: bool) -> dict:
    """`evaluate`'s `bvh` and `plane` for a query that `search` ran with
    these arguments: brute force re-derives its winner from the geometry's
    rows, the plain walk from the BVH's, a walk kernel through the plane
    equation."""
    if _use_brute(geom, mode, bvh):
        return dict(bvh=None, plane=False)
    return dict(bvh=bvh, plane=mode == "pallas" or not plain)


def intersect_bvh(o, d, geom: Geometry, bvh: Bvh, want_shade: bool = False,
                  t_cap=None, occlusion: bool = False, plain: bool = False,
                  streamed: bool | None = None, reorder: bool | None = None):
    """Nearest hit through the BVH (the JAX package's `intersect_bvh`
    contract, `search` with mode "bvh"), differentiable as `evaluate`.
    Returns Hit, or (Hit, ShadePoint) with `want_shade`."""
    found = search(o, d, geom, bvh, "bvh", t_cap, occlusion, plain, streamed, reorder,
                   want_shade)
    return evaluate(o, d, geom, found, t_cap, want_shade=want_shade,
                    **_evaluation(geom, "bvh", bvh, plain))


def intersect(o, d, geom: Geometry, bvh: Bvh, mode: str = "auto",
              plain: bool = False, streamed: bool | None = None,
              reorder: bool | None = None) -> Hit:
    """Nearest hit: brute force or the BVH, as `_use_brute` picks."""
    found = search(o, d, geom, bvh, mode, plain=plain, streamed=streamed, reorder=reorder,
                   want_shade=False)
    return evaluate(o, d, geom, found, want_shade=False,
                    **_evaluation(geom, mode, bvh, plain))


def intersect_shade(o, d, geom: Geometry, bvh: Bvh, mode: str = "auto",
                    t_cap=None, occlusion: bool = False, plain: bool = False,
                    streamed: bool | None = None, reorder: bool | None = None,
                    keep=None):
    """(Hit, ShadePoint): `search`, then `evaluate`. `keep(find)`, where
    given, runs the search `find()` or hands back what it found before
    (the `isect` recompute policies, integrator/wavefront.py::Remat)."""
    def find():
        return search(o, d, geom, bvh, mode, t_cap, occlusion, plain, streamed, reorder)

    found = find() if keep is None else keep(find)
    return evaluate(o, d, geom, found, t_cap, **_evaluation(geom, mode, bvh, plain))


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
    normal = torch.where(hitmask[..., None], normal, vec.unit(2, normal))
    return ShadePoint(position=pos, normal=normal, mat=mat, hit=hitmask)
