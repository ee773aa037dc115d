"""Nearest-triangle queries through the BVH: three hand-written CUDA walks.

* `intersect_tris`: csrc/bvh.cu, one thread per ray with its own cursor
  (the counterpart of the JAX package's `pallas_bvh._kernel`), any K: a
  leaf read up to its last valid slot (`counts`), its rows four slots a
  16-byte load at K = 128, scalar slots at any other K.
* `intersect_tris_wide`: entry `llr_bvh_wide` of csrc/bvh_aov.cu, the AOV
  walk over 128-wide leaves (the counterpart of `pallas_bvh_wide._kernel`),
  K = 128: every ray keeps its own cursor and the warp tests each leaf
  together.
* `intersect_tris_streamed`: entry `llr_bvh_streamed` of the same library,
  the same walk (the counterpart of `pallas_bvh._kernel_streamed`), any K
  dividing 128.

Each is the nearest triangle strictly closer than `t_init` per lane,
stopping a lane once its best t is <= `t_stop`: (t, prim[, mat, n]) with
prim = -1 (t = t_init) where none is. Each launches its kernel for CUDA
tensors and runs the plain walk `ops/intersect.py::_walk_tris` for CPU
tensors (`walk`, the search alone), and is differentiable in o and d
through the plane equation at the detached winner (`plane_t`, the JAX
package's custom VJP, `pallas_bvh.py::_make_diff_fn`,
`pallas_bvh_wide.py::_make_diff_fn`). Each has a bare launch into
preallocated outputs (`*_launch`) and a launch counter (`.launches`),
raised by that launch and nowhere else.

`pack_bvh(bvh)` builds the kernels' tables from a `Bvh`; `tables_of(bvh)`
packs once per Bvh object and keeps the result on it. `wide_admitted(bvh)`
is the routing's "admitted as wide" (`ops/intersect.py::bvh_route`).
"""

from __future__ import annotations

import torch

from ..scene.data import Bvh
from . import cuda_build
from .intersect import _walk_tris


def pack_bvh(bvh: Bvh) -> dict:
    """The kernel's tables (layouts in csrc/bvh_walk.cuh), on the BVH's
    device: nodes (N, 8) float32 [min3 | max3 | miss | leaf]; leaves
    (L, 12, K) float32, component-major (p0, e1, e2, n); ids (L, 2, K) int32
    (prim, mat); counts (L,) int32, each leaf's last slot with prim >= 0
    plus one (0 for a leaf of padding only), computed from blk_prim so that
    padding inside a leaf stays possible; tri_n (T, 3), each prim's face
    normal for the backward pass; k; and the Bvh itself for the plain
    walk."""
    f32 = torch.float32
    nodes = torch.cat([bvh.node_min, bvh.node_max,
                       bvh.node_miss.to(f32)[:, None],
                       bvh.node_leaf.to(f32)[:, None]], dim=1).contiguous()
    leaves = torch.cat([bvh.blk_p0, bvh.blk_e1, bvh.blk_e2, bvh.blk_n],
                       dim=2).transpose(1, 2).contiguous()
    ids = torch.stack([bvh.blk_prim, bvh.blk_mat], dim=1).to(torch.int32)
    valid = bvh.blk_prim >= 0
    k = bvh.blk_p0.shape[1]
    slot = torch.arange(1, k + 1, dtype=torch.int32, device=valid.device)
    counts = torch.where(valid, slot, torch.zeros_like(slot)).amax(dim=1)
    prim = bvh.blk_prim[valid].long()
    n_tris = int(prim.max()) + 1 if prim.numel() else 0
    tri_n = torch.zeros((n_tris, 3), dtype=f32, device=nodes.device)
    tri_n[prim] = bvh.blk_n[valid]
    return dict(nodes=nodes, leaves=leaves, ids=ids.contiguous(),
                counts=counts.contiguous(), tri_n=tri_n, k=k, bvh=bvh)


def tables_of(bvh: Bvh) -> dict:
    """`pack_bvh(bvh)`, packed at the first call and kept on `bvh`."""
    tables = getattr(bvh, "_kernel_tables", None)
    if tables is None:
        tables = pack_bvh(bvh)
        bvh._kernel_tables = tables
    return tables


WIDE_K = 128
# The JAX package's cap on the wide kernel's VMEM-resident tables
# (`pallas_bvh_wide.WIDE_VMEM_BYTES`), kept so that a scene takes the same
# walk in both packages. It is that package's routing on its TPU, not a
# property of the H100; chip_smoke.py times both AOV walks on both
# terrains so that the card's own boundary can be set.
WIDE_TABLE_BYTES = 96 * 1024 * 1024


def wide_table_bytes(bvh: Bvh) -> int:
    """The JAX package's `pallas_bvh_wide.table_vmem_bytes` of this BVH: its
    chunk-major node table (8 rows of 128 nodes per chunk) and its leaf and
    id tables (12 and 2 rows of 128 per leaf, each with 8 rows of tail
    padding), in bytes."""
    nn, nl = bvh.node_min.shape[0], bvh.blk_p0.shape[0]
    return (-(-nn // 128) * 8 + (nl * 12 + 8) + (nl * 2 + 8)) * 128 * 4


def wide_admitted(bvh: Bvh) -> bool:
    """A K=128 BVH whose wide tables fit WIDE_TABLE_BYTES (the JAX package's
    `pallas_bvh_wide.supported`)."""
    return (bvh.blk_p0.shape[1] == WIDE_K
            and wide_table_bytes(bvh) <= WIDE_TABLE_BYTES)


_WALKS = {"bvh": "BVH", "bvh_wide": "wide BVH", "bvh_streamed": "streamed BVH"}
# entry -> the library that exports it (ops/cuda_build.py::SOURCES).
_LIBS = {"bvh": "bvh", "bvh_wide": "bvh_aov", "bvh_streamed": "bvh_aov"}


def _launch(name: str, o, d, t_init, t_stop, tables: dict, out):
    """Check the rays, outputs and tables, and launch `llr_<name>`."""
    what = _WALKS[name]
    n = o.shape[0]
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"the {what} kernel takes CUDA tensors, not {dev}")
    if n >= 2**31:
        raise ValueError(f"{n} lanes do not fit the kernel's int32 lane index")
    want_shade = len(out) == 4
    specs = [("o", o, (n, 3), torch.float32), ("d", d, (n, 3), torch.float32),
             ("t_init", t_init, (n,), torch.float32),
             ("t_stop", t_stop, (n,), torch.float32),
             ("t", out[0], (n,), torch.float32),
             ("prim", out[1], (n,), torch.int32)]
    if want_shade:
        specs += [("mat", out[2], (n,), torch.int32),
                  ("n", out[3], (n, 3), torch.float32)]
    elif len(out) != 2:
        raise ValueError("out is (t, prim) or (t, prim, mat, n)")
    k = tables["k"]
    if name == "bvh_wide" and k != WIDE_K:
        raise ValueError(f"the wide BVH kernel takes {WIDE_K}-wide leaves, not {k}")
    if name == "bvh_streamed" and (k > 128 or 128 % k):
        raise ValueError(f"the streamed BVH kernel takes leaves of a K that "
                         f"divides 128, not {k}")
    nodes, leaves, ids = tables["nodes"], tables["leaves"], tables["ids"]
    specs += [("nodes", nodes, (nodes.shape[0], 8), torch.float32),
              ("leaves", leaves, (leaves.shape[0], 12, k), torch.float32),
              ("ids", ids, (leaves.shape[0], 2, k), torch.int32)]
    counts = []
    if name == "bvh":
        specs.append(("counts", tables["counts"], (leaves.shape[0],), torch.int32))
        counts = [cuda_build.ptr(tables["counts"])]
    for arg, t, shape, dtype in specs:
        if (t.shape != shape or t.dtype != dtype or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"{arg} must be a contiguous {shape} {dtype} "
                             f"tensor on {dev}")
    # Node rows are read as two float4s, leaf and id rows as float4 / int4
    # groups of slots: misaligned tables raise, nothing falls back.
    if any(t.data_ptr() % 16 for t in (nodes, leaves, ids)):
        raise ValueError("the BVH tables must be 16-byte aligned")
    rc = cuda_build.fn(_LIBS[name], f"llr_{name}")(
        cuda_build.ptr(o), cuda_build.ptr(d), cuda_build.ptr(t_init),
        cuda_build.ptr(t_stop), cuda_build.ptr(nodes), cuda_build.ptr(leaves),
        cuda_build.ptr(ids), *counts, k, n, cuda_build.ptr(out[0]),
        cuda_build.ptr(out[1]),
        cuda_build.ptr(out[2]) if want_shade else None,
        cuda_build.ptr(out[3]) if want_shade else None,
        cuda_build.stream(),
    )
    cuda_build.check(rc, what)


def intersect_tris_launch(o, d, t_init, t_stop, tables: dict, out):
    """The per-thread kernel (csrc/bvh.cu) alone: reads o, d (n,3), t_init,
    t_stop (n,) float32 and writes `out` = (t (n,) float32, prim (n,)
    int32) or, for the shade query, (t, prim, mat (n,) int32, n (n,3)
    float32), all contiguous on one CUDA device. `intersect_tris`
    allocates these; this is the launch it counts."""
    _launch("bvh", o, d, t_init, t_stop, tables, out)
    intersect_tris.launches += 1


def intersect_tris_wide_launch(o, d, t_init, t_stop, tables: dict, out):
    """The wide kernel (`llr_bvh_wide`, csrc/bvh_aov.cu) alone, as
    `intersect_tris_launch`; K must be 128."""
    _launch("bvh_wide", o, d, t_init, t_stop, tables, out)
    intersect_tris_wide.launches += 1


def intersect_tris_streamed_launch(o, d, t_init, t_stop, tables: dict, out):
    """The streamed kernel (`llr_bvh_streamed`, csrc/bvh_aov.cu) alone, as
    `intersect_tris_launch`; K must divide 128."""
    _launch("bvh_streamed", o, d, t_init, t_stop, tables, out)
    intersect_tris_streamed.launches += 1


_LAUNCH = {"bvh": intersect_tris_launch, "bvh_wide": intersect_tris_wide_launch,
           "bvh_streamed": intersect_tris_streamed_launch}


def walk(name: str, o, d, t_init, t_stop, tables: dict, want_shade: bool):
    """The search alone, with no gradient: `llr_<name>` ("bvh", "bvh_wide"
    or "bvh_streamed") for CUDA tensors, the plain walk `_walk_tris` for
    CPU ones: (t, prim[, mat, n])."""
    if o.device.type == "cpu":
        return _walk_tris(o, d, t_init, t_stop, tables["bvh"], want_shade)
    n, dev = o.shape[0], o.device
    out = (torch.empty(n, dtype=torch.float32, device=dev),
           torch.empty(n, dtype=torch.int32, device=dev))
    if want_shade:
        out += (torch.empty(n, dtype=torch.int32, device=dev),
                torch.empty((n, 3), dtype=torch.float32, device=dev))
    _LAUNCH[name](o.contiguous(), d.contiguous(), t_init.contiguous(),
                  t_stop.contiguous(), tables, out)
    return out


class _PlaneT(torch.autograd.Function):
    """A walk's t, differentiable through the plane equation of the
    winner, t = ((p0 - o) . n) / (d . n): dt/do = -n / (d . n), dt/dd = -t n
    / (d . n), zero on lanes no triangle won (`won` false; an unasked
    query's t of -inf included) and where |d . n| <= 1e-20 (the JAX
    package's custom VJP). `n` (N, 3) is each lane's winning face normal."""

    @staticmethod
    def forward(ctx, o, d, t, won, n):
        ctx.save_for_backward(d, t, won, n)
        return t

    @staticmethod
    def backward(ctx, g_t):
        d, t, won, nrm = ctx.saved_tensors
        dn = (d * nrm).sum(dim=-1)
        safe = won & (torch.abs(dn) > 1e-20)
        inv = torch.where(safe, 1.0 / torch.where(safe, dn, torch.ones_like(dn)),
                          torch.zeros_like(dn))
        o_bar = (-g_t * inv)[..., None] * nrm
        # A lane whose query was not asked keeps t_init = -inf: 0 * -inf
        # would put NaN into its zero cotangent.
        d_bar = (-g_t * torch.where(safe, t, torch.zeros_like(t)) * inv)[..., None] * nrm
        return o_bar, d_bar, None, None, None


def plane_t(o, d, t, won, n):
    """`t` (a walk's, detached) as a function of o and d through the plane
    equation of each lane's winning triangle (`won`, its face normal `n`);
    see `_PlaneT`."""
    return _PlaneT.apply(o, d, t, won, n)


def _walk_diff(name, o, d, t_init, t_stop, tables: dict, want_shade: bool):
    with torch.no_grad():
        outs = walk(name, o, d, t_init, t_stop, tables, want_shade)
    won = outs[1] >= 0
    nrm = tables["tri_n"][torch.clamp(outs[1], min=0).long()]
    return (plane_t(o, d, outs[0], won, nrm),) + tuple(outs[1:])


def intersect_tris(o, d, t_init, t_stop, tables: dict, want_shade: bool = False):
    """Nearest triangle strictly closer than `t_init` per lane, stopping a
    lane once its best t is <= `t_stop`: (t, prim) or, with `want_shade`,
    (t, prim, mat, n (N,3)). Launches the per-thread kernel for CUDA
    tensors (with `tables` from `pack_bvh`); the plain walk for CPU
    tensors. t is differentiable in o and d (`plane_t`)."""
    return _walk_diff("bvh", o, d, t_init, t_stop, tables, want_shade)


def intersect_tris_wide(o, d, t_init, t_stop, tables: dict, want_shade: bool = False):
    """`intersect_tris` through the wide kernel (K = 128)."""
    return _walk_diff("bvh_wide", o, d, t_init, t_stop, tables, want_shade)


def intersect_tris_streamed(o, d, t_init, t_stop, tables: dict,
                            want_shade: bool = False):
    """`intersect_tris` through the streamed kernel (K divides 128)."""
    return _walk_diff("bvh_streamed", o, d, t_init, t_stop, tables, want_shade)


intersect_tris.launches = 0
intersect_tris_wide.launches = 0
intersect_tris_streamed.launches = 0
