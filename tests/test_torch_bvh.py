"""The port's BVH path against the JAX package's, on the CPU.

* `intersect_bvh` (the plain walk) against the JAX package's XLA walk, its
  packet kernel (`pallas_bvh._kernel`, interpret mode) and brute force, on
  tests/test_pallas.py's random scene (257 triangles, 4 spheres) with 32-
  and 8-wide leaves: prims equal except on stated tie lanes, t within 1e-5
  relative, material and normal where the prims agree; `t_cap`/occlusion
  verdicts; origins on box planes (the slab test's 0 * inf); the gradient
  of t in o and d against `jax.grad`.
* The plain bounce step on the ~9k-triangle terrain scene
  (tests/test_fused_bvh.py's, built with the port's own terrain generator)
  against the JAX package's XLA step and one bounce of its TPU kernel
  `make_step_bvh` (interpret mode), under tests/test_fused_bounce.py's
  lane rules.
* Ties inside a leaf: three identical triangles in slots of one lane's
  rounds or of different lanes of the BVH bounce's warp walk (TIE_LAYOUTS
  of tests/torch_tie_leaves.py); the plain walk and the JAX package's walk
  both keep the first slot's prim, material and normal.
* Each leaf's valid count (`cuda_bvh.pack_bvh`'s `counts`, where the
  per-thread kernel stops reading a leaf): the native and the numpy SAH
  builders, leaves with padding inside and at the end, and the plain
  walk's result, which nothing stored past a leaf's count changes.
The CUDA kernels against these plain versions: tests/test_torch_cuda.py.
"""

import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumillyrender_tpu.accel.pack import _pack_kernel_tables
from lumillyrender_tpu.accel.pack import build_tri_bvh as jax_build_bvh
from lumillyrender_tpu.integrator.wavefront import make_bounce_step as jax_step
from lumillyrender_tpu.ops import intersect as jax_isect
from lumillyrender_tpu.ops import pallas_bounce
from lumillyrender_tpu.scene.compiler import compile_scene as jax_compile_scene
from lumillyrender_tpu.scene.data import Bvh as JaxBvh
from lumillyrender_tpu.scene.data import Geometry as JaxGeometry
from lumillyrender_tpu.scene.loader import parse_config as jax_parse
from lumillyrender_tpu_torch.accel.pack import build_tri_bvh
from lumillyrender_tpu_torch.constants import EPS
from lumillyrender_tpu_torch.convert import (
    scene_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from lumillyrender_tpu_torch.integrator import wavefront
from lumillyrender_tpu_torch.ops import cuda_bounce, cuda_bvh
from lumillyrender_tpu_torch.ops.intersect import (
    _tri_t,
    _walk_tris,
    intersect_bvh,
    intersect_shade_brute,
)
from lumillyrender_tpu_torch.scene import terrain
from lumillyrender_tpu_torch.scene.data import Bvh, Geometry, tensor_of
from test_fused_bounce import _assert_states_close, _mk_state, _random_state
from test_pallas import _rays, _scene
from torch_tie_leaves import TIE_LAYOUTS, tie_bvh, tie_rays, with_live_padding

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SEED = 7
BOUNCES = (0, 3, 7, 70)


def _pair(seed, k, tris=257, spheres=4):
    """The random scene as (JAX geometry, JAX Bvh, port geometry, port Bvh),
    both BVHs from the JAX package's builder."""
    geom, (p0, e1, e2, nrm, tmat) = _scene(seed=seed, tris=tris, spheres=spheres)
    arrays = jax_build_bvh(p0, e1, e2, tri_n=nrm, tri_mat=tmat, max_leaf=k)
    jbvh = JaxBvh(**{n: jnp.asarray(v) for n, v in arrays.items()})
    pgeom = Geometry(**{f: tensor_of(np.asarray(getattr(geom, f)))
                        for f in Geometry.__dataclass_fields__})
    pbvh = Bvh(**{f: tensor_of(arrays[f]) for f in Bvh.__dataclass_fields__})
    return geom, jbvh, pgeom, pbvh


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_hits_agree(ref, got, tag):
    """prim equal except where the two t agree within 1e-5 relative (a tie
    between equidistant prims); t within 1e-5 relative everywhere; material
    and normal equal where the prims are."""
    (h_r, sp_r), (h_g, sp_g) = ref, got
    t_r, t_g = _np(h_r.t), _np(h_g.t)
    p_r, p_g = _np(h_r.prim), _np(h_g.prim)
    rel = np.abs(t_r - t_g) / np.maximum(np.abs(t_r), 1.0)
    assert rel.max() <= 1e-5, f"{tag}: t rel {rel.max():.2e}"
    same = p_r == p_g
    assert np.all(same | (rel <= 1e-5)), f"{tag}: {int((~same).sum())} prim flips"
    assert (~same).mean() < 0.01, f"{tag}: {int((~same).sum())} tie lanes"
    np.testing.assert_array_equal(_np(sp_g.mat)[same], _np(sp_r.mat)[same])
    nd = np.abs(_np(sp_g.normal) - _np(sp_r.normal)).max(axis=1)[same]
    assert nd.max(initial=0.0) < 1e-5, f"{tag}: normal {nd.max():.2e}"
    return same


@pytest.mark.parametrize("k", [32, 8])
def test_plain_walk_matches_jax(k):
    """The port's plain walk against the JAX XLA walk, the JAX packet kernel
    (interpret mode) and brute force. On this scene every lane agrees on
    the prim; the spheres win ties in the BVH contract, triangles in brute
    force, which the tie rule covers."""
    geom, jbvh, pgeom, pbvh = _pair(0, k)
    o, d = _rays(1500)
    got = intersect_bvh(_t(o), _t(d), pgeom, pbvh, want_shade=True)
    walk = jax_isect.intersect_bvh(o, d, geom, jbvh, want_shade=True)
    packet = jax_isect.intersect_bvh(o, d, geom, jbvh, want_shade=True,
                                     use_pallas=True, pallas_interpret=True)
    brute = intersect_shade_brute(_t(o), _t(d), pgeom)
    for tag, ref in (("xla walk", walk), ("packet kernel", packet),
                     ("brute force", brute)):
        _assert_hits_agree(ref, got, f"K={k} vs {tag}")
    np.testing.assert_array_equal(_np(got[0].prim), _np(walk[0].prim))
    assert (_np(got[0].prim) >= 0).mean() > 0.05


@pytest.mark.parametrize("k", [32, 8])
def test_t_cap_and_occlusion_verdicts(k):
    """`t_cap` nearest hits equal the JAX walk's; occlusion queries may stop
    at any hit below cap - 4*EPS, but their verdicts |t - dist| <= EPS equal
    the exact query's and the JAX walk's on every lane."""
    geom, jbvh, pgeom, pbvh = _pair(41, k, tris=400)
    o, d = _rays(2048, seed=42)
    # Light distances spanning hit, miss and boundary: half the lanes put
    # the light on their nearest hit.
    dist = np.random.default_rng(43).uniform(0.3, 6.0, size=2048).astype(np.float32)
    near = intersect_bvh(_t(o), _t(d), pgeom, pbvh)
    on = (_np(near.prim) >= 0) & (np.arange(2048) % 2 == 0)
    dist[on] = _np(near.t)[on]
    cap = dist + np.float32(2.0 * EPS)
    exact = intersect_bvh(_t(o), _t(d), pgeom, pbvh, want_shade=True, t_cap=_t(cap))
    occl = intersect_bvh(_t(o), _t(d), pgeom, pbvh, want_shade=True, t_cap=_t(cap),
                         occlusion=True)
    j_exact = jax_isect.intersect_bvh(o, d, geom, jbvh, want_shade=True,
                                      t_cap=jnp.asarray(cap))
    j_occl = jax_isect.intersect_bvh(o, d, geom, jbvh, want_shade=True,
                                     t_cap=jnp.asarray(cap), occlusion=True)
    _assert_hits_agree(j_exact, exact, f"K={k} t_cap")

    def verdict(r):
        h, sp = r
        return _np(sp.hit) & (np.abs(_np(h.t) - dist) <= EPS)

    v = verdict(occl)
    np.testing.assert_array_equal(v, verdict(exact))
    np.testing.assert_array_equal(v, verdict(j_occl))
    np.testing.assert_array_equal(v, verdict(j_exact))
    assert v.any() and (~v & _np(occl[1].hit)).any()  # both verdicts occur


def test_slab_nan_on_box_planes():
    """Axis-aligned rays whose origins lie on node planes: 1/d is inf on the
    zero components and (plane - o) * inf is NaN, which minimum/maximum
    propagate, so such a box misses. The port's walk treats these lanes as
    the JAX XLA walk and packet kernel do."""
    geom, jbvh, pgeom, pbvh = _pair(5, 32)
    rng = np.random.default_rng(6)
    n = 2048
    lo, hi = np.asarray(jbvh.node_min[0]), np.asarray(jbvh.node_max[0])
    o = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    axis = rng.integers(0, 3, size=n)
    d = np.zeros((n, 3), np.float32)
    d[np.arange(n), axis] = rng.choice([-1.0, 1.0], size=n)
    planes = np.concatenate([np.asarray(jbvh.node_min), np.asarray(jbvh.node_max)])
    rows = rng.integers(0, planes.shape[0], size=n)
    for shift in (1, 2):
        side = (axis + shift) % 3
        o[np.arange(n), side] = planes[rows, side]
    with np.errstate(divide="ignore", invalid="ignore"):
        slab = (planes[rows] - o) * (1.0 / d)
    assert np.isnan(slab).any(axis=1).mean() > 0.9  # the case is exercised
    got = intersect_bvh(_t(o), _t(d), pgeom, pbvh, want_shade=True)
    walk = jax_isect.intersect_bvh(jnp.asarray(o), jnp.asarray(d), geom, jbvh,
                                   want_shade=True)
    packet = jax_isect.intersect_bvh(jnp.asarray(o), jnp.asarray(d), geom, jbvh,
                                     want_shade=True, use_pallas=True,
                                     pallas_interpret=True)
    for tag, ref in (("xla walk", walk), ("packet kernel", packet)):
        np.testing.assert_array_equal(_np(got[0].prim), _np(ref[0].prim), tag)
        _assert_hits_agree(ref, got, tag)
    assert (_np(got[0].prim) >= 0).any()


def test_gradient_matches_jax():
    """d(sum of hit t)/d(o, d) through the port's autograd Function (the
    plane equation at the detached winner; spheres through their own
    arithmetic) against jax.grad through the JAX package's intersect_bvh."""
    geom, jbvh, pgeom, pbvh = _pair(7, 32, tris=64)
    o, d = _rays(512, seed=8)

    def f_jax(o_, d_):
        h = jax_isect.intersect_bvh(o_, d_, geom, jbvh)
        return jnp.sum(jnp.where(h.prim >= 0, h.t, 0.0))

    go_j, gd_j = jax.grad(f_jax, argnums=(0, 1))(o, d)
    o_t = _t(o).clone().requires_grad_()
    d_t = _t(d).clone().requires_grad_()
    h = intersect_bvh(o_t, d_t, pgeom, pbvh)
    torch.where(h.prim >= 0, h.t, torch.zeros_like(h.t)).sum().backward()
    assert (h.prim.numpy() >= 64).any() and ((h.prim.numpy() >= 0)
                                             & (h.prim.numpy() < 64)).any()
    np.testing.assert_allclose(o_t.grad.numpy(), np.asarray(go_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(d_t.grad.numpy(), np.asarray(gd_j), rtol=1e-4, atol=1e-5)


def test_intersect_tris_on_cpu_is_the_plain_walk():
    """For CPU tensors the kernel wrapper is the plain walk and launches
    nothing; pack_bvh's tables hold the Bvh's rows."""
    _, _, pgeom, pbvh = _pair(3, 32)
    o, d = _rays(256, seed=4)
    o, d = _t(o), _t(d)
    t0 = torch.full((256,), 1e5)
    stop = torch.full((256,), -1e5)
    tables = cuda_bvh.pack_bvh(pbvh)
    cuda_bounce.reset_counts()
    got = cuda_bvh.intersect_tris(o, d, t0, stop, tables, True)
    want = _walk_tris(o, d, t0, stop, pbvh, True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert cuda_bounce.counts()["bvh"] == 0
    k = pbvh.blk_p0.shape[1]
    assert tables["nodes"].shape == (pbvh.node_min.shape[0], 8)
    assert tables["leaves"].shape == (pbvh.blk_p0.shape[0], 12, k)
    assert torch.equal(tables["leaves"][:, 3:6].transpose(1, 2), pbvh.blk_e1)
    assert torch.equal(tables["ids"][:, 1], pbvh.blk_mat)
    assert torch.equal(tables["nodes"][:, 6].to(torch.int32), pbvh.node_miss)
    assert torch.equal(tables["tri_n"], pgeom.tri_n)


def test_wide_leaves_are_refused():
    """A K=128 BVH (the compiler's layout from 650,000 triangles) is no
    longer refused on the card: the bounce kernels serve it with their
    per-thread walk and the AOVs with the wide walk, under every sky: the
    simple sky too."""
    import dataclasses

    from lumillyrender_tpu_torch.scene.compiler import compile_scene_file
    from lumillyrender_tpu_torch.scene.data import SKY_SIMPLE

    c = compile_scene_file(REPO / "assets" / "new-cbox.toml", spp=1, device="cpu")
    g = c.data.geometry
    wide = Bvh(**{n: tensor_of(v) for n, v in build_tri_bvh(
        g.tri_p0.numpy(), g.tri_e1.numpy(), g.tri_e2.numpy(), g.tri_n.numpy(),
        g.tri_mat.numpy(), max_leaf=128).items()})
    st = dataclasses.replace(c.settings, intersector="bvh")
    assert cuda_bounce.supported(c.data, st) == (True, "")
    scene = dataclasses.replace(c.data, bvh=wide)
    for integrator in ("pt", "pt-direct", "depth", "normal"):
        assert cuda_bounce.supported(
            scene, dataclasses.replace(st, integrator=integrator)) == (True, "")
    for integrator in ("pt", "pt-direct", "depth", "normal"):
        simple = dataclasses.replace(st, sky_kind=SKY_SIMPLE, integrator=integrator)
        assert cuda_bounce.supported(scene, simple) == (True, "")



@pytest.mark.parametrize("case", list(TIE_LAYOUTS))
def test_tie_leaf_keeps_the_first_slot(case):
    """On the hand-written tie BVHs over new-cbox (the root one K=128 leaf
    with the ties in one lane's rounds or in three lanes, a K=32 twin, and
    the 128 slots as four K=32 leaves), `_walk_tris` and
    the JAX package's walk pick the first tie slot's prim (0), material row
    and normal on every lane that hits the tie, and agree with each other
    on every lane: the rule "smaller t, then the earlier slot" that the
    BVH bounce's warp walk implements."""
    from lumillyrender_tpu_torch.scene.compiler import compile_scene_file

    g = compile_scene_file(REPO / "assets" / "new-cbox.toml", device="cpu").data.geometry
    arrays = tie_bvh(g, case)
    pbvh = Bvh(**{f: tensor_of(v) for f, v in arrays.items()})
    jbvh = JaxBvh(**{f: jnp.asarray(v) for f, v in {
        **arrays, **_pack_kernel_tables(**arrays)}.items()})
    jgeom = JaxGeometry(**{f: jnp.asarray(getattr(g, f).numpy())
                           for f in Geometry.__dataclass_fields__})
    o, d = tie_rays(g, 2048, 11)
    n = o.shape[0]
    h_p, sp_p = intersect_bvh(_t(o), _t(d), g, pbvh, want_shade=True, plain=True)
    t, prim, mat, nrm = h_p.t, h_p.prim, sp_p.mat, sp_p.normal
    h_j, sp_j = jax_isect.intersect_bvh(jnp.asarray(o), jnp.asarray(d), jgeom, jbvh,
                                        want_shade=True)
    # The lanes whose nearest triangle is the tie: triangle 0 alone gives t.
    _, _, ties, _ = TIE_LAYOUTS[case]
    t0 = _tri_t(_t(o), _t(d), g.tri_p0[:1], g.tri_e1[:1], g.tri_e2[:1])[0]
    tie = (prim >= 0) & (t == t0)
    assert int(tie.sum()) > n // 8
    first = ties[0]
    want_n = arrays["blk_n"].reshape(-1, 3)[first]
    want_m = arrays["blk_mat"].reshape(-1)[first]
    for tag, p_, m_, n_ in (("plain walk", prim, mat, nrm),
                            ("jax walk", _t(h_j.prim), _t(sp_j.mat), _t(sp_j.normal))):
        assert (p_[tie] == 0).all(), tag
        assert (m_[tie] == int(want_m)).all(), tag
        assert torch.equal(n_[tie], torch.from_numpy(want_n).expand(int(tie.sum()), 3)), tag
    # The two walks agree on every lane.
    np.testing.assert_array_equal(_np(h_j.prim), prim.numpy())
    _assert_hits_agree((h_j, sp_j), (h_p, sp_p), f"tie {case}")

def _last_valid(prim: np.ndarray) -> np.ndarray:
    """Each leaf's last slot with prim >= 0, plus one (0 for none)."""
    k = prim.shape[1]
    valid = prim >= 0
    return np.where(valid.any(1), k - np.argmax(valid[:, ::-1], axis=1), 0)


@pytest.mark.parametrize("builder", ["native", "sah"])
@pytest.mark.parametrize("k", [32, 8])
def test_leaf_counts_of_both_builders(builder, k, monkeypatch):
    """pack_bvh's counts are each leaf's last valid slot plus one, for the
    native builder and its plain version (accel/sah.py); both fill a leaf
    from slot 0, so the count is the leaf's number of triangles."""
    from lumillyrender_tpu_torch.accel import pack, sah

    if builder == "sah":
        monkeypatch.setattr(pack.native, "build_ranges", sah.build_ranges)
    arrays = build_tri_bvh(*terrain.make_terrain(3000, seed=4), max_leaf=k)
    counts = cuda_bvh.pack_bvh(Bvh(**{f: tensor_of(v) for f, v in arrays.items()}))["counts"]
    prim = arrays["blk_prim"]
    assert counts.dtype == torch.int32 and counts.shape == (prim.shape[0],)
    np.testing.assert_array_equal(counts.numpy(), _last_valid(prim))
    np.testing.assert_array_equal(counts.numpy(), (prim >= 0).sum(1))
    assert int(counts.min()) >= 1 and int(counts.max()) == k


@pytest.mark.parametrize("case,want", [("k32x4", [6, 9, 27, 32]), ("k32", [32]),
                                       ("k8x16", [6, 0, 0, 0, 6, 1, 0, 0, 7, 0, 0, 3, 6, 7,
                                                  0, 8])])
def test_leaf_counts_with_padding_inside(case, want):
    """Padding inside a leaf (prim -1 before its last triangle) does not
    end its count; a leaf of padding only counts 0."""
    from lumillyrender_tpu_torch.scene.compiler import compile_scene_file

    g = compile_scene_file(REPO / "assets" / "new-cbox.toml", device="cpu").data.geometry
    arrays = tie_bvh(g, case)
    counts = cuda_bvh.pack_bvh(Bvh(**{f: tensor_of(v) for f, v in arrays.items()}))["counts"]
    assert counts.tolist() == want
    np.testing.assert_array_equal(counts.numpy(), _last_valid(arrays["blk_prim"]))


@pytest.mark.parametrize("case,drop", [("k32x4", (110, 127)), ("k128", (110, 127)),
                                       ("k8x16", (40,))])
def test_plain_walk_never_takes_a_padding_slot(case, drop):
    """Slots past a leaf's count hold padding only, and the nearest-hit
    rule never takes a padding slot, whatever it stores: on the tie BVHs
    with every padding slot holding the aimed-at tie triangle (prim -1),
    the plain walk gives the result of the same BVH with zero padding, so
    a walk that stops at each leaf's count gives it too."""
    from lumillyrender_tpu_torch.scene.compiler import compile_scene_file

    g = compile_scene_file(REPO / "assets" / "new-cbox.toml", device="cpu").data.geometry
    base = with_live_padding(tie_bvh(g, case), drop)
    zero = {f: v.copy() for f, v in base.items()}
    pad = zero["blk_prim"] < 0
    for f in ("p0", "e1", "e2", "n"):
        zero[f"blk_{f}"][pad] = 0.0
    live, plain = (Bvh(**{f: tensor_of(v) for f, v in a.items()}) for a in (base, zero))
    counts = cuda_bvh.pack_bvh(live)["counts"].numpy()
    k = base["blk_prim"].shape[1]
    assert (counts < k).any() and base["blk_e1"][pad].any(axis=-1).all()
    o, d = (_t(x) for x in tie_rays(g, 2048, 12))
    t0 = torch.full((o.shape[0],), 1e5)
    stop = torch.full_like(t0, -1e5)
    got = _walk_tris(o, d, t0, stop, live, True)
    want = _walk_tris(o, d, t0, stop, plain, True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int((got[1] == 0).sum()) > o.shape[0] // 8


# ---------------------------------------------------------------------------
# The bounce on the terrain scene
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def terrain_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_bvh")
    terrain.write_obj(d / "terrain.obj", *terrain.make_terrain(9000)[:3])
    return d


def test_terrain_generator_matches_tools():
    sys.path.insert(0, str(REPO / "tools"))
    from bench_bigmesh import make_terrain

    for a, b in zip(terrain.make_terrain(9000), make_terrain(9000)):
        np.testing.assert_array_equal(a, b)


# A simple sky (tests/test_camera.py's): meridian and horizon blended by |d.y|.
SIMPLE_SKY = 'type = "simple"\nmeridian = [0.1, 0.2, 0.9]\nhorizon = [0.9, 0.8, 0.7]'


def _terrain(terrain_dir, integrator, sky_kind, assets_dir):
    sky = {"uniform": terrain.UNIFORM_SKY, "simple": SIMPLE_SKY}.get(sky_kind) or \
        terrain.ibl_sky(assets_dir / "models" / "ibl" / "test_sky.hdr")
    toml = terrain.terrain_scene_toml(integrator, sky)
    return jax_compile_scene(jax_parse(toml, base_dir=terrain_dir))


def _port_state(parts, bounce):
    return state_from_numpy(bounce, *parts)


@pytest.mark.parametrize("integrator,sky", [
    ("pt-direct", "uniform"), ("pt", "uniform"), ("pt-direct", "ibl"), ("pt", "ibl"),
    ("pt-direct", "simple"),
])
def test_plain_step_matches_jax_step_on_terrain(terrain_dir, assets_dir, integrator, sky):
    ref = _terrain(terrain_dir, integrator, sky, assets_dir)
    scene = scene_from_numpy(ref.data)
    assert scene.geometry.tri_p0.shape[0] > 8192  # the BVH path
    step_ref = jax.jit(jax_step(ref.data, ref.settings, SEED, allow_fused=False))
    rng = np.random.default_rng(len(integrator) + len(sky))
    for bounce in BOUNCES:
        parts = _random_state(rng, ref.data, n=768)
        want = step_ref(_mk_state(parts, bounce))
        got = wavefront.plain_bounce_step(scene, ref.settings, SEED,
                                          _port_state(parts, bounce))
        _assert_states_close(want, types.SimpleNamespace(**state_to_numpy(got)),
                             f"terrain {integrator} {sky}@b{bounce}")


def test_plain_step_walks_only_what_it_uses(terrain_dir, assets_dir):
    """The plain step walks the BVH only where the kernel does: dead lanes
    add no node visit or triangle test, so a state's walks are those of its
    live lanes alone, and a dead state walks nothing."""
    import dataclasses

    from lumillyrender_tpu_torch.ops import intersect

    ref = _terrain(terrain_dir, "pt-direct", "uniform", assets_dir)
    scene = scene_from_numpy(ref.data)
    parts = _random_state(np.random.default_rng(13), ref.data, n=512)
    state = _port_state(parts, 0)
    live = state.alive.nonzero()[:, 0]
    sub = dataclasses.replace(state, **{k: getattr(state, k)[live] for k in (
        "o", "d", "throughput", "accum", "alive", "lane")})
    dead = dataclasses.replace(state, alive=torch.zeros_like(state.alive))
    counts = []
    for st in (state, sub, dead):
        with intersect.count_work() as work:
            wavefront.plain_bounce_step(scene, ref.settings, SEED, st)
        counts.append((int(work["visits"]), int(work["tests"])))
    assert 0 < live.numel() < 512
    assert counts[0] == counts[1] and counts[0][0] > 0
    assert counts[2] == (0, 0)


def test_plain_step_matches_tpu_bvh_kernel(terrain_dir, assets_dir):
    """One bounce of the TPU kernel itself (`make_step_bvh`, interpret mode,
    IBL epilogue included) on the terrain scene, same rules."""
    ref = _terrain(terrain_dir, "pt-direct", "ibl", assets_dir)
    assert pallas_bounce.supported_bvh(ref.data, ref.settings)
    scene = scene_from_numpy(ref.data)
    kernel = pallas_bounce.make_step_bvh(ref.data, ref.settings, SEED, interpret=True)
    parts = _random_state(np.random.default_rng(12), ref.data, n=1024)
    want = jax.jit(kernel)(_mk_state(parts, 1))
    got = wavefront.plain_bounce_step(scene, ref.settings, SEED, _port_state(parts, 1))
    _assert_states_close(want, types.SimpleNamespace(**state_to_numpy(got)),
                         "terrain@b1 vs tpu kernel")
