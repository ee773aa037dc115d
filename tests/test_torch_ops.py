"""The port's shading ops against the JAX package's functions on the same
numpy inputs: camera rays (four kinds), sky radiance (three kinds), the
BSDF table (five families) and brute-force intersection and shading; and
the plain step's sqrt and divisions by host numbers against numpy's IEEE
results.

Tolerances: the two sides run the same formulas in float32, but XLA fuses
multiply-adds and brings its own sin/cos/exp/pow, so results differ in the
last bits; RTOL bounds that. Discrete outputs (hit prim, validity flags)
must agree except on ties.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumillyrender_tpu.ops import bsdf as jbsdf
from lumillyrender_tpu.ops import camera as jcamera
from lumillyrender_tpu.ops import intersect as jisect
from lumillyrender_tpu.ops import sky as jsky
from lumillyrender_tpu.scene import data as jdata
from lumillyrender_tpu.scene.compiler import compile_scene_file as jax_compile
from lumillyrender_tpu_torch.convert import scene_from_numpy
from lumillyrender_tpu_torch.ops import bsdf, camera, intersect, sky
from lumillyrender_tpu_torch.scene import data

torch.set_num_threads(2)

RTOL = 2e-5  # relative to max(|x|, 1), per element


def _close(got, want, rtol=RTOL, name=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got.astype(np.float64) - want) / np.maximum(np.abs(want), 1.0)
    assert err.max() <= rtol, f"{name}: max rel err {err.max():.2e}"


def _t(x):
    x = np.asarray(x)
    return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x.copy())


def _compiled(assets_dir, name):
    ref = jax_compile(assets_dir / f"{name}.toml")
    return ref, scene_from_numpy(ref.data)


CAMERAS = [
    ("new-cbox", data.CAM_IDEAL_PINHOLE),
    ("ibl-material", data.CAM_THIN_LENS),
    ("ibl-material", data.CAM_PINHOLE),  # realistic pinhole on a lens frame
    ("vr", data.CAM_OMNIDIRECTIONAL),
]


@pytest.mark.parametrize("name,kind", CAMERAS)
def test_sample_rays_matches_jax(assets_dir, name, kind):
    ref, scene = _compiled(assets_dir, name)
    w, h, n = 40, 24, 3000
    rng = np.random.default_rng(kind)
    px = rng.integers(0, w, n).astype(np.int32)
    py = rng.integers(0, h, n).astype(np.int32)
    u = [rng.random(n, dtype=np.float32) for _ in range(4)]
    want = jcamera.sample_rays(ref.data.camera, kind, jnp.asarray(px),
                               jnp.asarray(py), w, h, *map(jnp.asarray, u))
    got = camera.sample_rays(scene.camera, kind, _t(px), _t(py), w, h,
                             *map(_t, u))
    for g, wv, nm in zip(got, want, ("o", "d", "pdf", "g")):
        _close(g.expand(np.shape(wv)), np.broadcast_to(wv, np.shape(wv)),
               name=f"{name}/{kind}/{nm}")


def _dirs(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


@pytest.mark.parametrize("kind", [data.SKY_UNIFORM, data.SKY_IBL,
                                  data.SKY_SIMPLE])
def test_sky_radiance_matches_jax(assets_dir, kind):
    ref, scene = _compiled(assets_dir, "ibl-material")
    jsk, tsk = ref.data.sky, scene.sky
    if kind != data.SKY_IBL:
        color = np.array([0.3, 0.6, 0.9], np.float32)
        color2 = np.array([1.0, 0.5, 0.25], np.float32)
        jsk = dataclasses.replace(jsk, color=jnp.asarray(color),
                                  color2=jnp.asarray(color2))
        tsk = dataclasses.replace(tsk, color=_t(color), color2=_t(color2))
    d = _dirs(np.random.default_rng(5), 4000)
    want = jsky.radiance(jsk, kind, jnp.asarray(d))
    got = sky.radiance(tsk, kind, _t(d))
    _close(got, np.broadcast_to(want, d.shape), rtol=0.0 if kind == data.SKY_IBL else RTOL,
           name=f"sky{kind}")


def _material_tables():
    """One row per family plus an emissive Lambert row."""
    rows = dict(
        type_id=np.array([0, 1, 2, 3, 4, 0], np.int32),
        color=np.array([[0.7, 0.5, 0.3], [0.8, 0.8, 0.8], [0.7, 0.8, 0.9],
                        [0.9, 0.8, 0.7], [0.95, 0.95, 0.95], [0, 0, 0]],
                       np.float32),
        emission=np.array([[0, 0, 0]] * 5 + [[4, 3, 2]], np.float32),
        alpha=np.array([0, 40, 25, 0.4, 0, 0], np.float32),
        ior=np.array([1, 1, 1, 1.8, 1.5, 1], np.float32),
        absorbtance=np.array([0, 0, 0, 0, 0.2, 0], np.float32),
    )
    jt = jdata.MaterialTable(**{k: jnp.asarray(v) for k, v in rows.items()})
    tt = data.MaterialTable(**{k: _t(v) for k, v in rows.items()})
    return jt, tt


def _shading_inputs(n=6000, seed=11):
    rng = np.random.default_rng(seed)
    mat = rng.integers(-1, 6, n).astype(np.int32)  # -1: a miss lane
    out = _dirs(rng, n)
    inn = _dirs(rng, n)
    nrm = _dirs(rng, n)
    pos = rng.uniform(-400, 400, size=(n, 3)).astype(np.float32)
    dist = rng.uniform(0.01, 50, n).astype(np.float32)
    r = [rng.random(n, dtype=np.float32) for _ in range(3)]
    return mat, out, inn, nrm, pos, dist, r


def test_bsdf_matches_jax_all_families():
    jt, tt = _material_tables()
    mat, out, inn, nrm, pos, dist, r = _shading_inputs()
    jm = jbsdf.gather(jt, jnp.asarray(mat))
    tm = bsdf.gather(tt, _t(mat))
    for f in jbsdf.GatheredMaterial._fields:
        np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                      np.asarray(getattr(jm, f)), err_msg=f)
    _close(bsdf.rr_weight(tm), jbsdf.rr_weight(jm), rtol=0.0, name="rr_weight")

    J = lambda x: jnp.asarray(x)
    _close(bsdf.eval_brdf(tm, _t(out), _t(inn), _t(nrm), _t(pos)),
           jbsdf.eval_brdf(jm, J(out), J(inn), J(nrm), J(pos)), name="eval")
    _close(bsdf.coef(tm, _t(out), _t(nrm), _t(dist)),
           jbsdf.coef(jm, J(out), J(nrm), J(dist)), name="coef")
    gs = bsdf.sample(tm, _t(out), _t(nrm), *map(_t, r))
    ws = jbsdf.sample(jm, J(out), J(nrm), *map(J, r))
    _close(gs.direction, ws.direction, name="sample.direction")
    # The Phong/Blinn pdfs carry cos^alpha (alpha up to 40): the last-bit
    # difference of the direction is amplified alpha-fold.
    _close(gs.pdf, ws.pdf, rtol=1e-4, name="sample.pdf")


def test_bsdf_pruning_by_present():
    """An all-Lambert `present` gives the same result as all five families
    on Lambert lanes."""
    _, tt = _material_tables()
    mat, out, inn, nrm, pos, dist, r = _shading_inputs()
    mat = np.where(np.isin(mat, [0, 5]), mat, 0).astype(np.int32)
    tm = bsdf.gather(tt, _t(mat))
    a = bsdf.eval_brdf(tm, _t(out), _t(inn), _t(nrm), _t(pos))
    b = bsdf.eval_brdf(tm, _t(out), _t(inn), _t(nrm), _t(pos), present=(0,))
    assert torch.equal(a, b)
    sa = bsdf.sample(tm, _t(out), _t(nrm), *map(_t, r))
    sb = bsdf.sample(tm, _t(out), _t(nrm), *map(_t, r), present=(0,))
    assert torch.equal(sa.direction, sb.direction) and torch.equal(sa.pdf, sb.pdf)
    assert torch.equal(bsdf.coef(tm, _t(out), _t(nrm), _t(dist), present=(0,)),
                       torch.ones(len(mat), 3))


def _rays(scene, n, seed):
    g = scene.geometry
    ref = np.concatenate([np.asarray(g.tri_p0).reshape(-1, 3),
                          np.asarray(g.sph_c).reshape(-1, 3)])
    ref = ref[np.abs(ref).max(axis=1) < 1e4]  # skip ground-sphere centers
    rng = np.random.default_rng(seed)
    o = rng.uniform(ref.min(0) - 1, ref.max(0) + 1, size=(n, 3)).astype(np.float32)
    return o, _dirs(rng, n)


# Tolerance on t and positions, relative to max(|x|, 1). primitive's ground
# is a sphere of radius 1e5: its discriminant holds terms of 1e10, whose
# float32 ulp is 1024, so either side's t near the ground is only good to
# ~1e-2 absolute and the two roundings differ by up to 7.8e-3 (measured).
T_RTOL = {"new-cbox": 1e-4, "primitive": 2e-2, "many-light": 1e-4}


@pytest.mark.parametrize("name", sorted(T_RTOL))
def test_brute_intersect_and_shade_match_jax(assets_dir, name):
    ref, scene = _compiled(assets_dir, name)
    o, d = _rays(ref.data, 3000, 3)
    J = jnp.asarray
    jh = jisect.intersect_brute(J(o), J(d), ref.data.geometry)
    th = intersect.intersect_brute(_t(o), _t(d), scene.geometry)
    same = th.prim.numpy() == np.asarray(jh.prim)
    assert same.mean() >= 0.999, f"{name}: prim agreement {same.mean():.4f}"
    # Hit distances where both pick the same prim.
    _close(th.t[torch.from_numpy(same)], np.asarray(jh.t)[same],
           rtol=T_RTOL[name], name=f"{name}/t")

    jsp = jisect.shade_point(J(o), J(d), jh, ref.data.geometry)
    tsp = intersect.shade_point(_t(o), _t(d), th, scene.geometry)
    keep = torch.from_numpy(same)
    _close(tsp.normal[keep], np.asarray(jsp.normal)[same],
           rtol=T_RTOL[name], name=f"{name}/normal")
    np.testing.assert_array_equal(tsp.mat[keep].numpy(), np.asarray(jsp.mat)[same])

    # Fused shade with a per-lane cap, as the NEE shadow query uses it.
    cap = np.random.default_rng(4).uniform(1, 800, len(o)).astype(np.float32)
    jh2, jsp2 = jisect.intersect_shade_brute(J(o), J(d), ref.data.geometry,
                                             t_cap=J(cap))
    th2, tsp2 = intersect.intersect_shade_brute(_t(o), _t(d), scene.geometry,
                                                t_cap=_t(cap))
    same2 = th2.prim.numpy() == np.asarray(jh2.prim)
    assert same2.mean() >= 0.999
    np.testing.assert_array_equal(tsp2.hit.numpy()[same2], np.asarray(jsp2.hit)[same2])
    _close(tsp2.position[torch.from_numpy(same2)], np.asarray(jsp2.position)[same2],
           rtol=T_RTOL[name], name=f"{name}/position")


def test_intersect_ties_go_to_the_first_prim():
    """Two coincident triangles: the lower prim id wins (strict <)."""
    p0 = np.array([[-1, -1, 0], [-1, -1, 0]], np.float32)
    e1 = np.array([[2, 0, 0], [2, 0, 0]], np.float32)
    e2 = np.array([[0, 2, 0], [0, 2, 0]], np.float32)
    geom = data.Geometry(
        tri_p0=_t(p0), tri_e1=_t(e1), tri_e2=_t(e2),
        tri_n=_t(np.array([[0, 0, 1]] * 2, np.float32)),
        tri_mat=_t(np.array([0, 1], np.int32)),
        sph_c=torch.zeros((0, 3)), sph_r=torch.zeros(0),
        sph_mat=torch.zeros(0, dtype=torch.int32),
    )
    o = torch.tensor([[-0.5, -0.4, 5.0]] * 3)
    d = torch.tensor([[0.0, 0.0, -1.0]] * 3)
    h = intersect.intersect_brute(o, d, geom)
    assert h.prim.tolist() == [0, 0, 0]
    assert torch.allclose(h.t, torch.full((3,), 5.0))


def test_sphere_brute_matches_jax(assets_dir):
    """Folding the spheres into a running best (the BVH path's sphere
    pass) picks the same winners as the JAX package's."""
    ref, scene = _compiled(assets_dir, "debug-nee")
    o, d = _rays(ref.data, 3000, 8)
    rng = np.random.default_rng(9)
    best_t = rng.uniform(1, 400, len(o)).astype(np.float32)
    best_p = rng.integers(-1, 3, len(o)).astype(np.int32)
    jt, jp = jisect._sphere_brute(jnp.asarray(o), jnp.asarray(d),
                                  ref.data.geometry, jnp.asarray(best_t),
                                  jnp.asarray(best_p))
    tt, tp = intersect._sphere_brute(_t(o), _t(d), scene.geometry, _t(best_t),
                                     _t(best_p))
    same = tp.numpy() == np.asarray(jp)
    assert same.mean() >= 0.999
    _close(tt[torch.from_numpy(same)], np.asarray(jt)[same], rtol=1e-4,
           name="sphere_brute/t")


def _ieee_inputs(n=1 << 20, seed=5):
    """float32 inputs over the whole positive range (random bit patterns),
    numbers of every scale the step takes, and the special values."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 0x7F800000, size=n, dtype=np.int64).astype(np.int32)
    scaled = (rng.uniform(1.0, 2.0, size=n) * 2.0 ** rng.integers(-40, 40, size=n))
    special = np.array([0.0, -0.0, 1.0, 4.0, np.inf, -1.0, np.nan, 1e-45, 3.4e38])
    return np.concatenate([bits.view(np.float32), scaled.astype(np.float32),
                           special.astype(np.float32)])


def _same_bits(got: torch.Tensor, want: np.ndarray):
    got = got.numpy()
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))


def test_sqrt_and_host_divisions_round_as_ieee():
    """vec.sqrt and vec.over give numpy's correctly rounded float32 sqrt and
    division bit for bit (the card's sqrtf and division, the kernels' and
    XLA's), so the plain step rounds them alike on the CPU and on the card;
    PyTorch's own CPU sqrt goes through MKL's vector math, an ulp off on
    about 0.5% of inputs (tools/torch_device_fork.py)."""
    from lumillyrender_tpu_torch.constants import PI
    from lumillyrender_tpu_torch.ops import vec

    x = _ieee_inputs()
    with np.errstate(invalid="ignore"):
        _same_bits(vec.sqrt(torch.from_numpy(x)), np.sqrt(x))
    for c in (PI, 2.0 * PI, 3.0, 2138 * 1536):
        _same_bits(vec.over(torch.from_numpy(x), c), x / np.float32(c))
    g = torch.from_numpy(x[:64] + 1.0).requires_grad_()
    vec.sqrt(g).sum().backward()
    assert g.grad.dtype == torch.float32 and torch.isfinite(g.grad).all()
