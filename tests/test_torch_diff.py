"""The port's differentiable path on the CPU: render_diff, film_and_grads
and pixel_grad against the JAX package and against finite differences.

* Whole-path gradients against `jax.grad` of the JAX `render_diff` at the
  same seed, on tests/test_diff.py's mixed Lambert/GGX scene (the hybrid
  step: autograd of the plain step) and the Lambert scene of
  tests/test_fused_bounce.py (the closed-form backward, `plain_bounce_bwd`):
  every float leaf within 1e-3 of its largest magnitude (measured: 9.1e-5,
  camera position on the mixed scene; 2.7e-6 on the Lambert scene).
  `film_and_grads` likewise, with its loss and film.
* FD-vs-AD on the port itself, as tests/test_diff.py gates the JAX package
  (sampling measure pinned at theta0, central differences at three steps,
  the median): albedo, emission, roughness, ior, camera, sky, albedo
  through an IBL sky, an IBL texel, and welcome-geo (BASELINE config 5) at
  12x9, which runs autograd through the plain BVH walk.
* The `bwd_remat` policies give the same gradients, bit for bit; every
  gradient is finite on a scene with all five BSDFs; inverse rendering
  converges.

Inputs are compiled by the JAX package and carried across with
`convert.py`; everything runs on `device="cpu"`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumillyrender_tpu.diff.render import film_and_grads as jax_film_and_grads
from lumillyrender_tpu.diff.render import params_of as jax_params_of
from lumillyrender_tpu.diff.render import render_diff as jax_render_diff
from lumillyrender_tpu.scene.compiler import compile_scene as jax_compile_scene
from lumillyrender_tpu.scene.compiler import compile_scene_file as jax_compile
from lumillyrender_tpu.scene.data import SKY_IBL
from lumillyrender_tpu.scene.loader import parse_config as jax_parse
from lumillyrender_tpu_torch.convert import (
    params_from_numpy,
    params_to_numpy,
    scene_from_numpy,
    state_from_numpy,
)
from lumillyrender_tpu_torch.diff import film_and_grads, params_of, pixel_grad, render_diff
from lumillyrender_tpu_torch.diff.render import leaves
from lumillyrender_tpu_torch.integrator import wavefront
from lumillyrender_tpu_torch.ops import cuda_bounce
from lumillyrender_tpu_torch.ops.bounce_bwd import plain_bounce_bwd
from test_diff import SCENE
from test_fused_bounce import GGX_REFR_SCENE, LAMBERT_DIFF_SCENE, _random_state

torch.set_num_threads(2)

SEED = 21
CPU = "cpu"
WHOLE_PATH_RTOL = 1e-3


def _compiled(toml, max_bounces=5, spp=4):
    c = jax_compile_scene(jax_parse(toml), spp=spp)
    c.settings = dataclasses.replace(c.settings, max_bounces=max_bounces)
    return c


def _mixed(integrator="pt-direct", **kw):
    return _compiled(SCENE.replace("INTEGRATOR", integrator), **kw)


def _with_ibl(c, h=8, seed=2):
    """tests/test_diff.py::_with_ibl: a random IBL texture for the sky."""
    img = np.random.default_rng(seed).random((h, 2 * h, 3)).astype(np.float32)
    c.data = dataclasses.replace(c.data, sky=dataclasses.replace(
        c.data.sky, color=jnp.zeros(3), color2=jnp.zeros(3),
        ibl=jnp.asarray(img * 0.8 + 0.2), longitude_offset=jnp.float32(6.0)))
    c.settings = dataclasses.replace(c.settings, sky_kind=SKY_IBL)
    return c


def _port(c):
    return scene_from_numpy(c.data), params_from_numpy(jax_params_of(c.data))


def _set(params, part, field, idx, value):
    t = getattr(getattr(params, part), field).clone()
    t[idx] = value
    return params._replace(**{part: dataclasses.replace(getattr(params, part),
                                                        **{field: t})})


def _mean_grad(scene, settings, p0):
    return pixel_grad(scene, settings, p0, SEED, settings.spp, lambda f: f.mean(),
                      params_sample=p0, device=CPU)


def _fd_vs_ad(c, part, field, idx, eps, atol, rtol):
    """tests/test_diff.py::fd_vs_ad on the port."""
    scene, p0 = _port(c)
    f = lambda p: float(render_diff(scene, c.settings, p, SEED, c.settings.spp,
                                    params_sample=p0, device=CPU).mean())
    g_ad = float(getattr(getattr(_mean_grad(scene, c.settings, p0), part), field)[idx])
    v0 = float(getattr(getattr(p0, part), field)[idx])

    def central(e):
        return (f(_set(p0, part, field, idx, v0 + e))
                - f(_set(p0, part, field, idx, v0 - e))) / (2 * e)

    g_fd = float(np.median([central(eps / 2), central(eps), central(2 * eps)]))
    assert np.isfinite(g_ad) and np.isfinite(g_fd)
    assert abs(g_ad - g_fd) < atol + rtol * abs(g_fd), (g_ad, g_fd)
    return g_ad


# name: (scene factory, parameter, FD step, atol, rtol, sign of the gradient),
# the steps and tolerances of tests/test_diff.py and test_fused_bounce.py.
FD_CASES = {
    "albedo": (_mixed, ("materials", "color", (1, 0)), 2e-2, 2e-4, 0.08, 1),
    "emission": (_mixed, ("materials", "emission", (0, 1)), 0.5, 1e-5, 0.05, 1),
    "roughness": (_mixed, ("materials", "alpha", 2), 2e-2, 5e-4, 0.1, 0),
    "ior": (_mixed, ("materials", "ior", 2), 2.0, 1e-6, 0.1, 0),
    "camera": (lambda: _mixed("pt", max_bounces=3),
               ("camera", "aperture_position", 2), 5e-2, 2e-3, 0.25, 0),
    "lambert-albedo": (lambda: _compiled(LAMBERT_DIFF_SCENE),
                       ("materials", "color", (1, 0)), 2e-2, 2e-4, 0.08, 1),
    "lambert-emission": (lambda: _compiled(LAMBERT_DIFF_SCENE),
                         ("materials", "emission", (0, 1)), 0.5, 1e-5, 0.05, 1),
    "lambert-sky": (lambda: _compiled(LAMBERT_DIFF_SCENE),
                    ("sky", "color", 1), 5e-2, 1e-5, 0.05, 1),
    "lambert-camera": (lambda: _compiled(LAMBERT_DIFF_SCENE, max_bounces=3),
                       ("camera", "aperture_position", 2), 5e-2, 2e-3, 0.25, 0),
    "albedo-through-ibl": (lambda: _with_ibl(_mixed()),
                           ("materials", "color", (1, 0)), 2e-2, 2e-4, 0.08, 1),
}


@pytest.mark.parametrize("name", list(FD_CASES))
def test_fd_vs_ad(name):
    make, (part, field, idx), eps, atol, rtol, sign = FD_CASES[name]
    g = _fd_vs_ad(make(), part, field, idx, eps, atol, rtol)
    assert sign * g >= 0


def test_ibl_texel_grad_matches_fd():
    """The film is linear in each texel given the (detached) texel pick, so
    AD matches FD to float32 precision (tests/test_diff.py)."""
    c = _with_ibl(_mixed("pt"))
    scene, p0 = _port(c)
    g_tex = _mean_grad(scene, c.settings, p0).sky.ibl.numpy()
    assert g_tex.shape == tuple(scene.sky.ibl.shape)
    assert (g_tex >= 0).all() and g_tex.sum() > 0
    idx = np.unravel_index(np.argmax(g_tex), g_tex.shape)
    f = lambda p: float(render_diff(scene, c.settings, p, SEED, c.settings.spp,
                                    params_sample=p0, device=CPU).mean())
    v0 = float(p0.sky.ibl[idx])
    g_fd = (f(_set(p0, "sky", "ibl", idx, v0 + 0.1))
            - f(_set(p0, "sky", "ibl", idx, v0 - 0.1))) / 0.2
    assert abs(g_tex[idx] - g_fd) < 1e-5 + 0.01 * abs(g_fd), (g_tex[idx], g_fd)


def test_welcome_geo_config5_grad_matches_fd(assets_dir):
    """BASELINE config 5 end to end at 12x9: the BVH scene's autograd path
    (plain walk, IBL sky, thin lens, NEE)."""
    c = jax_compile(assets_dir / "welcome-geo.toml", spp=2)
    c.settings = dataclasses.replace(c.settings, width=12, height=9, max_bounces=2)
    assert not cuda_bounce.hybrid_supported(scene_from_numpy(c.data), c.settings)[0]
    assert _fd_vs_ad(c, "materials", "color", (0, 0), 2e-2, 1e-2, 0.08) > 0


def _assert_params_close(got, want, rtol):
    got, want = params_to_numpy(got), want
    for part, fields in got.items():
        for field, g in fields.items():
            w = np.asarray(getattr(getattr(want, part), field))
            if not np.issubdtype(w.dtype, np.floating):
                continue
            assert np.isfinite(g).all(), (part, field)
            err = np.abs(g - w).max(initial=0.0) / max(np.abs(w).max(initial=0.0), 1e-12)
            assert err < rtol or np.abs(g - w).max(initial=0.0) < 1e-9, (part, field, err)


@pytest.mark.parametrize("name", ["mixed", "lambert"])
def test_pixel_grad_matches_jax_grad(name):
    c = _mixed() if name == "mixed" else _compiled(LAMBERT_DIFF_SCENE)
    scene, p0 = _port(c)
    jp0 = jax_params_of(c.data)
    want = jax.grad(lambda p: jnp.mean(jax_render_diff(c.data, c.settings, p, SEED, 4,
                                                       params_sample=jp0)),
                    allow_int=True)(jp0)
    _assert_params_close(_mean_grad(scene, c.settings, p0), want, WHOLE_PATH_RTOL)


def test_film_and_grads_matches_jax():
    c = _compiled(LAMBERT_DIFF_SCENE)
    scene, p_true = _port(c)
    target = render_diff(scene, c.settings, p_true, 33, 4, device=CPU)
    p = _set(p_true, "materials", "color", (1, 0), 0.15)
    jp = jax_params_of(c.data)
    jp = jp._replace(materials=dataclasses.replace(
        jp.materials, color=jp.materials.color.at[1, 0].set(0.15)))
    loss, film, grads = film_and_grads(scene, c.settings, p, target, 33, 4, device=CPU)
    j_loss, j_film, j_grads = jax_film_and_grads(c.data, c.settings, jp,
                                                 jnp.asarray(target.numpy()), 33, 4)
    assert abs(float(loss) - float(j_loss)) <= 1e-4 * float(j_loss)
    assert np.abs(film.numpy() - np.asarray(j_film)).max() < 1e-4
    _assert_params_close(grads, j_grads, WHOLE_PATH_RTOL)


def test_params_round_trip():
    c = _compiled(LAMBERT_DIFF_SCENE)
    scene, p = _port(c)
    for a, b in zip(leaves(p), leaves(params_of(scene))):
        assert torch.equal(a, b)
    back = params_to_numpy(p)
    np.testing.assert_array_equal(back["materials"]["color"], np.asarray(c.data.materials.color))
    assert not back["materials"]["type_id"].any()  # integer leaves: zeros


def test_bwd_remat_policies_agree():
    """Every `bwd_remat` policy gives the gradients of 'none' bit for bit
    (checkpointing recomputes each bounce exactly; the 'isect' policies
    hand the recompute the forward pass's searches and samples), on the
    IBL scene whose step is autograd of the plain step; a typo raises."""
    c = _with_ibl(_mixed(spp=2))
    scene, p0 = _port(c)
    grads = {}
    for mode in ("none", "full", "hybrid", "isect", "isect+samp"):
        st = dataclasses.replace(c.settings, bwd_remat=mode)
        grads[mode] = leaves(_mean_grad(scene, st, p0))
    for mode in ("full", "hybrid", "isect", "isect+samp"):
        for a, b in zip(grads[mode], grads["none"]):
            assert torch.equal(a, b), mode
    with pytest.raises(ValueError):
        _mean_grad(scene, dataclasses.replace(c.settings, bwd_remat="sometimes"), p0)


@pytest.mark.parametrize("name", ["families", "lambert", "families-no-compaction"])
def test_every_gradient_is_finite(name):
    """All five BSDFs (refraction's Beer-Lambert coef, GGX, Phong,
    Blinn-Phong) and the Lambert closed form: no NaN or inf reaches any
    gradient, with and without compaction."""
    c = _compiled(LAMBERT_DIFF_SCENE if name == "lambert" else GGX_REFR_SCENE, max_bounces=8)
    if name.endswith("no-compaction"):
        c.settings = dataclasses.replace(c.settings, compaction="off")
    scene, p0 = _port(c)
    g = _mean_grad(scene, c.settings, p0)
    for t in leaves(g):
        assert torch.isfinite(t).all()
    assert g.materials.color.abs().sum() > 0


def _state(c, n=512, bounce=2, seed=3):
    rng = np.random.default_rng(seed)
    return state_from_numpy(bounce, *_random_state(rng, c.data, n))


@pytest.mark.parametrize("name", ["lambert", "mixed", "ibl"])
def test_step_dispatch_and_its_gradients(name):
    """make_step_diff picks the closed-form step for a Lambert scene (its
    backward is plain_bounce_bwd), the hybrid for other brute-force scenes
    under a uniform sky (its backward is autograd of the plain step) and
    plain autograd for the rest; all three give one bounce's gradients."""
    c = {"lambert": lambda: _compiled(LAMBERT_DIFF_SCENE), "mixed": _mixed,
         "ibl": lambda: _with_ibl(_mixed())}[name]()
    scene, p0 = _port(c)
    st = _state(c)
    x = [t.clone().requires_grad_() for t in (st.o, st.d, st.throughput)]
    mats = dataclasses.replace(p0.materials, color=p0.materials.color.clone().requires_grad_())
    step = cuda_bounce.make_step_diff(scene, c.settings, SEED, mats)
    assert step.fused_diff == (name != "ibl")
    out = step(dataclasses.replace(st, o=x[0], d=x[1], throughput=x[2]))
    cot = [torch.from_numpy(np.random.default_rng(k).normal(size=(512, 3)).astype(np.float32))
           for k in range(4)]
    got = torch.autograd.grad((out.o, out.d, out.throughput, out.accum),
                              x + [mats.color], cot, allow_unused=True)
    y = [t.clone().requires_grad_() for t in (st.o, st.d, st.throughput)]
    m2 = dataclasses.replace(p0.materials, color=p0.materials.color.clone().requires_grad_())
    ref = wavefront.plain_bounce_step(scene, c.settings, SEED,
                                      dataclasses.replace(st, o=y[0], d=y[1], throughput=y[2]),
                                      m2)
    for k in ("o", "d", "throughput", "accum", "alive"):
        assert torch.equal(getattr(out, k), getattr(ref, k)), k
    if name == "lambert":
        want = plain_bounce_bwd(scene, c.settings, SEED, st, *cot, mats_eval=p0.materials)
        want = [want.o, want.d, want.throughput, want.albedo]
    else:
        want = torch.autograd.grad((ref.o, ref.d, ref.throughput, ref.accum),
                                   y + [m2.color], cot, allow_unused=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_trace_fixed_length_matches_the_forward_loop():
    """`trace` without compaction: the differentiable loop's fixed
    max_bounces steps give the forward loop's radiance (dead lanes stay
    dead), and its gradients are finite."""
    c = _compiled(LAMBERT_DIFF_SCENE)
    scene, p0 = _port(c)
    st = _state(c, bounce=0)
    fwd, rays = wavefront.trace(scene, c.settings, st.o, st.d, st.lane, SEED)
    color = p0.materials.color.clone().requires_grad_()
    mats = dataclasses.replace(p0.materials, color=color)
    rad, rays_d = wavefront.trace(scene, c.settings, st.o, st.d, st.lane, SEED,
                                  differentiable=True, mats_eval=mats)
    assert torch.equal(rad.detach(), fwd) and torch.equal(rays_d, rays)
    (g,) = torch.autograd.grad(rad.sum(), color)
    assert torch.isfinite(g).all() and g.abs().sum() > 0


def test_raygen_camera_row_follows_in_place_updates():
    """The raygen kernel's camera argument, kept on the CameraData, is read
    again after an in-place update (an optimizer step on the camera)."""
    c = _compiled(LAMBERT_DIFF_SCENE)
    scene, _ = _port(c)
    row0 = list(cuda_bounce._camera_row(scene))
    assert cuda_bounce._camera_row(scene) == row0
    with torch.no_grad():
        scene.camera.position.add_(torch.tensor([1.0, 2.0, 3.0]))
    row = cuda_bounce._camera_row(scene)
    assert row[:3] == [v + dv for v, dv in zip(row0[:3], (1.0, 2.0, 3.0))]
    assert row[3:] == row0[3:]


def test_inverse_rendering_converges():
    """tests/test_diff.py::test_inverse_rendering_converges on the port:
    recover a perturbed albedo by gradient descent against a rendered
    target."""
    c = _mixed(spp=8, max_bounces=4)
    scene, p_true = _port(c)
    target = render_diff(scene, c.settings, p_true, 33, 8, device=CPU)
    p = _set(p_true, "materials", "color", (1, 0), 0.15)
    val0 = 0.15
    for _ in range(80):
        _, _, grads = film_and_grads(scene, c.settings, p, target, 33, 8, device=CPU)
        v = float(p.materials.color[1, 0] - 30.0 * grads.materials.color[1, 0])
        p = _set(p, "materials", "color", (1, 0), v)
    val = float(p.materials.color[1, 0])
    assert abs(val - 0.6) < abs(val0 - 0.6) * 0.2, (val0, val)
