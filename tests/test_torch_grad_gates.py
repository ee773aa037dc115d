"""The JAX package's gradient gates on the port's differentiable path, on
every material family and on the hero scenes, through the step the card
runs: `cuda_bounce.make_step_hybrid` (on the CPU the plain step forward and
autograd of `cuda_bounce.recompute` backward; on the card the bounce
kernel forward and the same recompute, kernel 3 its walk on a BVH scene).
`make_step_diff` is replaced by it, as on the card's route of
tests/test_torch_diff_hybrid.py. FD is central differences at three steps
(eps/2, eps, 2 eps; the median) of the film's mean with the sampling
pinned at theta0, as tests/test_diff.py::fd_vs_ad takes it; a gate holds
when |AD - FD| < atol + rtol |FD| and the AD has its case's sign
(tools/torch_grad_gates.py's fd_vs_ad, the one chip_smoke.py's phases 12,
25 and 30 call; test_fd_gate_fails_on_a_wrong_gradient shows that it
rejects an AD of the wrong sign, of 0 or a third off).

READINGS

* The analytic direct view (tests/test_diff.py:207): pt, one bounce, 8
  spp on test_diff.SCENE. The lamp row's emission gradient is >= 0, the
  same in each channel, equal to the share of camera samples that hit the
  lamp over 3 (counted from the film with that emission at 1 and every
  other emission and the sky at 0) and to `jax.grad`'s, within 1e-6
  relative.
* The hybrid step's FD tests (tests/test_fused_bounce.py:606 and :622) on
  GLOSSY_DIFF_SCENE (12x12 x 4 spp, five bounces), the GGX row 1:
  roughness at step 4e-2 (atol 2e-4, rtol 0.15, g < 0), reflectance at
  2e-2 (2e-4, 0.1, g > 0). Both scene strings are the JAX tests'
  (test_gate_scenes_are_the_jax_tests).
* Every family on ibl-material at 32x24 x 4 spp and five bounces
  (tools/torch_grad_gates.py's IBL_MATERIAL_FD): the GGX roughness (row 5, step
  2e-2, tests/test_diff.py:176's atol 5e-4 and rtol 0.1, g > 0); the Phong
  and Blinn-Phong exponents (rows 6 and 7, step 1, atol 2e-4, rtol 0.1, g >
  0); the glass row's absorbtance (step 1e-2, g < 0), IOR (step 5e-3, atol
  1e-6, rtol 0.1 as tests/test_diff.py:186, g < 0) and reflectance (2e-2,
  2e-4, 0.08, g > 0). Readings (AD / FD): 9.309303 / 9.31032, 0.01464023 /
  0.01464019, 0.007128228 / 0.007120487, -6.684862 / -6.702197, -0.9772635
  / -0.9928267, 10.58913 / 10.6474.
  No JAX test holds the Phong, Blinn-Phong or absorbtance gradients; the
  IOR's step is the finding below. Then the whole film's gradients, every
  float leaf, against `jax.grad` of the JAX `render_diff` within
  test_torch_diff.WHOLE_PATH_RTOL (1e-3 of the leaf's largest magnitude),
  under test_torch_diff_hybrid.FLIP's rule: the pixels whose forward films
  differ by more than 1e-5 of the film max (a lane whose decision flipped
  between the packages) leave both objectives.
* The hero scenes welcome, ridaisai and sample (the JAX package's
  `film_and_grads`, tests/test_diff.py:305's step): a camera narrowed onto
  a bunny (tools/torch_grad_gates.py's view_of_rows, the same edit on both packages'
  compiled scene; ridaisai once for each bunny), a small film, the bunny
  rows' parameters moved off their values toward the film at the true
  ones; loss, film and every float leaf's gradient as
  test_torch_diff_hybrid.py holds welcome-geo's, under FLIP's rule; the
  bunny rows' gradients nonzero on both sides (welcome's GGX roughness and
  reflectance, both ridaisai rows' IOR, absorbtance and reflectance,
  sample's albedo).

The IOR step (`python tools/torch_grad_gates.py --ior-steps`): on
ibl-material's glass, AD -0.9773; the central difference reads -0.9926 at a
step of 5e-3 and -1.0433 at 1e-2, but +0.0143 at 2e-2 and +2.2346 at 4e-2:
the wider steps cross a lane's discrete decision. A gate on an ideal
refraction's IOR takes steps of 1e-2 or less.

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
from lumillyrender_tpu.scene.loader import parse_config as jax_parse
from lumillyrender_tpu_torch import parity
from lumillyrender_tpu_torch.convert import params_to_numpy, scene_from_numpy
from lumillyrender_tpu_torch.diff import film_and_grads, params_of, pixel_grad, render_diff
from lumillyrender_tpu_torch.ops import cuda_bounce
from test_diff import SCENE
from test_fused_bounce import GLOSSY_DIFF_SCENE
from test_torch_diff import WHOLE_PATH_RTOL, _assert_params_close
from test_torch_diff_hybrid import FLIP
from tools import torch_grad_gates as gg

torch.set_num_threads(2)

CPU = "cpu"
SEED = gg.FD_SEED
TRAIN_SEED = 33
CAMERA_LEAVES = {f"camera.{k}" for k in ("position", "aperture_position", "forward", "right",
                                         "up", "sensor_size", "aperture_radius",
                                         "focus_distance")}

# view: (scene, bunny rows in view, w, h, spp, bounces, fields whose
# gradients in those rows must be nonzero). ridaisai's refraction needs
# three bounces for a path through a bunny to the sky.
HERO_VIEWS = {
    "welcome": ("welcome", (0,), 16, 12, 2, 2, ("color", "alpha")),
    "ridaisai-orange": ("ridaisai", (0,), 16, 16, 2, 3, ("color", "ior", "absorbtance")),
    "ridaisai-black": ("ridaisai", (1,), 16, 16, 2, 3, ("color", "ior", "absorbtance")),
    "sample": ("sample", (0,), 16, 16, 2, 2, ("color",)),
}


@pytest.fixture(autouse=True)
def cards_route(monkeypatch):
    """The differentiable loop takes the card's step on the CPU."""
    monkeypatch.setattr(cuda_bounce, "make_step_diff", cuda_bounce.make_step_hybrid)


def _compiled(toml, spp, **settings):
    c = jax_compile_scene(jax_parse(toml), spp=spp)
    c.settings = dataclasses.replace(c.settings, **settings)
    return c


def _hybrid_on_card(scene, settings):
    assert cuda_bounce.diff_step_kind(scene, settings, on_card=True) == "hybrid"
    return scene


@pytest.fixture(scope="module")
def fd_scenes(assets_dir):
    """name -> (port scene, settings, mean_grad), each gradient taken once
    (under the card's route)."""
    glossy = _compiled(GLOSSY_DIFF_SCENE, 4, max_bounces=5)
    w, h, spp, bounces = gg.IBL_MATERIAL_SIZE
    ibl = jax_compile(assets_dir / "ibl-material.toml", spp=spp)
    ibl.settings = dataclasses.replace(ibl.settings, width=w, height=h, max_bounces=bounces)
    out = {}
    with pytest.MonkeyPatch.context() as m:
        m.setattr(cuda_bounce, "make_step_diff", cuda_bounce.make_step_hybrid)
        for name, c in (("glossy", glossy), ("ibl-material 32x24", ibl)):
            scene = _hybrid_on_card(scene_from_numpy(c.data), c.settings)
            out[name] = (c, scene, c.settings, gg.mean_grad(scene, c.settings, CPU))
    return out


def _check_fd(fd_scenes, name, case):
    _, scene, st, grad = fd_scenes[name]
    r = gg.fd_vs_ad(scene, st, {case: gg.KERNEL2_FD[name][case]}, CPU, grad)[case]
    assert r["ok"], r


@pytest.mark.parametrize("case", list(gg.GLOSSY_FD))
def test_hybrid_fd_on_glossy_scene(fd_scenes, case):
    _check_fd(fd_scenes, "glossy", case)


@pytest.mark.parametrize("case", list(gg.IBL_MATERIAL_FD))
def test_every_family_fd_on_ibl_material(fd_scenes, case):
    _check_fd(fd_scenes, "ibl-material 32x24", case)


@pytest.mark.parametrize("fault", ["wrong sign", "zero", "off by a third"])
def test_fd_gate_fails_on_a_wrong_gradient(fd_scenes, fault):
    """The gate that phase 30 and the tests share fails where the AD
    gradient is of the wrong sign, exactly 0 or a third off, each in turn
    put into the AD side of the glossy scene's roughness case."""
    _, scene, st, grad = fd_scenes["glossy"]
    table, field, idx, *_ = case = gg.GLOSSY_FD["roughness"]
    g = float(getattr(getattr(grad, table), field)[idx])
    bad = {"wrong sign": -g, "zero": 0.0, "off by a third": g * 4 / 3}[fault]
    r = gg.fd_vs_ad(scene, st, {fault: case}, CPU, gg.set_leaf(grad, table, field, idx, bad))
    assert not r[fault]["ok"], r


@pytest.mark.parametrize("n", [6, 7])
def test_fd_gate_takes_cases_without_a_sign(fd_scenes, n):
    """A case of six fields (phase 12's) or seven (a pixel rule, phase
    25's) has no sign: the gate holds on |AD - FD| alone."""
    _, scene, st, grad = fd_scenes["glossy"]
    case = gg.GLOSSY_FD["roughness"][:6] + ("interior",) * (n - 6)
    r = gg.fd_vs_ad(scene, st, {"case": case}, CPU, grad)["case"]
    assert r["ok"] and r["sign"] == 0 and r["pixels"] == (case[6] if n == 7 else None), r


def test_gate_scenes_are_the_jax_tests():
    """The scene strings that phase 30 runs on the card are the JAX tests'."""
    assert gg.MIXED_DIFF_SCENE == SCENE.replace("INTEGRATOR", "pt-direct")
    assert gg.GLOSSY_DIFF_SCENE == GLOSSY_DIFF_SCENE


def test_emission_grad_analytic_direct_view():
    c = _compiled(SCENE.replace("INTEGRATOR", "pt"), 8, max_bounces=1)
    st = c.settings
    scene = _hybrid_on_card(scene_from_numpy(c.data), st)
    ge, share = gg.direct_view(scene, st, CPU)
    jp0 = jax_params_of(c.data)
    want = jax.jit(jax.grad(lambda p: jnp.mean(jax_render_diff(
        c.data, st, p, SEED, st.spp, params_sample=jp0)), allow_int=True))(jp0)
    assert 0 < share < 1
    assert (ge >= 0).all() and ge[0] == ge[1] == ge[2], ge
    np.testing.assert_allclose(ge, share / 3, rtol=1e-6)
    np.testing.assert_allclose(ge, np.asarray(want.materials.emission[0]), rtol=1e-6)


def _reference_nonfinite(got, want):
    """The JAX package's float gradient leaves that are not finite, where
    the port's are: (`want` with those leaves set to the port's, their
    names). The reference's GGX G1 (`lumillyrender_tpu/ops/bsdf.py:115`)
    gives NaN in its VJP where |cos| of a direction to the normal is below
    ~2.3e-10 (1 / max(cos^2, 1e-20)'s derivative overflows float32), as an
    NEE direction from a point of ibl-material's key light to another point
    of it is, on the lanes that run the GGX branch masked; the NaN reaches
    the camera's leaves (ROADMAP queue 3)."""
    mine = params_to_numpy(got)
    names, parts = [], {}
    for part in ("materials", "camera", "sky"):
        table, repl = getattr(want, part), {}
        for f in dataclasses.fields(table):
            w = np.asarray(getattr(table, f.name))
            if np.issubdtype(w.dtype, np.floating) and not np.isfinite(w).all():
                assert np.isfinite(mine[part][f.name]).all(), (part, f.name)
                names.append(f"{part}.{f.name}")
                repl[f.name] = jnp.asarray(mine[part][f.name])
        parts[part] = dataclasses.replace(table, **repl)
    return want._replace(**parts), names


def _flip_mask(film, j_film):
    """Pixels whose two forward films agree (FLIP's rule), (h, w) bool."""
    flipped = np.abs(film - j_film).max(axis=2) > FLIP * np.abs(j_film).max()
    assert flipped.mean() < parity.LIMITS["excluded"], int(flipped.sum())
    return ~flipped


def test_ibl_material_grads_match_jax_grad(fd_scenes):
    c, scene, st, _ = fd_scenes["ibl-material 32x24"]
    jp0 = jax_params_of(c.data)

    def objective(p, mask):
        film = jax_render_diff(c.data, st, p, SEED, st.spp, params_sample=jp0)
        return jnp.sum(film * mask) / jnp.sum(mask), film

    jax_grad = jax.jit(jax.value_and_grad(objective, has_aux=True, allow_int=True))
    (_, j_film), _ = jax_grad(jp0, jnp.ones((st.height, st.width, 3), jnp.float32))
    p0 = params_of(scene)
    film = render_diff(scene, st, p0, SEED, st.spp, params_sample=p0, device=CPU).numpy()
    keep = _flip_mask(film, np.asarray(j_film))
    mask = np.broadcast_to(keep[..., None], film.shape).astype(np.float32)
    _, want = jax_grad(jp0, jnp.asarray(mask))
    m = torch.from_numpy(mask)
    got = pixel_grad(scene, st, p0, SEED, st.spp, lambda f: (f * m).sum() / m.sum(),
                     params_sample=p0, device=CPU)
    want, nonfinite = _reference_nonfinite(got, want)
    print(f"ibl-material: leaves whose jax.grad is not finite (ROADMAP queue 3, found in the "
          f"reference): {nonfinite}")
    assert set(nonfinite) <= CAMERA_LEAVES, nonfinite
    _assert_params_close(got, want, WHOLE_PATH_RTOL)
    for k in ("color", "alpha", "ior", "absorbtance"):
        assert getattr(got.materials, k).abs().sum() > 0, k


@pytest.fixture(scope="module")
def heroes(assets_dir):
    """The JAX compiler's scene of each hero, compiled once."""
    return {name: jax_compile(assets_dir / f"{name}.toml")
            for name in sorted({v[0] for v in HERO_VIEWS.values()})}


def _with_materials(jp, mats):
    """The JAX package's params with the port's material table's floats."""
    return jp._replace(materials=dataclasses.replace(jp.materials, **{
        k: jnp.asarray(getattr(mats, k).numpy()) for k in ("color", "alpha", "ior", "absorbtance")}))


@pytest.mark.parametrize("view", list(HERO_VIEWS))
def test_hero_film_and_grads_match_jax(heroes, view):
    name, rows, w, h, spp, bounces, fields = HERO_VIEWS[view]
    c = dataclasses.replace(heroes[name])
    scene, st = gg.view_of_rows(scene_from_numpy(c.data), c.settings, list(rows), w, h, spp)
    st = dataclasses.replace(st, max_bounces=bounces)
    _hybrid_on_card(scene, st)
    c.data = dataclasses.replace(c.data, camera=dataclasses.replace(
        c.data.camera, position=jnp.asarray(scene.camera.position.numpy()),
        sensor_size=jnp.asarray(scene.camera.sensor_size.numpy())))
    c.settings = st

    # Each package's target is its own film at the true parameters: the
    # loss's weights are residuals, small on the pixels the perturbed rows
    # barely reach, where a target shared across the packages would weigh
    # their last-bit film differences as residual (on ridaisai's floor,
    # 1.2% of its albedo's gradient).
    p_true = params_of(scene)
    jp_true = jax_params_of(c.data)
    p = p_true._replace(materials=gg.perturbed_rows(p_true.materials, rows))
    jp = _with_materials(jp_true, p.materials)
    zero = jnp.zeros((h, w, 3), jnp.float32)
    target = render_diff(scene, st, p_true, TRAIN_SEED, spp, device=CPU).numpy()
    j_target = np.asarray(jax_film_and_grads(c.data, st, jp_true, zero, TRAIN_SEED, spp)[1])
    film = render_diff(scene, st, p, TRAIN_SEED, spp, device=CPU).numpy()
    j_film = np.asarray(jax_film_and_grads(c.data, st, jp, zero, TRAIN_SEED, spp)[1])
    keep = (_flip_mask(film, j_film) & _flip_mask(target, j_target))[..., None]
    t_port = np.where(keep, target, film)
    t_jax = np.where(keep, j_target, j_film)

    loss, f, grads = film_and_grads(scene, st, p, torch.from_numpy(t_port), TRAIN_SEED, spp,
                                    device=CPU)
    j_loss, j_f, j_grads = jax_film_and_grads(c.data, st, jp, jnp.asarray(t_jax), TRAIN_SEED,
                                              spp)
    assert abs(float(loss) - float(j_loss)) <= 1e-4 * float(j_loss)
    assert np.array_equal(f.numpy(), film)
    assert np.abs(np.where(keep, film - np.asarray(j_f), 0)).max() <= FLIP * np.abs(film).max()
    _assert_params_close(grads, j_grads, WHOLE_PATH_RTOL)
    for k in fields:
        for r in rows:
            assert getattr(grads.materials, k)[r].abs().sum() > 0, (k, r)
            assert np.abs(np.asarray(getattr(j_grads.materials, k)[r])).sum() > 0, (k, r)


@pytest.mark.parametrize("cos", [1e-12, 1e-10, 1.5e-10, 2e-10, 3e-10, 1e-5, 0.3])
@pytest.mark.parametrize("a2", [0.0, 0.41])
def test_ggx_g1_gradient_is_finite_at_grazing_cosines(cos, a2):
    """The fault phase 30 of chip_smoke.py found on welcome at full width
    (one lane of 3,283,968 at bounce 7 put NaN into every camera leaf):
    the GGX G1's gradient for a direction within ~2.3e-10 of the surface's
    plane, where 1 / cos^2's derivative overflows float32 and a zero
    cotangent times it gave NaN. The port's value is the reference's bit
    for bit, its gradient finite, and where cos^2 is past the gradient's
    floor, the reference's gradient; the reference's is NaN at every
    cosine under ~3e-10 (printed; ROADMAP queue 3)."""
    from lumillyrender_tpu.ops import bsdf as jax_bsdf
    from lumillyrender_tpu_torch.ops import bsdf

    n = np.array([[1.0, 0.0, 0.0]], np.float32)

    def jax_g1(c):
        v = jnp.stack([c, jnp.sqrt(1.0 - c * c), jnp.float32(0.0)])[None]
        return jax_bsdf._ggx_g1(v, jnp.asarray(n), jnp.asarray([a2], jnp.float32))[0]

    c = torch.tensor(cos, dtype=torch.float32, requires_grad=True)
    v = torch.stack([c, torch.sqrt(1.0 - c * c), torch.zeros(())])[None]
    g1 = bsdf._ggx_g1(v, torch.from_numpy(n), torch.tensor([a2]))[0]
    grad, = torch.autograd.grad(g1, c)
    want = jax_g1(jnp.float32(cos))
    want_grad = float(jax.grad(jax_g1)(jnp.float32(cos)))
    print(f"cos {cos}, a2 {a2}: G1 {g1.item()!r} (reference {float(want)!r}); gradient "
          f"{grad.item()!r} (reference {want_grad!r})")
    assert np.float32(g1.item()) == np.float32(want)
    assert np.isfinite(grad.item())
    if cos * cos >= 1e-19:
        assert abs(grad.item() - want_grad) <= 1e-6 * max(abs(want_grad), 1e-30)


@pytest.mark.parametrize("scale", [0.0, 1e-30, 1e-10, 1.0])
def test_safe_normalize_gradient_is_finite_at_zero(scale):
    """The second fault phase 30 found on welcome at full width (the same
    lane): the half vector of a sampled direction opposite the outgoing
    one, `safe_normalize(in + out)` of a zero vector, whose root's infinite
    derivative times the zero cotangent of max(|a|, eps) gave NaN. The
    port's value is the reference's bit for bit and its gradient finite
    (1 / eps at zero, the derivative of a / eps); the reference's is NaN
    there (printed; ROADMAP queue 3)."""
    from lumillyrender_tpu.ops import vec as jax_vec
    from lumillyrender_tpu_torch.ops import vec

    a0 = np.array([[3.0, -4.0, 12.0]], np.float32) * np.float32(scale)
    a = torch.from_numpy(a0).requires_grad_()
    h = vec.safe_normalize(a)
    grad, = torch.autograd.grad(h.sum(), a)
    want = jax_vec.safe_normalize(jnp.asarray(a0))
    want_grad = np.asarray(jax.grad(lambda x: jax_vec.safe_normalize(x).sum())(jnp.asarray(a0)))
    print(f"|a| {scale * 13}: gradient {grad.numpy().tolist()} (reference {want_grad.tolist()})")
    np.testing.assert_array_equal(h.detach().numpy(), np.asarray(want))
    assert torch.isfinite(grad).all()
    if scale >= 1e-10:
        np.testing.assert_allclose(grad.numpy(), want_grad, rtol=1e-6)


# The plain step's guarded values whose derivatives no gate had reached:
# each site with its degenerate input (ROADMAP queue 3). "repaired": the
# port's gradient was NaN there and is finite now, the value the
# reference's; "finite": audited, the gradient finite as it was.
DERIVATIVE_SITES = {
    "light_point_on_the_shading_point": "repaired",  # wavefront._direct_light: wi's |path|
    "zero_length_shadow_path": "finite",  # _direct_light: g's |path|^2
    "rr_prob_zero_on_a_live_lane": "finite",  # plain_bounce_step: throughput / prob
    "refraction_i_dot_n_+1e-30": "repaired",  # bsdf.eval_brdf: 1 / (in . n)
    "refraction_i_dot_n_-1e-30": "repaired",
    "refraction_i_dot_n_0": "finite",
}


def _finite(grads) -> bool:
    return all(bool(np.isfinite(np.asarray(g)).all()) for g in grads)


def _direct_light_site(assets_dir, site, monkeypatch):
    """`_direct_light` on new-cbox's lanes with the shading point of lane 0
    at its sampled light point (path 0): (the port's contributions, the
    same with wi's distance by `vec.norm`, the unrepaired formula, the
    port's gradients in the point, the normal, the outgoing direction and
    the live albedo, JAX's)."""
    from lumillyrender_tpu.integrator import wavefront as jax_wavefront
    from lumillyrender_tpu.ops import bsdf as jax_bsdf
    from lumillyrender_tpu.ops import intersect as jax_intersect
    from lumillyrender_tpu_torch.integrator import wavefront
    from lumillyrender_tpu_torch.ops import bsdf, intersect, rng, vec

    c = jax_compile(assets_dir / "new-cbox.toml", spp=1)
    scene, st = scene_from_numpy(c.data), c.settings
    n, seed, ctr = 4, 7, 3 * wavefront._SLOTS
    lane = torch.arange(n, dtype=torch.int32)
    mat = torch.ones(n, dtype=torch.int32)  # a non-emissive row
    light, _ = wavefront._sample_light_point(scene, *rng.uniform4(seed, lane, ctr + wavefront._NEE)[:3])
    pos0 = torch.tensor([[278.0, 1.0, 279.0]] * n)
    pos0[0] = light[0]  # both sites see a zero path on lane 0
    nrm0 = torch.tensor([[0.0, 1.0, 0.0]] * n)
    out0 = torch.tensor([[0.0, 1.0, 0.0]] * n)
    col0 = scene.materials.color.clone()

    def port():
        xs = [t.clone().requires_grad_() for t in (pos0, nrm0, out0, col0)]
        sp = intersect.ShadePoint(xs[0], xs[1], mat, torch.ones(n, dtype=torch.bool))
        contrib = wavefront._direct_light(
            scene, st, sp, xs[2], bsdf.gather(scene.materials, mat), lane, seed, ctr,
            torch.ones(n, dtype=torch.bool), dataclasses.replace(scene.materials, color=xs[3]))
        grads = torch.autograd.grad(contrib.sum(), xs, allow_unused=True)
        return contrib.detach(), [torch.zeros(1) if g is None else g for g in grads]

    got, grads = port()
    monkeypatch.setattr(vec, "norm_at_zero", vec.norm)
    unrepaired, _ = port()
    monkeypatch.undo()
    jmat = jnp.asarray(mat.numpy())

    def jax_sum(p, nn, od, col):
        sp = jax_intersect.ShadePoint(p, nn, jmat, jnp.ones(n, bool))
        mats = dataclasses.replace(c.data.materials, color=col)
        return jax_wavefront._direct_light(
            c.data, st, sp, od, mats, jax_bsdf.gather(c.data.materials, jmat),
            jnp.asarray(lane.numpy()), seed, ctr).sum()

    want = jax.grad(jax_sum, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(t.numpy()) for t in (pos0, nrm0, out0, col0)))
    assert torch.equal(light[0] - pos0[0], torch.zeros(3))
    return got, unrepaired, grads, want


def _rr_site(assets_dir, monkeypatch):
    """One plain bounce of new-cbox's camera rays whose sampling table has
    every albedo 0 (the detached table `bsdf.rr_weight` reads: prob 0 on
    every live lane that hits), at bounce 0 and past the RR depth: the
    port's output sum, its gradients in o, d, throughput and the live
    albedo and emission, JAX's, and whether every lane died."""
    from lumillyrender_tpu.integrator import wavefront as jax_wavefront
    from lumillyrender_tpu_torch.integrator import wavefront
    from lumillyrender_tpu_torch.ops import cuda_bounce as cb

    c = jax_compile(assets_dir / "new-cbox.toml", spp=1)
    st = dataclasses.replace(c.settings, width=8, height=8)
    scene = scene_from_numpy(c.data)
    n = 64
    o, d, _, _ = cb.plain_generate_rays(scene, st, 3, 0, n)
    lane = torch.arange(n, dtype=torch.int32)
    zero = dataclasses.replace(scene.materials, color=torch.zeros_like(scene.materials.color))
    j_zero = dataclasses.replace(c.data.materials, color=jnp.zeros_like(c.data.materials.color))
    out = []
    for bounce in (0, st.depth + 2):
        xs = [t.clone().requires_grad_() for t in (o, d, torch.ones(n, 3), scene.materials.color,
                                                    scene.materials.emission)]
        mats = dataclasses.replace(scene.materials, color=xs[3], emission=xs[4])
        state = wavefront.PathState(bounce, xs[0], xs[1], xs[2], torch.zeros(n, 3),
                                    torch.ones(n, dtype=torch.bool), torch.zeros(()), lane)
        s = wavefront.plain_bounce_step(dataclasses.replace(scene, materials=zero), st, 3,
                                        state, mats)
        total = s.o.sum() + s.d.sum() + s.throughput.sum() + s.accum.sum()
        grads = torch.autograd.grad(total, xs, allow_unused=True)

        def jax_total(o_, d_, t_, col, em, bounce=bounce):
            me = dataclasses.replace(c.data.materials, color=col, emission=em)
            step = jax_wavefront.make_bounce_step(dataclasses.replace(c.data, materials=j_zero),
                                                  st, 3, mats_eval=me, allow_fused=False)
            s2 = step(jax_wavefront.PathState(
                jnp.int32(bounce), o_, d_, t_, jnp.zeros((n, 3)), jnp.ones(n, bool),
                jnp.float32(0), jnp.asarray(lane.numpy()).astype(jnp.uint32)))
            return s2.o.sum() + s2.d.sum() + s2.throughput.sum() + s2.accum.sum()

        want = jax.grad(jax_total, argnums=(0, 1, 2, 3, 4))(
            *(jnp.asarray(t.detach().numpy()) for t in xs))
        # Every lane dies: a miss, or a hit whose roulette prob is 0.
        out.append((total.detach(), [torch.zeros(1) if g is None else g for g in grads],
                    want, not bool(s.alive.any())))
    return out


def _refraction_site(i_dot_n, monkeypatch):
    """`bsdf.eval_brdf` of an ideal refraction lane and a Lambert lane (the
    refraction branch evaluated and masked) with in . n = `i_dot_n`: the
    port's f, f with the unrepaired 1 / where(in . n != 0, in . n, 1), the
    gradients in in, out, n, the colour and the IOR, JAX's."""
    from lumillyrender_tpu.ops import bsdf as jax_bsdf
    from lumillyrender_tpu_torch.ops import bsdf

    x0 = [np.array([[1.0, i_dot_n, 0.0]] * 2, np.float32),
          np.array([[0.6, 0.8, 0.0]] * 2, np.float32), np.array([[0.0, 1.0, 0.0]] * 2, np.float32),
          np.array([[0.9, 0.8, 0.7]] * 2, np.float32), np.array([1.5, 1.5], np.float32)]
    types = np.array([4, 0], np.int32)  # ideal refraction, Lambert

    def port():
        xs = [torch.from_numpy(x).requires_grad_() for x in x0]
        m = bsdf.GatheredMaterial(torch.from_numpy(types), xs[3], torch.zeros(2, 3),
                                  torch.ones(2), xs[4], torch.zeros(2))
        f = bsdf.eval_brdf(m, xs[1], xs[0], xs[2], torch.zeros(2, 3))
        return f.detach(), torch.autograd.grad(f.sum(), xs)

    got, grads = port()
    monkeypatch.setattr(bsdf, "_inv_idn", lambda x: 1.0 / bsdf._where(x != 0.0, x, 1.0))
    unrepaired, _ = port()
    monkeypatch.undo()

    def jax_sum(i, o, nn, col, ior):
        m = jax_bsdf.GatheredMaterial(jnp.asarray(types), col, jnp.zeros((2, 3)), jnp.ones(2),
                                      ior, jnp.zeros(2))
        return jax_bsdf.eval_brdf(m, o, i, nn, jnp.zeros((2, 3))).sum()

    want = jax.grad(jax_sum, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(x) for x in x0))
    return got, unrepaired, grads, want


@pytest.mark.parametrize("site", list(DERIVATIVE_SITES))
def test_plain_step_derivative_sites(assets_dir, monkeypatch, site):
    """The four places of the plain step that guard a value but not its
    derivative, each at its degenerate input, called directly on the CPU:
    the value bit-equal to the unrepaired formula, every live leaf's
    gradient finite, and the JAX package's `jax.grad` on the same input
    read (ROADMAP's "Found in the reference" where it is NaN).

    * wi = path / max(|path|, 1e-20) with the light point on the shading
      point: |path|'s root has an infinite derivative at 0, and the max's
      zero cotangent times it was NaN in the point's gradient (JAX's too);
      `vec.norm_at_zero` takes the root of 1 there.
    * g's 1 / max(|path|^2, 1e-20) at the same zero path: the max passes a
      zero cotangent to |path|^2, whose derivative 2 path is 0: finite.
      (Below ~5.4e-20 and above 1e-20 the quotient's derivative would
      overflow, but at a light's scene coordinates the shortest nonzero
      path is an ulp of them, ~3e-5 on new-cbox.) JAX's gradient at this
      input is NaN through the first site's root; this site's term alone,
      with a nonzero cotangent at a zero path, is finite in the port
      (PyTorch's clamp selects its cotangent) and NaN in JAX (its maximum
      multiplies the quotient's overflowed derivative, -inf, by 0).
    * throughput / max(prob, 1e-12) with prob 0 on live lanes: prob comes
      from the detached sampling table, so no cotangent reaches a live
      leaf through it; the lane dies, its 1e12-scaled throughput meets
      only zero cotangents: finite on both.
    * 1 / where(in . n != 0, in . n, 1) at +-1e-30: the reciprocal's
      derivative, -1 / (in . n)^2, overflows, and a zero cotangent (the
      Lambert lane's masked branch) or a nonzero one times it was NaN
      through n's zero components (JAX's too); `bsdf._inv_idn` floors the
      derivative's |in . n| at 1e-19. At exactly 0 the where passes
      nothing: finite (JAX's NaN there comes from its unrepaired GGX G1,
      PR 24's site)."""
    status = DERIVATIVE_SITES[site]
    if site in ("light_point_on_the_shading_point", "zero_length_shadow_path"):
        got, unrepaired, grads, want = _direct_light_site(assets_dir, site, monkeypatch)
        assert torch.equal(got, unrepaired)
        assert _finite(grads)
        print(f"{site}: port gradient finite; JAX's {_finite(want)}")
        assert not _finite(want)  # the first site's root, on both inputs
        if site == "zero_length_shadow_path":
            path = np.zeros((1, 3), np.float32)
            jt = jax.grad(lambda p: (0.5 / jnp.maximum(jnp.sum(p * p, axis=-1), 1e-20)).sum())
            pt = torch.zeros(1, 3, requires_grad=True)
            from lumillyrender_tpu_torch.ops import vec
            g, = torch.autograd.grad((0.5 / torch.clamp(vec.sqr_norm(pt), min=1e-20)).sum(), pt)
            # The term alone with a nonzero cotangent: the port's clamp
            # selects its cotangent, JAX's maximum multiplies -0.5 / 1e-40
            # (-inf) by 0: NaN in the reference (ROADMAP).
            assert _finite([g]) and not _finite([jt(jnp.asarray(path))])
    elif site == "rr_prob_zero_on_a_live_lane":
        for total, grads, want, dead in _rr_site(assets_dir, monkeypatch):
            assert dead and _finite([total]) and _finite(grads) and _finite(want)
            for g, w in zip(grads, want):
                w = np.asarray(w)
                if g.shape == w.shape:
                    np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6)
    else:
        i_dot_n = {"+1e-30": 1e-30, "-1e-30": -1e-30, "0": 0.0}[site.rsplit("_", 1)[1]]
        got, unrepaired, grads, want = _refraction_site(i_dot_n, monkeypatch)
        assert torch.equal(got, unrepaired) and bool(torch.isfinite(got).all())
        assert _finite(grads)
        print(f"{site}: port gradient finite; JAX's {_finite(want)}")
        assert not _finite(want)  # at 0 through JAX's G1 (PR 24), else this site
    assert status in ("repaired", "finite")
