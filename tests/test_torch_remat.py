"""The `bwd_remat` recompute policies "isect" and "isect+samp" and the
`fused` switch of the port, on the CPU.

* `film_and_grads` under `fused="off"` and each `isect` policy against the
  JAX package's `film_and_grads` under the same settings, on the mixed
  Lambert/GGX scene of tests/test_diff.py under an IBL sky (brute force)
  and on welcome-geo (BASELINE config 5: the BVH), at 12x9 x 2 spp and
  three bounces, every albedo at 0.8 of its value (so that every leaf's
  gradient stands well above float noise: the gate is relative to each
  leaf): the loss within 1e-4, every float leaf within 1e-3 of its
  largest magnitude (tests/test_torch_diff.py's gate). Each side's target
  is its own film at the true parameters, so that the packages' last-bit
  differences leave no residual in the loss; as
  tests/test_torch_diff_hybrid.py does, the pixels whose forward films
  differ by more than 1e-5 of the film max between the packages (a lane
  whose camera ray differs in the last bit) get each side's own film as
  target.
* What the backward pass runs, counted: under "full" both queries'
  searches (the welcome-geo walks) and both samples again each bounce,
  under "isect" no search, under "isect+samp" no search and no sample,
  under "none" and "hybrid" (narrow stages) nothing; the gradients bit-equal
  to "none" under every policy, through `trace` as through `trace_film`,
  and across a stage ladder that compacts the wavefront.
* `fused="off"` takes autograd of the plain step on the CPU and the card
  (`diff_step_kind`), even for a Lambert brute-force scene; `fused="on"`
  and intersector "pallas" raise on the CPU; "pallas" refuses leaves no
  walk kernel serves; the CLI's `--fused off --device cpu` writes the
  image the CPU run writes without it.

Inputs are compiled by the JAX package and carried across with
`convert.py`.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumillyrender_tpu.diff.render import film_and_grads as jax_film_and_grads
from lumillyrender_tpu.diff.render import params_of as jax_params_of
from lumillyrender_tpu.diff.render import render_diff as jax_render_diff
from lumillyrender_tpu.scene.compiler import compile_scene_file as jax_compile
from lumillyrender_tpu_torch import cli, parity
from lumillyrender_tpu_torch.convert import params_from_numpy, scene_from_numpy, settings_from
from lumillyrender_tpu_torch.diff import film_and_grads, params_of, render_diff
from lumillyrender_tpu_torch.diff.render import leaves, map_params
from lumillyrender_tpu_torch.integrator import wavefront
from lumillyrender_tpu_torch.integrator.render import ChunkRenderer
from lumillyrender_tpu_torch.ops import bsdf, cuda_bounce, intersect
from lumillyrender_tpu_torch.scene.compiler import compile_scene_file
from lumillyrender_tpu_torch.scene.data import Bvh
from test_fused_bounce import LAMBERT_DIFF_SCENE
from test_torch_diff import WHOLE_PATH_RTOL, _assert_params_close, _compiled, _mixed, _with_ibl

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SEED = 33
SPP = 2
FLIP = 1e-5  # tests/test_torch_diff_hybrid.py's flipped-pixel share of the film max
POLICIES = ("none", "full", "hybrid", "isect", "isect+samp")


@pytest.fixture(scope="module")
def compiled(assets_dir):
    """name -> the JAX-compiled scene at 12x9 x 2 spp, three bounces."""
    small = dict(width=12, height=9, max_bounces=3, fused="off")
    mixed = _with_ibl(_mixed(spp=SPP))
    mixed.settings = dataclasses.replace(mixed.settings, **small)
    geo = jax_compile(assets_dir / "welcome-geo.toml", spp=SPP)
    geo.settings = dataclasses.replace(geo.settings, **small)
    return {"mixed-ibl": mixed, "welcome-geo": geo}


@pytest.mark.parametrize("mode", ["isect", "isect+samp"])
@pytest.mark.parametrize("name", ["mixed-ibl", "welcome-geo"])
def test_film_and_grads_match_jax(compiled, name, mode):
    c = compiled[name]
    st = dataclasses.replace(c.settings, bwd_remat=mode)
    scene = scene_from_numpy(c.data)
    assert cuda_bounce.diff_step_kind(scene, st, on_card=False) == "plain"
    p_true = params_from_numpy(jax_params_of(c.data))
    target = render_diff(scene, st, p_true, SEED, SPP, device="cpu")
    p = p_true._replace(materials=dataclasses.replace(
        p_true.materials, color=p_true.materials.color * 0.8))
    jp = jax_params_of(c.data)
    jp = jp._replace(materials=dataclasses.replace(jp.materials, color=jp.materials.color * 0.8))

    film = render_diff(scene, st, p, SEED, SPP, device="cpu").numpy()
    j_target = np.asarray(jax_render_diff(c.data, st, jax_params_of(c.data), SEED, SPP))
    # The JAX step's film at p (a second call reuses the compiled step).
    j_film = np.asarray(jax_film_and_grads(c.data, st, jp, jnp.asarray(j_target), SEED,
                                           SPP)[1])
    flipped = np.abs(film - j_film).max(axis=2) > FLIP * np.abs(j_film).max()
    assert flipped.mean() < parity.LIMITS["excluded"], int(flipped.sum())
    keep = ~flipped[..., None]
    t_port = np.where(keep, target.numpy(), film)
    t_jax = np.where(keep, j_target, j_film)

    loss, f, grads = film_and_grads(scene, st, p, torch.from_numpy(t_port), SEED, SPP,
                                    device="cpu")
    j_loss, _, j_grads = jax_film_and_grads(c.data, st, jp, jnp.asarray(t_jax), SEED, SPP)
    assert abs(float(loss) - float(j_loss)) <= 1e-4 * float(j_loss)
    assert np.array_equal(f.numpy(), film)
    _assert_params_close(grads, j_grads, WHOLE_PATH_RTOL)
    assert grads.materials.color.abs().sum() > 0 and grads.camera.position.abs().sum() > 0


class _Counts:
    """Calls of the searches, the plain walk and both samplers."""

    def __init__(self, monkeypatch):
        self.n = dict(search=0, walk=0, bsdf_sample=0, light_sample=0)
        for mod, name, key in ((intersect, "search", "search"), (intersect, "_walk_tris", "walk"),
                               (bsdf, "sample", "bsdf_sample"),
                               (wavefront, "_sample_light_point", "light_sample")):
            def counted(*a, _fn=getattr(mod, name), _key=key, **k):
                self.n[_key] += 1
                return _fn(*a, **k)
            monkeypatch.setattr(mod, name, counted)

    def take(self):
        n = dict(self.n)
        self.n = dict.fromkeys(self.n, 0)
        return n


def _live(params):
    return map_params(params, lambda t: t.detach().requires_grad_(t.is_floating_point()))


def _grads(value, live):
    xs = [t for t in leaves(live) if t.requires_grad]
    return [torch.zeros_like(x) if g is None else g
            for g, x in zip(torch.autograd.grad(value, xs, allow_unused=True), xs)]


@pytest.mark.parametrize("name", ["mixed-ibl", "welcome-geo"])
def test_what_the_backward_pass_runs(compiled, monkeypatch, name):
    """Per bounce, the backward pass runs both queries' searches and both
    samples again under "full", the samples alone under "isect", nothing
    under "isect+samp", "none" and "hybrid" (its stages are narrow here);
    every policy's gradients are "none"'s bit for bit."""
    c = compiled[name]
    scene = scene_from_numpy(c.data)
    p0 = params_from_numpy(jax_params_of(c.data))
    counts = _Counts(monkeypatch)
    bounces = c.settings.max_bounces
    per_bounce = dict(search=2, walk=2 if name == "welcome-geo" else 0, bsdf_sample=1,
                      light_sample=1)
    nothing = dict.fromkeys(per_bounce, 0)
    want = {"none": nothing, "hybrid": nothing, "isect+samp": nothing,
            "full": {k: v * bounces for k, v in per_bounce.items()},
            "isect": dict(nothing, bsdf_sample=bounces, light_sample=bounces)}
    grads = {}
    for mode in POLICIES:
        st = dataclasses.replace(c.settings, bwd_remat=mode)
        live = _live(p0)
        film = render_diff(scene, st, live, SEED, SPP, device="cpu")
        assert counts.take() == {k: v * bounces for k, v in per_bounce.items()}, mode
        grads[mode] = _grads(film.mean(), live)
        assert counts.take() == want[mode], mode
    for mode in POLICIES:
        for a, b in zip(grads[mode], grads["none"]):
            assert torch.equal(a, b), mode


@pytest.mark.parametrize("mode", ["isect", "isect+samp"])
def test_isect_policies_through_trace_and_a_compacting_ladder(mode):
    """`trace` (one stage, no banking) and `trace_film` over a stage ladder
    whose widths change (48x48 x 2 spp = 4,608 lanes compacted to 4,096 at
    bounce 4) give "none"'s gradients bit for bit."""
    c = _with_ibl(_mixed(spp=SPP, max_bounces=6))
    c.settings = dataclasses.replace(c.settings, width=48, height=48, depth=1, fused="off")
    scene = scene_from_numpy(c.data)
    st = settings_from(c.settings)
    n = st.width * st.height * SPP
    plan = wavefront._stage_plan(n, st)
    assert [w for w, _, _ in plan] == [n, 4096]
    p0 = params_of(scene)
    rng = np.random.default_rng(4)
    # Rays from the camera's origin into its view (tests/test_diff.py's SCENE).
    o0 = torch.from_numpy((np.array([165.0, 0.0, 135.0])
                           + rng.uniform(-1.0, 1.0, size=(256, 3))).astype(np.float32))
    d0 = torch.from_numpy((np.array([0.0, 0.0, 1.0])
                           + rng.uniform(-0.3, 0.3, size=(256, 3))).astype(np.float32))
    lane = torch.arange(256, dtype=torch.int32)
    got = {}
    for policy in ("none", mode):
        s = dataclasses.replace(st, bwd_remat=policy)
        live = _live(p0)
        film = render_diff(scene, s, live, SEED, SPP, device="cpu")
        g_film = _grads((film * film).mean(), live)
        o, d = o0.clone().requires_grad_(), d0.clone().requires_grad_()
        rad, _ = wavefront.trace(scene, s, o, torch.nn.functional.normalize(d, dim=1), lane,
                                 SEED, differentiable=True, mats_eval=live.materials)
        got[policy] = g_film + list(torch.autograd.grad((rad * rad).sum(), [o, d]))
    for a, b in zip(got[mode], got["none"]):
        assert torch.equal(a, b)
    assert all(g.abs().sum() > 0 for g in got[mode][-2:])


def test_fused_switch_dispatch():
    """`fused="off"` takes autograd of the plain step on either device, a
    Lambert brute-force scene included (which takes the backward kernel
    otherwise); `fused="on"` raises on the CPU; an unknown value raises."""
    c = _compiled(LAMBERT_DIFF_SCENE)
    scene = scene_from_numpy(c.data)
    st = settings_from(c.settings)
    assert st.fused == "auto" and st.bwd_remat == "full"
    assert cuda_bounce.diff_step_kind(scene, st, on_card=False) == "bwd"
    off = dataclasses.replace(st, fused="off")
    for on_card in (False, True):
        assert cuda_bounce.diff_step_kind(scene, off, on_card=on_card) == "plain"
    assert cuda_bounce.make_step_diff(scene, off, SEED).fused_diff is False
    on = dataclasses.replace(st, fused="on")
    assert cuda_bounce.diff_step_kind(scene, on, on_card=True) == "bwd"
    for call in (lambda: cuda_bounce.diff_step_kind(scene, on, on_card=False),
                 lambda: cuda_bounce.make_step(scene, on, SEED),
                 lambda: cuda_bounce.make_step_diff(scene, on, SEED),
                 lambda: ChunkRenderer(scene, on, SEED, "cpu")):
        with pytest.raises(ValueError, match="only on a CUDA device"):
            call()
    with pytest.raises(ValueError, match="unknown fused mode"):
        cuda_bounce.make_step(scene, dataclasses.replace(st, fused="sometimes"), SEED)


def test_pallas_intersector_is_the_cards(assets_dir, tmp_path):
    """Intersector "pallas" raises on the CPU, where no walk kernel runs,
    and for leaves of a K that does not divide 128 (naming K), as the JAX
    package refuses such a layout; "bvh" keeps the plain walk there."""
    c = compile_scene_file(assets_dir / "welcome-geo.toml", spp=1, device="cpu")
    g, bvh = c.data.geometry, c.data.bvh
    o = torch.zeros((4, 3))
    d = torch.nn.functional.normalize(torch.ones((4, 3)), dim=1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        intersect.intersect(o, d, g, bvh, "pallas")
    assert intersect.intersect(o, d, g, bvh, "bvh").t.shape == (4,)
    for k in (3, 24):
        odd = Bvh(**{f.name: getattr(bvh, f.name)[:, :k] if getattr(bvh, f.name).dim() >= 2
                     and f.name.startswith("blk_") else getattr(bvh, f.name)
                     for f in dataclasses.fields(Bvh)})
        with pytest.raises(ValueError, match=f"K={k}"):
            intersect.search(o, d, g, odd, "pallas")
    with pytest.raises(ValueError, match="CUDA tensors"):
        cli.run([str(assets_dir / "welcome-geo.toml"), "--device", "cpu", "--intersector",
                 "pallas", "--spp", "1", "--resolution", "8", "8", "--out",
                 str(tmp_path / "never.png")])


def test_cli_fused_off_on_the_cpu_writes_the_same_image(assets_dir, tmp_path):
    argv = [str(assets_dir / "new-cbox.toml"), "--device", "cpu", "--spp", "2",
            "--resolution", "16", "16"]
    default = cli.run(argv + ["--out", str(tmp_path / "a.png")])
    off = cli.run(argv + ["--fused", "off", "--out", str(tmp_path / "b.png")])
    assert np.array_equal(default.film, off.film) and default.rays == off.rays
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()
    with pytest.raises(ValueError, match="only on a CUDA device"):
        cli.run(argv + ["--fused", "on", "--out", str(tmp_path / "c.png")])
