"""The JAX package's render-changing environment knobs in the port, on the CPU.

Each knob is set on both packages in one process: the ones read at import
as module attributes (`rng._MIXER`, `pack.TREELET_K`, `pack.WIDE_MIN_TRIS`),
the ones read at call time as environment variables. The JAX package caches
traces, so its caches are cleared whenever the mixer changes.

* `LLR_RNG=threefry`: the plain bounce step (new-cbox pt-direct with NEE,
  bounces 0, 3, 7; welcome-geo at K=24, bounce 1) against the JAX XLA step under
  tests/test_fused_bounce.py's lane rules; `_compact`'s resampling draw
  bit-equal; a new-cbox film against the JAX package's within the goldens'
  2% mean bound (the JAX film shown to differ from its pcg4d film, so a
  stale pcg4d trace cannot pass); `film_and_grads` at `fused="off"` against
  `jax.grad` of the JAX `render_diff` within tests/test_torch_diff.py's
  1e-3; on the card, every fused mode but "off" refused by name.
* `LLR_TREELET_K` / `LLR_WIDE_MIN_TRIS`: welcome-geo's BVH arrays equal to
  the JAX package's at K = 16, 24 and 64 and at K=128 from a low
  WIDE_MIN_TRIS (each compiled once for the module); the plain step at
  K=24, which no JAX kernel takes, against the JAX XLA step.
* `LLR_FUSED`, `LLR_FUSED_BVH`, `LLR_PALLAS`: the port's dispatch on the
  card (`cuda_bounce.step_mode`, `diff_step_kind`) against the JAX
  package's on its TPU (`pallas_bounce.enabled*`, with `on_tpu` true) over
  every combination; `LLR_FUSED=1` refused on the CPU, `LLR_PALLAS=0`
  refusing `intersector="pallas"` in both packages.
* `LLR_REORDER`: the port's sort against the JAX packet walk's (the ray
  sort keys each computes) over every combination with `reorder=`.
"""

import dataclasses
import functools
import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumillyrender_tpu.accel import pack as jax_pack
from lumillyrender_tpu.diff.render import params_of as jax_params_of
from lumillyrender_tpu.diff.render import render_diff as jax_render_diff
from lumillyrender_tpu.integrator import wavefront as jax_wavefront
from lumillyrender_tpu.integrator.render import render as jax_render
from lumillyrender_tpu.ops import intersect as jax_isect
from lumillyrender_tpu.ops import pallas_bounce, pallas_bvh
from lumillyrender_tpu.ops import rng as jax_rng
from lumillyrender_tpu.scene.compiler import compile_scene as jax_compile_scene
from lumillyrender_tpu.scene.compiler import compile_scene_file as jax_compile
from lumillyrender_tpu.scene.loader import parse_config as jax_parse
from lumillyrender_tpu_torch.accel import pack
from lumillyrender_tpu_torch.convert import (
    params_from_numpy,
    scene_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from lumillyrender_tpu_torch.diff import film_and_grads, render_diff
from lumillyrender_tpu_torch.integrator import wavefront
from lumillyrender_tpu_torch.integrator.render import render
from lumillyrender_tpu_torch.ops import cuda_bounce, rng
from lumillyrender_tpu_torch.ops import intersect as isect
from lumillyrender_tpu_torch.scene.compiler import compile_scene_file
from test_fused_bounce import LAMBERT_DIFF_SCENE, _assert_states_close, _mk_state, _random_state
from test_torch_diff import WHOLE_PATH_RTOL, _assert_params_close
from test_torch_render import MEAN_REL

torch.set_num_threads(2)

SEED = 77
ENV_KNOBS = ("LLR_FUSED", "LLR_FUSED_BVH", "LLR_PALLAS", "LLR_REORDER")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for k in ENV_KNOBS:
        monkeypatch.delenv(k, raising=False)


def _set_mixer(mixer):
    jax_rng._MIXER = rng._MIXER = mixer
    jax.clear_caches()


@pytest.fixture
def threefry(monkeypatch):
    monkeypatch.setattr(jax_rng, "_MIXER", "threefry")
    monkeypatch.setattr(rng, "_MIXER", "threefry")
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def cbox(assets_dir):
    ref = jax_compile(assets_dir / "new-cbox.toml", spp=1)
    return ref, scene_from_numpy(ref.data)


@pytest.fixture(scope="module")
def geo(assets_dir):
    ref = jax_compile(assets_dir / "welcome-geo.toml", spp=1)
    return ref, scene_from_numpy(ref.data)


def _as_ns(state):
    return types.SimpleNamespace(**state_to_numpy(state))


# ---------------------------------------------------------------------------
# LLR_RNG=threefry
# ---------------------------------------------------------------------------


def _step_matches_jax_step(ref, scene, tag, bounces, n, seed):
    """The port's plain step against the JAX XLA step on random states,
    under tests/test_fused_bounce.py's lane rules."""
    step_ref = jax_wavefront.make_bounce_step(ref.data, ref.settings, SEED, allow_fused=False)
    r = np.random.default_rng(seed)
    for bounce in bounces:
        parts = _random_state(r, ref.data, n=n)
        want = step_ref(_mk_state(parts, bounce))
        got = wavefront.plain_bounce_step(scene, ref.settings, SEED,
                                          state_from_numpy(bounce, *parts))
        _assert_states_close(want, _as_ns(got), f"{tag}@b{bounce}")


def test_threefry_plain_step_matches_jax_step(threefry, cbox):
    """new-cbox (pt-direct with NEE); welcome-geo's BVH bounce under
    threefry is held at K=24, in the leaf-width test below."""
    ref, scene = cbox
    _step_matches_jax_step(ref, scene, "new-cbox threefry", (0, 3, 7), 1536,
                           sum(map(ord, "new-cbox")))


def test_threefry_compact_draw_matches_jax(threefry, cbox):
    """Systematic resampling (96 of ~300 live lanes) keeps the JAX package's
    lanes: its jitter is a threefry draw, and pcg4d's keeps others."""
    ref, _ = cbox
    parts = _random_state(np.random.default_rng(4), ref.data)
    parts = parts[:4] + (np.random.default_rng(5).random(len(parts[0])) < 0.2, parts[5])
    kept = {}
    for mixer in ("threefry", "pcg4d"):
        _set_mixer(mixer)
        want = jax_wavefront._compact(_mk_state(parts, 8), 96, SEED, 0x50000001,
                                      salt=jnp.uint32(parts[5][0]))
        got = state_to_numpy(wavefront._compact(state_from_numpy(8, *parts), 96, SEED,
                                                0x50000001, salt=int(parts[5][0])))
        for k in ("o", "d", "throughput", "accum", "alive", "lane"):
            np.testing.assert_array_equal(got[k], np.asarray(getattr(want, k)), err_msg=k)
        kept[mixer] = got["lane"]
    assert not np.array_equal(kept["threefry"], kept["pcg4d"])


def test_threefry_film_matches_jax(cbox, assets_dir, monkeypatch):
    films = {}
    for mixer in ("pcg4d", "threefry"):
        monkeypatch.setattr(jax_rng, "_MIXER", mixer)
        monkeypatch.setattr(rng, "_MIXER", mixer)
        jax.clear_caches()
        c = jax_compile(assets_dir / "new-cbox.toml", spp=4)
        c.settings = dataclasses.replace(c.settings, width=32, height=32)
        p = compile_scene_file(assets_dir / "new-cbox.toml", spp=4, device="cpu")
        p.settings = c.settings
        films[mixer] = (np.asarray(jax_render(c, seed=1234).film),
                        render(p, seed=1234, device="cpu").film)
    jax.clear_caches()
    want, got = films["threefry"]
    assert np.isfinite(got).all() and got.shape == want.shape
    assert abs(got.mean() - want.mean()) / want.mean() < MEAN_REL
    # Not a pcg4d film on either side.
    assert np.abs(want - films["pcg4d"][0]).max() > 0.1
    assert np.abs(got - films["pcg4d"][1]).max() > 0.1


def test_threefry_film_and_grads_matches_jax(threefry):
    c = jax_compile_scene(jax_parse(LAMBERT_DIFF_SCENE), spp=4)
    c.settings = dataclasses.replace(c.settings, max_bounces=5, fused="off")
    scene, p_true = scene_from_numpy(c.data), params_from_numpy(jax_params_of(c.data))
    target = render_diff(scene, c.settings, p_true, 33, 4, device="cpu")
    t = p_true.materials.color.clone()
    t[1, 0] = 0.15
    p = p_true._replace(materials=dataclasses.replace(p_true.materials, color=t))
    jp = jax_params_of(c.data)
    jp = jp._replace(materials=dataclasses.replace(
        jp.materials, color=jp.materials.color.at[1, 0].set(0.15)))
    loss, film, grads = film_and_grads(scene, c.settings, p, target, 33, 4, device="cpu")
    j_target = jnp.asarray(target.numpy())

    def j_loss(q):
        f = jax_render_diff(c.data, c.settings, q, 33, 4)
        return jnp.mean((f - j_target) ** 2), f

    (want_loss, want_film), want = jax.value_and_grad(j_loss, has_aux=True,
                                                      allow_int=True)(jp)
    assert abs(float(loss) - float(want_loss)) <= 1e-4 * float(want_loss)
    assert np.abs(film.numpy() - np.asarray(want_film)).max() < 1e-4
    _assert_params_close(grads, want, WHOLE_PATH_RTOL)


@pytest.mark.parametrize("fused,env", [("auto", {}), ("on", {}), ("auto", {"LLR_FUSED": "1"}),
                                       ("off", {"LLR_FUSED_BVH": "1"})])
def test_threefry_refuses_the_bounce_kernels_on_the_card(threefry, cbox, geo, monkeypatch,
                                                         fused, env):
    """The card's dispatch (`on_card=True`) refuses every mode that would
    launch a bounce kernel, naming the mixer and the switch that renders
    it; "off" (here with LLR_FUSED_BVH=1, which "off" overrides) and the
    CPU take the plain step, which draws threefry."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for _, scene in (cbox, geo):
        st = dataclasses.replace(cbox[0].settings, fused=fused)
        if fused == "off":
            assert cuda_bounce.step_mode(scene, st, on_card=True) == "off"
            assert cuda_bounce.diff_step_kind(scene, st, on_card=True) == "plain"
            continue
        for call in (lambda: cuda_bounce.step_mode(scene, st, on_card=True),
                     lambda: cuda_bounce.diff_step_kind(scene, st, on_card=True)):
            with pytest.raises(ValueError, match=r"LLR_RNG=threefry.*--fused off"):
                call()
        if fused == "auto" and not env:
            assert cuda_bounce.step_mode(scene, st, on_card=False) == "auto"


# ---------------------------------------------------------------------------
# LLR_TREELET_K, LLR_WIDE_MIN_TRIS
# ---------------------------------------------------------------------------


BVH_FIELDS = ("node_min", "node_max", "node_miss", "node_leaf", "blk_p0", "blk_e1",
              "blk_e2", "blk_n", "blk_prim", "blk_mat")


@functools.lru_cache(maxsize=None)
def _welcome_geo(assets_dir, attr, value):
    """welcome-geo compiled by both packages with `pack.<attr>` = `value`
    on both sides, as the knob sets it at import; (JAX, port)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pack, attr, value)
        mp.setattr(pack, attr, value)
        return (jax_compile(assets_dir / "welcome-geo.toml", spp=1),
                compile_scene_file(assets_dir / "welcome-geo.toml", spp=1, device="cpu"))


@pytest.mark.parametrize("attr,value,k", [("TREELET_K", 16, 16), ("TREELET_K", 24, 24),
                                          ("TREELET_K", 64, 64),
                                          ("WIDE_MIN_TRIS", 50000, 128)])
def test_leaf_widths_build_the_jax_packages_bvh(assets_dir, attr, value, k):
    ref, port = _welcome_geo(assets_dir, attr, value)
    assert port.data.bvh.blk_p0.shape[1] == k
    for f in BVH_FIELDS:
        np.testing.assert_array_equal(getattr(port.data.bvh, f).numpy(),
                                      np.asarray(getattr(ref.data.bvh, f)), err_msg=f)


def test_plain_step_at_a_leaf_width_no_kernel_of_the_jax_package_takes(assets_dir, threefry):
    """K=24 does not divide 128: the JAX package walks it with its XLA walk,
    the port with its plain walk on the CPU; one bounce under the lane
    rules, bounces 1 and 2, under threefry (welcome-geo's threefry step:
    the nearest hit does not depend on the leaf width)."""
    ref, _ = _welcome_geo(assets_dir, "TREELET_K", 24)
    assert not pallas_bvh.supported(ref.data.bvh)
    _step_matches_jax_step(ref, scene_from_numpy(ref.data), "welcome-geo K=24 threefry",
                           (1, 2), 512, 24)


# ---------------------------------------------------------------------------
# LLR_FUSED, LLR_FUSED_BVH, LLR_PALLAS
# ---------------------------------------------------------------------------


GRID = list(itertools.product((None, "0", "1", "auto"), (None, "0", "1"), (None, "0"),
                              ("auto", "on", "off")))


def _on_tpu(monkeypatch):
    """The JAX package's dispatch as on its TPU, where "auto" takes its
    kernels (the port's "auto" takes them on the card)."""
    monkeypatch.setattr(pallas_bounce, "on_tpu", lambda: True)
    monkeypatch.setattr(pallas_bvh, "on_tpu", lambda: True)


def _set_env(monkeypatch, fused_env, fused_bvh_env, pallas_env):
    for k, v in (("LLR_FUSED", fused_env), ("LLR_FUSED_BVH", fused_bvh_env),
                 ("LLR_PALLAS", pallas_env)):
        if v is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, v)


def test_fused_switches_dispatch_as_the_jax_package(cbox, geo, monkeypatch):
    """Forward: new-cbox takes the brute-force bounce (LLR_FUSED), welcome-geo
    the BVH bounce (LLR_FUSED_BVH first, and off under LLR_PALLAS=0), as
    the JAX package's `make_bounce_step` picks them; the port's fused
    differentiable steps on new-cbox as its `enabled_diff` /
    `enabled_diff_hybrid` pick them (LLR_FUSED alone)."""
    _on_tpu(monkeypatch)
    for fused_env, fused_bvh_env, pallas_env, fused in GRID:
        _set_env(monkeypatch, fused_env, fused_bvh_env, pallas_env)
        case = (fused_env, fused_bvh_env, pallas_env, fused)
        for (ref, scene), jax_enabled in ((cbox, pallas_bounce.enabled),
                                          (geo, pallas_bounce.enabled_bvh)):
            st = dataclasses.replace(ref.settings, fused=fused)
            want = jax_enabled(ref.data, st)
            assert (cuda_bounce.step_mode(scene, st, on_card=True) != "off") == want, case
        ref, scene = cbox
        st = dataclasses.replace(ref.settings, fused=fused)
        want = (pallas_bounce.enabled_diff(ref.data, st)
                or pallas_bounce.enabled_diff_hybrid(ref.data, st))
        assert (cuda_bounce.diff_step_kind(scene, st, on_card=True) != "plain") == want, case


@pytest.mark.parametrize("env", [{"LLR_FUSED": "0"}, {"LLR_FUSED_BVH": "0"},
                                 {"LLR_PALLAS": "0"}, {"LLR_FUSED_BVH": "0", "LLR_FUSED": "1"}])
def test_bvh_switches_leave_the_brute_force_bounce_alone(cbox, geo, monkeypatch, env):
    """LLR_FUSED_BVH and LLR_PALLAS put welcome-geo on the plain step
    (forward and, on the card, its differentiable step too) and leave
    new-cbox on its kernel; LLR_FUSED=0 puts both on the plain step."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    geo_st, cbox_st = geo[0].settings, cbox[0].settings
    assert cuda_bounce.step_mode(geo[1], geo_st, on_card=True) == "off"
    assert cuda_bounce.diff_step_kind(geo[1], geo_st, on_card=True) == "plain"
    brute = cuda_bounce.step_mode(cbox[1], cbox_st, on_card=True)
    assert brute == ("off" if env.get("LLR_FUSED") == "0"
                     else "on" if env.get("LLR_FUSED") == "1" else "auto")


@pytest.mark.parametrize("var", ["LLR_FUSED", "LLR_FUSED_BVH"])
def test_fused_1_is_refused_on_the_cpu(geo, monkeypatch, var):
    monkeypatch.setenv(var, "1")
    ref, scene = geo
    with pytest.raises(ValueError, match=r"LLR_FUSED=1.*CUDA device"):
        wavefront.make_bounce_step(scene, ref.settings, SEED)
    monkeypatch.setenv("LLR_PALLAS", "0")  # no BVH bounce: nothing asked
    if var == "LLR_FUSED_BVH":
        wavefront.make_bounce_step(scene, ref.settings, SEED)


def test_pallas_0_refuses_the_pallas_intersector_in_both_packages(geo, monkeypatch):
    ref, scene = geo
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(4, 1)
    isect.check_pallas(scene.bvh)
    jax_isect._resolve(ref.data.geometry, ref.data.bvh, "pallas")
    monkeypatch.setenv("LLR_PALLAS", "0")
    with pytest.raises(ValueError, match="unsupported"):
        jax_isect._resolve(ref.data.geometry, ref.data.bvh, "pallas")
    with pytest.raises(ValueError, match="LLR_PALLAS=0"):
        isect.intersect(o, d, scene.geometry, scene.bvh, "pallas")
    assert isect.bvh_route(scene.bvh) == ("thread", False)  # the walk stays kernel 3


# ---------------------------------------------------------------------------
# LLR_REORDER
# ---------------------------------------------------------------------------


def test_reorder_sorts_as_the_jax_packet_walk(geo, monkeypatch):
    """Whether each package computes its ray sort keys, over LLR_REORDER
    and `reorder=`: the JAX packet walk (its kernel replaced by a stub that
    finds nothing) and the port's routed walk on the CPU. The defaults
    agree too: welcome-geo's tables are resident, so neither sorts."""
    ref, scene = geo
    sorts = {"jax": 0, "port": 0}

    def counted(which, fn):
        def key(*a, **k):
            sorts[which] += 1
            return fn(*a, **k)
        return key

    monkeypatch.setattr(jax_isect, "_ray_sort_key", counted("jax", jax_isect._ray_sort_key))
    monkeypatch.setattr(isect, "_ray_sort_key", counted("port", isect._ray_sort_key))
    monkeypatch.setattr(pallas_bvh, "intersect_tris_pallas",
                        lambda o, d, t0, *a, **k: (t0, jnp.full(t0.shape, -1, jnp.int32)))
    r = np.random.default_rng(3)
    o = r.uniform(-1, 1, size=(64, 3)).astype(np.float32)
    d = r.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    for env, reorder in itertools.product((None, "0", "1", "auto"), (None, False, True)):
        if env is None:
            monkeypatch.delenv("LLR_REORDER", raising=False)
        else:
            monkeypatch.setenv("LLR_REORDER", env)
        sorts.update(jax=0, port=0)
        jax_isect.intersect_bvh(jnp.asarray(o), jnp.asarray(d), ref.data.geometry,
                                ref.data.bvh, use_pallas=True, pallas_interpret=True,
                                reorder=reorder)
        isect.intersect(torch.from_numpy(o), torch.from_numpy(d), scene.geometry, scene.bvh,
                        "bvh", reorder=reorder)
        assert sorts["jax"] == sorts["port"] in (0, 1), (env, reorder, sorts)
        assert isect.bvh_route(scene.bvh, reorder=reorder)[1] == bool(sorts["port"])
