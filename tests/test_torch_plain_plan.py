"""The plain step kind (`fused="off"`) through the training plan and the
forward plan, on the CPU.

On the card `film_and_grads` captures the plain kind's whole step
(autograd of the plain step under a `bwd_remat` policy, its BVH walk kernel
3 or 7) as one CUDA graph, `sharded_train_step` replays a plan that takes
the rank's sample offsets as a device input, and a `fused="off"` forward
chunk is one captured `ForwardPlan`. On the CPU a plan runs the same step
eagerly, which is what these tests hold:

* Three Adam steps through a plain-kind `TrainPlan` under each of the five
  policies (none, full, hybrid, isect, isect+samp) equal the eager step
  (`eager_film_and_grads`) bit for bit, loss, film and every gradient,
  while the albedo, the sky colour (new-cbox) or the IBL texels
  (welcome-geo) and the seed change between calls; on new-cbox (brute
  force) and welcome-geo (a BVH, its queries through `bvh_route` and
  `cuda_bvh.plane_t`, as the card's plain step walks, kernel 3 there and
  the plain walk behind `cuda_bvh.walk` here), 32^2 x 4 spp at three
  bounces. A plan's first step is also held against the JAX package's
  `film_and_grads` on the same inputs within tests/test_torch_diff.py's
  tolerances (loss within 1e-4, every float leaf within WHOLE_PATH_RTOL of
  its largest magnitude), the pixels whose forward films part by more than
  FLIP of the film max (lanes whose decisions flipped between the
  packages) given each side's own film as their target, at JAX_SIZE: the
  packages' films part on more of new-cbox's pixels than parity.py's
  excluded share past one bounce (17% at 32^2 x 4 spp and two bounces,
  25% at three), and on 13% of welcome-geo's at 32^2 x 4 and three. The
  rule sees a flipped lane only through its pixel: at seed 100 one such
  lane under FLIP's threshold moves new-cbox's camera gradients by up to
  2.6e-3 of their largest magnitude (camera.position; every other leaf
  within 1e-4), where seeds 101-103 put every leaf within 1e-4, so the
  steps start at seed 101.
* The capture guard of tests/test_torch_train_plan.py (`HostReads`) over a
  plain-kind plan's second step under each policy: autograd over the
  whole plain step, `_compact` and `_bank_rows` included, reads nothing
  to the host and makes no tensor from host data (on welcome-geo the
  CPU's stand-in for kernel 3, `cuda_bvh.walk`, paused).
* Under "full" the checkpoints stash no RNG state: `torch.get_rng_state`
  and `torch.set_rng_state`, patched to raise, are never called.
* The forward plain step as `ForwardPlan` runs it on the card: every
  stage's fixed number of bounces (not `run_stage`'s CPU loop, which
  reads the card once a bounce), `_compact` and the banks, under the
  guard.
* A plan with a sample-offsets buffer: two calls at other offsets equal
  the eager step with those `sample_offsets` bit for bit, with no tensor
  made from host data in the guarded call; `sharded_train_step` outside a
  group is that plan's step.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumillyrender_tpu.diff.render import film_and_grads as jax_film_and_grads
from lumillyrender_tpu.diff.render import params_of as jax_params_of
from lumillyrender_tpu.diff.render import render_diff as jax_render_diff
from lumillyrender_tpu.scene.compiler import compile_scene_file as jax_compile
from lumillyrender_tpu_torch import parity
from lumillyrender_tpu_torch.convert import params_from_numpy, scene_from_numpy
from lumillyrender_tpu_torch.diff.render import (
    TrainPlan, eager_film_and_grads, leaves, render_diff)
from lumillyrender_tpu_torch.integrator import wavefront
from lumillyrender_tpu_torch.ops import cuda_bounce, cuda_bvh
from lumillyrender_tpu_torch.parallel import shard
from test_torch_diff import WHOLE_PATH_RTOL, _assert_params_close
from test_torch_train_plan import HostReads, _unguarded

torch.set_num_threads(2)

CPU = "cpu"
SEEDS = (101, 102, 103)
FLIP = 1e-5
POLICIES = ("none", "full", "hybrid", "isect", "isect+samp")
# name: (asset, the sky leaf trained).
SCENES = {"new-cbox": ("new-cbox.toml", "color"), "welcome-geo": ("welcome-geo.toml", "ibl")}
W, H, SPP, BOUNCES = 32, 32, 4, 3
# name: (w, h, spp, bounces) of the step held against the JAX package's.
JAX_SIZE = {"new-cbox": (32, 32, 4, 1), "welcome-geo": (12, 9, 2, 3)}


@pytest.fixture(scope="module")
def compiled(assets_dir):
    """name -> the JAX-compiled scene at 32^2 x 4 spp, three bounces, fused off."""
    out = {}
    for name, (asset, _) in SCENES.items():
        c = jax_compile(assets_dir / asset, spp=SPP)
        c.settings = dataclasses.replace(c.settings, width=W, height=H, max_bounces=BOUNCES,
                                         fused="off")
        out[name] = c
    return out


def _cards_plain_step(scene, settings, seed, mats_eval=None):
    """`make_step_diff`'s plain step as the card builds it: its BVH queries
    through `bvh_route` with `cuda_bvh.plane_t`'s VJP (kernel 3 on the
    card, the plain walk behind `cuda_bvh.walk` here)."""
    assert cuda_bounce.diff_step_kind(scene, settings, on_card=True) == "plain"
    mats = scene.materials if mats_eval is None else mats_eval

    def plain(state, remat=None):
        return wavefront.plain_bounce_step(scene, settings, seed, state, mats,
                                           plain_walk=False, remat=remat)

    plain.fused_diff = False
    return plain


@pytest.fixture(autouse=True)
def cards_route(monkeypatch):
    monkeypatch.setattr(cuda_bounce, "make_step_diff", _cards_plain_step)


def _with(p, color, field, sky):
    return p._replace(materials=dataclasses.replace(p.materials, color=color),
                      sky=dataclasses.replace(p.sky, **{field: sky}))


def _assert_steps_equal(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for a, b in zip(leaves(got[2]), leaves(want[2])):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _at(c, w, h, spp, bounces):
    return dataclasses.replace(c.settings, width=w, height=h, spp=spp, max_bounces=bounces)


@pytest.fixture(scope="module")
def against_jax(compiled):
    """name -> the JAX_SIZE step's inputs and the JAX package's step on
    them: (settings, params, port target, the JAX step's (loss, film,
    grads), keep mask, the port's film). Every policy computes one
    function, so one JAX step serves them all."""
    out = {}
    for name, c in compiled.items():
        field = SCENES[name][1]
        w, h, SPP, bounces = JAX_SIZE[name]
        scene, st = scene_from_numpy(c.data), _at(c, w, h, SPP, bounces)
        p_true = params_from_numpy(jax_params_of(c.data))
        p = _with(p_true, p_true.materials.color * 0.8, field, getattr(p_true.sky, field) * 1.2)
        jp = jax_params_of(c.data)
        jp = jp._replace(
            materials=dataclasses.replace(jp.materials, color=jp.materials.color * 0.8),
            sky=dataclasses.replace(jp.sky, **{field: getattr(jp.sky, field) * 1.2}))
        target = render_diff(scene, st, p_true, SEEDS[0], SPP, device=CPU).numpy()
        j_target = np.asarray(jax_render_diff(c.data, st, jax_params_of(c.data), SEEDS[0], SPP))
        film = render_diff(scene, st, p, SEEDS[0], SPP, device=CPU).numpy()
        j_film = np.asarray(jax_film_and_grads(c.data, st, jp, jnp.asarray(j_target),
                                               SEEDS[0], SPP)[1])
        flipped = np.abs(film - j_film).max(axis=2) > FLIP * np.abs(j_film).max()
        assert flipped.mean() < parity.LIMITS["excluded"], int(flipped.sum())
        keep = ~flipped[..., None]
        t_port = torch.from_numpy(np.where(keep, target, film))
        j_step = jax_film_and_grads(c.data, st, jp, jnp.asarray(np.where(keep, j_target, j_film)),
                                    SEEDS[0], SPP)
        out[name] = (st, p, t_port, j_step, keep, film)
    return out


@pytest.mark.parametrize("mode", POLICIES)
@pytest.mark.parametrize("name", list(SCENES))
def test_plain_plan_steps_equal_the_eager_step(compiled, against_jax, name, mode):
    c = compiled[name]
    field = SCENES[name][1]
    scene = scene_from_numpy(c.data)
    st, p0, target, (j_loss, j_film, j_grads), keep, film = against_jax[name]
    st = dataclasses.replace(st, bwd_remat=mode)
    spp = JAX_SIZE[name][2]
    plan = TrainPlan(scene, st, p0, target, spp, CPU)
    assert plan.kind == "plain"
    got = plan(p0, target, SEEDS[0])
    _assert_steps_equal(got, eager_film_and_grads(scene, st, p0, target, SEEDS[0], spp,
                                                  device=CPU))
    assert abs(float(got[0]) - float(j_loss)) <= 1e-4 * float(j_loss)
    gap = np.where(keep, got[1].numpy() - np.asarray(j_film), 0)
    assert np.abs(gap).max() <= FLIP * np.abs(film).max()
    _assert_params_close(got[2], j_grads, WHOLE_PATH_RTOL)

    # Three Adam steps at 32^2 x 4 spp, three bounces.
    st = dataclasses.replace(c.settings, bwd_remat=mode)
    target = render_diff(scene, st, params_from_numpy(jax_params_of(c.data)), SEEDS[0], SPP,
                         device=CPU)
    plan = TrainPlan(scene, st, p0, target, SPP, CPU)
    color = torch.nn.Parameter(p0.materials.color.clone())
    sky = torch.nn.Parameter(getattr(p0.sky, field).clone())
    opt = torch.optim.Adam([color, sky], lr=0.05)
    losses = []
    for k, seed in enumerate(SEEDS):
        p = _with(p0, color.detach().clone(), field, sky.detach().clone())
        got = plan(p, target, seed)
        _assert_steps_equal(got, eager_film_and_grads(scene, st, p, target, seed, SPP,
                                                      device=CPU))
        assert got[2].materials.color.abs().sum() > 0
        assert getattr(got[2].sky, field).abs().sum() > 0
        losses.append(float(got[0]))
        opt.zero_grad()
        color.grad, sky.grad = got[2].materials.color, getattr(got[2].sky, field)
        opt.step()
    assert len(set(losses)) == len(SEEDS)


def _plan_at_second_step(c, mode, sample_offsets=None):
    scene = scene_from_numpy(c.data)
    st = dataclasses.replace(c.settings, bwd_remat=mode)
    p = params_from_numpy(jax_params_of(c.data))
    target = render_diff(scene, st, p, 33, SPP, device=CPU) * 0.9
    plan = TrainPlan(scene, st, p, target, SPP, CPU, sample_offsets=sample_offsets)
    plan(p, target, 6, sample_offsets=sample_offsets)
    return plan, p, target


@pytest.mark.parametrize("mode", POLICIES)
@pytest.mark.parametrize("name", list(SCENES))
def test_plain_plan_step_reads_nothing_to_the_host(compiled, monkeypatch, name, mode):
    plan, p, target = _plan_at_second_step(compiled[name], mode)
    guard = HostReads()
    walks = []
    if name == "welcome-geo":
        _unguarded(guard, monkeypatch, cuda_bvh, "walk")
        inner = cuda_bvh.walk
        monkeypatch.setattr(cuda_bvh, "walk", lambda *a, **k: walks.append(1) or inner(*a, **k))
    with guard:
        plan(p, target, 7)
    assert guard.hits == []
    if name == "welcome-geo":
        assert len(walks) >= BOUNCES  # the guard saw the route and plane_t around the walks


def test_checkpoints_stash_no_rng_state(compiled, monkeypatch):
    plan, p, target = _plan_at_second_step(compiled["new-cbox"], "full")

    def refused(*a, **k):
        raise AssertionError("a checkpoint read or set torch's RNG state")

    monkeypatch.setattr(torch, "get_rng_state", refused)
    monkeypatch.setattr(torch, "set_rng_state", refused)
    got = plan(p, target, 7)
    assert all(bool(torch.isfinite(t).all()) for t in [got[0]] + leaves(got[2]))


def _fixed_stage(step, state, b1):
    """`run_stage` as it runs on the card: every step to `b1`, no host read."""
    for _ in range(b1 - state.bounce):
        state = step(state)
    return state


@pytest.mark.parametrize("name", list(SCENES))
def test_forward_plain_step_reads_nothing_to_the_host(compiled, monkeypatch, name):
    """A `fused="off"` forward chunk as the card's `ForwardPlan` captures it:
    the camera weights, the plain step's fixed bounces (its walk through
    `bvh_route`, as on the card), `_compact` at every stage cut and the
    banks; the same film as the CPU's host loop."""
    c = compiled[name]
    spp = 8  # 8,192 lanes, compacted to 4,096 after bounce depth + 3
    scene = scene_from_numpy(c.data)
    st = dataclasses.replace(c.settings, max_bounces=c.settings.depth + 5)
    n = W * H * spp
    assert min(w for w, _, _ in wavefront._stage_plan(n, st, aggressive=name == "new-cbox")) < n
    o, d, pdf, g = cuda_bounce.plain_generate_rays(scene, st, 9, 0, n)
    lane = torch.arange(n, dtype=torch.int32)
    weight = g * scene.camera.sensor_sensitivity / pdf

    def step(state):
        return wavefront.plain_bounce_step(scene, st, 9, state, plain_walk=False)

    want = wavefront.trace_film(scene, st, o, d, lane, 9, weight, n_pixels=W * H, step=step)
    monkeypatch.setattr(wavefront, "run_stage", _fixed_stage)
    guard = HostReads()
    if name == "welcome-geo":
        _unguarded(guard, monkeypatch, cuda_bvh, "walk")
    with guard:
        got = wavefront.trace_film(scene, st, o, d, lane, 9, weight, n_pixels=W * H, step=step)
    assert guard.hits == []
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].abs().sum() > 0


def test_plan_with_sample_offsets(compiled):
    c = compiled["new-cbox"]
    first = torch.tensor([3, 9, 4, 1])
    plan, p, target = _plan_at_second_step(c, "full", sample_offsets=first)
    scene, st = plan.source, plan.settings
    for k, offs in enumerate((torch.tensor([7, 0, 12, 5]), torch.tensor([2, 8, 6, 11]))):
        guard = HostReads()
        with guard:
            got = plan(p, target, 40 + k, sample_offsets=offs)
        assert guard.hits == []
        want = eager_film_and_grads(scene, st, p, target, 40 + k, SPP, device=CPU,
                                    sample_offsets=offs)
        _assert_steps_equal(got, want)
    with pytest.raises(ValueError, match="sample offsets"):
        plan(p, target, 1)
    with pytest.raises(ValueError, match="sample offsets"):
        plan(p, target, 1, sample_offsets=torch.tensor([1, 2]))
    # sharded_train_step outside a group: the plan's step at seed 0 on the
    # whole block of offsets.
    loss, grads = shard.sharded_train_step(scene, st, p, target, np.array([7, 0, 12, 5]),
                                           device=CPU)
    want = eager_film_and_grads(scene, st, p, target, 0, SPP, device=CPU,
                                sample_offsets=torch.tensor([7, 0, 12, 5]))
    assert torch.equal(loss, want[0])
    for a, b in zip(leaves(grads), leaves(want[2])):
        assert torch.equal(a, b)
