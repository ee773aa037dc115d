"""The training plan (`diff/render.py::TrainPlan`) on the CPU.

On the card `film_and_grads` captures the whole training step once as a
CUDA graph and replays it for new parameters and seeds; on the CPU the
plan runs the same step eagerly, from its static leaf buffers, its device
seed and its target, which is what these tests hold:

* Three Adam steps through a plan equal `film_and_grads` (the eager step)
  bit for bit, loss, film and every gradient, while the albedo, the sky
  (its uniform colour; ibl-material's IBL texels) and the seed change
  between calls, on the "bwd" route (the plain step forward,
  `plain_bounce_bwd` backward: the CPU's counterparts of kernels 2 and 5;
  tests/test_torch_diff.py's Lambert scene, and new-cbox at 32^2 x 8 spp
  and 9 bounces, whose 8,192 lanes compact to 4,096 at bounce 8) and on the
  hybrid route (the glossy scene of tests/test_torch_grad_gates.py, and
  ibl-material and welcome-geo, a BVH scene, with `make_step_diff`
  replaced by `make_step_hybrid`, as on the card). On the Lambert and glossy scenes the first step is also held
  against the JAX package's `film_and_grads` on the same inputs, within
  tests/test_torch_diff.py's tolerances (loss within 1e-4, every float
  leaf within WHOLE_PATH_RTOL of its largest magnitude), the pixels whose
  forward films differ by more than FLIP of the film max (lanes whose
  decisions flipped between the packages; at most parity.py's share) given
  each side's own film as their target (`SCENES` says why not on the
  other two).
* A capture guard: a plan's second step (on the card, the first call's
  second run of the step is the one captured; the first packs the tables)
  of each kind under a TorchDispatchMode that fails on any op that reads a
  value to the host or makes a tensor from host data (`HOST_OPS`, and an
  index or index_put with a bool mask, which runs nonzero), the ops a
  CUDA graph's capture refuses or bakes: new-cbox ("bwd"), ibl-material
  and welcome-geo (the hybrid; on welcome-geo the recompute's BVH query
  through `bvh_route`, the walk's differentiable t, `cuda_bvh.plane_t`,
  and the evaluation of its winners, with the CPU's stand-ins for kernels
  4 and 3, the plain walk, left out). A read
  planted in the step (a `float()` of a tensor, a tensor made from a
  Python list; on welcome-geo, in `cuda_bvh.plane_t`) makes it fire, so an edit that breaks the capture fails
  here, not only on the card.
* The plan cache (`train_plan`, one plan kept): a new seed, or the same
  tensors under another SceneData, reuses the plan, and the film differs
  at the new seed; another scene (other tensors, or an in-place edit),
  settings, spp or material types builds another plan, which replaces the
  kept one; a plan refuses parameters with other material types.
* The bounce kernels' argument block (`cuda_bounce.launch_args`): its
  layout, made with no host read, kept per seed.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from lumillyrender_tpu.diff.render import film_and_grads as jax_film_and_grads
from lumillyrender_tpu.diff.render import params_of as jax_params_of
from lumillyrender_tpu.diff.render import render_diff as jax_render_diff
from lumillyrender_tpu.scene.compiler import compile_scene as jax_compile_scene
from lumillyrender_tpu.scene.compiler import compile_scene_file as jax_compile
from lumillyrender_tpu.scene.loader import parse_config as jax_parse
from lumillyrender_tpu_torch import parity
from lumillyrender_tpu_torch.convert import params_from_numpy, scene_from_numpy
from lumillyrender_tpu_torch.diff import film_and_grads, render_diff
from lumillyrender_tpu_torch.diff.render import (
    TrainPlan, clear_plans, kept_plan, leaves, train_plan)
from lumillyrender_tpu_torch.integrator import wavefront
from lumillyrender_tpu_torch.ops import cuda_bounce, cuda_bvh, vec
from lumillyrender_tpu_torch.scene.data import SkyData
from test_fused_bounce import GLOSSY_DIFF_SCENE, LAMBERT_DIFF_SCENE
from test_torch_diff import WHOLE_PATH_RTOL, _assert_params_close

torch.set_num_threads(2)

CPU = "cpu"
SEEDS = (100, 101, 102)
FLIP = 1e-5
# name: (asset (a file of assets/, or a scene of tests/test_fused_bounce.py),
# width, height, spp, bounces, the sky leaf trained, held against the JAX
# package). The packages' films part on lanes whose decisions flip (the
# CPU's and XLA's last bits of sin, cos and the like), more of them the
# longer the paths: on new-cbox 1.6%, 7.1% and 13.6% of 8,192 one-sample
# lanes at 1, 3 and 9 bounces, and at 2 bounces its sky gradient, which few
# lanes carry, already differs by 0.8%; ibl-material's film max (5,712, its
# sun's texels) puts FLIP's threshold above lanes that flip, and its loss
# differs by 2e-4. So each route meets JAX on a small scene of
# tests/test_torch_diff.py's and tests/test_torch_grad_gates.py's (the
# Lambert scene: "bwd"; the glossy one: the hybrid), and new-cbox (at 9
# bounces and 8,192 lanes, where its stage plan compacts to 4,096 at bounce
# 8) and ibl-material are held to the eager step alone.
SCENES = {"lambert": (LAMBERT_DIFF_SCENE, 12, 12, 4, 5, "color", True),
          "glossy": (GLOSSY_DIFF_SCENE, 12, 12, 4, 5, "color", True),
          "new-cbox": ("new-cbox.toml", 32, 32, 8, 9, "color", False),
          "ibl-material": ("ibl-material.toml", 16, 16, 2, 3, "ibl", False),
          "welcome-geo": ("welcome-geo.toml", 8, 6, 1, 3, "ibl", False)}
# The scenes that take the hybrid step on the card, and autograd of the
# plain step on the CPU (the IBL sky; a BVH).
HYBRID_ON_CARD = ("ibl-material", "welcome-geo")
# Ops that read a tensor's value to the host, or make a tensor from host
# data: a CUDA graph's capture refuses the first kind and bakes the second.
HOST_OPS = {"aten._local_scalar_dense", "aten.nonzero", "aten.lift_fresh",
            "aten.lift_fresh_copy", "aten.masked_select", "aten.equal", "aten.is_nonzero",
            "aten.unique_consecutive", "aten._unique", "aten._unique2",
            "aten.unique_dim", "aten.repeat_interleave"}


class HostReads(TorchDispatchMode):
    """Records every op of HOST_OPS, and every index or index_put with a
    bool mask, run while open (`hits`, by op name)."""

    def __init__(self):
        super().__init__()
        self.hits = []
        self.paused = False  # set while a kernel's CPU stand-in runs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        bad = name in HOST_OPS and not self.paused
        if name in ("aten.index", "aten.index_put", "aten.index_put_") and not self.paused:
            bad = any(i is not None and i.dtype == torch.bool for i in args[1])
        if bad:
            self.hits.append(name)
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def compiled(assets_dir):
    """name -> (the JAX-compiled scene at the test's size, its settings)."""
    out = {}
    for name, (asset, w, h, spp, bounces, _, _) in SCENES.items():
        c = (jax_compile(assets_dir / asset, spp=spp) if asset.endswith(".toml")
             else jax_compile_scene(jax_parse(asset), spp=spp))
        c.settings = dataclasses.replace(c.settings, width=w, height=h, max_bounces=bounces)
        out[name] = c
    return out


@pytest.fixture
def route(monkeypatch):
    """The card's step kind on the CPU: HYBRID_ON_CARD take the hybrid, as
    on the card (on the CPU they take autograd of the plain step)."""
    def take(name):
        if name in HYBRID_ON_CARD:
            monkeypatch.setattr(cuda_bounce, "make_step_diff", cuda_bounce.make_step_hybrid)
    return take


def _with(p, materials_color=None, sky=None):
    """`p` with the albedo and the sky leaf `sky` = (field, value) replaced."""
    mats = p.materials if materials_color is None else dataclasses.replace(
        p.materials, color=materials_color)
    sk = p.sky if sky is None else dataclasses.replace(p.sky, **{sky[0]: sky[1]})
    return p._replace(materials=mats, sky=sk)


def _assert_steps_equal(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for a, b in zip(leaves(got[2]), leaves(want[2])):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _jax_params(jp, p, field):
    """The JAX DiffParams with the port's trained albedo and sky leaf."""
    return jp._replace(
        materials=dataclasses.replace(jp.materials,
                                      color=jnp.asarray(p.materials.color.numpy())),
        sky=dataclasses.replace(jp.sky, **{field: jnp.asarray(getattr(p.sky, field).numpy())}))


@pytest.mark.parametrize("name", list(SCENES))
def test_plan_steps_equal_film_and_grads_bit_for_bit(compiled, route, name):
    c = compiled[name]
    _, _, _, spp, _, field, against_jax = SCENES[name]
    route(name)
    scene, st = scene_from_numpy(c.data), c.settings
    p_true = params_from_numpy(jax_params_of(c.data))
    # The target at the first step's seed: its residuals are the parameters'
    # effect alone, not the noise of two seeds.
    target = render_diff(scene, st, p_true, SEEDS[0], spp, device=CPU)
    color = torch.nn.Parameter(p_true.materials.color * 0.8)
    sky = torch.nn.Parameter(getattr(p_true.sky, field) * 1.2)
    opt = torch.optim.Adam([color, sky], lr=0.05)
    plan = TrainPlan(scene, st, p_true, target, spp, CPU)
    losses = []
    for k, seed in enumerate(SEEDS):
        p = _with(p_true, color.detach().clone(), (field, sky.detach().clone()))
        t_port = target
        if k == 0 and against_jax:
            # The pixels where the packages' forward films part (flipped
            # lanes) get each side's own film as their target.
            jp = _jax_params(jax_params_of(c.data), p, field)
            film = render_diff(scene, st, p, seed, spp, device=CPU).numpy()
            j_film = np.asarray(jax_render_diff(c.data, st, jp, seed, spp))
            flipped = np.abs(film - j_film).max(axis=2) > FLIP * np.abs(j_film).max()
            assert flipped.mean() < parity.LIMITS["excluded"], int(flipped.sum())
            keep = ~flipped[..., None]
            t_port = torch.from_numpy(np.where(keep, target.numpy(), film))
            t_jax = jnp.asarray(np.where(keep, target.numpy(), j_film))
        got = plan(p, t_port, seed)
        want = film_and_grads(scene, st, p, t_port, seed, spp, device=CPU)
        _assert_steps_equal(got, want)
        if k == 0 and against_jax:
            j_loss, j_f, j_grads = jax_film_and_grads(c.data, st, jp, t_jax, seed, spp)
            assert abs(float(got[0]) - float(j_loss)) <= 1e-4 * float(j_loss)
            gap = np.where(keep, got[1].numpy() - np.asarray(j_f), 0)
            assert np.abs(gap).max() <= FLIP * np.abs(film).max()
            _assert_params_close(got[2], j_grads, WHOLE_PATH_RTOL)
        assert got[2].materials.color.abs().sum() > 0
        assert getattr(got[2].sky, field).abs().sum() > 0
        losses.append(float(got[0]))
        opt.zero_grad()
        color.grad, sky.grad = got[2].materials.color, getattr(got[2].sky, field)
        opt.step()
    assert len(set(losses)) == len(SEEDS)  # the parameters and seeds moved


def _unguarded(guard, monkeypatch, owner, name):
    """`owner.name` run with `guard` paused (a kernel's CPU stand-in)."""
    fn = getattr(owner, name)

    def paused(*a, **k):
        guard.paused = True
        try:
            return fn(*a, **k)
        finally:
            guard.paused = False

    monkeypatch.setattr(owner, name, paused)


def _guarded_step(c, name, route, monkeypatch, calls=None):
    """The host reads of a plan's second step on `c`. On welcome-geo the
    CPU's stand-ins for the BVH kernels are left out: the bounce's forward
    (kernel 4 on the card, the plain step with the plain walk here) and
    the recompute's search (`cuda_bvh.walk`: kernel 3 on the card, the
    plain walk `_walk_tris` here, a host loop over the live lanes); the
    rest of the recompute, the route, the walk's differentiable t
    (`cuda_bvh.plane_t`) and the evaluation of its winners, is guarded.
    `calls` (a dict) counts the searches and plane_t's calls."""
    route(name)
    spp = SCENES[name][3]
    scene, st = scene_from_numpy(c.data), c.settings
    p = params_from_numpy(jax_params_of(c.data))
    target = render_diff(scene, st, p, 33, spp, device=CPU) * 0.9
    plan = TrainPlan(scene, st, p, target, spp, CPU)
    plan(p, target, 6)
    guard = HostReads()
    if name == "welcome-geo":
        _unguarded(guard, monkeypatch, cuda_bounce._Bounce, "forward")
        _unguarded(guard, monkeypatch, cuda_bvh, "walk")
        if calls is not None:
            for fn in ("walk", "plane_t"):
                inner = getattr(cuda_bvh, fn)

                def counted(*a, _inner=inner, _fn=fn, **k):
                    calls[_fn] = calls.get(_fn, 0) + 1
                    return _inner(*a, **k)

                monkeypatch.setattr(cuda_bvh, fn, counted)
    with guard:
        plan(p, target, 7)
    return guard.hits


@pytest.mark.parametrize("name", ["new-cbox", "ibl-material", "welcome-geo"])
def test_plan_step_reads_nothing_to_the_host(compiled, route, monkeypatch, name):
    calls = {}
    assert _guarded_step(compiled[name], name, route, monkeypatch, calls) == []
    if name == "welcome-geo":
        # The recompute walked the BVH through the route and plane_t: a
        # search and a plane_t call each query of each bounce.
        bounces = SCENES[name][4]
        assert calls["walk"] >= bounces and calls["plane_t"] >= bounces


@pytest.mark.parametrize("planted", ["float", "list"])
def test_capture_guard_fires_on_a_planted_host_read(compiled, route, monkeypatch, planted):
    masked = wavefront._masked

    def with_read(mask, x):
        if planted == "float":
            float(x.detach().sum())  # a value read to the host
        else:
            x = x + x.new_tensor([0.0, 0.0, 0.0])  # a tensor made from host data
        return masked(mask, x)

    monkeypatch.setattr(wavefront, "_masked", with_read)
    hits = _guarded_step(compiled["ibl-material"], "ibl-material", route, monkeypatch)
    assert hits and set(hits) == {"aten._local_scalar_dense" if planted == "float"
                                  else "aten.lift_fresh"}


def test_capture_guard_fires_on_the_bvh_recompute(compiled, route, monkeypatch):
    """A value read planted in the BVH recompute's differentiable t
    (`cuda_bvh.plane_t`, which the stand-ins left out of the guard do not
    cover) makes the guard fire on welcome-geo."""
    plane_t = cuda_bvh.plane_t

    def with_read(o, d, t, won, n):
        float(t.detach().sum())
        return plane_t(o, d, t, won, n)

    monkeypatch.setattr(cuda_bvh, "plane_t", with_read)
    hits = _guarded_step(compiled["welcome-geo"], "welcome-geo", route, monkeypatch)
    assert hits and set(hits) == {"aten._local_scalar_dense"}


def test_unit_vectors_are_fills():
    for axis in range(3):
        like = torch.zeros(2, dtype=torch.float32)
        with HostReads() as guard:
            u = vec.unit(axis, like)
        want = torch.zeros(3)
        want[axis] = 1.0
        assert torch.equal(u, want) and u.dtype == like.dtype and guard.hits == []
        assert vec.unit(axis, like) is u  # made once a device and dtype


def test_plan_cache_keys(compiled):
    clear_plans()
    c = compiled["new-cbox"]
    scene = scene_from_numpy(c.data)
    st = dataclasses.replace(c.settings, width=8, height=8, max_bounces=2)
    p = params_from_numpy(jax_params_of(c.data))
    target = render_diff(scene, st, p, 33, 1, device=CPU)
    plan = train_plan(scene, st, p, target, 1, CPU)
    assert train_plan(scene, st, p, target, 1, CPU) is plan and kept_plan() is plan
    # The same tensors under another SceneData are the same scene.
    assert train_plan(dataclasses.replace(scene), st, p, target, 1, CPU) is plan
    assert train_plan(scene.to(CPU), st, p, target, 1, CPU) is plan
    _, f1, _ = plan(p, target, 1)
    _, f2, _ = train_plan(scene, st, p, target, 1, CPU)(p, target, 2)
    assert not torch.equal(f1, f2)  # a new seed, the same plan, another film
    others = [train_plan(scene, st, p, target, 2, CPU),
              train_plan(scene, dataclasses.replace(st, max_bounces=3), p, target, 1, CPU),
              train_plan(scene_from_numpy(c.data), st, p, target, 1, CPU)]
    assert len({id(x) for x in [plan] + others}) == 4
    assert kept_plan() is others[-1]  # one plan kept: each new one replaced it
    again = train_plan(scene, st, p, target, 1, CPU)
    assert again is not plan and kept_plan() is again
    # An in-place edit of the geometry is another scene.
    scene.geometry.sph_r.mul_(1.0)
    edited = train_plan(scene, st, p, target, 1, CPU)
    assert edited is not again
    # Material types: the same values in another tensor keep the plan; other
    # values make another, and the old plan refuses them.
    same = p._replace(materials=dataclasses.replace(
        p.materials, type_id=p.materials.type_id.clone()))
    assert train_plan(scene, st, same, target, 1, CPU) is edited
    types = p.materials.type_id.clone()
    types[0] = 1 - types[0] if int(types[0]) in (0, 1) else 0
    other = p._replace(materials=dataclasses.replace(p.materials, type_id=types))
    assert train_plan(scene, st, other, target, 1, CPU) is not edited
    with pytest.raises(ValueError, match="integer leaves"):
        edited(other, target, 1)
    with pytest.raises(ValueError, match="target of shape"):
        edited(p, target[:4], 1)
    clear_plans()
    assert kept_plan() is None


def test_kernel_argument_block():
    """The bounce kernels' argument block (csrc/bounce_body.cuh ARG_*): the
    seed's uint32 bits, then the sky colour, the horizon colour and the
    longitude offset as float32 bits; kept in the tables per seed."""
    sky = SkyData(color=torch.tensor([0.25, 0.5, 2.0]), color2=torch.tensor([1.0, -0.0, 3.5]),
                  ibl=torch.zeros((1, 2, 3)), longitude_offset=torch.tensor(-1.25))
    tables = {"sky": cuda_bounce.sky_values(sky)}
    for seed in (7, 0xFFFFFFFF, 2**32 + 5, torch.tensor(0x80000001)):
        with HostReads() as guard:
            args = cuda_bounce.launch_args(tables, seed)
        assert guard.hits == [] and args.dtype == torch.int32 and args.shape == (8,)
        assert int(args[0]) & 0xFFFFFFFF == int(seed) & 0xFFFFFFFF
        want = np.array([0.25, 0.5, 2.0, 1.0, -0.0, 3.5, -1.25], dtype=np.float32)
        assert np.array_equal(args[1:].numpy().view(np.float32).view(np.uint32),
                              want.view(np.uint32))
        assert cuda_bounce.launch_args(tables, seed) is args  # kept for this seed
