"""Differentiable rendering: film gradients in material, camera and sky
parameters (the JAX package's `diff/render.py`).

Detached-sampling estimator: every sampling decision (RR, light pick, the
NEE emitter test, BSDF lobe directions and pdfs) reads a detached copy of
the parameters, while the shading chain (emission, BRDF, coef, the camera
ray weights, and the intersection distances, which carry the geometric
derivatives of the camera) reads the live ones. With the sampling density
fixed at theta0, E[d/dtheta f(x, theta) / p(x)] = d/dtheta Int f: unbiased
film gradients, and finite differences of this renderer at the same seed
agree with its autograd up to truncation (tests/test_torch_diff.py).

The bounce loop is the differentiable `trace_film`: a fixed number of
steps per stage, with the step `cuda_bounce.make_step_diff` picks. On the
card a Lambert-only brute-force scene under a uniform sky runs the bounce
kernel forward and the hand-written backward kernel (csrc/bounce_bwd.cu);
every other scene (other materials, BVH scenes of any leaf width, the IBL
and the simple sky) runs the hybrid step, `cuda_bounce.make_step_hybrid`:
the bounce kernel forward (brute force or BVH) and backward autograd of
the plain step recomputed on the bounce's input state, whose BVH walk is a
kernel (kernel 3, or the wide walk at K=128) with the plane-equation VJP;
an IBL texture gets its texels' gradients through that recompute's
nearest-texel gather. On the CPU the BVH, IBL and simple-sky scenes run
autograd of the plain step, and so does every scene on either device under
`RenderSettings.fused = "off"` (on the card with kernel 3 or 7 as its
walk), as the JAX package's `render_diff` always does. The kernels' steps
keep only their input state; `RenderSettings.bwd_remat` sets what the
plain step's autograd keeps and recomputes (integrator/wavefront.py::
_run_fixed). Camera rays come from `ops/camera.py::sample_rays`, so that
camera gradients exist; the raygen kernel is not on this path.

On the card `film_and_grads` runs a `TrainPlan`: the whole step (forward,
loss, and autograd of it, each bounce's backward kernel or recompute
included) captured once as one CUDA graph and replayed for new parameter
values and new seeds, as the JAX package's jitted `film_and_grads` is one
compiled program that takes both as inputs. That holds for every step
kind: the kernels' ("bwd", "hybrid") and the plain one (`fused="off"`,
autograd of the plain step under each `bwd_remat` policy, its walk kernel
3 or 7). `parallel/shard.py::sharded_train_step` runs a plan too, with the
rank's sample offsets as one more input. `pixel_grad`, a bare `jax.grad`
in the JAX package, runs eagerly.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, NamedTuple

import torch

from ..integrator.render import tile_decode
from ..integrator.wavefront import trace_film, u32_to_i32
from ..ops import camera as camera_ops
from ..ops import rng, vec
from ..scene.data import (
    CameraData,
    MaterialTable,
    RenderSettings,
    SceneData,
    SkyData,
    resolve_device,
)


class DiffParams(NamedTuple):
    """The differentiable parameters. `sky` includes the IBL texture: its
    texels get gradients through the nearest-texel gather at every miss
    (the texel pick is discrete; given it, radiance is linear in the
    texel)."""

    materials: MaterialTable
    camera: CameraData
    sky: SkyData


def params_of(scene: SceneData) -> DiffParams:
    return DiffParams(materials=scene.materials, camera=scene.camera, sky=scene.sky)


def map_params(params: DiffParams, fn: Callable) -> DiffParams:
    """DiffParams with `fn` applied to every tensor leaf."""
    return DiffParams(*(
        dataclasses.replace(part, **{f.name: fn(getattr(part, f.name))
                                     for f in dataclasses.fields(part)})
        for part in params))


def leaves(params: DiffParams) -> list[torch.Tensor]:
    """The tensor leaves of `params`, in field order."""
    return [getattr(part, f.name) for part in params for f in dataclasses.fields(part)]


def render_diff(scene: SceneData, settings: RenderSettings, params: DiffParams,
                seed, spp: int, sample_offsets=None,
                params_sample: DiffParams | None = None, with_rays: bool = False,
                device=None):
    """Differentiable film (H, W, 3) as a function of `params`, on `device`
    (default `cuda`; the scene and the parameters are moved there with
    differentiable copies). `seed` is a Python int or an integer tensor on
    `device` (a training plan's).

    Sampling decisions read the detached `params` (or `params_sample`,
    which pins them: the FD gate holds the sampling measure at theta0 on
    both sides while it perturbs the live parameters); shading reads the
    live `params`. `sample_offsets` ((spp,) ints) gives the global sample
    ids of this call (a device tensor on `dev` is used as it is: a training
    plan's buffer). `with_rays=True` returns (film, rays), the rays
    counted as the forward renderer counts them (camera, live bounce and
    NEE shadow rays).
    """
    dev = resolve_device(device)
    scene = scene.to(dev)
    params = map_params(params, lambda t: t.to(dev))
    detached = map_params(params if params_sample is None else params_sample,
                          lambda t: t.detach().to(dev))
    # The scene copy whose material table drives sampling decisions only;
    # the sky is all shading (nothing is sampled from it), so it is live.
    scene_s = dataclasses.replace(scene, materials=detached.materials,
                                  camera=params.camera, sky=params.sky)

    w, h = settings.width, settings.height
    n = w * h * spp
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    decode = tile_decode(settings)
    pixel_fn = None
    if decode is None:
        px, py = lane % w, (lane // w) % h
    else:
        px, py = decode(lane % (w * h))

        def pixel_fn(lane_vals):
            px_, py_ = decode(lane_vals % (w * h))
            return py_ * w + px_

    if sample_offsets is not None:
        offs = torch.as_tensor(sample_offsets, dtype=torch.int64, device=dev)
        lane = lane % (w * h) + offs[lane // (w * h)] * (w * h)
    lane = u32_to_i32(lane & 0xFFFFFFFF)

    u, v, u2, v2 = rng.uniform4(seed, lane, 0x40000000)
    o, d, pdf, g = camera_ops.sample_rays(params.camera, settings.camera_kind, px, py,
                                          w, h, u, v, u2, v2)
    weight = g * params.camera.sensor_sensitivity / pdf
    film_flat, rays = trace_film(
        scene_s, settings, o.contiguous(), d.contiguous(), lane, seed, weight,
        n_pixels=w * h, differentiable=True, mats_eval=params.materials,
        pixel_fn=pixel_fn,
    )
    film = vec.over(film_flat.reshape(h, w, 3), spp)
    if with_rays:
        return film, rays + float(n)  # + camera rays
    return film


def _grads(fn, params: DiffParams, dev) -> tuple:
    """(value, aux, grads): `fn(live) -> (value, aux)` on leaf copies of
    `params` on `dev`, and the gradient of value in every leaf (zeros for
    integer leaves and for leaves value does not depend on)."""
    live = map_params(params, lambda t: t.detach().to(dev).requires_grad_(
        t.is_floating_point()))
    value, aux = fn(live)
    xs = [t for t in leaves(live) if t.requires_grad]
    gs = iter(torch.autograd.grad(value, xs, allow_unused=True))

    def grad_of(t):
        g = next(gs) if t.requires_grad else None
        return torch.zeros_like(t) if g is None else g

    return value.detach(), aux, map_params(live, grad_of)


def eager_film_and_grads(scene: SceneData, settings: RenderSettings, params: DiffParams,
                         target: torch.Tensor, seed, spp: int, device=None,
                         sample_offsets=None):
    """`film_and_grads` run op by op from the host, with nothing captured:
    the step a `TrainPlan` captures (with `sample_offsets`, the step of
    `parallel/shard.py::sharded_train_step` on a rank's block), and what
    `film_and_grads` runs on the CPU."""
    dev = resolve_device(device)
    target = target.to(dev)

    def loss_fn(p):
        film = render_diff(scene, settings, p, seed, spp, sample_offsets=sample_offsets,
                           device=dev)
        return torch.mean((film - target) ** 2), film.detach()

    loss, film, grads = _grads(loss_fn, params, dev)
    return loss, film, grads


def film_and_grads(scene: SceneData, settings: RenderSettings, params: DiffParams,
                   target: torch.Tensor, seed, spp: int, device=None):
    """One inverse-rendering step on `device` (default `cuda`): the L2 loss
    of the film against `target`, the film, and the loss's gradient in
    every parameter as a DiffParams (zeros for integer leaves), all new
    tensors the caller may keep across steps. On the card the step is a
    `TrainPlan`'s (`train_plan`: captured at the first call for the scene,
    settings, spp, shapes and material types, replayed at every later one
    with the new parameters and seed; one plan is kept, so steps that
    alternate between two scenes capture anew at every switch), whatever
    the step kind. On the CPU it runs eagerly."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return train_plan(scene, settings, params, target, spp, dev)(params, target, seed)
    return eager_film_and_grads(scene, settings, params, target, seed, spp, device=dev)


class TrainPlan:
    """One training step of a scene on a device: the counterpart of the JAX
    package's jitted `film_and_grads`, one program compiled once and run for
    every parameter value and seed.

    The plan keeps the scene on the device, a static buffer for every
    floating leaf of the DiffParams it was made from, the target and the
    seed as a device scalar. Its integer leaves, the material types, are
    its own and never copied: the kernels' instances and the step's
    branches follow them, so a call with other types raises. With
    `sample_offsets` ((spp,) global sample ids, as `render_diff` takes
    them) the plan also keeps an int64 offsets buffer on the device, which
    every call loads (`parallel/shard.py::sharded_train_step`: a rank's
    block). A call copies the new leaf values, the target, the seed (and
    the offsets) into the buffers and runs the step: `render_diff` at the
    buffers, the L2 loss and
    `torch.autograd.grad` of it in every floating leaf, each bounce's
    backward kernel or recompute included. The step reads nothing from the
    card on the host and makes no tensor from host data (the kernels'
    geometry tables are packed at the first call and kept on the scene's
    geometry, `cuda_bounce.geometry_of`), so on the card the first call
    runs it eagerly on a side stream (which also loads every kernel and
    packs the tables) and then captures it as one CUDA graph; every later
    call replays the graph on the current stream, the stream of the eager
    steps, and adds its launches to the kernels' counts. Every step kind
    (`cuda_bounce.diff_step_kind`) is captured: "bwd" and "hybrid", and
    "plain", autograd of the plain step under `settings.bwd_remat` (its
    checkpoints stash no RNG state, `wavefront._checkpointed`; the isect
    policies' kept searches are the graph's own tensors, read back in the
    replay's recompute at the addresses the capture wrote). On the CPU the
    plan runs the same step eagerly at every call. A capture or a replay
    that fails raises: nothing falls back to the eager step. `capture_seconds` and `pool_bytes` say
    what the graph cost; `replays` counts its replays."""

    def __init__(self, scene: SceneData, settings: RenderSettings, params: DiffParams,
                 target: torch.Tensor, spp: int, device=None, sample_offsets=None):
        from ..ops import cuda_bounce

        self.device = dev = resolve_device(device)
        self.source = scene  # its tensors, train_plan's key, stay unique while the plan lives
        self.scene = scene.to(dev)
        self.settings, self.spp = settings, spp
        self.on_card = dev.type == "cuda"
        self.kind = cuda_bounce.diff_step_kind(self.scene, settings, self.on_card)
        self.params = map_params(params, lambda t: t.detach().to(dev).clone())
        self.target = torch.zeros(target.shape, dtype=target.dtype, device=dev)
        self.seed = torch.zeros((), dtype=torch.int64, device=dev)
        self.offsets = None
        if sample_offsets is not None:
            self.offsets = torch.zeros((len(sample_offsets),), dtype=torch.int64, device=dev)
        self._types_seen = None  # the integer leaves last found equal to the plan's
        self.geometry = None  # on the card, the geometry tables its graph reads
        self.graph = None
        self.out = None  # the graph's loss, film and gradients
        self.launches = {}  # per replay, by cuda_bounce.counts() name
        self.capture_seconds = None
        self.pool_bytes = None
        self.replays = 0

    def takes(self, params: DiffParams) -> bool:
        """Whether `params` has the plan's leaf shapes and integer leaves.
        The integer leaves are compared on the host (a read of the card)
        only where they are other tensors, or were changed in place, since
        the last call that found them equal; the tensors of that call are
        held, so that no other tensor takes their storage."""
        pairs = list(zip(leaves(self.params), leaves(params)))
        if any(new.shape != buf.shape for buf, new in pairs):
            return False
        ints = [new for buf, new in pairs if not buf.is_floating_point()]
        key = tuple((t.data_ptr(), t._version) for t in ints)
        if self._types_seen is not None and self._types_seen[0] == key:
            return True
        if not all(torch.equal(buf, new.to(self.device)) for buf, new in pairs
                   if not buf.is_floating_point()):
            return False
        self._types_seen = (key, ints)
        return True

    def _load(self, params: DiffParams, target: torch.Tensor, seed, sample_offsets):
        if not self.takes(params):
            raise ValueError("the parameters' shapes or integer leaves (the material "
                             "types) are not the plan's: make another plan")
        for buf, new in zip(leaves(self.params), leaves(params)):
            if buf.is_floating_point():
                buf.copy_(new.detach())
        if target.shape != self.target.shape:
            raise ValueError(f"a target of shape {tuple(target.shape)} for the plan's "
                             f"{tuple(self.target.shape)}")
        self.target.copy_(target)
        if isinstance(seed, torch.Tensor):
            self.seed.copy_(seed.reshape(()).to(torch.int64) & 0xFFFFFFFF)
        else:
            self.seed.fill_(int(seed) & 0xFFFFFFFF)
        if (sample_offsets is None) != (self.offsets is None):
            raise ValueError("sample offsets are given to a plan made without them, or "
                             "missing from a plan made with them")
        if sample_offsets is not None:
            offs = torch.as_tensor(sample_offsets, dtype=torch.int64)
            if offs.shape != self.offsets.shape:
                raise ValueError(f"{tuple(offs.shape)} sample offsets for the plan's "
                                 f"{tuple(self.offsets.shape)}")
            self.offsets.copy_(offs)

    def _step(self):
        """The captured work (module docstring)."""
        def loss_fn(p):
            film = render_diff(self.scene, self.settings, p, self.seed, self.spp,
                               sample_offsets=self.offsets, device=self.device)
            return torch.mean((film - self.target) ** 2), film.detach()

        return _grads(loss_fn, self.params, self.device)

    @staticmethod
    def _copies(out):
        loss, film, grads = out
        return loss.clone(), film.clone(), map_params(grads, torch.clone)

    def __call__(self, params: DiffParams, target: torch.Tensor, seed, sample_offsets=None):
        """(loss, film, grads) of `film_and_grads` at `params`, `target` and
        `seed` (and `sample_offsets`, for a plan made with them), as new
        tensors."""
        from ..integrator.render import capture_graph
        from ..ops import cuda_bounce

        self._load(params, target, seed, sample_offsets)
        if not self.on_card:
            return self._step()
        if self.graph is None:
            # PyTorch's recipe for capturing a whole network: a warm-up run
            # on a side stream, then the capture.
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                out = self._step()
            current.wait_stream(side)
            out = self._copies(out)
            # The graph reads the geometry tables the warm-up packed by their
            # addresses: held here, a repack for other material types (an
            # eager step's) frees none of them. The plain kind launches no
            # bounce kernel (its walk's tables are kept on the BVH).
            if self.kind != "plain":
                self.geometry = cuda_bounce.geometry_of(
                    dataclasses.replace(self.scene, materials=self.params.materials))
            (self.graph, self.out, self.launches, self.capture_seconds,
             self.pool_bytes) = capture_graph(self._step, self.device)
            return out
        self.graph.replay()
        self.replays += 1
        cuda_bounce.add_counts(self.launches)
        return self._copies(self.out)


# The training plan `train_plan` keeps, (key, plan), or None: one, as the
# training loop a caller runs steps one scene at a time; a graph's pool is
# ~1 GiB at 753,664 lanes (PERF.md §6.25), so more would hold gigabytes.
_plan = None


def _plan_key(scene, settings, params, target, spp, dev, sample_offsets=None) -> tuple:
    """What a plan's graph depends on besides its inputs' values: the
    scene's geometry, lights and BVH (by the storage and version counter of
    each tensor, as `cuda_bounce._camera_row` keys the camera: the same
    tensors under another SceneData, `scene.to(device)` where they already
    lie, are the same scene; an in-place edit is another), the settings,
    spp, the leaves' and the target's shapes and dtypes, the device, the
    step kind, the random mixer, the environment's LLR_* knobs (read at
    call time) and the number of sample offsets (None without them). The
    integer leaves' values are checked by the plan (`TrainPlan.takes`)."""
    from ..ops import cuda_bounce

    kind = cuda_bounce.diff_step_kind(scene, settings, dev.type == "cuda")
    env = tuple(sorted((k, v) for k, v in os.environ.items() if k.startswith("LLR_")))
    shapes = tuple((tuple(t.shape), t.dtype) for t in leaves(params))
    parts = (scene.geometry, scene.lights, scene.bvh)
    tensors = tuple((t.data_ptr(), t._version, tuple(t.shape), str(t.device))
                    for part in parts for f in dataclasses.fields(part)
                    for t in (getattr(part, f.name),))
    offsets = None if sample_offsets is None else len(sample_offsets)
    return (tensors, settings, spp, shapes, tuple(target.shape), target.dtype, str(dev),
            kind, rng._MIXER, env, offsets)


def train_plan(scene: SceneData, settings: RenderSettings, params: DiffParams,
               target: torch.Tensor, spp: int, device=None,
               sample_offsets=None) -> TrainPlan:
    """The `TrainPlan` for this scene, settings, spp, shapes, material types,
    device and number of sample offsets (None: the plan takes none): the
    one kept where it matches, else a new one, which replaces it."""
    global _plan
    dev = resolve_device(device)
    key = _plan_key(scene, settings, params, target, spp, dev, sample_offsets)
    if _plan is not None and _plan[0] == key and _plan[1].takes(params):
        return _plan[1]
    _plan = None  # the old graph's pool is freed before the new plan captures
    plan = TrainPlan(scene, settings, params, target, spp, dev, sample_offsets)
    _plan = (key, plan)
    return plan


def kept_plan() -> TrainPlan | None:
    """The training plan `train_plan` keeps, if any."""
    return None if _plan is None else _plan[1]


def clear_plans():
    """Drop the kept training plan (and its graph's memory)."""
    global _plan
    _plan = None


def pixel_grad(scene: SceneData, settings: RenderSettings, params: DiffParams,
               seed: int, spp: int, select, params_sample: DiffParams | None = None,
               device=None) -> DiffParams:
    """The gradient of the scalar `select(film)` in every parameter (the
    entry point of the FD gates), on `device` (default `cuda`)."""
    dev = resolve_device(device)

    def f(p):
        film = render_diff(scene, settings, p, seed, spp, params_sample=params_sample,
                           device=dev)
        return select(film), None

    return _grads(f, params, dev)[2]
