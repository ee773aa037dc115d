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
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from ..integrator.render import tile_decode
from ..integrator.wavefront import trace_film, u32_to_i32
from ..ops import camera as camera_ops
from ..ops import rng
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
                seed: int, spp: int, sample_offsets=None,
                params_sample: DiffParams | None = None, with_rays: bool = False,
                device=None):
    """Differentiable film (H, W, 3) as a function of `params`, on `device`
    (default `cuda`; the scene and the parameters are moved there with
    differentiable copies).

    Sampling decisions read the detached `params` (or `params_sample`,
    which pins them: the FD gate holds the sampling measure at theta0 on
    both sides while it perturbs the live parameters); shading reads the
    live `params`. `sample_offsets` ((spp,) ints) gives the global sample
    ids of this call. `with_rays=True` returns (film, rays), the rays
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
    film = film_flat.reshape(h, w, 3) / torch.tensor(float(spp), device=dev)
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


def film_and_grads(scene: SceneData, settings: RenderSettings, params: DiffParams,
                   target: torch.Tensor, seed: int, spp: int, device=None):
    """One inverse-rendering step on `device` (default `cuda`): the L2 loss
    of the film against `target`, the film, and the loss's gradient in
    every parameter as a DiffParams (zeros for integer leaves)."""
    dev = resolve_device(device)
    target = target.to(dev)

    def loss_fn(p):
        film = render_diff(scene, settings, p, seed, spp, device=dev)
        return torch.mean((film - target) ** 2), film.detach()

    loss, film, grads = _grads(loss_fn, params, dev)
    return loss, film, grads


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
