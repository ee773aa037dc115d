"""Wavefront path tracing (`pt` and `pt-direct`), forward and differentiable.

The whole wavefront (lane = pixel x sample) advances together through an
iterative bounce loop (intersect, shade/NEE, sample next), with Russian
roulette deaths handled by masking, in the reference's estimator order
(`scene.rs:173-193`):
  accum += T * l_e                      (front-face, depth-0 rules)
  T /= rr_prob                          (survivors only)
  accum += T * direct_light             (pt-direct only)
  T *= brdf * coef * cos / pdf          (`scene.rs:78-102`)
with sky radiance added for missed rays at every depth (`scene.rs:43`).

`plain_bounce_step` is that transition in plain PyTorch (its intersection
is brute force or the plain BVH walk); `make_bounce_step` returns the step
the render loop runs, which launches a fused bounce kernel on a CUDA device
(ops/cuda_bounce.py: brute force or BVH) and is the plain step on the
CPU (and on the card under `fused="off"`). The forward stage loop
(`run_stage`) is a Python loop with one host sync per bounce (the "any
lane alive" test) on the CPU, and a fixed number of steps with no host
read on a CUDA device, which a CUDA graph captures, the kernels' step or
the plain one (integrator/render.py, `ChunkRenderer`): a bounce leaves a
dead lane as it is, so the steps past the last live lane change nothing.

The differentiable loop (`differentiable=True` of `trace` and
`trace_film`, which diff/render.py drives) takes a fixed number of steps
per stage, with no host sync, and steps from
`cuda_bounce.make_step_diff`, under the recompute policy
`settings.bwd_remat` (`_run_fixed`, `Remat`). Two material tables then
meet in the step: `scene.materials`, a detached copy that drives the
sampling decisions (RR, the NEE emitter test, BSDF sampling), and
`mats_eval`, the live parameters that every evaluated quantity reads
(emission, BRDF, coef, NEE's f and l_e). Intermediates of masked lanes stay finite (a lane whose query was
not asked, cap -inf, keeps its origin as position; coef's distance is 0
off a hit), so autograd's zero cotangents on them never meet an inf.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..constants import EPS, INF, PI
from ..ops import bsdf, rng, sky as sky_ops, table, vec
from ..ops.intersect import _use_brute, intersect, intersect_shade, shade_point
from ..scene.data import RenderSettings, SceneData

# RNG purpose slots per bounce (ctr = bounce * _SLOTS + slot): _SCATTER ->
# (rr, lobe phi, lobe radius, refraction roulette), _NEE -> (light pick,
# point-on-light u, v).
_SLOTS = 8
_SCATTER = 0
_NEE = 1


@dataclass
class PathState:
    bounce: int  # bounces taken so far (host-side)
    o: torch.Tensor  # (N, 3) f32
    d: torch.Tensor  # (N, 3) f32
    throughput: torch.Tensor  # (N, 3) f32
    accum: torch.Tensor  # (N, 3) f32
    alive: torch.Tensor  # (N,) bool
    rays_traced: torch.Tensor  # () f32 on the device
    lane: torch.Tensor  # (N,) int32: uint32 lane id bit pattern


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor of the same bit pattern."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _russian_roulette(weight, bounce: int, settings: RenderSettings):
    """`scene.rs:64-76`: prob = weight; halved per depth past depth_limit;
    forced to 1 while depth <= depth (if positive)."""
    over = max(bounce - settings.depth_limit, 0)
    prob = weight * (0.5 ** over)  # an exact power of two
    if bounce <= settings.depth:
        prob = torch.where(prob > 0.0, torch.ones_like(prob), prob)
    return prob


def _sample_light_point(scene: SceneData, u_pick, u1, u2):
    """Area-proportional light pick + uniform point (`objects.rs:37-51`,
    `triangle.rs:140-149`, `sphere.rs:79-84`). pdf = 1 / total_area.

    The pick is searchsorted(side="left") over the inclusive CDF, which is
    the JAX package's dense count of CDF entries below the roulette."""
    lights = scene.lights
    roulette = lights.total_area * u_pick
    n_lights = lights.prim.shape[0]
    li = torch.searchsorted(lights.cdf, roulette, right=False)
    li = torch.clamp(li, 0, n_lights - 1)

    is_tri = (table.take_rows(lights.is_tri, li) > 0)[..., None]
    # Triangle sample: min/max trick (`triangle.rs:140-149`).
    p0 = table.take_rows(lights.p0, li)
    le1 = table.take_rows(lights.e1, li)
    le2 = table.take_rows(lights.e2, li)
    mn = torch.minimum(u1, u2)[..., None]
    mx = torch.maximum(u1, u2)[..., None]
    p_tri = p0 * mn + (p0 + le1) * (1.0 - mx) + (p0 + le2) * (mx - mn)
    # Sphere sample: uniform over the FULL sphere (quirk #10).
    c = table.take_rows(lights.c, li)
    r = table.take_rows(lights.r, li)
    phi = 2.0 * PI * u1
    z = u2 * 2.0 - 1.0
    zs = vec.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    dir_s = torch.stack([torch.cos(phi) * zs, torch.sin(phi) * zs, z], dim=-1)
    p_sph = c + dir_s * r[..., None]

    point = torch.where(is_tri, p_tri, p_sph)
    pdf = torch.ones_like(u1) / lights.total_area
    return point, pdf


def emit_flag(settings: RenderSettings, bounce: int) -> bool:
    """Whether this bounce adds front-face emission (`scene.rs:175-179`):
    with NEE only at bounce 0 (no MIS, quirk #3), and at bounce 0 only
    without no-direct-emitter."""
    if settings.integrator == "pt-direct":
        return bounce == 0 and not settings.no_direct_emitter
    return bounce != 0 or not settings.no_direct_emitter


def _only(mask, cap):
    """The cap of a query whose answer only the `mask` lanes use: -inf on
    the others, which no hit beats, so a BVH walk takes no step for them
    (the kernels ask nothing there)."""
    return torch.where(mask, cap, torch.full_like(cap, -math.inf))


def _direct_light(scene, settings, sp, out_dir, m_gathered, lane, seed, ctr,
                  alive, mats_eval=None, plain_walk: bool = True,
                  remat: Remat | None = None):
    """NEE contribution (`scene.rs:104-151`) of the `alive` lanes. Returns
    (N,3) radiance. `m_gathered` (the lanes' sampling rows) decides the
    emitter early-out; f and l_e read `mats_eval` (default
    `scene.materials`); `plain_walk` and `remat` as in `plain_bounce_step`."""
    if mats_eval is None:
        mats_eval = scene.materials

    def light_sample():
        u_pick, u1, u2, _ = rng.uniform4(seed, lane, ctr + _NEE)
        return _sample_light_point(scene, u_pick, u1, u2)

    light_point, pdf = light_sample() if remat is None else remat.sampled(light_sample)

    path = light_point - sp.position
    # A light point on the shading point (path 0): `vec.norm`'s root has
    # an infinite derivative there, and the clamp's zero cotangent times it
    # is NaN; `norm_at_zero` gives the same value with a finite one.
    dist = vec.norm_at_zero(path)
    wi = path / torch.clamp(dist, min=1e-20)[..., None]

    point_normal = vec.orienting_normal(out_dir, sp.normal)
    cos_p = vec.dot(wi, point_normal)
    ok = alive & (cos_p > 0.0)

    # Emissive-hit early-out (`scene.rs:105-108`): no NEE from emitters.
    ok = ok & (vec.sqr_norm(m_gathered.emission) <= 0.0)

    # Capped shadow query: anything at t >= dist + 2*EPS cannot change the
    # verdict (`scene.rs:127-131` needs |t - dist| <= EPS); the second EPS
    # is slack for f32 rounding of `t < dist + EPS`. A BVH walk may stop at
    # any hit below the cap - 4*EPS: it settles the verdict as occluded.
    shadow, shadow_sp = intersect_shade(
        sp.position, wi, scene.geometry, scene.bvh, settings.intersector,
        t_cap=_only(ok, dist + 2.0 * EPS), occlusion=True, plain=plain_walk,
        keep=None if remat is None else remat.isect,
    )
    visible = shadow_sp.hit & (torch.abs(shadow.t - dist) <= EPS)
    ok = ok & visible

    light_cos = vec.dot(-wi, shadow_sp.normal)
    ok = ok & (light_cos > 0.0)

    g = cos_p * light_cos / torch.clamp(vec.sqr_norm(path), min=1e-20)
    f = bsdf.eval_brdf(
        bsdf.gather(mats_eval, sp.mat), out_dir, wi, point_normal,
        sp.position, present=settings.mat_types,
    )
    l_e = bsdf.gather(mats_eval, shadow_sp.mat).emission
    contrib = f * l_e * (g / pdf)[..., None]
    return torch.where(ok[..., None], contrib, torch.zeros_like(contrib))


def _masked(mask, x):
    """x where mask (per lane), else 0."""
    return torch.where(mask[..., None], x, torch.zeros_like(x))


def plain_bounce_step(scene: SceneData, settings: RenderSettings, seed,
                      state: PathState, mats_eval=None, plain_walk: bool = True,
                      remat: Remat | None = None) -> PathState:
    """One bounce transition over a PathState, in plain PyTorch: the plain
    version of the fused bounce kernel, and the step the CPU runs. Like the
    kernel it walks the BVH only for the queries whose answer it uses: the
    primary ray of a live lane, the shadow ray of a lane that survived
    Russian roulette, faces its light and is not emissive. `scene.materials`
    drives the sampling decisions and `mats_eval` (default: the same table)
    the evaluated quantities; autograd through the step gives the gradients
    of its outputs in the state, `mats_eval`, the sky and the geometry.

    A BVH scene's queries take the plain walk (`_walk_tris`, autograd
    through its triangle tests), or with `plain_walk=False` the walk
    `ops/intersect.py::bvh_route` picks (a kernel for CUDA tensors, the plain
    walk for CPU ones) with the plane-equation VJP of `cuda_bvh.plane_t`:
    the same values, and the JAX package's gradient of the walk. The
    hybrid step's backward recomputes the bounce that way, and so does the
    card's step under `fused="off"`.

    `remat` (the loop's `bwd_remat` "isect" and "isect+samp" policies)
    keeps both queries' searches, and under "isect+samp" the BSDF and
    light samples, in the forward pass and hands them back in the
    checkpoint's recompute (`Remat`)."""
    if mats_eval is None:
        mats_eval = scene.materials
    bounce = state.bounce
    lane = state.lane
    ctr = bounce * _SLOTS
    nee = settings.integrator == "pt-direct"

    inf = torch.full_like(state.o[:, 0], INF)
    hit, sp = intersect_shade(
        state.o, state.d, scene.geometry, scene.bvh, settings.intersector,
        t_cap=_only(state.alive, inf), plain=plain_walk,
        keep=None if remat is None else remat.isect,
    )
    rays = state.rays_traced + state.alive.sum(dtype=torch.float32)

    # Sky on miss (`scene.rs:43`) — at every depth, both integrators.
    missed = state.alive & ~sp.hit
    sky_l = sky_ops.radiance(scene.sky, settings.sky_kind, state.d)
    accum = state.accum + _masked(missed, state.throughput * sky_l)
    alive = state.alive & sp.hit

    m = bsdf.gather(scene.materials, sp.mat)
    m_eval = bsdf.gather(mats_eval, sp.mat)
    out_dir = -state.d

    # Emission (`scene.rs:175-179`): front faces only.
    if emit_flag(settings, bounce):
        front = vec.dot(out_dir, sp.normal) > 0.0
        accum = accum + _masked(alive & front, state.throughput * m_eval.emission)

    # One mixer call covers RR + all three BSDF-sampling draws.
    u_rr, r1, r2, r3 = rng.uniform4(seed, lane, ctr + _SCATTER)

    # Russian roulette (`scene.rs:180-183`).
    prob = _russian_roulette(bsdf.rr_weight(m), bounce, settings)
    alive = alive & ((prob == 1.0) | (u_rr < prob))
    throughput = state.throughput / torch.clamp(prob, min=1e-12)[..., None]

    # NEE (`scene.rs:185-186`).
    if nee and settings.has_lights:
        direct = _direct_light(scene, settings, sp, out_dir, m, lane, seed, ctr,
                               alive, mats_eval, plain_walk, remat)
        accum = accum + _masked(alive, throughput * direct)
        rays = rays + alive.sum(dtype=torch.float32)  # shadow rays

    # BSDF sampling + throughput update (`scene.rs:78-102`).
    def bsdf_sample():
        return bsdf.sample(m, out_dir, sp.normal, r1, r2, r3,
                           present=settings.mat_types)

    s = bsdf_sample() if remat is None else remat.sampled(bsdf_sample)
    f = bsdf.eval_brdf(m_eval, out_dir, s.direction, sp.normal, sp.position,
                       present=settings.mat_types)
    t_hit = torch.where(sp.hit, hit.t, torch.zeros_like(hit.t))  # -inf on dead lanes
    cf = bsdf.coef(m_eval, out_dir, sp.normal, t_hit, present=settings.mat_types)
    cos = vec.dot(s.direction, sp.normal)  # geometric n (`scene.rs:91`)
    safe_pdf = torch.where(s.pdf != 0.0, s.pdf, torch.ones_like(s.pdf))
    w = f * cf * (cos / safe_pdf)[..., None]
    throughput = throughput * torch.where(alive[..., None], w,
                                          torch.ones_like(w))
    # Lanes whose weight collapsed to exactly zero can never contribute.
    alive = alive & (w != 0.0).any(dim=-1) & (s.pdf != 0.0)

    keep = alive[..., None]
    return PathState(
        bounce=bounce + 1,
        o=torch.where(keep, sp.position, state.o),
        d=torch.where(keep, s.direction, state.d),
        throughput=torch.where(keep, throughput, state.throughput),
        accum=accum,
        alive=alive,
        rays_traced=rays,
        lane=lane,
    )


def make_bounce_step(scene: SceneData, settings: RenderSettings, seed,
                     mats_eval=None, differentiable: bool = False):
    """The per-bounce transition the render loop runs: a fused bounce
    kernel for CUDA tensors (brute force or BVH), the plain step for CPU
    tensors. With `differentiable`, the step of `cuda_bounce.make_step_diff`
    (a kernel forward with the hand-written backward kernel, or with
    autograd of the plain step recomputed on the input state; raises on the
    card only for a scene no bounce kernel serves)."""
    from ..ops import cuda_bounce

    if differentiable:
        return cuda_bounce.make_step_diff(scene, settings, seed, mats_eval)
    return cuda_bounce.make_step(scene, settings, seed, mats_eval)


def _keep_saved(x):
    return x


class Remat:
    """What one checkpointed bounce keeps besides its input state under
    `bwd_remat` "isect" (both queries' searches, `ops/intersect.py::Found`)
    or "isect+samp" (also the BSDF sample and the light sample), in the
    order the bounce asks for them. The checkpoint runs the bounce twice:
    in the forward pass each `isect` / `sampled` call runs its function and
    keeps the result; in the recompute for the backward pass it hands the
    kept result back and runs nothing.

    The backward pass walks the forward pass's autograd graph; the
    recompute only regenerates the tensors that graph saved, matched by
    their order (torch.utils.checkpoint, non-reentrant). A search runs
    under no_grad and saves nothing, so skipping it leaves that order as
    it was. A BSDF sample is differentiable (its direction follows the
    incoming direction and a sphere's normal), so in the forward pass it
    runs under saved-tensor hooks of its own: its graph keeps what it
    saved, the checkpoint does not track it, and the recompute need not
    regenerate it. A kept tensor comes back detached, requiring grad as
    the original did, so the ops after it save what they saved before.
    The gradients are those of "full" and "none" bit for bit."""

    def __init__(self, samp: bool):
        self.samp = samp
        self.kept = []  # (kind of tuple, tensors detached, requires_grad flags)
        self.at = None  # the next kept result's index in a recompute

    def start(self):
        """Called as the bounce starts: a recompute once the forward pass
        has kept its results."""
        self.at = 0 if self.kept else None

    def isect(self, find):
        return self._take(find)

    def sampled(self, draw):
        return self._take(draw) if self.samp else draw()

    def _take(self, compute):
        if self.at is None:
            with torch.autograd.graph.saved_tensors_hooks(_keep_saved, _keep_saved):
                out = compute()
            self.kept.append((type(out), tuple(x.detach() for x in out),
                              tuple(x.requires_grad for x in out)))
            return out
        kind, vals, grads = self.kept[self.at]
        self.at += 1
        vals = [x.detach().requires_grad_(g) if g else x.detach() for x, g in zip(vals, grads)]
        return kind._make(vals) if hasattr(kind, "_make") else kind(vals)


def _checkpointed(step, state: PathState, remat: Remat | None = None) -> PathState:
    """`step(state)` under torch.utils.checkpoint: only the input state
    (and with `remat` what it keeps) is kept for the backward pass, which
    recomputes the bounce. The checkpoint stashes no RNG state
    (`preserve_rng_state=False`): the step draws only the counter-based
    mixers of ops/rng.py, from lane ids and counters, never torch's
    generators, so the recompute draws the same numbers bit for bit, and a
    CUDA graph's capture, which cannot read or set a generator's state on
    the host, holds the checkpoint."""
    from torch.utils.checkpoint import checkpoint

    def run(o, d, thr, acc, alive, rays, lane):
        st = PathState(state.bounce, o, d, thr, acc, alive, rays, lane)
        if remat is None:
            s = step(st)
        else:
            remat.start()
            s = step(st, remat=remat)
        return s.o, s.d, s.throughput, s.accum, s.alive, s.rays_traced

    o, d, thr, acc, alive, rays = checkpoint(
        run, state.o, state.d, state.throughput, state.accum, state.alive,
        state.rays_traced, state.lane, use_reentrant=False, preserve_rng_state=False)
    return PathState(state.bounce + 1, o, d, thr, acc, alive, rays, state.lane)


REMAT_POLICIES = ("none", "full", "hybrid", "isect", "isect+samp")


def _run_fixed(step, state: PathState, n_steps: int,
               settings: RenderSettings) -> PathState:
    """`n_steps` bounces of the differentiable loop, with no host sync (a
    dead lane stays dead through the mask-correct step). The recompute
    policy is `settings.bwd_remat`, the JAX package's `run_stage`'s:
    "full" checkpoints every bounce, "none" keeps every bounce's
    intermediates, "hybrid" keeps them on stages of at most 48k lanes and
    checkpoints wider ones, "isect" checkpoints every bounce keeping both
    queries' searches (the recompute walks nothing), "isect+samp" also the
    BSDF and light samples (`Remat`); a step without its own backward
    takes `remat=` for those two. A step with its own backward
    (`fused_diff`: the hand-written backward or the hybrid's) keeps only
    its input state anyway, so it is never checkpointed, as the JAX
    package's `run_stage` skips `jax.checkpoint` for its fused steps."""
    mode = getattr(settings, "bwd_remat", "full")
    if mode not in REMAT_POLICIES:
        raise ValueError(f"unknown bwd_remat policy {mode!r}; expected one of "
                         + ", ".join(repr(m) for m in REMAT_POLICIES))
    if getattr(step, "fused_diff", False):
        mode = "none"
    keep = mode == "none" or (mode == "hybrid" and state.o.shape[0] <= 48 * 1024)
    for _ in range(n_steps):
        if keep:
            state = step(state)
        elif mode in ("full", "hybrid"):
            state = _checkpointed(step, state)
        else:
            state = _checkpointed(step, state, Remat(samp=mode == "isect+samp"))
    return state


def run_stage(step, state: PathState, b1: int) -> PathState:
    """The forward loop of one stage, up to bounce `b1`, as the JAX
    package's `lax.while_loop` (condition `any(alive) & bounce < b1`)
    computes it. On the CPU it is that loop, with one host read per bounce.
    On a CUDA device it takes all `b1 - bounce` steps and reads nothing: a
    bounce leaves a dead lane's o, d, throughput and accum as they are and
    counts no ray for it (csrc/bounce_body.cuh), so the steps past the last
    live lane change neither the state nor the ray count, and a CUDA graph
    can hold the stage."""
    if state.o.device.type == "cuda":
        for _ in range(b1 - state.bounce):
            state = step(state)
        return state
    while state.bounce < b1 and bool(state.alive.any()):
        state = step(state)
    return state


def trace(scene: SceneData, settings: RenderSettings, o, d, lane, seed,
          differentiable: bool = False, mats_eval=None):
    """Trace radiance for a wavefront of rays (no compaction). Returns
    (radiance (N,3), rays_traced ()). The forward loop is one stage of
    `run_stage`; the differentiable one takes max_bounces steps."""
    n = o.shape[0]
    dev = o.device
    state = PathState(
        bounce=0, o=o, d=d,
        throughput=torch.ones((n, 3), dtype=o.dtype, device=dev),
        accum=torch.zeros((n, 3), dtype=o.dtype, device=dev),
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
        rays_traced=torch.zeros((), dtype=torch.float32, device=dev),
        lane=lane,
    )
    step = make_bounce_step(scene, settings, seed, mats_eval=mats_eval,
                            differentiable=differentiable)
    if differentiable:
        state = _run_fixed(step, state, settings.max_bounces, settings)
    else:
        state = run_stage(step, state, settings.max_bounces)
    return state.accum, state.rays_traced


def aov(scene: SceneData, settings: RenderSettings, o, d):
    """Debug AOV integrators (`scene.rs:48-62`): "normal" maps the hit
    normal to [0,1]^3, "depth" returns the hit distance (0 on miss). On a
    BVH scene the triangle walk is the kernel `ops/intersect.py::bvh_route`
    picks for CUDA tensors (per-thread, wide or streamed)."""
    hit = intersect(o, d, scene.geometry, scene.bvh, settings.intersector)
    sp = shade_point(o, d, hit, scene.geometry)
    if settings.integrator == "normal":
        return _masked(sp.hit, sp.normal / 2.0 + 0.5)
    t = torch.where(sp.hit, hit.t, torch.zeros_like(hit.t))
    return t[..., None].expand(-1, 3)


# ---------------------------------------------------------------------------
# Staged wavefront compaction
# ---------------------------------------------------------------------------


def _stage_plan(n: int, settings: RenderSettings, aggressive: bool = False):
    """Static (width, first_bounce, last_bounce) stages; widths shrink as
    Russian roulette kills paths.

    * `aggressive` (brute-force scenes): full width until depth+3, then
      n/64 until depth+14, then 4096. The first cut overflows the live
      population, so population-control RR resamples the survivors.
    * default (BVH scenes): occupancy-matched n/8, n/64, 4096 cuts.
    The JAX package chose these ladders; the port keeps them so that both
    render the same estimator.
    """
    def cap(div):
        return max(4096, (n // div + 255) // 256 * 256)

    d = settings.depth
    mb = settings.max_bounces
    if aggressive:
        cuts = [
            (n, 0, min(d + 3, mb)),
            (cap(64), min(d + 3, mb), min(d + 14, mb)),
            (4096, min(d + 14, mb), mb),
        ]
    else:
        cuts = [
            (n, 0, min(d + 3, mb)),
            (cap(8), min(d + 3, mb), min(d + 9, mb)),
            (cap(64), min(d + 9, mb), min(d + 19, mb)),
            (4096, min(d + 19, mb), mb),
        ]
    return tuple((min(w, n), b0, b1) for w, b0, b1 in cuts if b1 > b0)


def _compact(state: PathState, width: int, seed, ctr: int,
             salt=None) -> PathState:
    """Shrink the wavefront to `width` slots.

    When the live population fits (a <= width): prefix compaction keeps
    every live lane (exact, weight 1). On overflow: systematic resampling —
    exactly `width` of the `a` live lanes are kept via a jittered-grid rank
    pick (one scalar uniform u; ranks ceil((j+u)*a/width)), each live lane
    kept with marginal probability width/a, survivors reweighted by a/width
    (population-control Russian roulette, unbiased). The jitter u is salted
    with the chunk's first camera lane id (`salt`), independent of the live
    set.
    """
    n = state.alive.shape[0]
    dev = state.alive.device
    s = torch.cumsum(state.alive.to(torch.int32), dim=0)
    a = s[-1]
    af = a.to(torch.float32)

    # rank -> lane index (slot 0 absorbs dead lanes' writes; live ranks
    # start at 1).
    rank_pos = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    rank_pos[torch.where(state.alive, s, 0).long()] = torch.arange(n, device=dev)
    rank_pos[0].zero_()  # a fill: a CUDA graph can capture it

    overflow = a > width
    j = torch.arange(width, dtype=torch.int32, device=dev)
    if salt is None:
        salt = state.lane[0]
    salt = rng.as_u32(salt, dev) ^ 0x5EED5EED
    u = rng.uniform(seed, salt, ctr)
    # A fill, not a copy from the host: a CUDA graph can capture it. (A
    # host scalar divisor would be a multiply by its reciprocal on CUDA.)
    ratio = af / torch.full((), float(width), dtype=torch.float32, device=dev)
    g = (j.to(torch.float32) + u) * ratio
    r_over = torch.ceil(g).to(torch.int32)
    r = torch.where(overflow, r_over, j + 1)
    r = torch.clamp(r, min=1)
    r = torch.minimum(r, torch.clamp(a, min=1))
    src = rank_pos[r.long()]

    alive = torch.where(overflow, torch.ones_like(j, dtype=torch.bool), j < a)
    alive = alive & (a > 0)
    scale = torch.clamp(ratio, min=1.0)
    # index_select, not x[src]: without overflow every dead slot repeats the
    # last live lane's index, and the backward pass of x[src] sorts the
    # indices and adds each run of repeats serially (45 ms a 16-spp
    # training step on the H100, PERF.md 6.3), where index_select's adds
    # the rows at once. Only the dead slots repeat, and their cotangents
    # are exact zeros, so the sum is the same on every run.
    take = lambda x: torch.index_select(x, 0, src)
    return PathState(
        bounce=state.bounce,
        o=take(state.o),
        d=take(state.d),
        throughput=take(state.throughput) * scale,
        accum=torch.zeros((width, 3), dtype=state.accum.dtype, device=dev),
        alive=alive,
        rays_traced=state.rays_traced,
        lane=take(state.lane),
    )


def _bank_rows(film, idx, lane, vals, deterministic: bool):
    """film + vals added into the rows idx, out of place. With
    `deterministic` (the differentiable loop, whose gradients must repeat
    bit for bit) in the same order on every run: on CUDA index_add adds
    with atomics, in an order that changes between runs, and index_put with
    accumulate sorts the indices and adds each run of one index serially.
    Compaction's padding slots all repeat the last live lane (each repeats
    the row before it; live lanes are distinct) and stay dead with accum 0
    and no gradient, so they go to rows of their own past the film, and no
    run is long. The forward render keeps index_add, which on the CPU adds
    in order."""
    if film.device.type != "cuda" or not deterministic:
        return film.index_add(0, idx, vals)
    n_pix = film.shape[0]
    pad = torch.zeros_like(idx, dtype=torch.bool)
    pad[1:] = lane[1:] == lane[:-1]
    idx = torch.where(pad, torch.arange(idx.shape[0], device=idx.device) + n_pix, idx)
    big = torch.cat([film, film.new_zeros((idx.shape[0], film.shape[1]))])
    return big.index_put((idx,), vals, accumulate=True)[:n_pix]


def bank_ordered(film, vals, pixel_fn=None, deterministic: bool = False):
    """film + the per-lane `vals` (N, C) of lanes in arange order, lane i
    on film row i % P (P = film rows; N a multiple of P) or, with a tile
    decode, on row `pixel_fn(i % P)`: a reshape-sum over the samples, the
    rows placed through the decode's permutation, each row written once.
    No two adds meet in a row, so the sum is the same on every run (the
    JAX package's `.at[pix].add` adds in lane order; index_add on CUDA with
    atomics, in an order that changes between runs). `trace_film`'s first
    bank and the AOV chunks bank through it; `deterministic` as in
    `_bank_rows`."""
    n_pix = film.shape[0]
    by_lane = vals.reshape(-1, n_pix, vals.shape[-1]).sum(dim=0)
    if pixel_fn is None:
        return film + by_lane
    perm = pixel_fn(torch.arange(n_pix, device=film.device))
    return _bank_rows(film, perm, perm, by_lane, deterministic)


def trace_film(scene: SceneData, settings: RenderSettings, o, d, lane, seed,
               weight0, n_pixels: int, pixel_fn=None, step=None,
               differentiable: bool = False, mats_eval=None):
    """Trace a wavefront and accumulate straight into a flat pixel buffer.

    `weight0` (N,) is the camera estimator weight, folded into the initial
    throughput. Returns (film_flat (n_pixels, 3) SUM over lanes, rays).
    With settings.compaction == "pop-rr" the wavefront shrinks at the
    stage plan's bounce depths: contributions are banked into the film at
    every stage boundary and live lanes are compacted (`_compact`).
    Lane ids arrive in arange order, so the first bank is a reshape-sum.
    `pixel_fn(lane) -> pixel index` overrides
    `lane % n_pixels` (the tile decode). `step` defaults to
    `make_bounce_step(scene, settings, seed, mats_eval, differentiable)`.

    `differentiable=True` is the inverse-rendering path: every stage takes
    its fixed number of steps (`_run_fixed`, no host sync), and the stage
    plan is the occupancy-matched one for every scene (the JAX package
    keeps the aggressive ladder to forward rendering). Compaction and
    banking are gathers, scalings and out-of-place index_adds, so
    gradients flow through them to the camera rays and `weight0`.
    """
    n = o.shape[0]
    dev = o.device
    state = PathState(
        bounce=0,
        o=o,
        d=d,
        throughput=torch.ones((n, 3), dtype=o.dtype, device=dev)
        * weight0[..., None],
        accum=torch.zeros((n, 3), dtype=o.dtype, device=dev),
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
        rays_traced=torch.zeros((), dtype=torch.float32, device=dev),
        lane=lane,
    )
    if step is None:
        step = make_bounce_step(scene, settings, seed, mats_eval=mats_eval,
                                differentiable=differentiable)
    film = torch.zeros((n_pixels, 3), dtype=o.dtype, device=dev)

    def to_pixel(lane_vals):
        lane64 = rng.as_u32(lane_vals)
        if pixel_fn is not None:
            return pixel_fn(lane64)
        return lane64 % n_pixels

    def bank(film, st: PathState, ordered: bool = False):
        if ordered and st.accum.shape[0] % n_pixels == 0:
            return bank_ordered(film, st.accum, pixel_fn, differentiable)
        return _bank_rows(film, to_pixel(st.lane), st.lane, st.accum, differentiable)

    def stage(state, b1: int):
        if differentiable:
            return _run_fixed(step, state, b1 - state.bounce, settings)
        return run_stage(step, state, b1)

    if settings.compaction != "pop-rr":
        state = stage(state, settings.max_bounces)
        return bank(film, state, ordered=True), state.rays_traced

    first = True
    plan = _stage_plan(
        n, settings,
        aggressive=(not differentiable
                    and _use_brute(scene.geometry, settings.intersector)),
    )
    for si, (width, b0, b1) in enumerate(plan):
        if width != state.alive.shape[0]:
            film = bank(film, state, ordered=first)
            first = False
            state = _compact(state, width, seed, 0x50000000 + si,
                             salt=lane[0])
        state = stage(state, b1)
    film = bank(film, state, ordered=first)
    return film, state.rays_traced
