"""The forward path's kernels, hand-written CUDA C++ for Hopper (sm_90a).

* `generate_rays` wraps `csrc/raygen.cu` (camera rays per lane); its plain
  version is `plain_generate_rays` (`rng.uniform4` + `camera.sample_rays`).
* `bounce` wraps `csrc/bounce.cu` (one whole brute-force bounce) and
  `bounce_bvh` wraps `csrc/bounce_bvh.cu` (one whole bounce through the
  BVH); both are `csrc/bounce_body.cuh` with another intersector, and their
  plain version is `integrator/wavefront.py:plain_bounce_step`.
* The BVH nearest-triangle kernel, `csrc/bvh.cu`, is wrapped in
  `ops/cuda_bvh.py`.

Each wrapper runs its plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises. The launch itself is
`raygen_launch` / `bounce_launch` / `bounce_bvh_launch` (preallocated
outputs, nothing else on the device, so it can be timed alone). Each kernel
has a launch counter, raised by one per launch and nowhere else;
`counts()` reads all four and `reset_counts()` zeroes them. The kernels are
built by `ops/cuda_build.py`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..scene.data import (
    CAM_IDEAL_PINHOLE,
    CAM_OMNIDIRECTIONAL,
    RenderSettings,
    SKY_IBL,
    SKY_UNIFORM,
    SceneData,
)
from . import cuda_build, cuda_bvh
from .cuda_build import ptr as _ptr
from .intersect import _use_brute


# ---------------------------------------------------------------------------
# What the kernels serve
# ---------------------------------------------------------------------------


def raygen_supported(settings: RenderSettings) -> tuple[bool, str]:
    """(ok, reason) for the raygen kernel: every camera but the
    omnidirectional one."""
    if settings.camera_kind == CAM_OMNIDIRECTIONAL:
        return False, ("the omnidirectional camera on the card comes in a "
                       "later slice (queue 1 of ROADMAP.md)")
    return True, ""


def bvh_supported(scene: SceneData) -> tuple[bool, str]:
    """(ok, reason) for the BVH kernels: treelets of TREELET_K (32)
    triangles. The compiler builds 128-wide leaves for meshes of
    WIDE_MIN_TRIS triangles or more; those need the wide-leaf kernel."""
    from ..accel.pack import TREELET_K, WIDE_MIN_TRIS

    k = scene.bvh.blk_p0.shape[1]
    if k != TREELET_K:
        return False, (f"a BVH of {k}-wide leaves (built for meshes of "
                       f"{WIDE_MIN_TRIS} triangles or more) needs the "
                       "wide-leaf BVH kernel, which comes in slice 4 "
                       "(pallas_bvh_wide._kernel, queue 2 of ROADMAP.md)")
    return True, ""


def _shading_supported(settings: RenderSettings) -> tuple[bool, str]:
    """(ok, reason) for what both bounce kernels shade: pt or pt-direct
    under a uniform or IBL sky."""
    if settings.sky_kind not in (SKY_UNIFORM, SKY_IBL):
        return False, ("the simple sky on the card comes in a later slice "
                       "(queue 1 of ROADMAP.md); the card serves uniform "
                       "and IBL skies")
    if settings.integrator not in ("pt", "pt-direct"):
        return False, (f"integrator {settings.integrator!r} has no bounce "
                       "kernel: the AOVs run intersect and shade_point")
    return True, ""


def bounce_supported(scene: SceneData, settings: RenderSettings) -> tuple[bool, str]:
    """(ok, reason) for the bounce kernels: pt or pt-direct under a uniform
    or IBL sky, on a brute-force scene (bounce.cu) or a BVH scene of
    32-wide leaves (bounce_bvh.cu). Lights and materials have no cap
    (binary-search light pick, tables read from global memory)."""
    ok, why = _shading_supported(settings)
    if not ok:
        return ok, why
    if _use_brute(scene.geometry, settings.intersector, scene.bvh):
        return True, ""
    return bvh_supported(scene)


def supported(scene: SceneData, settings: RenderSettings) -> tuple[bool, str]:
    """(ok, reason): whether the card's forward path serves this scene:
    raygen, then the bounce kernels (pt, pt-direct) or, for the AOV
    integrators, `intersect` (PyTorch brute force, or the sphere pre-pass
    and the BVH kernel). The reason names the later slice of the port that
    will."""
    ok, why = raygen_supported(settings)
    if not ok:
        return ok, why
    if settings.integrator in ("normal", "depth"):
        if _use_brute(scene.geometry, settings.intersector, scene.bvh):
            return True, ""
        return bvh_supported(scene)
    return bounce_supported(scene, settings)


def _require(check):
    ok, why = check
    if not ok:
        raise NotImplementedError(f"not on the card yet: {why}")


def require_supported(scene: SceneData, settings: RenderSettings):
    _require(supported(scene, settings))


# ---------------------------------------------------------------------------
# Kernel A: camera rays
# ---------------------------------------------------------------------------


def _camera_row(scene: SceneData) -> list[float]:
    """The kernel's 24-float camera argument. Reading it from the card is a
    host sync, so it is read once per CameraData and kept on it."""
    cam = scene.camera
    row = getattr(cam, "_kernel_row", None)
    if row is None:
        parts = [cam.position, cam.aperture_position, cam.right,
                 cam.sensor_size[:2], cam.up, cam.forward,
                 cam.aperture_radius.reshape(1), cam.focus_distance.reshape(1),
                 cam.aperture_sensor_distance.reshape(1)]
        vals = torch.cat([p.reshape(-1).to(torch.float32).cpu() for p in parts])
        row = vals.tolist() + [0.0] * (24 - vals.numel())
        cam._kernel_row = row
    return row


def plain_generate_rays(scene: SceneData, settings: RenderSettings, seed,
                        sample_offset: int, n: int):
    """Camera rays in plain PyTorch on the scene's device: (o, d, pdf, g)."""
    from ..integrator.render import camera_lanes
    from . import camera, rng

    dev = scene.camera.position.device
    glane, px, py = camera_lanes(settings, sample_offset, n, dev)
    # High counter so it never collides with bounce-loop slots.
    u, v, u2, v2 = rng.uniform4(seed, glane, 0x40000000)
    o, d, pdf, g = camera.sample_rays(
        scene.camera, settings.camera_kind, px, py,
        settings.width, settings.height, u, v, u2, v2,
    )
    return o.contiguous(), d, pdf.contiguous(), g


def generate_rays(scene: SceneData, settings: RenderSettings, seed,
                  sample_offset: int, n: int, uniforms: torch.Tensor | None = None):
    """(o (n,3), d (n,3), pdf (n,), g (n,)) for `n` camera lanes starting at
    sample `sample_offset`. Launches the raygen kernel when the scene lies
    on a CUDA device; the plain version on the CPU. A float32 (n, 4)
    `uniforms` tensor on the card receives the kernel's four random numbers
    per lane (for checking them against `rng.uniform4`)."""
    from .camera import aperture_pdf

    dev = scene.camera.position.device
    if dev.type == "cpu":
        return plain_generate_rays(scene, settings, seed, sample_offset, n)
    o = torch.empty((n, 3), dtype=torch.float32, device=dev)
    d = torch.empty((n, 3), dtype=torch.float32, device=dev)
    ideal = settings.camera_kind == CAM_IDEAL_PINHOLE
    g = None if ideal else torch.empty(n, dtype=torch.float32, device=dev)
    raygen_launch(scene, settings, seed, sample_offset, o, d, g, uniforms)
    if ideal:
        g = torch.ones(n, dtype=torch.float32, device=dev)
        pdf = torch.ones(n, dtype=torch.float32, device=dev)
    else:
        pdf = aperture_pdf(scene.camera, settings.width,
                           settings.height).expand(n).contiguous()
    return o, d, pdf, g


def raygen_launch(scene: SceneData, settings: RenderSettings, seed,
                  sample_offset: int, o: torch.Tensor, d: torch.Tensor,
                  g: torch.Tensor | None = None,
                  uniforms: torch.Tensor | None = None):
    """The raygen kernel alone, for o.shape[0] lanes: writes `o` and `d`
    ((n,3) float32 on the card) and, for the aperture cameras, `g` ((n,)
    float32; None for the ideal pinhole, whose g is 1). `generate_rays`
    allocates these and adds pdf and g; this is the launch it counts."""
    from ..integrator.render import tile_dims

    _require(raygen_supported(settings))
    n = o.shape[0]
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"raygen outputs must lie on a CUDA device, not {dev}")
    if n >= 2**31:
        raise ValueError(f"{n} lanes do not fit the kernel's int32 lane index")
    for name, t, shape in (("o", o, (n, 3)), ("d", d, (n, 3)),
                           ("g", g, (n,)), ("uniforms", uniforms, (n, 4))):
        if t is not None and (t.shape != shape or t.device != dev
                              or t.dtype != torch.float32
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {shape} float32 "
                             f"tensor on {dev}")
    ideal = settings.camera_kind == CAM_IDEAL_PINHOLE
    if (g is None) != ideal:
        raise ValueError("g is written for the aperture cameras only")
    w, h = settings.width, settings.height
    tw, th = tile_dims(settings) or (0, 0)
    cam = (ctypes.c_float * 24)(*_camera_row(scene))  # copied into the launch
    rc = cuda_build.fn("raygen")(
        _ptr(o), _ptr(d), None if g is None else _ptr(g),
        None if uniforms is None else _ptr(uniforms), n,
        int(seed) & 0xFFFFFFFF, (sample_offset * w * h) & 0xFFFFFFFF,
        w, h, tw, th, settings.camera_kind, ctypes.addressof(cam), cuda_build.stream(),
    )
    cuda_build.check(rc, "raygen")
    generate_rays.launches += 1


generate_rays.launches = 0


# ---------------------------------------------------------------------------
# Kernels B and D: one bounce, brute force or through the BVH
# ---------------------------------------------------------------------------


def pack_tables(scene: SceneData, bvh: bool = False) -> dict:
    """The bounce kernels' tables (layouts in csrc/bounce.cu and
    csrc/bounce_body.cuh), on the scene's device; with `bvh`, also the BVH
    kernel's (csrc/bvh_walk.cuh), which only the BVH bounce reads."""
    g = scene.geometry
    mt = scene.materials
    lt = scene.lights
    dev = g.tri_p0.device
    f32 = torch.float32

    def rows(parts, width):
        cols = [p.to(f32).reshape(p.shape[0], math.prod(p.shape[1:]))
                for p in parts]
        t = torch.cat(cols, dim=1)
        pad = torch.zeros((t.shape[0], width - t.shape[1]), dtype=f32,
                          device=dev)
        return torch.cat([t, pad], dim=1).contiguous()

    tables = dict(
        tris=rows([g.tri_p0, g.tri_e1, g.tri_e2, g.tri_n, g.tri_mat], 16),
        sph=rows([g.sph_c, g.sph_r, g.sph_mat], 8),
        mats=rows([mt.type_id, mt.color, mt.emission, mt.alpha, mt.ior,
                   mt.absorbtance], 16),
        lights=rows([lt.is_tri, lt.p0, lt.e1, lt.e2, lt.c, lt.r, lt.cdf], 16),
        total_area=float(lt.total_area),
        sky=[float(x) for x in scene.sky.color.cpu()],
        ibl=scene.sky.ibl.to(f32).contiguous(),
        lon=float(scene.sky.longitude_offset),
    )
    if bvh:
        tables["bvh"] = cuda_bvh.tables_of(scene.bvh)
    return tables


def _launch(kernel: str, scene: SceneData, settings: RenderSettings, seed,
            state, tables: dict, out):
    """Check the state, outputs and tables, and launch `llr_<kernel>`
    ("bounce" or "bounce_bvh") on them."""
    _require(_shading_supported(settings))
    bvh = kernel == "bounce_bvh"
    if bvh:
        _require(bvh_supported(scene))
        if "bvh" not in tables:
            raise ValueError("the BVH bounce needs pack_tables(scene, bvh=True)")
    n = state.o.shape[0]
    for name in ("o", "d", "throughput", "accum"):
        t = getattr(state, name)
        if t.dtype != torch.float32 or t.shape != (n, 3) or not t.is_contiguous():
            raise ValueError(f"PathState.{name} must be a contiguous ({n},3) float32 tensor")
    if state.alive.dtype != torch.bool or state.lane.dtype != torch.int32:
        raise ValueError("PathState.alive must be bool and PathState.lane int32")
    if n >= 2**31:
        raise ValueError(f"{n} lanes do not fit the kernel's int32 lane index")
    o, d, thr, acc, alive, rays = out
    dev = state.o.device
    tensors = (state.o, state.d, state.throughput, state.accum, state.alive,
               state.lane, *out, tables["sph"], tables["mats"],
               tables["lights"], tables["ibl"])
    if bvh:
        bt = tables["bvh"]
        tensors += (bt["nodes"], bt["leaves"], bt["ids"])
    else:
        tensors += (tables["tris"],)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("the state, the outputs and the tables must lie on "
                         "one CUDA device")
    for t, shape, dtype in ((o, (n, 3), torch.float32), (d, (n, 3), torch.float32),
                            (thr, (n, 3), torch.float32), (acc, (n, 3), torch.float32),
                            (alive, (n,), torch.bool), (rays, (n,), torch.float32)):
        if t.shape != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"bounce outputs must be contiguous {shape} {dtype}")
    alive_in = state.alive.contiguous()
    lane_in = state.lane.contiguous()

    b = state.bounce
    nee = settings.integrator == "pt-direct"
    if nee:
        emit = b == 0 and not settings.no_direct_emitter
    else:
        emit = b != 0 or not settings.no_direct_emitter
    flags = ((1 if nee and settings.has_lights else 0)
             | (2 if emit else 0)
             | (4 if b <= settings.depth else 0))
    rr_scale = 0.5 ** max(b - settings.depth_limit, 0)
    if bvh:
        # A scene without triangles has an empty BVH: no walk at all.
        has_tris = scene.geometry.tri_p0.shape[0] > 0
        if has_tris and bt["nodes"].data_ptr() % 16:
            raise ValueError("the node table must be 16-byte aligned")
        isect = [_ptr(bt["nodes"]) if has_tris else None, _ptr(bt["leaves"]),
                 _ptr(bt["ids"]), bt["k"]]
    else:
        isect = [_ptr(tables["tris"]), tables["tris"].shape[0]]
    ibl = settings.sky_kind == SKY_IBL
    h, w = tables["ibl"].shape[:2]
    sky = tables["sky"]
    rc = cuda_build.fn(kernel)(
        _ptr(state.o), _ptr(state.d), _ptr(state.throughput),
        _ptr(state.accum), _ptr(alive_in), _ptr(lane_in),
        _ptr(o), _ptr(d), _ptr(thr), _ptr(acc), _ptr(alive), _ptr(rays),
        *isect,
        _ptr(tables["sph"]), tables["sph"].shape[0],
        _ptr(tables["mats"]), tables["mats"].shape[0],
        _ptr(tables["lights"]), tables["lights"].shape[0],
        tables["total_area"], n, b, int(seed) & 0xFFFFFFFF, flags, rr_scale,
        sky[0], sky[1], sky[2], _ptr(tables["ibl"]) if ibl else None, w, h,
        tables["lon"], cuda_build.stream(),
    )
    cuda_build.check(rc, kernel)


def _step_out(state):
    n = state.o.shape[0]
    dev = state.o.device
    f3 = lambda: torch.empty((n, 3), dtype=torch.float32, device=dev)
    return (f3(), f3(), f3(), f3(), torch.empty(n, dtype=torch.bool, device=dev),
            torch.empty(n, dtype=torch.float32, device=dev))


def _next_state(state, out):
    from ..integrator.wavefront import PathState

    o, d, thr, acc, alive, rays = out
    return PathState(
        bounce=state.bounce + 1, o=o, d=d, throughput=thr, accum=acc,
        alive=alive, rays_traced=state.rays_traced + rays.sum(),
        lane=state.lane,
    )


def bounce(scene: SceneData, settings: RenderSettings, seed, state,
           tables: dict | None = None):
    """PathState -> PathState after one brute-force bounce. Launches the
    bounce kernel for a state on a CUDA device (with `tables` from
    `pack_tables`, packed here when not given); the plain step on the
    CPU."""
    from ..integrator.wavefront import plain_bounce_step

    if state.o.device.type == "cpu":
        return plain_bounce_step(scene, settings, seed, state)
    out = _step_out(state)
    bounce_launch(scene, settings, seed, state,
                  pack_tables(scene) if tables is None else tables, out)
    return _next_state(state, out)


def bounce_launch(scene: SceneData, settings: RenderSettings, seed, state,
                  tables: dict, out):
    """The brute-force bounce kernel alone: reads `state`, writes `out` =
    (o, d, throughput, accum (n,3) float32, alive (n,) bool, rays (n,)
    float32), all on the card. `bounce` allocates these and sums the rays;
    this is the launch it counts."""
    _launch("bounce", scene, settings, seed, state, tables, out)
    bounce.launches += 1


bounce.launches = 0


def bounce_bvh(scene: SceneData, settings: RenderSettings, seed, state,
               tables: dict | None = None):
    """PathState -> PathState after one bounce through the BVH: the BVH
    bounce kernel for a state on a CUDA device, the plain step on the
    CPU. As `bounce` otherwise."""
    from ..integrator.wavefront import plain_bounce_step

    if state.o.device.type == "cpu":
        return plain_bounce_step(scene, settings, seed, state)
    out = _step_out(state)
    bounce_bvh_launch(scene, settings, seed, state,
                      pack_tables(scene, bvh=True) if tables is None else tables, out)
    return _next_state(state, out)


def bounce_bvh_launch(scene: SceneData, settings: RenderSettings, seed, state,
                      tables: dict, out):
    """The BVH bounce kernel alone, as `bounce_launch`."""
    _launch("bounce_bvh", scene, settings, seed, state, tables, out)
    bounce_bvh.launches += 1


bounce_bvh.launches = 0


def make_step(scene: SceneData, settings: RenderSettings, seed):
    """PathState -> PathState transition for the render loop: the bounce
    kernel on a CUDA device (brute force or BVH, as `_use_brute` picks;
    tables packed once), the plain step on the CPU."""
    from ..integrator.wavefront import plain_bounce_step

    if scene.geometry.tri_p0.device.type == "cpu":
        return lambda state: plain_bounce_step(scene, settings, seed, state)
    _require(bounce_supported(scene, settings))
    brute = _use_brute(scene.geometry, settings.intersector, scene.bvh)
    tables = pack_tables(scene, bvh=not brute)
    kernel = bounce if brute else bounce_bvh
    return lambda state: kernel(scene, settings, seed, state, tables)


def reset_counts():
    generate_rays.launches = 0
    bounce.launches = 0
    cuda_bvh.intersect_tris.launches = 0
    bounce_bvh.launches = 0


def counts() -> dict:
    return {"raygen": generate_rays.launches, "bounce": bounce.launches,
            "bvh": cuda_bvh.intersect_tris.launches,
            "bounce_bvh": bounce_bvh.launches}
