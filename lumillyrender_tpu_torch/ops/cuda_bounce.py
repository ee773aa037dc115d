"""The render kernels' wrappers, hand-written CUDA C++ for Hopper (sm_90a).

* `generate_rays` wraps `csrc/raygen.cu` (camera rays per lane, drawing
  `rng`'s mixer: its pcg4d or its threefry instance); its plain version is
  `plain_generate_rays` (`rng.uniform4` + `camera.sample_rays`).
* `bounce` wraps `csrc/bounce.cu` (one whole brute-force bounce) and
  `bounce_bvh` wraps `csrc/bounce_bvh.cu` (one whole bounce through the
  BVH); both are `csrc/bounce_body.cuh` with another intersector, and their
  plain version is `integrator/wavefront.py:plain_bounce_step`. Both read a
  sampling and an evaluation material table (`pack_tables`).
* `bounce_bwd` wraps `csrc/bounce_bwd.cu`, the closed-form backward pass of
  one brute-force bounce on a Lambert scene, which sums its row table
  inside the launch; its plain version is `ops/bounce_bwd.py:plain_bounce_bwd`.
* Both brute-force kernels come in instances specialised to the scene, as
  the TPU kernel is: `launch_instance` picks, from the table shapes, the
  material families and the launch's width, the small sweep (prim rows in
  the kernel's parameters) or the general one, Lambert-only or all-family
  shading, and for the narrow forward launches the threads per lane.
* The BVH nearest-triangle kernels, `csrc/bvh.cu` and `csrc/bvh_aov.cu`
  (the wide and streamed entry points), are wrapped in `ops/cuda_bvh.py`.
* `make_step_diff` builds the differentiable path's step: the bounce
  kernel forward with the backward kernel (`diff_supported`), or with
  autograd of the plain step recomputed on the input state
  (`make_step_hybrid`: every other scene on the card, BVH, IBL and
  simple-sky scenes included), or under `fused="off"` (`step_mode`, as
  `make_step` for the forward render) autograd of the plain step itself.
* `step_mode` reads the JAX package's switches as it reads
  them, at call time: `settings.fused`, `LLR_FUSED`, `LLR_FUSED_BVH` and
  `LLR_PALLAS`; under `LLR_RNG=threefry` the card takes only the plain
  step, and a fused mode is refused by name.

Each wrapper runs its plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises. The launch itself is
`raygen_launch` / `bounce_launch` / `bounce_bvh_launch` /
`bounce_bwd_launch` (preallocated outputs, nothing else on the device, so
it can be timed alone). Each kernel has a launch counter, raised by one per
launch and nowhere else; `counts()` reads all seven and `reset_counts()`
zeroes them. A CUDA graph's replay adds the launches it holds
(`add_counts`, integrator/render.py), since it runs them without their
wrappers. The kernels are built by `ops/cuda_build.py`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import os
from typing import NamedTuple

import numpy as np
import torch

from ..scene.data import (
    MAT_LAMBERT,
    MaterialTable,
    RenderSettings,
    SKY_IBL,
    SKY_SIMPLE,
    SKY_UNIFORM,
    SceneData,
    SkyData,
)
from . import cuda_build, cuda_bvh, rng
from .bounce_bwd import BounceGrads, plain_bounce_bwd
from .cuda_build import ptr as _ptr
from .intersect import _use_brute, check_pallas, pallas_enabled


# ---------------------------------------------------------------------------
# What the kernels serve
# ---------------------------------------------------------------------------


def _shading_supported(settings: RenderSettings) -> tuple[bool, str]:
    """(ok, reason) for what both bounce kernels shade: pt or pt-direct
    under any sky (uniform, IBL or simple)."""
    if settings.integrator not in ("pt", "pt-direct"):
        return False, (f"integrator {settings.integrator!r} has no bounce "
                       "kernel: the AOVs run intersect and shade_point")
    return True, ""


def bounce_supported(scene: SceneData, settings: RenderSettings) -> tuple[bool, str]:
    """(ok, reason) for the bounce kernels: pt or pt-direct under any sky,
    on a brute-force scene (bounce.cu) or a BVH scene of any leaf width
    (bounce_bvh.cu: K > 32 through the warp walk, K <= 32 through the
    per-thread walk, at any table size; held against the plain step at
    K = 8, 16, 24, 32, 48, 64 and 128, tests/test_torch_cuda.py and
    chip_smoke.py phase 27). Lights and materials have no cap
    (binary-search light pick, tables read from global memory)."""
    return _shading_supported(settings)


def supported(scene: SceneData, settings: RenderSettings) -> tuple[bool, str]:
    """(ok, reason): whether the card's forward path serves this scene:
    raygen (every camera kind), then the bounce kernels (pt, pt-direct) or,
    for the AOV integrators, `intersect` (PyTorch brute force, or the
    sphere pre-pass and the BVH walk that `ops/intersect.py::bvh_route`
    picks: per-thread, wide or streamed)."""
    if settings.integrator in ("normal", "depth"):
        return True, ""
    return bounce_supported(scene, settings)


def _diff_scene(scene: SceneData, settings: RenderSettings) -> tuple[bool, str]:
    """(ok, reason) for the brute-force differentiable steps (the backward
    kernel's and the JAX package's fused hybrid): what the bounce kernels
    serve, restricted to brute force and a uniform sky. Every other scene
    the bounce kernels serve takes `make_step_hybrid` on the card."""
    ok, why = bounce_supported(scene, settings)
    if not ok:
        return ok, why
    if not _use_brute(scene.geometry, settings.intersector, scene.bvh):
        return False, ("a BVH scene: the brute-force steps do not walk a BVH (on "
                       "the card it takes make_step_hybrid's BVH bounce)")
    if settings.sky_kind != SKY_UNIFORM:
        sky = SKY_NAMES.get(settings.sky_kind, f"sky kind {settings.sky_kind}")
        return False, (f"a scene under {sky}: the brute-force steps' backward takes "
                       "the uniform sky's one colour (on the card it takes "
                       "make_step_hybrid)")
    return True, ""


SKY_NAMES = {SKY_IBL: "an IBL sky", SKY_SIMPLE: "the simple sky"}
# The sky's leaves that its radiance reads, which a differentiable step
# takes as inputs: the uniform colour, the simple sky's meridian and
# horizon, the IBL texture (its longitude offset reaches the radiance only
# through the texel pick, which has no gradient).
SKY_LEAVES = {SKY_UNIFORM: ("color",), SKY_SIMPLE: ("color", "color2"), SKY_IBL: ("ibl",)}


def _lambert_only(settings: RenderSettings) -> bool:
    present = settings.mat_types
    return present is not None and tuple(present) == (MAT_LAMBERT,)


# Material rows the backward kernel takes: each of its four warps keeps a
# (6 nm + 3)-float row table in shared memory, within the 232,448 B a block
# may opt in to (csrc/bounce_bwd.cu).
BWD_MAX_ROWS = (232448 // 16 - 1 - 3) // 6


def diff_supported(scene: SceneData, settings: RenderSettings) -> tuple[bool, str]:
    """(ok, reason) for the hand-written backward kernel (bounce_bwd.cu,
    the JAX package's `supported_diff`): a brute-force scene under a
    uniform sky with Lambert materials only, whose bounce VJP is
    closed-form, of at most BWD_MAX_ROWS material rows (the JAX kernel's
    cap was 15)."""
    ok, why = _diff_scene(scene, settings)
    if ok and not _lambert_only(settings):
        return False, "the closed-form backward kernel is derived for Lambert materials only"
    if ok and scene.materials.type_id.shape[0] > BWD_MAX_ROWS:
        return False, (f"the backward kernel's row tables take at most {BWD_MAX_ROWS} "
                       "material rows (shared memory)")
    return ok, why


def hybrid_supported(scene: SceneData, settings: RenderSettings) -> tuple[bool, str]:
    """(ok, reason) for the hybrid differentiable step (the JAX package's
    `supported_diff_hybrid`): a brute-force scene under a uniform sky that
    the backward kernel does not take (`diff_supported`: materials other
    than Lambert, or more than BWD_MAX_ROWS material rows); the bounce
    kernel forward, autograd of the plain step backward."""
    ok, why = _diff_scene(scene, settings)
    if ok and diff_supported(scene, settings)[0]:
        return False, "the scene takes the backward kernel (diff_supported)"
    return ok, why


def _require(check):
    ok, why = check
    if not ok:
        raise NotImplementedError(f"not on the card yet: {why}")


def require_supported(scene: SceneData, settings: RenderSettings):
    _require(supported(scene, settings))


def _require_kernels(scene: SceneData, settings: RenderSettings):
    """Raise unless the bounce kernels serve the scene; under intersector
    "pallas", also unless a walk kernel serves its BVH's leaves."""
    _require(bounce_supported(scene, settings))
    if settings.intersector == "pallas":
        check_pallas(scene.bvh)


# ---------------------------------------------------------------------------
# Kernel A: camera rays
# ---------------------------------------------------------------------------


def _camera_row(scene: SceneData) -> list[float]:
    """The kernel's 24-float camera argument. Reading it from the card is a
    host sync, so it is kept on the CameraData, keyed by the storage and
    version counter of each camera tensor: an in-place update (an
    optimizer step on the camera) or a new tensor reads it again."""
    cam = scene.camera
    src = [cam.position, cam.aperture_position, cam.right, cam.sensor_size,
           cam.up, cam.forward, cam.aperture_radius, cam.focus_distance,
           cam.aperture_sensor_distance]
    key = tuple((t.data_ptr(), t._version) for t in src)
    cached = getattr(cam, "_kernel_row", None)
    if cached is None or cached[0] != key:
        parts = src[:3] + [cam.sensor_size[:2]] + src[4:6] + [t.reshape(1) for t in src[6:]]
        vals = torch.cat([p.detach().reshape(-1).to(torch.float32).cpu() for p in parts])
        cached = (key, vals.tolist() + [0.0] * (24 - vals.numel()))
        cam._kernel_row = cached
    return cached[1]


RAYGEN_CTR = 0x40000000  # kernel 1's counter: above every bounce-loop slot


def magic_divisor(d: int) -> tuple[int, int, int, int]:
    """(m, s1, s2, d) of the kernel's division by `d` (csrc/raygen.cu
    `udiv`): for every uint32 n, n // d == (t + ((n - t) >> s1)) >> s2 with
    t = (m * n) >> 32 (Granlund & Montgomery 1994, fig. 4.1)."""
    if not 0 < d < 2**32:
        raise ValueError(f"divisor {d} is not a positive uint32")
    lg = (d - 1).bit_length()  # ceil(log2 d)
    m = (2**32 * (2**lg - d)) // d + 1
    return m, min(lg, 1), max(lg - 1, 0), d


def threefry_schedule(seed: int, ctr: int) -> tuple[list[int], list[int], list[int]]:
    """Kernel 1's threefry key schedule for `seed` (the key (seed, seed ^
    0x9E3779B9) of `rng.uniform4`'s two blocks): each block's x1 after its
    first injection (its counter, ctr and ctr ^ 0x80000000, plus ks[1]),
    and the x0 and x1 injections after rounds 4, 8, .., 20 (ks[j % 3] and
    ks[(j + 1) % 3] + j for j = 1 .. 5). A lane's x0 enters as lane + seed."""
    m = rng._MASK
    ks = (seed & m, (seed ^ rng._KEY2) & m)
    ks += (ks[0] ^ ks[1] ^ rng._KS_PARITY,)
    x1 = [(c + ks[1]) & m for c in (ctr, ctr ^ rng._BLOCK2)]
    return (x1, [ks[j % 3] for j in range(1, 6)],
            [(ks[(j + 1) % 3] + j) & m for j in range(1, 6)])


def raygen_consts(settings: RenderSettings, seed: int) -> list[int]:
    """The 28 uint32 words of kernel 1's RaygenConsts for a launch at
    `settings` and `seed`: the divisors w*h and, in raster order, w, else
    the tile's size, the tiles a row and the tile width (`magic_divisor`;
    unused ones are 1), then `threefry_schedule` at RAYGEN_CTR."""
    from ..integrator.render import tile_dims

    w, h = settings.width, settings.height
    tw, th = tile_dims(settings) or (0, 0)
    divs = (w * h, w, 1, 1) if tw == 0 else (w * h, tw * th, w // tw, tw)
    x1, k0, k1 = threefry_schedule(seed, RAYGEN_CTR)
    return [x for d in divs for x in magic_divisor(d)] + x1 + k0 + k1


def plain_generate_rays(scene: SceneData, settings: RenderSettings, seed,
                        sample_offset: int, n: int):
    """Camera rays in plain PyTorch on the scene's device: (o, d, pdf, g)."""
    from ..integrator.render import camera_lanes
    from . import camera

    dev = scene.camera.position.device
    glane, px, py = camera_lanes(settings, sample_offset, n, dev)
    u, v, u2, v2 = rng.uniform4(seed, glane, RAYGEN_CTR)
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
    from .camera import aperture_pdf, samples_aperture

    dev = scene.camera.position.device
    if dev.type == "cpu":
        return plain_generate_rays(scene, settings, seed, sample_offset, n)
    o = torch.empty((n, 3), dtype=torch.float32, device=dev)
    d = torch.empty((n, 3), dtype=torch.float32, device=dev)
    aperture = samples_aperture(settings.camera_kind)
    g = torch.empty(n, dtype=torch.float32, device=dev) if aperture else None
    raygen_launch(scene, settings, seed, sample_offset, o, d, g, uniforms)
    if not aperture:
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
    float32; None for the ideal pinhole and the omnidirectional camera,
    whose g is 1). The kernel draws `rng`'s mixer (its pcg4d or its
    threefry instance). `generate_rays` allocates these and adds pdf and
    g; this is the launch it counts."""
    from ..integrator.render import tile_dims
    from .camera import samples_aperture

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
    if (g is None) == samples_aperture(settings.camera_kind):
        raise ValueError("g is written for the aperture cameras only")
    w, h = settings.width, settings.height
    tw, th = tile_dims(settings) or (0, 0)
    cam = (ctypes.c_float * 24)(*_camera_row(scene))  # copied into the launch
    seed = int(seed) & 0xFFFFFFFF
    consts = (ctypes.c_uint32 * 28)(*raygen_consts(settings, seed))
    rc = cuda_build.fn("raygen")(
        _ptr(o), _ptr(d), None if g is None else _ptr(g),
        None if uniforms is None else _ptr(uniforms), n,
        seed, (sample_offset * w * h) & 0xFFFFFFFF,
        w, h, tw, th, settings.camera_kind, ctypes.addressof(cam), ctypes.addressof(consts),
        int(rng._MIXER == "threefry"), cuda_build.stream(),
    )
    cuda_build.check(rc, "raygen")
    generate_rays.launches += 1


generate_rays.launches = 0


# ---------------------------------------------------------------------------
# Kernels B and D: one bounce, brute force or through the BVH
# ---------------------------------------------------------------------------


def _rows(parts, width: int) -> torch.Tensor:
    """(R, width) float32 rows: the parts' columns side by side, then zeros.
    Differentiable in the parts."""
    f32 = torch.float32
    cols = [p.to(f32).reshape(p.shape[0], math.prod(p.shape[1:])) for p in parts]
    t = torch.cat(cols, dim=1)
    pad = torch.zeros((t.shape[0], width - t.shape[1]), dtype=f32, device=t.device)
    return torch.cat([t, pad], dim=1).contiguous()


def material_rows(mt: MaterialTable) -> torch.Tensor:
    """The kernels' (nm, 16) material table: type | color 3 | emission 3 |
    alpha | ior | absorbtance | pad 6. Differentiable in the float leaves,
    so a gradient of the rows reaches the MaterialTable."""
    return _rows([mt.type_id, mt.color, mt.emission, mt.alpha, mt.ior,
                  mt.absorbtance], 16)


def materials_of_rows(rows: torch.Tensor, type_id: torch.Tensor) -> MaterialTable:
    """`material_rows` inverted (type ids given as the int32 tensor)."""
    return MaterialTable(type_id=type_id, color=rows[:, 1:4], emission=rows[:, 4:7],
                         alpha=rows[:, 7], ior=rows[:, 8], absorbtance=rows[:, 9])


# The small sweep's caps (csrc/bounce_body.cuh kSmallTris, kSmallSpheres):
# its rows go by value in the kernel's parameters, 16 * 64 + 8 * 32 B.
SMALL_TRIS = 16
SMALL_SPHERES = 8
# Lanes up to which a small scene takes the small sweep: about two waves of
# blocks on an H100. Past them the general sweep's compact loop was faster
# (new-cbox at 1,048,576 and 2,097,152 lanes; PERF.md 6.10).
SMALL_MAX_LANES = 1 << 18


class Instance(NamedTuple):
    """A brute-force kernel instance: `sweep` "small" (the prim rows in the
    kernel's parameters, an unrolled sweep) or "general" (any size, rows
    read from the tables); `shading` "lambert" (Lambert's code alone) or
    "all" (every family)."""

    sweep: str
    shading: str

    @property
    def code(self) -> int:
        """The `instance` bits of llr_bounce and llr_bounce_bwd."""
        return (1 if self.sweep == "small" else 0) | (2 if self.shading == "lambert" else 0)

    def label(self, group: int = 1) -> str:
        return f"{self.sweep}/{self.shading}" + (f"/group{group}" if group > 1 else "")


def bounce_instance(nt: int, ns: int, families, n: int) -> Instance:
    """The brute-force instance of a launch of `n` lanes on `nt` triangles,
    `ns` spheres and the material `families` (type ids) present: the small
    sweep up to SMALL_TRIS and SMALL_SPHERES at up to SMALL_MAX_LANES
    lanes, Lambert-only shading where every row is Lambert."""
    small = nt <= SMALL_TRIS and ns <= SMALL_SPHERES and n <= SMALL_MAX_LANES
    lambert = tuple(sorted(set(families))) == (MAT_LAMBERT,)
    return Instance("small" if small else "general", "lambert" if lambert else "all")


# Threads a narrow forward launch is spread over (csrc/bounce_body.cuh
# GroupIsect): its lanes' sweeps are split over groups of threads until
# the launch has about this many.
TAIL_THREADS = 1 << 16


def tail_group(n: int) -> int:
    """Threads per lane for a forward brute-force launch of `n` lanes: the
    power of two, at most 16, that brings it near TAIL_THREADS threads; 1
    (one thread a lane) where that is under 4, at widths whose grid
    already fills the card."""
    g = 1
    while g < 16 and n * g * 2 <= TAIL_THREADS:
        g *= 2
    return g if g >= 4 else 1


def _small_rows(tris: torch.Tensor, sph: torch.Tensor):
    """The small sweep's parameter block (csrc/bounce_body.cuh SmallPrims):
    the tris and sph rows, zero-padded to the caps, as a host float array
    (read from the card once, here)."""
    block = np.zeros(SMALL_TRIS * 16 + SMALL_SPHERES * 8, dtype=np.float32)
    t = tris.detach().cpu().numpy().reshape(-1)
    block[:t.size] = t
    sp = sph.detach().cpu().numpy().reshape(-1)
    block[SMALL_TRIS * 16:SMALL_TRIS * 16 + sp.size] = sp
    return (ctypes.c_float * block.size).from_buffer_copy(block.tobytes())


def pack_geometry(scene: SceneData) -> dict:
    """What the bounce kernels read of a scene besides its parameters and
    its BVH (layouts in csrc/bounce_body.cuh), on the scene's device: the
    triangle, sphere and light rows, the total light area, the material
    families present (for the brute-force kernels' instances) and, for a
    scene within the small sweep's caps, the host copy of its prim rows
    (`small`). The total area, the families and the small rows are read to
    the host here; `geometry_of` keeps what this packs."""
    g = scene.geometry
    lt = scene.lights
    geo = dict(
        tris=_rows([g.tri_p0, g.tri_e1, g.tri_e2, g.tri_n, g.tri_mat], 16),
        sph=_rows([g.sph_c, g.sph_r, g.sph_mat], 8),
        lights=_rows([lt.is_tri, lt.p0, lt.e1, lt.e2, lt.c, lt.r, lt.cdf], 16),
        total_area=float(lt.total_area.detach()),
        families=tuple(sorted(set(scene.materials.type_id.tolist()))),
    )
    nt, ns = geo["tris"].shape[0], geo["sph"].shape[0]
    fits = nt <= SMALL_TRIS and ns <= SMALL_SPHERES
    geo["small"] = _small_rows(geo["tris"], geo["sph"]) if fits else None
    return geo


def geometry_of(scene: SceneData) -> dict:
    """`pack_geometry(scene)`, packed at the first call and kept on
    `scene.geometry` (the geometry is never trained), keyed by the storage
    and version counter of every tensor it reads, as `_camera_row` keys the
    camera: an in-place update or another tensor (other material types)
    packs again. The entry holds those tensors, so that no other tensor
    takes their storage while it is kept. A step after the first packs
    nothing and reads nothing to the host, which a training plan's capture
    needs (diff/render.py::TrainPlan)."""
    g, lt = scene.geometry, scene.lights
    src = [getattr(part, f.name) for part in (g, lt)
           for f in dataclasses.fields(part)] + [scene.materials.type_id]
    key = tuple((t.data_ptr(), t._version) for t in src)
    cached = getattr(g, "_kernel_tables", None)
    if cached is None or cached[0] != key:
        cached = (key, src, pack_geometry(scene))
        g._kernel_tables = cached
    return cached[2]


def sky_values(sky: SkyData) -> torch.Tensor:
    """The sky's words of the kernels' argument block (`kernel_args`): its
    colour, its horizon colour and its longitude offset, (7,) float32 on
    its device, detached."""
    return torch.cat([sky.color.reshape(3), sky.color2.reshape(3),
                      sky.longitude_offset.reshape(1)]).detach().to(torch.float32)


def pack_tables(scene: SceneData, bvh: bool = False,
                mats_eval: MaterialTable | None = None) -> dict:
    """The bounce kernels' tables (layouts in csrc/bounce_body.cuh), on the
    scene's device: the geometry's (`geometry_of`); with `bvh`, the BVH
    kernel's tables (csrc/bvh_walk.cuh, `cuda_bvh.tables_of`), which only
    the BVH bounce reads; then what the parameters give, made on the device
    with no host read: `mats`, the sampling table (scene.materials),
    `mats_eval` the evaluation table (`mats_eval`, default the same rows),
    `ibl` the sky's texture and `sky` its values (`sky_values`). A launch
    reads these and its argument block (`launch_args`) and nothing from the
    card's memory on the host. A test or a tool may add "instance" (an
    Instance) and "group" (threads per lane) to fix what every launch
    takes."""
    tables = dict(geometry_of(scene))
    if bvh:
        tables["bvh"] = cuda_bvh.tables_of(scene.bvh)
    mats = material_rows(scene.materials).detach()
    tables.update(
        mats=mats,
        mats_eval=mats if mats_eval is None else material_rows(mats_eval).detach(),
        ibl=scene.sky.ibl.detach().to(torch.float32).contiguous(),
        sky=sky_values(scene.sky),
    )
    if tables["mats_eval"].shape != mats.shape:
        raise ValueError("the evaluation table must have the sampling table's rows")
    return tables


def kernel_args(seed, sky: torch.Tensor) -> torch.Tensor:
    """The bounce kernels' argument block (csrc/bounce_body.cuh ARG_*), (8,)
    int32 on `sky`'s device: the uint32 bits of `seed` (a Python int, or an
    integer tensor on that device), then those of `sky` (`sky_values`).
    Made with no host read, so that a CUDA graph can capture it and a
    replay takes the seed and sky it is given."""
    from ..integrator.wavefront import u32_to_i32

    word = u32_to_i32(rng.as_u32(seed, sky.device)).reshape(1)
    return torch.cat([word, sky.contiguous().view(torch.int32)])


def _same_seed(a, b) -> bool:
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return a is b
    return int(a) == int(b)


def launch_args(tables: dict, seed) -> torch.Tensor:
    """`kernel_args(seed, tables["sky"])`, made at the tables' first launch
    at that seed (the same int, or the same tensor) and kept in them as
    "args", so that a step's or a render's launches make nothing else on the
    device. A block made inside a CUDA graph's capture holds its values only
    in a replay, so it serves only launches captured with it; one made
    outside serves any launch."""
    sky = tables["sky"]
    capturing = sky.is_cuda and torch.cuda.is_current_stream_capturing()
    kept = tables.get("args")
    if kept is not None and _same_seed(kept[0], seed) and (capturing or not kept[2]):
        return kept[1]
    args = kernel_args(seed, sky)
    tables["args"] = (seed, args, capturing)
    return args


def launch_instance(tables: dict, n: int, backward: bool = False) -> tuple[Instance, int]:
    """The brute-force instance and threads per lane of a launch of `n`
    lanes: `bounce_instance` of the tables and `tail_group(n)` (one thread
    a lane for the backward kernel), or tables["instance"] and
    tables["group"] where given."""
    nt, ns = tables["tris"].shape[0], tables["sph"].shape[0]
    inst = tables.get("instance") or bounce_instance(nt, ns, tables["families"], n)
    if inst.sweep == "small" and tables.get("small") is None:
        raise ValueError("the small instance needs the prim rows of pack_tables")
    group = tables.get("group") or (1 if backward else tail_group(n))
    if group not in ((1,) if backward else (1, 2, 4, 8, 16)):
        raise ValueError(f"threads per lane must be 1, 2, 4, 8 or 16 (1 backward), not {group}")
    return inst, group


def _aligned(*tensors):
    """The kernels read table rows as float4s (and the argument block as
    two 16-byte loads)."""
    if any(t.numel() and t.data_ptr() % 16 for t in tensors):
        raise ValueError("the bounce kernels' tables must be 16-byte aligned")


def _launch(kernel: str, scene: SceneData, settings: RenderSettings, seed,
            state, tables: dict, out):
    """Check the state, outputs and tables, and launch `llr_<kernel>`
    ("bounce" or "bounce_bvh") on them."""
    _require(_shading_supported(settings))
    bvh = kernel == "bounce_bvh"
    if bvh:
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
               tables["mats_eval"], tables["lights"], tables["ibl"])
    if bvh:
        bt = tables["bvh"]
        tensors += (bt["nodes"], bt["leaves"], bt["ids"], bt["counts"])
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
    flags, rr_scale = _flags(settings, b)
    _check_mats(tables)
    if bvh:
        # A scene without triangles has an empty BVH: no walk at all.
        has_tris = scene.geometry.tri_p0.shape[0] > 0
        if has_tris and any(bt[t].data_ptr() % 16 for t in ("nodes", "leaves", "ids")):
            raise ValueError("the BVH tables must be 16-byte aligned")
        isect = [_ptr(bt["nodes"]) if has_tris else None, _ptr(bt["leaves"]),
                 _ptr(bt["ids"]), _ptr(bt["counts"]), bt["k"]]
        extra = []
    else:
        isect = [_ptr(tables["tris"]), tables["tris"].shape[0]]
        inst, group = launch_instance(tables, n)
        small = tables.get("small")
        extra = [inst.code, group, None if small is None else ctypes.addressof(small)]
    args = launch_args(tables, seed)
    _aligned(tables["tris"], tables["sph"], tables["mats"], tables["mats_eval"],
             tables["lights"], args)
    if args.device != dev:
        raise ValueError("the argument block must lie on the state's device")
    ibl = settings.sky_kind == SKY_IBL
    h, w = tables["ibl"].shape[:2]
    rc = cuda_build.fn(kernel)(
        _ptr(state.o), _ptr(state.d), _ptr(state.throughput),
        _ptr(state.accum), _ptr(alive_in), _ptr(lane_in),
        _ptr(o), _ptr(d), _ptr(thr), _ptr(acc), _ptr(alive), _ptr(rays),
        *isect,
        _ptr(tables["sph"]), tables["sph"].shape[0],
        _ptr(tables["mats"]), _ptr(tables["mats_eval"]), tables["mats"].shape[0],
        _ptr(tables["lights"]), tables["lights"].shape[0],
        tables["total_area"], n, b, _ptr(args), flags, rr_scale,
        _ptr(tables["ibl"]) if ibl else None, w, h, int(settings.sky_kind == SKY_SIMPLE),
        *extra, cuda_build.stream(),
    )
    cuda_build.check(rc, kernel)


def _flags(settings: RenderSettings, bounce: int) -> tuple[int, float]:
    """The bounce kernels' flags (csrc/bounce_body.cuh) and RR scale for
    this bounce."""
    from ..integrator.wavefront import emit_flag

    nee = settings.integrator == "pt-direct"
    flags = ((1 if nee and settings.has_lights else 0)
             | (2 if emit_flag(settings, bounce) else 0)
             | (4 if bounce <= settings.depth else 0))
    return flags, 0.5 ** max(bounce - settings.depth_limit, 0)


def _check_mats(tables: dict):
    for name in ("mats", "mats_eval"):
        t = tables[name]
        if (t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != 16
                or not t.is_contiguous()):
            raise ValueError(f"tables[{name!r}] must be a contiguous (nm, 16) float32 tensor")


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
           tables: dict | None = None, mats_eval: MaterialTable | None = None):
    """PathState -> PathState after one brute-force bounce, with
    `mats_eval` as the evaluation table (default scene.materials). Launches
    the bounce kernel for a state on a CUDA device (with `tables` from
    `pack_tables(scene, mats_eval=mats_eval)`, packed here when not given);
    the plain step on the CPU."""
    from ..integrator.wavefront import plain_bounce_step

    if state.o.device.type == "cpu":
        return plain_bounce_step(scene, settings, seed, state, mats_eval)
    out = _step_out(state)
    if tables is None:
        tables = pack_tables(scene, mats_eval=mats_eval)
    bounce_launch(scene, settings, seed, state, tables, out)
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
               tables: dict | None = None, mats_eval: MaterialTable | None = None):
    """PathState -> PathState after one bounce through the BVH: the BVH
    bounce kernel for a state on a CUDA device, the plain step on the
    CPU. As `bounce` otherwise."""
    from ..integrator.wavefront import plain_bounce_step

    if state.o.device.type == "cpu":
        return plain_bounce_step(scene, settings, seed, state, mats_eval)
    out = _step_out(state)
    if tables is None:
        tables = pack_tables(scene, bvh=True, mats_eval=mats_eval)
    bounce_bvh_launch(scene, settings, seed, state, tables, out)
    return _next_state(state, out)


def bounce_bvh_launch(scene: SceneData, settings: RenderSettings, seed, state,
                      tables: dict, out):
    """The BVH bounce kernel alone, as `bounce_launch`."""
    _launch("bounce_bvh", scene, settings, seed, state, tables, out)
    bounce_bvh.launches += 1


bounce_bvh.launches = 0


FUSED_MODES = ("auto", "on", "off")


def step_mode(scene: SceneData, settings: RenderSettings, on_card: bool) -> str:
    """The JAX package's switch between the fused kernels and the plain
    step for the scene's bounce, "auto", "on" or "off", as it reads it at
    call time: `LLR_FUSED` ("0" off, "1" on; for the BVH bounce, a scene
    that `_use_brute` puts on the BVH, `LLR_FUSED_BVH` first) beside
    `settings.fused`, "0" or "off" first, then "1" or "on"; for the BVH
    bounce, also off under `LLR_PALLAS=0` (`intersect.pallas_enabled`: the
    JAX package's fused BVH bounce needs its Pallas walk; the port's BVH
    bounce follows, and kernel 3 or 7 stays its plain step's walk). "auto"
    and "on" take the bounce kernels on the card (they serve every scene
    the card renders), "off" the plain step, forward and differentiable, on
    any device. Raises for "on" on the CPU, where no kernel runs, and for
    anything but "off" on the card under `LLR_RNG=threefry`: the bounce
    kernels draw pcg4d, so one film would mix two mixers (`ops/rng.py`)."""
    mode = getattr(settings, "fused", "auto")
    if mode not in FUSED_MODES:
        raise ValueError(f"unknown fused mode {mode!r}; expected 'auto', 'on' or 'off'")
    bvh = not _use_brute(scene.geometry, settings.intersector, scene.bvh)
    flag = os.environ.get("LLR_FUSED", "auto")
    if bvh:
        flag = os.environ.get("LLR_FUSED_BVH", flag)
    if flag == "0" or mode == "off" or (bvh and not pallas_enabled()):
        return "off"
    if flag == "1" or mode == "on":
        if not on_card:
            raise ValueError("fused='on' (or LLR_FUSED=1 / LLR_FUSED_BVH=1) asks for the "
                             "bounce kernels, which run only on a CUDA device; use 'auto' "
                             "or 'off' on the CPU")
        mode = "on"
    if on_card and rng._MIXER == "threefry":
        raise ValueError(f"LLR_RNG=threefry with fused={mode!r}: the bounce kernels draw "
                         "pcg4d, and only the plain step draws threefry; render it on the "
                         "card with fused='off' (--fused off) or LLR_FUSED=0")
    return mode


def _on_card(scene: SceneData) -> bool:
    return scene.geometry.tri_p0.device.type != "cpu"


def make_step(scene: SceneData, settings: RenderSettings, seed,
              mats_eval: MaterialTable | None = None):
    """PathState -> PathState transition for the render loop: the bounce
    kernel on a CUDA device (brute force or BVH, as `_use_brute` picks;
    tables packed once), the plain step on the CPU and, where `step_mode`
    says "off" (`fused="off"`, LLR_FUSED=0, and for the BVH bounce
    LLR_FUSED_BVH=0 or LLR_PALLAS=0), on the card too, its BVH walk there a
    kernel (the walk `bvh_route` picks). `mats_eval` is the evaluation
    table (default scene.materials)."""
    from ..integrator.wavefront import plain_bounce_step

    on_card = _on_card(scene)
    if step_mode(scene, settings, on_card) == "off" or not on_card:
        return lambda state: plain_bounce_step(scene, settings, seed, state, mats_eval,
                                               plain_walk=not on_card)
    _require_kernels(scene, settings)
    brute = _use_brute(scene.geometry, settings.intersector, scene.bvh)
    tables = pack_tables(scene, bvh=not brute, mats_eval=mats_eval)
    launch_args(tables, seed)
    kernel = bounce if brute else bounce_bvh
    return lambda state: kernel(scene, settings, seed, state, tables)


# ---------------------------------------------------------------------------
# Kernel E: the backward pass of one brute-force Lambert bounce
# ---------------------------------------------------------------------------


def bounce_bwd(scene: SceneData, settings: RenderSettings, seed, state,
               g_o, g_d, g_t, g_a, tables: dict | None = None,
               mats_eval: MaterialTable | None = None,
               with_alive: bool = False) -> BounceGrads:
    """The backward pass of one bounce (see ops/bounce_bwd.py) for the
    cotangents g_o, g_d, g_t, g_a ((n,3) float32) of its outputs. Launches
    the backward kernel for a state on a CUDA device (with `tables` from
    `pack_tables(scene, mats_eval=mats_eval)`, packed here when not given),
    which sums the row table itself; runs `plain_bounce_bwd` on the CPU.
    `with_alive` also returns the kernel's recomputed alive' (else
    `alive` is None)."""
    if state.o.device.type == "cpu":
        grads = plain_bounce_bwd(scene, settings, seed, state, g_o, g_d, g_t, g_a,
                                 mats_eval)
        return grads if with_alive else grads._replace(alive=None)
    if tables is None:
        tables = pack_tables(scene, mats_eval=mats_eval)
    n = state.o.shape[0]
    dev = state.o.device
    nm = tables["mats"].shape[0]
    f3 = lambda: torch.empty((n, 3), dtype=torch.float32, device=dev)
    out = (f3(), f3(), f3(), torch.empty(6 * nm + 3, dtype=torch.float32, device=dev),
           torch.empty(n, dtype=torch.bool, device=dev) if with_alive else None)
    bounce_bwd_launch(scene, settings, seed, state, (g_o, g_d, g_t, g_a), tables, out)
    rows = out[3][:6 * nm].reshape(nm, 6)
    return BounceGrads(o=out[0], d=out[1], throughput=out[2], albedo=rows[:, :3],
                       emission=rows[:, 3:], sky=out[3][6 * nm:], alive=out[4])


BWD_BLOCK = 128  # threads per block of csrc/bounce_bwd.cu
# Blocks of the backward kernel's persistent grid an SM can hold at most
# (2,048 threads of 128), which bounds the partial table's columns.
BWD_BLOCKS_PER_SM = 16

_tickets: dict = {}  # device index -> the backward kernel's zero uint32 ticket


def bwd_blocks(n: int, device: torch.device) -> int:
    """Columns of the backward kernel's partial table for `n` lanes: at
    most one a 128-lane tile and BWD_BLOCKS_PER_SM an SM (the kernel
    launches as many blocks as the card holds at once)."""
    tiles = -(-n // BWD_BLOCK)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(tiles, BWD_BLOCKS_PER_SM * sms))


def _ticket(device: torch.device) -> torch.Tensor:
    """The backward kernel's ticket on `device`: zeroed once, and left zero
    by every launch (the last block resets it). The launches of one device
    share it, so they must run on one stream, as the port's do (a training
    plan's graph replays on the stream its eager steps use)."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _tickets:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the backward kernel's ticket is zeroed outside a CUDA "
                               "graph's capture: launch the kernel once before capturing")
        _tickets[idx] = torch.zeros(1, dtype=torch.int32, device=device)
    return _tickets[idx]


def bounce_bwd_launch(scene: SceneData, settings: RenderSettings, seed, state,
                      cot, tables: dict, out):
    """The backward kernel alone: reads `state` and `cot` = (g_o, g_d, g_t,
    g_a) and writes `out` = (o_bar, d_bar, t_bar (n,3) float32, rows
    (6*nm+3,) float32, alive (n,) bool or None), all on the card, the row
    table summed over every lane in the launch (its partial table is
    scratch allocated here). `bounce_bwd` allocates the outputs; this is
    the launch it counts."""
    _require(diff_supported(scene, settings))
    n = state.o.shape[0]
    dev = state.o.device
    nm = tables["mats"].shape[0]
    o_bar, d_bar, t_bar, rows, alive_out = out
    specs = [(name, getattr(state, name), (n, 3), torch.float32)
             for name in ("o", "d", "throughput")]
    specs += [("alive", state.alive, (n,), torch.bool), ("lane", state.lane, (n,), torch.int32)]
    specs += [(f"cotangent {k}", t, (n, 3), torch.float32) for k, t in enumerate(cot)]
    specs += [("o_bar", o_bar, (n, 3), torch.float32), ("d_bar", d_bar, (n, 3), torch.float32),
              ("t_bar", t_bar, (n, 3), torch.float32),
              ("rows", rows, (6 * nm + 3,), torch.float32),
              ("tris", tables["tris"], tables["tris"].shape, torch.float32),
              ("sph", tables["sph"], tables["sph"].shape, torch.float32),
              ("lights", tables["lights"], tables["lights"].shape, torch.float32)]
    if alive_out is not None:
        specs.append(("alive_out", alive_out, (n,), torch.bool))
    if dev.type != "cuda":
        raise ValueError(f"the backward kernel takes CUDA tensors, not {dev}")
    if n >= 2**31:
        raise ValueError(f"{n} lanes do not fit the kernel's int32 lane index")
    for name, t, shape, dtype in specs:
        if (t.shape != shape or t.dtype != dtype or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {tuple(shape)} {dtype} "
                             f"tensor on {dev}")
    _check_mats(tables)
    if tables["mats"].device != dev or tables["mats_eval"].device != dev:
        raise ValueError("the material tables must lie on the state's device")
    _aligned(tables["tris"], tables["sph"], tables["mats"], tables["mats_eval"],
             tables["lights"])
    inst, _ = launch_instance(tables, n, backward=True)
    if inst.shading != "lambert":
        raise ValueError("the backward kernel shades Lambert rows only")
    blocks = bwd_blocks(n, dev)
    partial = torch.empty((6 * nm + 3) * blocks, dtype=torch.float32, device=dev)
    small = tables.get("small")
    flags, rr_scale = _flags(settings, state.bounce)
    args = launch_args(tables, seed)
    _aligned(args)
    if args.device != dev:
        raise ValueError("the argument block must lie on the state's device")
    rc = cuda_build.fn("bounce_bwd")(
        _ptr(state.o), _ptr(state.d), _ptr(state.throughput), _ptr(state.alive),
        _ptr(state.lane), *(_ptr(t) for t in cot), _ptr(o_bar), _ptr(d_bar), _ptr(t_bar),
        _ptr(rows), _ptr(alive_out), _ptr(tables["tris"]), tables["tris"].shape[0],
        _ptr(tables["sph"]), tables["sph"].shape[0], _ptr(tables["mats"]),
        _ptr(tables["mats_eval"]), nm, _ptr(tables["lights"]), tables["lights"].shape[0],
        tables["total_area"], n, state.bounce, _ptr(args), flags, rr_scale, inst.code,
        None if small is None else ctypes.addressof(small), _ptr(partial), blocks,
        _ptr(_ticket(dev)), cuda_build.stream(),
    )
    cuda_build.check(rc, "bounce_bwd")
    bounce_bwd.launches += 1


bounce_bwd.launches = 0


# ---------------------------------------------------------------------------
# The differentiable path's steps
# ---------------------------------------------------------------------------


class _Bounce:
    """What one differentiable bounce needs besides its tensors: the scene
    (sampling table, geometry, lights), settings, seed, bounce index and,
    on the card, the forward kernel (`bounce` or `bounce_bvh`) and its
    packed tables."""

    def __init__(self, scene, settings, seed, bounce, kernel, tables):
        self.scene, self.settings, self.seed = scene, settings, seed
        self.bounce, self.kernel, self.tables = bounce, kernel, tables

    def scene_with(self, sky):
        """The scene with `sky`, the sky's SKY_LEAVES in order, in place of
        its own."""
        names = SKY_LEAVES[self.settings.sky_kind]
        return dataclasses.replace(self.scene, sky=dataclasses.replace(
            self.scene.sky, **dict(zip(names, sky))))

    def mats(self, mt_eval):
        return materials_of_rows(mt_eval, self.scene.materials.type_id)

    def state(self, o, d, thr, acc, alive, lane):
        from ..integrator.wavefront import PathState

        return PathState(self.bounce, o, d, thr, acc, alive,
                         torch.zeros((), dtype=torch.float32, device=o.device), lane)

    def forward(self, state, mt_eval, sky):
        """The bounce: the kernel with both tables on the card, the plain
        step on the CPU."""
        from ..integrator.wavefront import plain_bounce_step

        if state.o.device.type == "cpu":
            return plain_bounce_step(self.scene_with(sky), self.settings, self.seed,
                                     state, self.mats(mt_eval))
        tables = dict(self.tables, mats_eval=mt_eval.detach().contiguous())
        return self.kernel(self.scene, self.settings, self.seed, state, tables)


def recompute(run: _Bounce, o, d, thr, acc, mt_eval, sky, alive, lane):
    """The hybrid step's recompute of one bounce for its backward: the
    plain step on the saved input state, its BVH queries through the walk
    `bvh_route` picks (a kernel on the card) with the plane-equation VJP."""
    from ..integrator.wavefront import plain_bounce_step

    return plain_bounce_step(run.scene_with(sky), run.settings, run.seed,
                             run.state(o, d, thr, acc, alive, lane), run.mats(mt_eval),
                             plain_walk=False)


def _cotangents(like, grads):
    return [torch.zeros_like(like) if g is None else g.contiguous() for g in grads]


class _BounceFn(torch.autograd.Function):
    """The forward of both differentiable steps: the bounce kernel with two
    tables (the plain step on the CPU), saving only the input state, the
    evaluation rows and the sky's leaves (`sky`: SKY_LEAVES of the
    settings' sky). Each subclass is one backward."""

    @staticmethod
    def forward(ctx, run, alive, lane, o, d, thr, acc, mt_eval, *sky):
        st = run.forward(run.state(o, d, thr, acc, alive, lane), mt_eval, sky)
        ctx.save_for_backward(o, d, thr, acc, alive, lane, mt_eval, *sky)
        ctx.run = run
        ctx.mark_non_differentiable(st.alive, st.rays_traced)
        return st.o, st.d, st.throughput, st.accum, st.alive, st.rays_traced


class _BounceDiff(_BounceFn):
    """One bounce with the hand-written backward: the backward kernel
    (`plain_bounce_bwd` on the CPU). Gradients go
    to o, d, throughput, accum (passed through), the evaluation rows'
    colours and emissions, and the sky colour (a uniform sky)."""

    @staticmethod
    def backward(ctx, g_o, g_d, g_t, g_a, _alive, _rays):
        o, d, thr, _acc, alive, lane, mt_eval, sky = ctx.saved_tensors
        run = ctx.run
        g_o, g_d, g_t, g_a = _cotangents(o, (g_o, g_d, g_t, g_a))
        state = run.state(o, d, thr, None, alive, lane)
        if o.device.type == "cpu":
            gr = plain_bounce_bwd(run.scene_with((sky,)), run.settings, run.seed, state,
                                  g_o, g_d, g_t, g_a, run.mats(mt_eval))
        else:
            tables = dict(run.tables, mats_eval=mt_eval.detach().contiguous())
            gr = bounce_bwd(run.scene, run.settings, run.seed, state, g_o, g_d, g_t, g_a,
                            tables)
        mt_bar = torch.zeros_like(mt_eval)
        mt_bar[:, 1:4] = gr.albedo
        mt_bar[:, 4:7] = gr.emission
        return (None, None, None, gr.o, gr.d, gr.throughput, g_a, mt_bar,
                gr.sky.to(sky.dtype))


class _BounceHybrid(_BounceFn):
    """One bounce of the hybrid step: backward autograd of `recompute`,
    the plain step on the saved input state (the JAX package's
    `make_step_diff_hybrid`, and its autodiff of the XLA step with the BVH
    walk's VJP). Gradients go to o, d, throughput, accum, the evaluation
    rows and the sky's leaves (an IBL texture's through the texel
    gather)."""

    @staticmethod
    def backward(ctx, g_o, g_d, g_t, g_a, _alive, _rays):
        o, d, thr, acc, alive, lane, mt_eval, *sky = ctx.saved_tensors
        ins = [x.detach().requires_grad_() for x in (o, d, thr, acc, mt_eval, *sky)]
        with torch.enable_grad():
            st = recompute(ctx.run, *ins[:5], ins[5:], alive, lane)
            outs = (st.o, st.d, st.throughput, st.accum)
            grads = torch.autograd.grad(outs, ins, _cotangents(o, (g_o, g_d, g_t, g_a)),
                                        allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, ins)]
        return (None, None, None, *grads)


def diff_step_kind(scene: SceneData, settings: RenderSettings, on_card: bool) -> str:
    """Which differentiable step `make_step_diff` builds for the scene, on
    the card or on the CPU: "plain" (autograd of the plain step) where
    `step_mode` says "off" on either, as the JAX package's `render_diff`
    always runs, and otherwise "bwd" (the backward kernel, `diff_supported`),
    "hybrid" (`make_step_hybrid`: on the CPU only where `hybrid_supported`,
    on the card for every other scene) or "plain" (the CPU's path for BVH,
    IBL and simple-sky scenes). `fused="on"` raises on the CPU, and a
    fused mode on the card under threefry (`step_mode`)."""
    if step_mode(scene, settings, on_card) == "off":
        return "plain"
    if diff_supported(scene, settings)[0]:
        return "bwd"
    if on_card or hybrid_supported(scene, settings)[0]:
        return "hybrid"
    return "plain"


def _make_step(fn, scene: SceneData, settings: RenderSettings, seed,
               mats_eval: MaterialTable):
    """The PathState -> PathState step that applies `fn` (`_BounceDiff` or
    `_BounceHybrid`) to each bounce: on the card with the bounce kernel that
    `_use_brute` picks and its tables (`pack_tables`: the geometry's as
    kept, the parameters' made on the device from detached values) and one
    argument block for the step's launches; on the CPU with the plain step
    forward. `seed` is a Python int or an integer tensor on the scene's
    device."""
    from ..integrator.wavefront import PathState

    on_card = _on_card(scene)
    kernel = tables = None
    if on_card:
        _require_kernels(scene, settings)
        brute = _use_brute(scene.geometry, settings.intersector, scene.bvh)
        tables = pack_tables(scene, bvh=not brute)
        launch_args(tables, seed)
        kernel = bounce if brute else bounce_bvh
    mt_eval = material_rows(mats_eval)
    sky = [getattr(scene.sky, name) for name in SKY_LEAVES[settings.sky_kind]]

    def step(state: PathState) -> PathState:
        run = _Bounce(scene, settings, seed, state.bounce, kernel, tables)
        o, d, thr, acc, alive, rays = fn.apply(
            run, state.alive, state.lane, state.o, state.d, state.throughput,
            state.accum, mt_eval, *sky)
        return PathState(state.bounce + 1, o, d, thr, acc, alive,
                         state.rays_traced + rays, state.lane)

    step.fused_diff = True
    return step


def make_step_hybrid(scene: SceneData, settings: RenderSettings, seed,
                     mats_eval: MaterialTable | None = None):
    """The hybrid differentiable step for any scene the bounce kernels
    serve: forward, the bounce kernel (`bounce` on brute force, `bounce_bvh`
    on a BVH of any leaf width) on the card, the plain step on the CPU;
    backward, autograd of `recompute` on the saved input state, whose BVH
    walk is the one `bvh_route` picks (kernel 3, or the AOV walks at
    K=128) through `cuda_bvh.plane_t`'s plane-equation VJP. Arguments as
    `make_step_diff`; the sky's live leaves are SKY_LEAVES of its kind."""
    if mats_eval is None:
        mats_eval = scene.materials
    return _make_step(_BounceHybrid, scene, settings, seed, mats_eval)


def make_step_diff(scene: SceneData, settings: RenderSettings, seed,
                   mats_eval: MaterialTable | None = None):
    """The differentiable path's PathState -> PathState step, as the JAX
    package's `make_bounce_step` dispatches it (`diff_step_kind`):
    `scene.materials` is the detached sampling table, `mats_eval` (default
    the same) the live evaluation table, and `scene.sky` the live sky.
    `seed` is a Python int or an integer tensor on the scene's device.

    * a Lambert-only brute-force scene under a uniform sky
      (`diff_supported`): the bounce kernel forward with the hand-written
      backward kernel (`_BounceDiff`);
    * any other brute-force scene under a uniform sky (`hybrid_supported`:
      other materials, or Lambert rows past BWD_MAX_ROWS), and on the card
      every other scene the bounce kernels serve (BVH scenes of any leaf
      width, the IBL and the simple sky): `make_step_hybrid`;
    * under `fused="off"` on either device, and for anything else on the
      CPU: autograd of the plain step, whose BVH walk is a kernel on the
      card (kernel 3, or kernel 7 at K=128, through `cuda_bvh.plane_t`)
      and the plain walk on the CPU.
    On the CPU the first two run the plain step forward. Both have their
    own backward and keep only their input state, so the step carries
    `fused_diff = True` and the loop does not checkpoint it. The plain step
    carries `fused_diff = False` and takes the loop's `remat` (the `isect`
    policies, integrator/wavefront.py::Remat). On the card it raises only
    for a scene no bounce kernel serves."""
    from ..integrator.wavefront import plain_bounce_step

    if mats_eval is None:
        mats_eval = scene.materials
    on_card = _on_card(scene)
    kind = diff_step_kind(scene, settings, on_card)
    if kind == "bwd":
        return _make_step(_BounceDiff, scene, settings, seed, mats_eval)
    if kind == "hybrid":
        return make_step_hybrid(scene, settings, seed, mats_eval)

    def plain(state, remat=None):
        return plain_bounce_step(scene, settings, seed, state, mats_eval,
                                 plain_walk=not on_card, remat=remat)

    plain.fused_diff = False
    return plain


def _counted() -> dict:
    """The seven counted wrappers by the names `counts()` gives them."""
    return {"raygen": generate_rays, "bounce": bounce, "bvh": cuda_bvh.intersect_tris,
            "bvh_wide": cuda_bvh.intersect_tris_wide,
            "bvh_streamed": cuda_bvh.intersect_tris_streamed,
            "bounce_bvh": bounce_bvh, "bounce_bwd": bounce_bwd}


def reset_counts():
    for f in _counted().values():
        f.launches = 0


def counts() -> dict:
    return {name: f.launches for name, f in _counted().items()}


def add_counts(launched: dict):
    """Add what a CUDA graph's replay launched ({name: launches}, the keys
    of `counts()`) to the counts: a replay runs the captured launches
    without their wrappers (integrator/render.py, `ForwardPlan`); a
    capture, which launches nothing, takes its calls back."""
    for name, v in launched.items():
        _counted()[name].launches += v
