"""Render driver: wavefront batching, film accumulation, ray counts.

Lane = (sample, pixel), chunked over samples to bound memory; the film is
accumulated on the device in float32 and divided by spp at the end. The
estimator matches `main.rs:92-121`:
  pixel = mean_spp( L * g_term * sensitivity / pdf ).
Rays are counted as camera rays + live bounce rays + NEE shadow rays.

On a CUDA device a forward chunk reads nothing from the card: raygen writes
into a `ForwardPlan`'s buffers, and the plan replays the chunk's whole stage
plan (every bounce, `_compact` and bank) as one CUDA graph, captured at its
first chunk: the counterpart of the JAX package's jitted chunk with its
`lax.while_loop` stages. That holds for every step: the bounce kernels',
and under `fused="off"` the plain step's PyTorch ops (its walk kernel 3 or
7), which make their constants by fills and read nothing to the host
(`run_stage` takes every stage to its full step count on the card). It
holds for the AOV integrators too: their chunk (the query through the walk
`ops/intersect.py::bvh_route` picks, kernel 3, 6 or 7, with the sort where
`LLR_REORDER=1` asks for it, and the ordered bank) is a plan's graph, as
the JAX package jits it in its chunk. `render` submits chunks with no host
sync between them unless telemetry times each one.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..scene.compiler import CompiledScene
from ..ops.camera import aperture_pdf, samples_aperture
from ..scene.data import RenderSettings, SceneData, resolve_device
from .wavefront import aov, bank_ordered, make_bounce_step, trace_film, u32_to_i32

TILE = 32  # max camera-lane tile side


def _pow2_tile(dim: int) -> int:
    t = 1
    while t < TILE and dim % (t * 2) == 0:
        t *= 2
    return t


def tile_dims(settings: RenderSettings) -> tuple[int, int] | None:
    """(tw, th) of the camera-lane tile order, or None for raster order.

    Consecutive camera lanes form tw x th pixel tiles (the largest powers
    of 2 dividing the film dims, up to 32); films whose dims don't yield at
    least an 8x8 tile keep raster order."""
    tw, th = _pow2_tile(settings.width), _pow2_tile(settings.height)
    if tw * th < 64:
        return None
    return tw, th


def tile_decode(settings: RenderSettings):
    """Lane-within-image -> (px, py) mapping, or None for raster order."""
    dims = tile_dims(settings)
    if dims is None:
        return None
    tw, th = dims
    w = settings.width

    def decode(j):
        tiles_per_row = w // tw
        tile = j // (tw * th)
        within = j % (tw * th)
        px = (tile % tiles_per_row) * tw + within % tw
        py = (tile // tiles_per_row) * th + within // tw
        return px, py

    return decode


def global_lanes(settings: RenderSettings, sample_offset: int, n: int,
                 device) -> torch.Tensor:
    """Lane ids of `n` camera lanes of a chunk starting at sample
    `sample_offset`: lane + sample_offset*w*h, wrapping in uint32, as int32
    bit patterns. Unique across chunks, so RNG streams never repeat."""
    lane = torch.arange(n, dtype=torch.int64, device=device)
    off = sample_offset * settings.width * settings.height
    return u32_to_i32((lane + off) & 0xFFFFFFFF)


def camera_lanes(settings: RenderSettings, sample_offset: int, n: int,
                 device):
    """(glane, px, py) for `n` camera lanes (see `global_lanes`)."""
    w, h = settings.width, settings.height
    glane = global_lanes(settings, sample_offset, n, device)
    lane = torch.arange(n, dtype=torch.int64, device=device)
    decode = tile_decode(settings)
    if decode is None:
        px = lane % w
        py = (lane // w) % h
    else:
        px, py = decode(lane % (w * h))
    return glane, px, py


def _pixel_fn(settings: RenderSettings):
    """Lane id -> film row, tile decode (None in raster order)."""
    decode = tile_decode(settings)
    if decode is None:
        return None
    w, h = settings.width, settings.height

    def pixel_fn(lane_vals):
        px, py = decode(lane_vals % (w * h))
        return py * w + px

    return pixel_fn


def aov_film(scene: SceneData, settings: RenderSettings, o, d):
    """An AOV chunk's film_flat (w*h, 3) sum from its camera rays o, d (in
    lane order): `aov`, banked by `bank_ordered` (no atomics: the same film
    on every run)."""
    film = torch.zeros((settings.width * settings.height, 3), dtype=torch.float32,
                       device=o.device)
    return bank_ordered(film, aov(scene, settings, o, d), _pixel_fn(settings))


def capture_graph(fn, device: torch.device):
    """`fn()` captured as one CUDA graph on `device`: (graph, its outputs,
    the launches it holds by `cuda_bounce.counts()` name, the capture's
    seconds, the device memory the capture reserved in bytes). The capture
    launches nothing, so the calls it made are taken back from the counts;
    a replay adds `launches` (`cuda_bounce.add_counts`). A capture that
    fails raises."""
    from ..ops import cuda_bounce

    before = cuda_bounce.counts()
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    graph = torch.cuda.CUDAGraph()
    t0 = time.monotonic()
    with torch.cuda.graph(graph):
        out = fn()
    seconds = time.monotonic() - t0
    pool_bytes = torch.cuda.memory_reserved(device) - reserved
    after = cuda_bounce.counts()
    launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    cuda_bounce.add_counts({k: -v for k, v in launches.items()})
    return graph, out, launches, seconds, pool_bytes


class ForwardPlan:
    """One forward chunk size of a scene on a CUDA device: raygen writes the
    camera rays into `o`, `d` (and `g`), and the chunk's stage plan, from
    the lane ids to the film, runs with no host read; with no `step` (the
    AOV integrators), `aov_film`.
    The first chunk runs it eagerly (which also loads every kernel) and
    captures it as a CUDA graph; every later chunk replays the graph, which
    adds its launches to the kernels' counts. `capture_seconds` and
    `pool_bytes` (the device memory the capture reserved) say what the
    graph cost. A capture or replay that fails raises."""

    def __init__(self, scene: SceneData, settings: RenderSettings, seed, step,
                 spp_chunk: int):
        self.scene, self.settings, self.seed, self.step = scene, settings, seed, step
        w, h = settings.width, settings.height
        self.n = n = w * h * spp_chunk
        dev = scene.camera.position.device
        f32 = torch.float32
        self.o = torch.empty((n, 3), dtype=f32, device=dev)
        self.d = torch.empty((n, 3), dtype=f32, device=dev)
        aperture = samples_aperture(settings.camera_kind)
        self.g = torch.empty(n, dtype=f32, device=dev) if aperture else None
        self.lane_base = torch.arange(n, dtype=torch.int64, device=dev)
        self.lane_offset = torch.zeros((), dtype=torch.int64, device=dev)
        self.pixel_fn = _pixel_fn(settings)
        self.graph = None
        self.out = None  # the graph's film_flat and rays
        self.launches = {}  # per replay, by counts() name
        self.capture_seconds = None
        self.pool_bytes = None

    def _trace(self):
        """The captured work: lane ids from the offset, camera weights,
        then trace_film's stages, as `ChunkRenderer.chunk` computes them on
        the CPU; for an AOV, `aov_film` (no ray but the camera's is
        counted)."""
        st, scene, n = self.settings, self.scene, self.n
        if self.step is None:
            return (aov_film(scene, st, self.o, self.d),
                    torch.zeros((), dtype=torch.float32, device=self.o.device))
        lane = u32_to_i32((self.lane_base + self.lane_offset) & 0xFFFFFFFF)
        if self.g is None:
            g = torch.ones(n, dtype=torch.float32, device=self.o.device)
            pdf = torch.ones(n, dtype=torch.float32, device=self.o.device)
        else:
            g = self.g
            pdf = aperture_pdf(scene.camera, st.width, st.height).expand(n).contiguous()
        weight = g * scene.camera.sensor_sensitivity / pdf
        return trace_film(scene, st, self.o, self.d, lane, self.seed, weight,
                          n_pixels=st.width * st.height, pixel_fn=self.pixel_fn,
                          step=self.step)

    def _capture(self):
        (self.graph, self.out, self.launches, self.capture_seconds,
         self.pool_bytes) = capture_graph(self._trace, self.o.device)

    def __call__(self, sample_offset: int):
        """(film_flat (w*h, 3) sum, rays ()) of the chunk at `sample_offset`;
        both stay on the device, and the plan's next chunk overwrites them."""
        from ..ops import cuda_bounce

        st = self.settings
        cuda_bounce.raygen_launch(self.scene, st, self.seed, sample_offset,
                                  self.o, self.d, self.g)
        self.lane_offset.fill_((sample_offset * st.width * st.height) & 0xFFFFFFFF)
        if self.graph is None:
            out = self._trace()
            self._capture()
            return out
        self.graph.replay()
        cuda_bounce.add_counts(self.launches)
        return self.out


def captures_chunks(device: torch.device) -> bool:
    """Whether a `ChunkRenderer` on `device` renders its chunks as
    `ForwardPlan`s: on a CUDA device, for every integrator (pt, pt-direct
    and the AOVs), as the JAX package jits every chunk; the CPU runs each
    chunk eagerly, with its host loop."""
    return device.type == "cuda"


class ChunkRenderer:
    """What a render keeps across its chunks: the scene on the device
    (checked once for the card), the bounce step with its tables packed
    once (the plain step where `cuda_bounce.step_mode` says "off"; none for
    the AOVs), and on a CUDA device one `ForwardPlan` per chunk size
    (`graphed`, `captures_chunks`: every integrator, the AOVs too). A chunk
    with `graphed` false runs eagerly, on either device."""

    def __init__(self, scene: SceneData, settings: RenderSettings, seed, device=None):
        from ..ops import cuda_bounce

        self.device = dev = resolve_device(device)
        self.scene = scene.to(dev)
        self.settings, self.seed = settings, seed
        self.aov = settings.integrator in ("normal", "depth")
        if dev.type == "cuda":
            cuda_bounce.require_supported(self.scene, settings)
        self.step = None if self.aov else make_bounce_step(self.scene, settings, seed)
        self.graphed = captures_chunks(dev)
        self.plans: dict[int, ForwardPlan] = {}

    def chunk(self, sample_offset: int, spp_chunk: int):
        """Render `spp_chunk` samples for every pixel -> (film_sum (h,w,3),
        rays () f32), both on the device."""
        from ..ops import cuda_bounce

        scene, settings, seed, dev = self.scene, self.settings, self.seed, self.device
        w, h = settings.width, settings.height
        n = w * h * spp_chunk
        if self.graphed:
            plan = self.plans.get(spp_chunk)
            if plan is None:
                plan = self.plans[spp_chunk] = ForwardPlan(scene, settings, seed, self.step,
                                                           spp_chunk)
            film_flat, rays = plan(sample_offset)
            return film_flat.reshape(h, w, 3).clone(), rays + float(n)

        o, d, pdf, g = cuda_bounce.generate_rays(scene, settings, seed, sample_offset, n)
        if self.aov:
            film = aov_film(scene, settings, o, d)
            return film.reshape(h, w, 3), torch.full((), float(n), device=dev)
        lane = global_lanes(settings, sample_offset, n, dev)
        weight = g * scene.camera.sensor_sensitivity / pdf
        film_flat, rays = trace_film(
            scene, settings, o, d, lane, seed, weight, n_pixels=w * h,
            pixel_fn=_pixel_fn(settings), step=self.step,
        )
        return film_flat.reshape(h, w, 3), rays + float(n)  # + camera rays


def render_chunk(scene: SceneData, settings: RenderSettings, seed,
                 sample_offset: int, spp_chunk: int, device=None):
    """Render `spp_chunk` samples for every pixel -> (film_sum (h,w,3),
    rays () f32), both on the device. Runs on `cuda` unless `device` says
    otherwise. Each call packs the tables (and on the card captures the
    chunk's graph) anew: a caller of many chunks keeps a `ChunkRenderer`."""
    return ChunkRenderer(scene, settings, seed, device).chunk(sample_offset, spp_chunk)


@dataclass
class RenderResult:
    film: np.ndarray  # (H, W, 3) float32, radiance (pre tone map)
    seconds: float
    rays: float

    @property
    def rays_per_second(self) -> float:
        return self.rays / max(self.seconds, 1e-9)


def default_spp_chunk(settings: RenderSettings, budget_lanes: int = 1 << 21) -> int:
    per_sample = settings.width * settings.height
    return max(1, min(settings.spp, budget_lanes // max(per_sample, 1)))


def render(compiled: CompiledScene, seed: int = 0, spp_chunk: int | None = None,
           progress: bool = False, device=None, checkpoint: str | None = None,
           checkpoint_every: int = 0, telemetry=None, chunk_fn=None) -> RenderResult:
    """Render the film on `device` (default `cuda`; raises without a card).

    Chunks are submitted with no host sync between them: the film and the
    ray count stay on the device until the end, or until a checkpoint.
    With `checkpoint`, the film sum, the sample counter and the ray count
    are saved every `checkpoint_every` samples (default every chunk) and at
    the end, and a matching checkpoint resumes exactly (counter-based RNG;
    utils/checkpoint.py). With `telemetry` (utils/telemetry.py's
    RenderTelemetry), each chunk is timed to a synchronize and logged, as
    the JAX package does. With `chunk_fn(renderer, done)`, each chunk is
    what it returns for the `spp_chunk` samples from `done` on, the tail
    chunk padded to full size and the film divided by the samples rendered
    (parallel/shard.py: this rank's block, summed over the ranks)."""
    from ..utils import checkpoint as ckpt

    settings = compiled.settings
    renderer = ChunkRenderer(compiled.data, settings, seed, device)
    dev = renderer.device
    if spp_chunk is None:
        spp_chunk = default_spp_chunk(settings)

    film = torch.zeros((settings.height, settings.width, 3),
                       dtype=torch.float32, device=dev)
    rays = torch.zeros((), dtype=torch.float64, device=dev)
    total_rays = 0.0  # what the host holds: a checkpoint's, telemetry's
    done = 0
    if checkpoint:
        saved = ckpt.load(checkpoint, settings, seed)
        if saved is not None:
            film_sum, done, total_rays = saved
            film = torch.from_numpy(film_sum).to(dev)
            if progress:
                print(f"  resumed at {done}/{settings.spp} spp")
    since_ckpt = 0
    t0 = time.monotonic()
    while done < settings.spp:
        t_chunk = time.monotonic()
        if chunk_fn is None:
            cur = min(spp_chunk, settings.spp - done)
            part, chunk_rays = renderer.chunk(done, cur)
        else:
            cur = spp_chunk
            part, chunk_rays = chunk_fn(renderer, done)
        film += part
        done += cur
        since_ckpt += cur
        if telemetry is not None:
            chunk_rays = float(chunk_rays)  # waits for the chunk
            total_rays += chunk_rays
            telemetry.log("chunk", spp=cur, done=done, rays=chunk_rays,
                          seconds=time.monotonic() - t_chunk)
        else:
            rays += chunk_rays
        if checkpoint and (since_ckpt >= max(checkpoint_every, spp_chunk)
                           or done >= settings.spp):
            total_rays += float(rays)
            rays.zero_()
            ckpt.save(checkpoint, film.cpu().numpy(), done, seed, settings, total_rays)
            since_ckpt = 0
        if progress:
            print(f"\r  {done}/{settings.spp} spp", end="", flush=True)
    film_np = film.cpu().numpy()
    total_rays += float(rays)
    seconds = time.monotonic() - t0
    if progress:
        print()
    return RenderResult(
        film=film_np / max(done, 1), seconds=seconds, rays=total_rays
    )
