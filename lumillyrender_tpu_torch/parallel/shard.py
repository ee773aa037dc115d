"""Data parallelism over sample batches: the JAX package's
`parallel/shard.py` on `torch.distributed`, one rank per device.

Every rank holds the whole scene on its device and renders its own block
of each chunk's samples through its own `ChunkRenderer` (on the card: the
raygen kernel and the captured stage plan of bounce kernels); the chunk's
films and ray counts are summed over the ranks by one all-reduce and added
into the total, as the JAX package psums each chunk over its mesh and then
adds it on the host. The training step (on the card a captured training
plan's replay, `diff.render.TrainPlan`) all-reduces the loss and the
gradients the same way, outside the graph. The payloads are the film and the parameter rows:
there is no weight matrix in a renderer.

One difference from the JAX package: a JAX process may hold several
devices and its mesh spans them all, while a rank here is one process on
one device (one card, with NCCL; or the CPU, with gloo). `--devices N` of
the CLI therefore starts N processes.
"""

from __future__ import annotations

import datetime
import os
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..integrator.render import ChunkRenderer, RenderResult, render
from ..scene.compiler import CompiledScene
from ..scene.data import RenderSettings, SceneData, resolve_device

# How long a rank waits for the others at the coordinator and in a
# collective before it raises, rather than hanging.
TIMEOUT = datetime.timedelta(minutes=10)


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, device=None,
                     backend: str | None = None) -> bool:
    """Join this process to a group of ranks, from explicit arguments or the
    LLR_COORDINATOR / LLR_NUM_PROCESSES / LLR_PROCESS_ID variables, as the
    JAX package's `init_distributed` does. Returns False when no
    coordinator is given, True once the group is up.

    `coordinator` is HOST:PORT (or a tcp:// URL) of rank 0's store. A rank
    on `device` cuda (the default) takes its local card, process_id modulo
    the cards on its host, with `torch.cuda.set_device` before anything
    touches CUDA, and joins over NCCL; a CPU rank joins over gloo.
    `backend` overrides that choice (gloo lets two ranks share one card,
    which NCCL refuses).

    Unlike a JAX process, which may hold several devices, a rank is one
    process on one device."""
    coordinator = coordinator or os.environ.get("LLR_COORDINATOR")
    if not coordinator:
        return False
    num_processes = int(num_processes if num_processes is not None
                        else os.environ["LLR_NUM_PROCESSES"])
    process_id = int(process_id if process_id is not None else os.environ["LLR_PROCESS_ID"])
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    card = None
    if dev.type == "cuda":
        card = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(card)
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id, timeout=TIMEOUT,
                            device_id=card if backend == "nccl" else None)
    return True


def ranks() -> tuple[int, int]:
    """(this rank, world size): (0, 1) outside a group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def build_kernels(dev: torch.device):
    """On the card, rank 0 builds the render and training kernels while the
    other ranks wait at a barrier, so that one nvcc runs per source and not
    one per rank; the others then load what rank 0 built."""
    if dev.type != "cuda" or not dist.is_initialized():
        return
    from ..ops import cuda_build

    if dist.get_rank() == 0:
        cuda_build.build(tuple(n for n in cuda_build.SOURCES if n != "probes"))
    dist.barrier()


class ChunkReducer:
    """Sums a float32 buffer over the ranks in place by one all-reduce (a
    no-op outside a group), and times each reduction (CUDA events on the
    card, read at the end: no host read per chunk)."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.events = []
        self.seconds = 0.0

    def __call__(self, buf: torch.Tensor):
        if not dist.is_initialized():
            return
        if self.dev.type == "cuda":
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
        t0 = time.monotonic()
        dist.all_reduce(buf)
        if self.dev.type == "cuda":
            b.record()
            self.events.append((a, b))
        else:
            self.seconds += time.monotonic() - t0
            self.events.append(None)

    def ms_per_call(self) -> float | None:
        """Mean ms of one reduction (synchronizes the card), None if none ran."""
        if not self.events:
            return None
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            return sum(a.elapsed_time(b) for a, b in self.events) / len(self.events)
        return self.seconds * 1e3 / len(self.events)


@dataclass
class ShardedResult(RenderResult):
    """A RenderResult of `render_sharded` (the film summed over every rank,
    on every rank), with the rank, the world size, the samples a rank
    renders per chunk and the mean ms of a chunk's all-reduce (None outside
    a group)."""

    rank: int = 0
    world: int = 1
    spp_per_device: int = 1
    reduce_ms: float | None = None


def default_spp_per_device(settings: RenderSettings, world: int) -> int:
    """The JAX package's default: ceil(spp / world) (no overshoot of a small
    spp), capped at 2**21 lanes per rank."""
    lanes_budget = 1 << 21
    return max(1, min(-(-settings.spp // world),
                      lanes_budget // (settings.width * settings.height)))


def rank_chunk(renderer: ChunkRenderer, first: int, spp_per_device: int, reduce):
    """One chunk of world * spp_per_device samples from sample `first`: this
    rank renders its block [first + rank*spp_per_device, first +
    (rank+1)*spp_per_device), the block of the chunk's offsets that the JAX
    package's P("dp") gives device `rank`, and `reduce` sums its film and
    ray count over the ranks in one buffer -> (film (h,w,3), rays ()), both
    on the device."""
    part, rays = renderer.chunk(first + ranks()[0] * spp_per_device, spp_per_device)
    buf = torch.cat([part.reshape(-1), rays.reshape(1).to(torch.float32)])
    reduce(buf)
    return buf[:-1].view(part.shape), buf[-1]


def render_sharded(compiled: CompiledScene, seed: int = 0, n_devices: int | None = None,
                   spp_per_device: int | None = None, device=None) -> ShardedResult:
    """Render `compiled` over every rank of the group (one rank, with no
    collective, outside a group); `n_devices`, where given, must be the
    world size. `render` in chunks of world * spp_per_device samples, each
    chunk `rank_chunk`'s: the all-reduce runs outside the captured stage
    plan, and the sums are added into the total on the device. The tail
    chunk is padded, and the film divided by the samples rendered, as the
    JAX package does."""
    rank, world = ranks()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"{n_devices} devices asked of a group of {world} ranks: a rank is "
                         "one process on one device")
    if spp_per_device is None:
        spp_per_device = default_spp_per_device(compiled.settings, world)
    dev = resolve_device(device)
    build_kernels(dev)
    reduce = ChunkReducer(dev)
    r = render(compiled, seed, spp_chunk=world * spp_per_device, device=dev,
               chunk_fn=lambda renderer, done: rank_chunk(renderer, done, spp_per_device,
                                                          reduce))
    return ShardedResult(film=r.film, seconds=r.seconds, rays=r.rays, rank=rank, world=world,
                         spp_per_device=spp_per_device, reduce_ms=reduce.ms_per_call())


def sharded_train_step(scene: SceneData, settings: RenderSettings, params, target,
                       offsets, device=None):
    """One inverse-rendering step over every rank, the JAX package's
    `build_sharded_train_step`: rank r renders its contiguous block of
    `offsets` ((world * spp_local,) global sample ids) differentiably at
    seed 0, takes the L2 loss against the replicated `target` and its
    gradient in every parameter; the loss and every float gradient are
    divided by the world size and summed over the ranks by one all-reduce
    (integer leaves keep their zero gradient). Returns (loss, grads), the
    same on every rank. The rank's step is a training plan's
    (`diff.render.train_plan`, keyed by the scene, settings, spp_local and
    shapes, with the rank's block as one more input): on the card captured
    at the first step and replayed at every later one, as the JAX
    package's step is one jitted program; on the CPU run eagerly. The
    all-reduce runs outside the graph, on the plan's copies (a gloo group
    cannot be captured), as `render_sharded` reduces outside the stage
    plan."""
    from ..diff.render import leaves, map_params, train_plan

    rank, world = ranks()
    offsets = np.asarray(offsets, dtype=np.int64)
    if offsets.ndim != 1 or offsets.size % world:
        raise ValueError(f"{offsets.size} sample offsets do not split over {world} ranks")
    per = offsets.size // world
    local = torch.from_numpy(offsets[rank * per:(rank + 1) * per].copy())
    dev = resolve_device(device)
    target = target.to(dev)
    plan = train_plan(scene, settings, params, target, per, dev, sample_offsets=local)
    if plan.graph is None:  # a plan not yet captured: the kernels built before its first step
        build_kernels(dev)
    loss, _, grads = plan(params, target, 0, sample_offsets=local)
    if not dist.is_initialized():
        return loss, grads
    floats = [g for g in leaves(grads) if g.is_floating_point()]
    buf = torch.cat([loss.reshape(1).to(torch.float32)]
                    + [g.reshape(-1).to(torch.float32) for g in floats]) / world
    ChunkReducer(dev)(buf)
    parts = iter(buf[1:].split([g.numel() for g in floats]))

    def reduced(g):
        return next(parts).view(g.shape).to(g.dtype) if g.is_floating_point() else g

    return buf[0].to(loss.dtype), map_params(grads, reduced)
