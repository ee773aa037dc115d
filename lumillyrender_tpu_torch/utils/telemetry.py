"""Observability: structured render telemetry and the profiler, as the JAX
package's `lumillyrender_tpu/utils/telemetry.py` gives them.

`RenderTelemetry` logs one JSON line per event on stderr (`render` logs a
`chunk` event per chunk: spp, samples done, rays, seconds) and sums the
chunks in `summary()`. `profiler_trace` wraps a render in `torch.profiler`
(CPU, and CUDA where a card is present) and writes a Chrome trace, the
counterpart of `jax.profiler.trace`. `bounce_occupancy` is the uncompacted
loop's live-lane count after each bounce (the wavefront occupancy that
compaction manages).
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

TRACE_FILE = "trace.json"  # profiler_trace's Chrome trace, in its log_dir


@dataclass
class RenderTelemetry:
    events: list = field(default_factory=list)

    def log(self, event: str, **fields):
        rec = {"ts": time.time(), "event": event, **fields}
        self.events.append(rec)
        print(json.dumps(rec), file=sys.stderr)

    def summary(self) -> dict:
        out: dict = {}
        for e in self.events:
            if e["event"] == "chunk":
                out["chunks"] = out.get("chunks", 0) + 1
                out["rays"] = out.get("rays", 0.0) + e["rays"]
                out["seconds"] = out.get("seconds", 0.0) + e["seconds"]
        if out.get("seconds"):
            out["rays_per_second"] = out["rays"] / out["seconds"]
        return out


@contextlib.contextmanager
def profiler_trace(log_dir: str | None):
    """Profile what runs inside (CPU ops, and CUDA kernels where a card is
    present) and write a Chrome trace to `log_dir`/trace.json. Nothing
    without `log_dir`."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / TRACE_FILE))


def bounce_occupancy(scene, settings, o, d, lane, seed, max_bounces=None) -> np.ndarray:
    """Live lanes after each of `max_bounces` (default settings.max_bounces)
    bounces of the uncompacted loop from the rays (o, d) with lane ids
    `lane` (uint32 values or their int32 bit patterns): an (max_bounces,)
    int64 array. The bounce kernel on a CUDA device, the plain step on the
    CPU; the counts stay on the device and are copied once, at the end."""
    from ..integrator.wavefront import PathState, make_bounce_step, u32_to_i32
    from ..ops import rng

    n = o.shape[0]
    dev = o.device
    mb = max_bounces or settings.max_bounces
    state = PathState(
        bounce=0, o=o, d=d,
        throughput=torch.ones((n, 3), dtype=o.dtype, device=dev),
        accum=torch.zeros((n, 3), dtype=o.dtype, device=dev),
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
        rays_traced=torch.zeros((), dtype=torch.float32, device=dev),
        lane=u32_to_i32(rng.as_u32(lane)),
    )
    step = make_bounce_step(scene, settings, seed)
    live = torch.zeros(mb, dtype=torch.int64, device=dev)
    for b in range(mb):
        state = step(state)
        live[b] = state.alive.sum()
    return live.cpu().numpy()
