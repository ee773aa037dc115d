"""Forward-render and training-step rates of the PyTorch/CUDA port, for
comparing two trees on one card.

    python tools/torch_forward_rate.py --root DIR [--tag NAME]

imports `lumillyrender_tpu_torch` from DIR (a checkout of any commit of the
port) and prints one JSON line. For new-cbox (256^2, 32 spp per chunk),
welcome-geo (512x368, 11 spp per chunk) and terrain-1m (256^2, 32 spp per
2,097,152-lane chunk; written by the port's `scene/terrain.py` under this
repo's `lumillyrender_tpu_torch/build/scenes` if missing): ms per chunk and
rays/s (host clock around chunks that end in a synchronize, after one
warm-up chunk), device busy ms per chunk and the idle share (the profiler's
kernel records over two chunks), and launches per chunk. A tree with
`integrator.render.ChunkRenderer` renders its chunks through it (the stage
plan captured as a CUDA graph at the first chunk, then replayed; the capture's
seconds and the graph pool's bytes are printed), an older tree through
`render_chunk`. Then the training step on new-cbox 256^2 (render_diff, an L2
loss and its gradient with respect to every parameter, as chip_smoke.py's
phase 13 times it) in ms per step and its idle share at 4 and 16 spp. Run
two trees in turns in one call (A, B, B, A): the host and the card's power
limit change between calls.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

SEED = 1234
SCENES_DIR = Path(__file__).resolve().parents[1] / "lumillyrender_tpu_torch" / "build" / "scenes"


def busy_ms(fn, times: int) -> float | None:
    """Device busy ms per call of `fn` from the profiler's kernel records
    over `times` calls; None where it recorded no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(times):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if getattr(e, "device_type", None) == DeviceType.CUDA]
    return sum(us) / 1e3 / times if us else None


def chunk_rate(c, spp, chunks):
    """{chunk_ms, rays_per_s, busy_ms, idle_share, launches_per_chunk, and
    for a tree with ChunkRenderer capture_seconds and pool_bytes}."""
    from lumillyrender_tpu_torch.integrator import render as render_mod
    from lumillyrender_tpu_torch.ops import cuda_bounce

    dev = torch.device("cuda")
    if hasattr(render_mod, "ChunkRenderer"):
        renderer = render_mod.ChunkRenderer(c.data, c.settings, SEED, dev)
        run = lambda off: renderer.chunk(off, spp)
    else:
        renderer = None
        run = lambda off: render_mod.render_chunk(c.data, c.settings, SEED, off, spp, device=dev)
    run(0)
    torch.cuda.synchronize()
    cuda_bounce.reset_counts()
    t0 = time.monotonic()
    rays = [run((k + 1) * spp)[1] for k in range(chunks)]
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    launches = {k: v / chunks for k, v in cuda_bounce.counts().items() if v}
    offset = [100 * spp]

    def profiled():
        run(offset[0])
        offset[0] += spp

    busy = busy_ms(profiled, 2)
    chunk_ms = dt / chunks * 1e3
    out = dict(chunk_ms=chunk_ms, rays_per_s=sum(float(r) for r in rays) / dt,
               busy_ms=busy, idle_share=None if busy is None else 1.0 - busy / chunk_ms,
               launches_per_chunk=launches)
    if renderer is not None:
        plan = renderer.plans[spp]
        out.update(capture_seconds=plan.capture_seconds, pool_bytes=plan.pool_bytes)
    return out


def train_step(c, spp, steps):
    """{step_ms, busy_ms, idle_share} of the training step at `spp` (host
    clock around `steps` steps that end in a synchronize, after one warm-up
    step; busy from one profiled step), from a perturbed albedo (x0.8)
    toward the film at the true one."""
    import dataclasses

    from lumillyrender_tpu_torch.diff import params_of, render_diff
    from lumillyrender_tpu_torch.diff.render import leaves, map_params

    st = c.settings
    p_true = params_of(c.data)
    with torch.no_grad():
        target = render_diff(c.data, st, p_true, SEED, spp)
    p = p_true._replace(materials=dataclasses.replace(
        p_true.materials, color=p_true.materials.color * 0.8))

    def step(seed):
        live = map_params(p, lambda t: t.detach().requires_grad_(t.is_floating_point()))
        film = render_diff(c.data, st, live, seed, spp)
        loss = torch.mean((film - target) ** 2)
        torch.autograd.grad(loss, [t for t in leaves(live) if t.requires_grad],
                            allow_unused=True)

    step(SEED + 50)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for k in range(steps):
        step(SEED + 51 + k)
    torch.cuda.synchronize()
    step_ms = (time.monotonic() - t0) / steps * 1e3
    busy = busy_ms(lambda: step(SEED + 99), 1)
    return dict(step_ms=step_ms, busy_ms=busy,
                idle_share=None if busy is None else 1.0 - busy / step_ms)


def terrain_1m():
    from lumillyrender_tpu_torch.scene import terrain

    d = SCENES_DIR / "terrain-1m"
    if not (d / "scene.toml").exists():
        d.mkdir(parents=True, exist_ok=True)
        terrain.write_obj(d / "terrain.obj", *terrain.make_terrain(1_000_000)[:3])
        (d / "scene.toml").write_text(terrain.terrain_scene_toml(
            "pt-direct", resolution=(256, 256), samples=64, **terrain.TERRAIN_VIEW))
    return d / "scene.toml"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    sys.path.insert(0, args.root)
    from lumillyrender_tpu_torch.ops import cuda_build
    from lumillyrender_tpu_torch.scene.compiler import compile_scene_file

    cuda_build.build(tuple(n for n in cuda_build.SOURCES if n != "probes"))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    cbox = compile_scene_file(f"{args.root}/assets/new-cbox.toml", device="cuda")
    geo = compile_scene_file(f"{args.root}/assets/welcome-geo.toml", device="cuda")
    terrain = compile_scene_file(terrain_1m(), device="cuda")
    print(json.dumps(dict(
        tag=args.tag, card=card,
        new_cbox=chunk_rate(cbox, 32, 8), welcome_geo=chunk_rate(geo, 11, 4),
        terrain_1m=chunk_rate(terrain, 32, 3),
        train_4spp=train_step(cbox, 4, 5), train_16spp=train_step(cbox, 16, 3))), flush=True)


if __name__ == "__main__":
    main()
