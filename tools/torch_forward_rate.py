"""Forward-render and training-step rates of the PyTorch/CUDA port, for
comparing two trees on one card.

    python tools/torch_forward_rate.py --root DIR [--tag NAME]

imports `lumillyrender_tpu_torch` from DIR (a checkout of any commit of the
port) and prints one JSON line: new-cbox (256^2, 32 spp per chunk) and
welcome-geo (512x368, 11 spp per chunk) ms per chunk and rays/s (host clock
around chunks that end in a synchronize, after one warm-up chunk); the
training step on new-cbox 256^2 (render_diff, an L2 loss and its gradient
with respect to every parameter, as chip_smoke.py's phase 13 times it) in ms
per step at 4 and 16 spp; and the brute-force bounce kernel's bare launch
at 2,097,152 random lanes (CUDA graph + events). Run two trees in turns in
one call (A, B, B, A): the host and the card's power limit change between
calls.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch


def chunk_rate(c, spp, chunks):
    from lumillyrender_tpu_torch.integrator.render import render_chunk

    dev = torch.device("cuda")
    render_chunk(c.data, c.settings, 1234, 0, spp, device=dev)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    rays = [render_chunk(c.data, c.settings, 1234, (k + 1) * spp, spp, device=dev)[1]
            for k in range(chunks)]
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    return dt / chunks * 1e3, sum(float(r) for r in rays) / dt


def train_step_ms(c, spp, steps):
    """ms per training step at `spp` (host clock around `steps` steps that
    end in a synchronize, after one warm-up step), from a perturbed albedo
    (x0.8) toward the film at the true one."""
    import dataclasses

    from lumillyrender_tpu_torch.diff import params_of, render_diff
    from lumillyrender_tpu_torch.diff.render import leaves, map_params

    st = c.settings
    p_true = params_of(c.data)
    with torch.no_grad():
        target = render_diff(c.data, st, p_true, 1234, spp)
    p = p_true._replace(materials=dataclasses.replace(
        p_true.materials, color=p_true.materials.color * 0.8))

    def step(seed):
        live = map_params(p, lambda t: t.detach().requires_grad_(t.is_floating_point()))
        film = render_diff(c.data, st, live, seed, spp)
        loss = torch.mean((film - target) ** 2)
        torch.autograd.grad(loss, [t for t in leaves(live) if t.requires_grad],
                            allow_unused=True)

    step(1284)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for k in range(steps):
        step(1285 + k)
    torch.cuda.synchronize()
    return (time.monotonic() - t0) / steps * 1e3


def bounce_ms(c, n=1 << 21, reps=10):
    from lumillyrender_tpu_torch.convert import state_from_numpy
    from lumillyrender_tpu_torch.ops import cuda_bounce

    g = c.data.geometry
    pts = torch.cat([g.tri_p0, g.sph_c]).cpu().numpy()
    rng = np.random.default_rng(0)
    o = rng.uniform(pts.min(0) - 1, pts.max(0) + 1, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    st = state_from_numpy(3, o, d, np.ones((n, 3), np.float32), np.zeros((n, 3), np.float32),
                          np.ones(n, bool), rng.integers(0, 2**32, n, dtype=np.uint32),
                          device="cuda")
    tables = cuda_bounce.pack_tables(c.data)
    f3 = lambda: torch.empty((n, 3), device="cuda")
    out = (f3(), f3(), f3(), f3(), torch.empty(n, dtype=torch.bool, device="cuda"),
           torch.empty(n, device="cuda"))
    launch = lambda: cuda_bounce.bounce_launch(c.data, c.settings, 1234, st, tables, out)
    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            launch()
    graph.replay()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


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

    cuda_build.build(("bounce", "bounce_bvh", "raygen", "bounce_bwd"))
    cbox = compile_scene_file(f"{args.root}/assets/new-cbox.toml", device="cuda")
    geo = compile_scene_file(f"{args.root}/assets/welcome-geo.toml", device="cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    cb_ms, cb_rate = chunk_rate(cbox, 32, 8)
    geo_ms, geo_rate = chunk_rate(geo, 11, 3)
    print(json.dumps(dict(tag=args.tag, card=card, new_cbox_chunk_ms=cb_ms,
                          new_cbox_rays_per_s=cb_rate, welcome_geo_chunk_ms=geo_ms,
                          welcome_geo_rays_per_s=geo_rate,
                          train_4spp_ms=train_step_ms(cbox, 4, 5),
                          train_16spp_ms=train_step_ms(cbox, 16, 3),
                          bounce_ms_2m=bounce_ms(cbox))))


if __name__ == "__main__":
    main()
