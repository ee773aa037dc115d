"""Sample-batch data parallelism of the PyTorch/CUDA port over 1, 2 and 4
ranks (lumillyrender_tpu_torch/parallel/shard.py), one card a rank.

    python tools/torch_dp_scaling.py [--ranks 1 2 4] [--scenes new-cbox terrain-1m]
        [--device cuda|cpu] [--resolution W H] [--spp N] [--timed K]

For each world size N, starts N processes of this script (`--rank`), joined
over NCCL (gloo with `--device cpu`) on a local TCP store, each on its own
card. Every rank renders each scene twice:

* the whole film through `render_sharded` at its default samples a rank a
  chunk (the JAX package's: ceil(spp / N), at most 2**21 lanes; new-cbox
  and terrain-1m 256^2 x 64 spp: 32 on 1 and 2 ranks, 16 on 4), new-cbox
  pt-direct and terrain-1m pt-direct (written by scene/terrain.py under
  lumillyrender_tpu_torch/build/scenes if missing), its seconds including
  the first chunk's stage-plan capture, its all-reduce ms a chunk;
* the steady state: a warm ChunkRenderer's chunks of the same size,
  `--timed` of them on the host clock to a synchronize (the ranks start
  together at a barrier) without the all-reduce, then `--timed` more each
  summed over the ranks as render_sharded sums it, and two under the
  profiler for the device busy time (the collectives' kernels apart: they
  run while they wait for the other ranks) and idle share of each rank.

Prints, per scene and world size: rays/s (every rank's rays over the
slowest rank's time), the scaling efficiency against one rank (rays/s over
N times the one-rank rays/s), the chunk ms with and without the
all-reduce, the all-reduce's ms a chunk and each rank's idle share; and
checks that the N-rank film is within 1e-5 of its max of the film one rank
renders in chunks of the same samples a rank (exit 1 otherwise): the
brute-force stage ladder resamples lanes inside a chunk when its live
population overflows a stage, so the film depends on the samples a rank
renders at once, and the one-rank film at its own chunk is printed beside
it. The last line is
one JSON object of every number, also written to
chiprun_out/dp_scaling.json. Run it on a host with four cards:

    python tools/torch_dp_scaling.py

and on the CPU (four gloo ranks, small films) to find faults first:

    python tools/torch_dp_scaling.py --device cpu --scenes new-cbox \\
        --resolution 32 32 --spp 8
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "chiprun_out"
SCENES_DIR = REPO / "lumillyrender_tpu_torch" / "build" / "scenes"
SEED = 1234
FILM_TOL = 1e-5  # of the film's max: the N-rank film sums the same samples in another order


def scene_path(name: str) -> Path:
    if name != "terrain-1m":
        return REPO / "assets" / f"{name}.toml"
    from lumillyrender_tpu_torch.scene import terrain

    d = SCENES_DIR / name
    if not (d / "scene.toml").exists():
        d.mkdir(parents=True, exist_ok=True)
        terrain.write_obj(d / "terrain.obj", *terrain.make_terrain(1_000_000)[:3])
        (d / "scene.toml").write_text(terrain.terrain_scene_toml(
            "pt-direct", resolution=(256, 256), samples=64, **terrain.TERRAIN_VIEW))
    return d / "scene.toml"


def busy_ms(fn, dev) -> tuple[float | None, float | None]:
    """(ms of the render's kernels, ms of the collectives' kernels) of
    `fn()` from the profiler's kernel records; (None, None) without a card
    or where it recorded none. A collective's kernel runs while it waits
    for the other ranks, so it is kept apart from the busy time."""
    if dev.type != "cuda":
        return None, None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    work, comm = [], []
    for e in prof.events():
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            (comm if "nccl" in e.name.lower() else work).append(e.time_range.elapsed_us())
    return (sum(work) / 1e3 if work else None), sum(comm) / 1e3


def rank_main(a) -> int:
    sys.path.insert(0, str(REPO))
    from lumillyrender_tpu_torch.integrator.render import ChunkRenderer
    from lumillyrender_tpu_torch.parallel import shard
    from lumillyrender_tpu_torch.scene.compiler import compile_scene_file

    shard.init_distributed(f"127.0.0.1:{a.port}", a.world, a.rank, device=a.device)
    dev = torch.device(a.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out = {}
    try:
        for name in a.scenes:
            c = compile_scene_file(scene_path(name), device=dev)
            if a.resolution:
                c.settings = dataclasses.replace(c.settings, width=a.resolution[0],
                                                 height=a.resolution[1])
            if a.spp:
                c.settings = dataclasses.replace(c.settings, spp=a.spp)
            st = c.settings
            spd = shard.default_spp_per_device(st, a.world)
            r = shard.render_sharded(c, seed=SEED, spp_per_device=spd, device=dev)
            if a.rank == 0:
                np.save(a.out_dir / f"film-{name}-{a.world}.npy", r.film)
            if a.world == min(a.ranks):
                # The reference films: one rank in chunks of each world
                # size's samples a rank (the brute-force stage ladder
                # resamples lanes within a chunk, so the film depends on it).
                for ref in sorted({shard.default_spp_per_device(st, n) for n in a.ranks}):
                    rr = shard.render_sharded(c, seed=SEED, spp_per_device=ref, device=dev)
                    if a.rank == 0:
                        np.save(a.out_dir / f"film-{name}-ref{ref}.npy", rr.film)
            # The steady state: a warm renderer's chunks, each summed over
            # the ranks as render_sharded sums it.
            renderer = ChunkRenderer(c.data, st, SEED, dev)
            chunk = a.world * spd

            def chunks(k, first, reduce):
                return [shard.rank_chunk(renderer, (first + j) * chunk, spd, reduce)[1]
                        for j in range(k)]

            def timed(k, first, reduce):
                sync()
                shard.dist.barrier()
                t0 = time.monotonic()
                rays = chunks(k, first, reduce)
                sync()
                return time.monotonic() - t0, float(sum(float(x) for x in rays))

            chunks(1, 0, shard.ChunkReducer(dev))  # the capture
            local, _ = timed(a.timed, 1, lambda buf: None)
            reduce = shard.ChunkReducer(dev)
            window, rays = timed(a.timed, 1 + a.timed, reduce)  # rays of every rank
            shard.dist.barrier()
            busy, comm = busy_ms(
                lambda: chunks(2, 1 + 2 * a.timed, shard.ChunkReducer(dev)), dev)
            wall2, _ = timed(2, 3 + 2 * a.timed, shard.ChunkReducer(dev))
            out[name] = dict(
                world=a.world, rank=a.rank, spp_per_rank=spd, chunk_spp=chunk,
                film_seconds=r.seconds, film_rays=r.rays, film_reduce_ms=r.reduce_ms,
                window_s=window, rays=rays, chunk_ms=window / a.timed * 1e3,
                local_chunk_ms=local / a.timed * 1e3, reduce_ms=reduce.ms_per_call(),
                busy_ms_per_chunk=None if busy is None else busy / 2,
                collective_ms_per_chunk=None if comm is None else comm / 2,
                idle_share=None if busy is None else 1.0 - busy / (wall2 * 1e3))
            del renderer
    finally:
        shard.dist.destroy_process_group()
    (a.out_dir / f"rank-{a.world}-{a.rank}.json").write_text(json.dumps(out))
    return 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def gpu_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
        return "; ".join(r.stdout.strip().splitlines()) if r.returncode == 0 else "not measured"
    except OSError:
        return "not measured"


def main(a) -> int:
    sys.path.insert(0, str(REPO))
    out_dir = OUT / "dp_scaling"
    out_dir.mkdir(parents=True, exist_ok=True)
    if a.device == "cuda":
        need = max(a.ranks)
        if torch.cuda.device_count() < need:
            print(f"{need} ranks need {need} cards; this machine has "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 2
    for name in a.scenes:
        scene_path(name)  # written once, before the ranks start
    card = gpu_line()
    print(f"cards: {card}", flush=True)
    recs = {}
    for world in a.ranks:
        port = free_port()
        common = ["--world", str(world), "--port", str(port), "--device", a.device,
                  "--out-dir", str(out_dir), "--timed", str(a.timed), "--scenes", *a.scenes,
                  "--ranks", *map(str, a.ranks)]
        if a.resolution:
            common += ["--resolution", *map(str, a.resolution)]
        if a.spp:
            common += ["--spp", str(a.spp)]
        env = dict(os.environ, GLOO_SOCKET_IFNAME=os.environ.get("GLOO_SOCKET_IFNAME", "lo"))
        if a.device == "cpu":
            env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 4) // (2 * world)))
        logs = [open(out_dir / f"log-{world}-{r}.txt", "w") for r in range(world)]
        procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), *common],
                                  stdout=logs[r], stderr=subprocess.STDOUT, env=env, cwd=REPO)
                 for r in range(world)]
        t0 = time.monotonic()
        try:
            codes = [p.wait(timeout=a.rank_timeout) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        if any(codes):
            for r in range(world):
                print((out_dir / f"log-{world}-{r}.txt").read_text()[-4000:])
            print(f"{world} ranks exited with {codes}", file=sys.stderr)
            return 1
        recs[world] = [json.loads((out_dir / f"rank-{world}-{r}.json").read_text())
                       for r in range(world)]
        print(f"{world} rank(s) done in {time.monotonic() - t0:.1f} s", flush=True)

    report, ok = {"cards": card, "device": a.device, "scenes": {}}, True
    base = min(a.ranks)
    fmt = lambda xs: ", ".join("not measured" if x is None else f"{x:.4f}" for x in xs)
    for name in a.scenes:
        rate = {}
        rows = {}
        for world in a.ranks:
            per = [recs[world][r][name] for r in range(world)]
            # Every rank's rays, summed by the all-reduce, over the slowest window.
            rate[world] = per[0]["rays"] / max(p["window_s"] for p in per)
            spd = per[0]["spp_per_rank"]
            film = np.load(out_dir / f"film-{name}-{world}.npy")
            ref = np.load(out_dir / f"film-{name}-ref{spd}.npy")
            one = np.load(out_dir / f"film-{name}-{base}.npy")
            gap = float(np.abs(film - ref).max())
            within = gap <= FILM_TOL * max(float(np.abs(ref).max()), 1e-30)
            ok &= within
            rows[world] = dict(
                rays_per_s=rate[world], efficiency=rate[world] / (world / base * rate[base]),
                spp_per_rank=spd, chunk_ms=[p["chunk_ms"] for p in per],
                local_chunk_ms=[p["local_chunk_ms"] for p in per],
                reduce_ms=[p["reduce_ms"] for p in per],
                idle_share=[p["idle_share"] for p in per],
                busy_ms_per_chunk=[p["busy_ms_per_chunk"] for p in per],
                collective_ms_per_chunk=[p["collective_ms_per_chunk"] for p in per],
                film_seconds=[p["film_seconds"] for p in per],
                film_rays_per_s=per[0]["film_rays"] / max(p["film_seconds"] for p in per),
                film_max_abs_vs_one_rank_same_chunk=gap,
                film_max_abs_vs_one_rank_default=float(np.abs(film - one).max()))
            row = rows[world]
            print(f"{name}, {world} rank(s) x {spd} spp a chunk: {rate[world]:.6e} rays/s "
                  f"(efficiency {row['efficiency']:.4f}); chunk ms [{fmt(row['chunk_ms'])}], "
                  f"without the all-reduce [{fmt(row['local_chunk_ms'])}]; all-reduce ms a chunk "
                  f"[{fmt(row['reduce_ms'])}]; idle share "
                  f"[{fmt(row['idle_share'])}], collective kernels ms a chunk "
                  f"[{fmt(row['collective_ms_per_chunk'])}]; whole film "
                  f"{row['film_rays_per_s']:.6e} rays/s (capture included); film max |diff| "
                  f"from one rank at {spd} spp a chunk {gap:.3e}{'' if within else '  FAIL'}, "
                  f"from one rank at its own chunk {row['film_max_abs_vs_one_rank_default']:.3e}"
                  f"  [{card}]", flush=True)
        report["scenes"][name] = rows
    (OUT / "dp_scaling.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0 if ok else 1


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--scenes", nargs="+", default=["new-cbox", "terrain-1m"])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--resolution", type=int, nargs=2, default=None)
    p.add_argument("--spp", type=int, default=None)
    p.add_argument("--timed", type=int, default=6, help="steady-state chunks timed")
    p.add_argument("--rank-timeout", type=float, default=600)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--out-dir", type=Path, default=None, help=argparse.SUPPRESS)
    args = p.parse_args()
    sys.exit(rank_main(args) if args.rank is not None else main(args))
