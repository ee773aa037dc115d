"""CLI driver: `python -m lumillyrender_tpu_torch <scene.toml> [options]`.

Parity: `src/main.rs:43-173` — loads a TOML scene, renders, tone-maps and
writes `images/image_<timestamp>_<spp>.<png|hdr>`. Runs on the CUDA card
unless `--device cpu` is given.

Sample-batch data parallelism (parallel/shard.py): `--devices N` starts N
ranks on this host, one card each (or N gloo ranks with `--device cpu`);
`--coordinator HOST:PORT --num-processes N --process-id R` makes this
process rank R of a group that may span hosts. A rank is one process on one
device, where a JAX process may hold several. Rank 0 writes the image.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import socket
import sys
import tempfile
import time
from pathlib import Path


def run(argv=None):
    """Parse `argv`, render, write the image; returns the RenderResult."""
    parser = argparse.ArgumentParser(
        prog="lumillyrender_tpu_torch", description=__doc__
    )
    parser.add_argument("scene", help="Path for .toml scene description")
    parser.add_argument("--spp", type=int, default=None, help="Override sample count")
    parser.add_argument(
        "--resolution", type=int, nargs=2, default=None, metavar=("W", "H"),
        help="Override film resolution",
    )
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None, help="Output file (default images/...)")
    parser.add_argument("--spp-chunk", type=int, default=None)
    parser.add_argument(
        "--intersector", choices=("auto", "brute", "bvh", "pallas"), default="auto",
        help="Intersection backend: auto picks brute force up to 8192 prims "
             "and the BVH past them; brute and bvh force one (the BVH walk is "
             "a kernel on the card, the plain walk on the CPU); pallas forces "
             "the BVH through a walk kernel (the card only; leaves of a K that "
             "divides 128)",
    )
    parser.add_argument(
        "--fused", choices=("auto", "on", "off"), default="auto",
        help="Fused bounce kernels: auto runs them on the card; off forces "
             "the plain PyTorch bounce step (on the card with the BVH walk "
             "kernels; a forward chunk then runs in the host loop); on forces "
             "the kernels and refuses the CPU",
    )
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda runs the kernels; cpu runs the plain "
                             "PyTorch path")
    parser.add_argument("--devices", type=int, default=0,
                        help="Shard the samples over N ranks, one device each "
                             "(0 = one device); without --coordinator, starts "
                             "the N ranks on this host")
    parser.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                        help="This process is one rank of a group whose rank 0 "
                             "listens at HOST:PORT (with --num-processes and "
                             "--process-id, or the LLR_COORDINATOR / "
                             "LLR_NUM_PROCESSES / LLR_PROCESS_ID variables)")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--aov", choices=("normal", "depth"), default=None,
                        help="Render a debug AOV instead of radiance")
    parser.add_argument("--checkpoint", default=None,
                        help="Checkpoint file: saves film+sample counter; resumes if present")
    parser.add_argument("--checkpoint-every", type=int, default=0,
                        help="Checkpoint every N samples (default: every chunk)")
    parser.add_argument("--telemetry", action="store_true",
                        help="Emit structured per-chunk metrics on stderr")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="Write a torch.profiler Chrome trace into DIR")
    args = parser.parse_args(argv)
    coordinated = bool(args.coordinator or os.environ.get("LLR_COORDINATOR"))
    if args.devices > 1 or coordinated:
        given = [f for f, v in (("--checkpoint", args.checkpoint),
                                ("--telemetry", args.telemetry),
                                ("--profile", args.profile)) if v]
        if given:
            parser.error(f"{', '.join(given)} follow one process's chunks; sharded over "
                         "ranks, each rank renders its own samples, so render on one "
                         "device to use them")
    if args.devices > 1 and not coordinated:
        return _spawn(args.devices, sys.argv[1:] if argv is None else list(argv),
                      args.device)

    t0 = time.time()
    print(f"start: {time.strftime('%Y-%m-%dT%H:%M:%S%z')}")
    print(f"loading: {args.scene}")

    from .parallel import shard

    distributed = shard.init_distributed(args.coordinator, args.num_processes,
                                         args.process_id, device=args.device)
    try:
        return _render(args, distributed, t0)
    finally:
        if distributed:
            shard.dist.destroy_process_group()


def _render(args, distributed: bool, t0: float):
    """Compile, render (sharded over the group where `distributed`), and
    write the image on rank 0; returns the RenderResult."""
    import dataclasses

    from .integrator.render import render
    from .io.image import to_color, write_hdr, write_png
    from .parallel import shard
    from .scene.compiler import compile_scene_file
    from .utils.telemetry import RenderTelemetry, profiler_trace

    rank, world = shard.ranks()
    if distributed:
        print(f"distributed: rank {rank}/{world} on {args.device}")
    compiled = compile_scene_file(args.scene, spp=args.spp, device=args.device)
    if args.intersector != "auto":
        compiled.settings = dataclasses.replace(
            compiled.settings, intersector=args.intersector
        )
    if args.fused != "auto":
        compiled.settings = dataclasses.replace(compiled.settings, fused=args.fused)
    if args.resolution:
        compiled.settings = dataclasses.replace(
            compiled.settings, width=args.resolution[0], height=args.resolution[1]
        )
    if args.aov:
        compiled.settings = dataclasses.replace(compiled.settings, integrator=args.aov)
    s = compiled.settings
    print(f"device: {args.device}")
    print(f"resolution: {s.width}x{s.height}")
    print(f"spp: {s.spp}")
    print(f"integrator: {s.integrator}")
    print(f"polygons: {compiled.stats['polygons']}")
    print(f"bvh construction: {compiled.stats['bvh_seconds']:.3f}s")

    telemetry = RenderTelemetry() if args.telemetry else None
    with profiler_trace(args.profile):
        if distributed:
            # --spp-chunk is each rank's share of a chunk here.
            result = shard.render_sharded(compiled, seed=args.seed,
                                          n_devices=args.devices or None,
                                          spp_per_device=args.spp_chunk,
                                          device=args.device)
        else:
            result = render(compiled, seed=args.seed, spp_chunk=args.spp_chunk,
                            progress=True, device=args.device, checkpoint=args.checkpoint,
                            checkpoint_every=args.checkpoint_every, telemetry=telemetry)
    if telemetry is not None:
        print(json.dumps(telemetry.summary()))
    if rank != 0:
        # The film is the same on every rank; rank 0 writes it.
        print(f"rays/s: {result.rays_per_second:.3e}")
        return result

    print("saving...")
    fmt = compiled.config.film.output
    if args.out:
        out_path = Path(args.out)
    else:
        Path("images").mkdir(exist_ok=True)
        stamp = time.strftime("%Y%m%d%H%M%S")
        out_path = Path("images") / f"image_{stamp}_{s.spp}.{fmt}"

    if fmt == "hdr":
        write_hdr(out_path, result.film)
    elif fmt == "png":
        write_png(out_path, to_color(result.film, compiled.config.film.gamma))
    else:
        raise SystemExit(f"Unsupported output type `{fmt}`")

    print(f"saved: {out_path}")
    print(f"rays/s: {result.rays_per_second:.3e}")
    print(f"elapse: {time.time() - t0:.3f}s")
    return result


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, argv, port: int, n: int, threads: int, out: str):
    """Rank `rank` of `_spawn`'s n: the CLI on `argv` as that rank; rank 0
    pickles its result to `out`."""
    if threads:
        import torch

        torch.set_num_threads(threads)
    result = run(argv + ["--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n),
                         "--process-id", str(rank)])
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(result, f)


def _spawn(n: int, argv: list, device: str):
    """`--devices n` without a coordinator: n ranks on this host
    (torch.multiprocessing.spawn, which stops the others when a rank
    fails), joined over a local TCP store, each rank this CLI with
    --coordinator, --num-processes and --process-id added. Returns rank 0's
    result; raises SystemExit if a rank fails."""
    import torch
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    if device == "cuda" and torch.cuda.device_count() < n:
        raise SystemExit(f"--devices {n}: this host has {torch.cuda.device_count()} CUDA "
                         "cards, and each rank takes a card of its own (NCCL refuses two "
                         "ranks on one card)")
    # CPU ranks share this host's threads.
    threads = max(1, torch.get_num_threads() // n) if device == "cpu" else 0
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.pkl")
        try:
            mp.spawn(_rank_main, args=(argv, _free_port(), n, threads, out), nprocs=n)
        except ProcessException as e:
            raise SystemExit(f"--devices {n}: the ranks exited with a failure of rank "
                             f"{e.error_index}: {e}") from e
        with open(out, "rb") as f:
            return pickle.load(f)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
