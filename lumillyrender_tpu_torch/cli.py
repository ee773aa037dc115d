"""CLI driver: `python -m lumillyrender_tpu_torch <scene.toml> [options]`.

Parity: `src/main.rs:43-173` — loads a TOML scene, renders, tone-maps and
writes `images/image_<timestamp>_<spp>.<png|hdr>`. Runs on the CUDA card
unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
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
        "--intersector", choices=("auto", "brute", "bvh"), default="auto",
        help="Intersection backend: auto picks brute force up to 8192 prims "
             "and the BVH past them",
    )
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda runs the kernels; cpu runs the plain "
                             "PyTorch path")
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

    t0 = time.time()
    print(f"start: {time.strftime('%Y-%m-%dT%H:%M:%S%z')}")
    print(f"loading: {args.scene}")

    import dataclasses

    from .integrator.render import render
    from .io.image import to_color, write_hdr, write_png
    from .scene.compiler import compile_scene_file
    from .utils.telemetry import RenderTelemetry, profiler_trace

    compiled = compile_scene_file(args.scene, spp=args.spp, device=args.device)
    if args.intersector != "auto":
        compiled.settings = dataclasses.replace(
            compiled.settings, intersector=args.intersector
        )
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
        result = render(compiled, seed=args.seed, spp_chunk=args.spp_chunk,
                        progress=True, device=args.device, checkpoint=args.checkpoint,
                        checkpoint_every=args.checkpoint_every, telemetry=telemetry)
    if telemetry is not None:
        print(json.dumps(telemetry.summary()))

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


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
