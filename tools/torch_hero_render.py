"""The hero renders (assets/welcome.toml, assets/ridaisai.toml) through the
port's CLI on the card at their full size, 512 spp, checkpointed every 64
spp, with telemetry; and a 3x3 box-filtered preview of each film.

    python tools/torch_hero_render.py [--out-dir chiprun_out/hero]

Each scene runs `python -m lumillyrender_tpu_torch <scene> --spp 512 --out
<dir>/<scene>.hdr --checkpoint <dir>/<scene>.ckpt.npz --checkpoint-every 64
--telemetry` in this process (the checkpoint is removed first, so the
render starts at sample 0). Reported per scene: wall seconds (the CLI from
its start, scene compile included), render seconds and rays (the CLI's
result), rays/s, the chunk ms from the telemetry lines (median, mean, min,
max), the render's time outside its chunks split by where it falls (after
a checkpointed chunk, after the last chunk, elsewhere), the device's peak
allocated memory, and the card's name and power limit. The preview
`<dir>/<scene>_hero_preview_h100.png` averages each 3x3 block of the film
(the last columns and rows that fill no block are dropped) and tone-maps
it as the CLI writes a png (gamma 2.2); it is held against the JAX
package's preview (images/<scene>_hero_preview.png) by the mean
|difference| in 8-bit levels. Prints one JSON line and writes it to
`<dir>/hero_render.json`. The films and checkpoints (35-40 MB each) are
removed. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SCENES = ("welcome", "ridaisai")
SPP = 512
CHECKPOINT_EVERY = 64


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "unknown"


def preview(film: np.ndarray, gamma: float = 2.2) -> np.ndarray:
    """The mean of each 3x3 block of `film` (h, w, 3), tone-mapped to uint8."""
    from lumillyrender_tpu_torch.io.image import to_color

    h, w = film.shape[0] // 3, film.shape[1] // 3
    blocks = film[:3 * h, :3 * w].reshape(h, 3, w, 3, 3).mean(axis=(1, 3))
    return to_color(blocks, gamma)


def outside_chunks(chunks: list[dict], render_seconds: float) -> dict:
    """The render's seconds outside its chunks, from the telemetry's chunk
    events (each stamped at the chunk's end with the chunk's seconds):
    `after_checkpoints`, the gaps that follow a chunk whose end the render
    checkpoints; `after_last`, from the last chunk's end to the render's
    end (the last checkpoint and the film's copy to the host);
    `elsewhere`, the other gaps."""
    gaps = {"after_checkpoints": 0.0, "elsewhere": 0.0}
    for a, b in zip(chunks, chunks[1:]):
        key = "after_checkpoints" if a["done"] % CHECKPOINT_EVERY == 0 else "elsewhere"
        gaps[key] += b["ts"] - a["ts"] - b["seconds"]
    span = chunks[-1]["ts"] - (chunks[0]["ts"] - chunks[0]["seconds"])
    gaps["after_last"] = render_seconds - span
    return gaps


def against_jax(name, out_dir) -> dict | None:
    """The preview of `name` in `out_dir` against the JAX package's
    (images/<name>_hero_preview.png, same filter, same size): mean |diff|
    and each image's mean, in 8-bit levels."""
    from lumillyrender_tpu_torch.io.image import read_png

    jax_png = REPO / "images" / f"{name}_hero_preview.png"
    if not jax_png.exists():
        return None
    port = read_png(out_dir / f"{name}_hero_preview_h100.png").astype(np.float64)
    ref = read_png(jax_png).astype(np.float64)
    if port.shape != ref.shape:
        return dict(shape=list(port.shape), jax_shape=list(ref.shape))
    return dict(mean_abs_levels=float(np.abs(port - ref).mean()), mean_levels=float(port.mean()),
                jax_mean_levels=float(ref.mean()))


def render_one(name, out_dir) -> dict:
    from lumillyrender_tpu_torch import cli
    from lumillyrender_tpu_torch.io.image import write_png

    ck, hdr = out_dir / f"{name}.ckpt.npz", out_dir / f"{name}.hdr"
    ck.unlink(missing_ok=True)
    argv = [str(REPO / "assets" / f"{name}.toml"), "--spp", str(SPP), "--out", str(hdr),
            "--checkpoint", str(ck), "--checkpoint-every", str(CHECKPOINT_EVERY), "--telemetry"]
    torch.cuda.reset_peak_memory_stats()
    out, err = io.StringIO(), io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        result = cli.run(argv)
    wall = time.monotonic() - t0
    (out_dir / f"{name}.log").write_text(out.getvalue() + err.getvalue())
    events = [json.loads(x) for x in err.getvalue().splitlines() if x.startswith('{"ts"')]
    chunks = [e for e in events if e.get("event") == "chunk"]
    ms = [c["seconds"] * 1e3 for c in chunks]
    film = result.film
    write_png(out_dir / f"{name}_hero_preview_h100.png", preview(film))
    ck_bytes = ck.stat().st_size
    ck.unlink()
    hdr.unlink()
    return dict(
        scene=f"assets/{name}.toml", resolution=[film.shape[1], film.shape[0]], spp=SPP,
        checkpoint_every=CHECKPOINT_EVERY, wall_seconds=wall, render_seconds=result.seconds,
        rays=result.rays, rays_per_second=result.rays_per_second, chunks=len(ms),
        chunk_ms=dict(median=statistics.median(ms), mean=statistics.fmean(ms), min=min(ms),
                      max=max(ms)),
        chunk_seconds=sum(ms) / 1e3,
        outside_chunk_seconds=outside_chunks(chunks, result.seconds),
        peak_allocated_bytes=torch.cuda.max_memory_allocated(),
        checkpoint_bytes=ck_bytes, film_mean=float(film.mean()),
        film_finite=bool(np.isfinite(film).all()), preview_vs_jax=against_jax(name, out_dir))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out-dir", type=Path, default=REPO / "chiprun_out" / "hero")
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_hero_render: no CUDA device", file=sys.stderr)
        return 2
    a.out_dir.mkdir(parents=True, exist_ok=True)
    report = dict(card=card_line(), device=torch.cuda.get_device_name(0))
    for name in SCENES:
        report[name] = rec = render_one(name, a.out_dir)
        print(f"{name}: {json.dumps(rec)}", flush=True)
        if not rec["film_finite"]:
            print(f"torch_hero_render: {name}'s film is not finite", file=sys.stderr)
            return 1
    line = json.dumps(report)
    (a.out_dir / "hero_render.json").write_text(line)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
