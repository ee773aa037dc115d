"""chip_smoke.py's phase 26 alone: the recompute policies of the port's own
differentiable path (`fused="off"`) on one card.

    python tools/torch_remat_policies.py [--out FILE]

builds the kernels, then runs `chip_smoke.remat_policies` with what it takes
from the earlier phases: new-cbox's captured chunk time (256^2, 32 spp a
chunk, the kernels' plan, as phase 6 times it), welcome-geo's training step
at 512x368 x 4 spp through the default dispatch (the hybrid step: its
parameters at 0.8 of the albedo, its target and its gradients, as phase 25
takes them) and terrain-1m (written by the port's `scene/terrain.py` under
`lumillyrender_tpu_torch/build/scenes`). It prints what phase 26 prints
(kernel 3's launches in the forward and backward passes, each policy's
eager step against its captured plan's replays in turns, the replay's
device busy ms, idle share, peak memory, capture seconds and pool bytes,
the new-cbox film under `fused="off"` against the kernels') and writes its
record as JSON to
FILE (default chiprun_out/remat_policies.json). Exits non-zero without a
card, or where phase 26 fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=REPO / "chiprun_out" / "remat_policies.json")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_remat_policies: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from lumillyrender_tpu_torch.diff import film_and_grads, params_of, render_diff
    from lumillyrender_tpu_torch.integrator.render import ChunkRenderer
    from lumillyrender_tpu_torch.ops import cuda_build
    from lumillyrender_tpu_torch.scene.compiler import compile_scene_file

    card = cs.gpu_line()
    print(f"gpu: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    cuda_build.build(("raygen", "bounce", "bvh", "bounce_bvh", "bounce_bwd", "bvh_aov"))
    cbox = compile_scene_file(REPO / "assets" / "new-cbox.toml", device="cuda")
    geo = compile_scene_file(REPO / "assets" / "welcome-geo.toml", device="cuda")
    terrain_1m = compile_scene_file(cs.write_terrain("terrain-1m", 1_000_000)[0], device="cuda")

    renderer = ChunkRenderer(cbox.data, cbox.settings, cs.SEED, "cuda")
    _, chunk_ms, _ = cs.chunk_rate(renderer, 32, 4, 0)
    del renderer
    full = cs.resized(geo, geo.settings.width, geo.settings.height, 4)
    p_true = params_of(full.data)
    with torch.no_grad():
        target = render_diff(full.data, full.settings, p_true, cs.SEED, 4)
    p = p_true._replace(materials=dataclasses.replace(
        p_true.materials, color=p_true.materials.color * 0.8))
    _, _, grads = film_and_grads(full.data, full.settings, p, target, cs.SEED, 4)

    def lap(name, t0):
        print(f"[{name}: {time.monotonic() - t0:.1f}s]", flush=True)

    report = cs.remat_policies(card, lap, cbox, geo, terrain_1m, (p, target, grads), chunk_ms)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(card=card, **report), indent=1, default=str))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
