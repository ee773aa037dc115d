"""The AOV walk kernels of two trees of the PyTorch/CUDA port, on the same
rays, in turns on one card.

    python tools/torch_walk_ab.py --parent DIR

builds DIR's `lumillyrender_tpu_torch/csrc/bvh_wide.cu` and
`bvh_streamed.cu` (a checkout of an earlier commit of the port; its own
headers beside them) and this tree's, with this tree's nvcc flags, into
this tree's `lumillyrender_tpu_torch/build/` under their own library names,
and loads them.

Cases: kernel 7 (bvh_wide) on terrain-1m (K=128); kernel 6 (bvh_streamed)
on terrain-1.5m (K=128), and on terrain-1m rebuilt at K=32 and at K=2 (4-
byte rows); on each, the camera rays of one chunk and random rays
(chip_smoke.terrain_rays), sorted by the ray sort key and unsorted, at
2,097,152 lanes. On each, both trees write their own outputs for the
shade query (t, prim, mat, n) and for a capped occlusion query (half the
lanes' light on their nearest hit, as chip_smoke.py's phases 15-16), and
the change's must be bit-equal to the parent's; then the bare launches of
the nearest-hit query (t, prim) are captured in CUDA graphs of `REPS`
launches and replayed in turns, `chip_smoke.PROBE_ROUNDS` replays each with the order reversed
every other round (`chip_smoke.alternating_ms`). Prints both trees'
ptxas lines of the walk kernels (registers, shared memory, spills) and the
blocks per SM they allow, the card's name and power limit, per case the
median and [min, max] ms per launch of each, and one JSON line of all of it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
sys.path.insert(0, str(REPO))
from torch_bounce_ab import build_parent, entry_point, kernel_lines  # noqa: E402

# (kernel library, scene, leaf width) in the order they run.
CASES = (("bvh_wide", "terrain-1m", 128), ("bvh_streamed", "terrain-1.5m", 128),
         ("bvh_streamed", "terrain-1m", 32), ("bvh_streamed", "terrain-1m", 2))
REPS = 3  # launches per CUDA graph


def occlusion(near, n: int):
    """(t_init, t_stop) of chip_smoke.py's capped occlusion query: the even
    lanes that hit have their light on their nearest hit, the others at a
    seeded distance."""
    from lumillyrender_tpu_torch.constants import EPS

    rng = np.random.default_rng(8)
    dist = torch.from_numpy(rng.uniform(0.5, 40.0, size=n).astype(np.float32)).cuda()
    on = (near[1] >= 0) & (torch.arange(n, device="cuda") % 2 == 0)
    dist = torch.where(on, near[0], dist)
    t0 = dist + 2.0 * EPS
    return t0, t0 - 4.0 * EPS


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python tools/torch_walk_ab.py")
    ap.add_argument("--parent", required=True, type=Path,
                    help="a checkout of the earlier tree")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_walk_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from lumillyrender_tpu_torch.accel.pack import build_tri_bvh
    from lumillyrender_tpu_torch.constants import INF
    from lumillyrender_tpu_torch.integrator.render import default_spp_chunk
    from lumillyrender_tpu_torch.ops import cuda_bvh, intersect
    from lumillyrender_tpu_torch.scene.compiler import compile_scene_file
    from lumillyrender_tpu_torch.scene.data import Bvh, tensor_of

    names = ("bvh_wide", "bvh_streamed")
    who_all = ("parent", "change")
    fns, logs = {who: {} for who in who_all}, {who: {} for who in who_all}
    for who, src in (("parent", args.parent.resolve()), ("change", REPO)):
        for name in names:
            fns[who][name], logs[who][name] = build_parent(src, name, who)
    card = chip_smoke.gpu_line()
    res = {"card": card, "rounds": chip_smoke.PROBE_ROUNDS, "reps": REPS,
           "ptxas": {who: {name: kernel_lines(log, "kernel") for name, log in by_name.items()}
                     for who, by_name in logs.items()}}
    for who, by_name in res["ptxas"].items():
        for lines in by_name.values():
            for kernel, rec in lines.items():
                print(f"{who} {kernel}: {rec['ptxas']} ({rec['blocks_per_sm']} blocks of 128 "
                      "per SM)")
    print(card, flush=True)
    scenes = {}
    for name, scene, k in CASES:
        if scene not in scenes:
            path = chip_smoke.write_terrain(scene, chip_smoke.BIG_TRIS[scene])[0]
            scenes[scene] = compile_scene_file(path, device="cuda")
        c = scenes[scene]
        bvh = c.data.bvh
        if bvh.blk_p0.shape[1] != k:
            g = c.data.geometry
            arrays = build_tri_bvh(*(getattr(g, f).cpu().numpy() for f in (
                "tri_p0", "tri_e1", "tri_e2", "tri_n", "tri_mat")), max_leaf=k)
            bvh = Bvh(**{f: tensor_of(v).cuda() for f, v in arrays.items()})
        tables = cuda_bvh.tables_of(bvh)
        launch = {"bvh_wide": cuda_bvh.intersect_tris_wide_launch,
                  "bvh_streamed": cuda_bvh.intersect_tris_streamed_launch}[name]
        n = c.settings.width * c.settings.height * default_spp_chunk(c.settings)
        inf = torch.full((n,), INF, device="cuda")
        never = torch.full((n,), -INF, device="cuda")
        for key, (o0, d0) in chip_smoke.terrain_rays(c, n).items():
            if key == "axis-aligned":
                continue
            for srt in (False, True):
                o, d = o0, d0
                if srt:
                    perm, _ = intersect.sort_rays(o, d, bvh)
                    o, d = o[perm].contiguous(), d[perm].contiguous()
                tag = f"{name} {scene} K={k}, {key} rays, {'sorted' if srt else 'unsorted'}"
                near = intersect._walk_tris(o, d, inf, never, bvh, False)
                t0, ts = occlusion(near, n)
                queries = {"shade": (inf, never, 4), "occlusion": (t0, ts, 2),
                           "nearest": (inf, never, 2)}
                outs = {}
                for who in who_all:
                    outs[who] = {}
                    for q, (a, b, m) in queries.items():
                        out = (torch.empty(n, device="cuda"),
                               torch.empty(n, dtype=torch.int32, device="cuda"),
                               torch.empty(n, dtype=torch.int32, device="cuda"),
                               torch.empty((n, 3), device="cuda"))[:m]
                        with entry_point(name, fns[who][name]):
                            launch(o, d, a, b, tables, out)
                        outs[who][q] = out
                torch.cuda.synchronize()
                for q in queries:
                    same = [torch.equal(bits(x), bits(y))
                            for x, y in zip(outs["parent"][q], outs["change"][q])]
                    if not all(same):
                        raise SystemExit(f"torch_walk_ab: {tag}: the change's {q} outputs differ "
                                         f"from the parent's (equal: {same})")

                def run(who, o=o, d=d, out=outs):
                    with entry_point(name, fns[who][name]):
                        launch(o, d, inf, never, tables, out[who]["nearest"])

                times = chip_smoke.alternating_ms([lambda w=w: run(w) for w in who_all],
                                                  REPS, chip_smoke.PROBE_ROUNDS)
                rec = {who: chip_smoke.spread(t) for who, t in zip(who_all, times)}
                rec.update(bit_equal=True, hits=int((near[1] >= 0).sum()),
                           ratio=rec["change"][0] / rec["parent"][0])
                res[tag] = rec
                print(f"{tag}, every output bit-equal to the parent's: " + ", ".join(
                    f"{who} {rec[who][0]:.4f} ms [{rec[who][1][0]:.4f}, {rec[who][1][1]:.4f}]"
                    for who in who_all) + f": change/parent {rec['ratio']:.3f}x  [{card}]",
                      flush=True)
        del tables, bvh
        torch.cuda.empty_cache()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
