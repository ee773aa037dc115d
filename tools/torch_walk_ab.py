"""The BVH walk kernels of two trees of the PyTorch/CUDA port, on the same
rays, in turns on one card.

    python tools/torch_walk_ab.py --parent DIR [--cases k3|aov|all]

builds DIR's kernel 3 (`lumillyrender_tpu_torch/csrc/bvh.cu`) and AOV
walks (`bvh_aov.cu`, or `bvh_wide.cu` and `bvh_streamed.cu` in a tree from
before they were one library), a checkout of an earlier commit of the
port with its own headers beside them, and this tree's, with this tree's
nvcc flags (`torch_bounce_ab.build_sources`: into this tree's
`lumillyrender_tpu_torch/build/` under their own library names, one nvcc
each, all at once), and loads them. An earlier
`llr_bvh` without the leaves' valid counts is called without them.

Kernel 3 (the per-thread walk) runs on welcome-geo's camera rays (one
chunk, 2,072,576 lanes, K=32) and on terrain-1m's (one chunk, 2,097,152
lanes, K=128, unsorted: the route's per-thread walk past the wide cap).
Kernels 7 (bvh_wide) and 6 (bvh_streamed) run on terrain-1m (K=128) and
terrain-1.5m (K=128), and kernel 6 on terrain-1m rebuilt at K=32 and K=2
(4-byte rows); on each, the camera rays of one chunk and random rays
(chip_smoke.terrain_rays), sorted by the ray sort key and unsorted, at
2,097,152 lanes.

On each case every build writes its own outputs for the shade query (t,
prim, mat, n), a capped occlusion query (half the lanes' light on their
nearest hit, as chip_smoke.py's phases 15-16) and the nearest-hit query
(t, prim), and each must be bit-equal to the parent's. Then the bare
launches of the nearest-hit query (and for kernel 3 also of the shade
query) are captured in CUDA graphs of `REPS` launches and replayed in
turns, `chip_smoke.PROBE_ROUNDS` replays each with the order reversed
every other round (`chip_smoke.alternating_ms`). Prints every build's
ptxas lines of the walk kernels (registers, shared memory, spills) and the
blocks per SM they allow, the card's name and power limit, per case the
median and [min, max] ms per launch of each, and one JSON line of all of
it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
sys.path.insert(0, str(REPO))
from torch_bounce_ab import build_sources, entry_point, kernel_lines  # noqa: E402

# (kernel library, scene, leaf width) of the AOV cases, in the order they run.
AOV_CASES = (("bvh_wide", "terrain-1m", 128), ("bvh_streamed", "terrain-1.5m", 128),
             ("bvh_streamed", "terrain-1m", 32), ("bvh_streamed", "terrain-1m", 2))
REPS = 3  # launches per CUDA graph
K3_REPS = 10  # kernel 3 on welcome-geo takes tens of microseconds
_P, _I = ctypes.c_void_p, ctypes.c_int
# `llr_bvh` before it took the leaves' valid counts.
EARLIER_BVH_ARGTYPES = [_P] * 7 + [_I, _I] + [_P] * 4 + [_P]


def entry(lib, sym: str, earlier: bool = False):
    """`sym` of a loaded library with this tree's argument types; an earlier
    llr_bvh is called without the counts (the argument after ids)."""
    from lumillyrender_tpu_torch.ops import cuda_build

    fn = getattr(lib, sym)
    fn.argtypes = EARLIER_BVH_ARGTYPES if earlier else cuda_build.ARGTYPES[sym]
    fn.restype = ctypes.c_int
    return (lambda *a: fn(*a[:7], *a[8:])) if earlier else fn


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


def outputs(n: int, m: int) -> tuple:
    return (torch.empty(n, device="cuda"), torch.empty(n, dtype=torch.int32, device="cuda"),
            torch.empty(n, dtype=torch.int32, device="cuda"),
            torch.empty((n, 3), device="cuda"))[:m]


def run_case(tag, runs: dict, o, d, bvh, tables, timed, reps, res, card):
    """`runs` ({label: (wrapper launch, entry name, entry or None)}, the
    parent first) on one ray set: every query's outputs bit-equal to the
    parent's, then the `timed` queries' bare launches in turns."""
    import chip_smoke
    from lumillyrender_tpu_torch.constants import INF
    from lumillyrender_tpu_torch.ops import intersect

    n = o.shape[0]
    inf = torch.full((n,), INF, device="cuda")
    never = torch.full((n,), -INF, device="cuda")
    near = intersect._walk_tris(o, d, inf, never, bvh, False)
    t0, ts = occlusion(near, n)
    queries = {"shade": (inf, never, 4), "occlusion": (t0, ts, 2), "nearest": (inf, never, 2)}
    outs = {label: {q: outputs(n, m) for q, (_, _, m) in queries.items()} for label in runs}

    def launch(label, q):
        fn, name, ep = runs[label]
        a, b, _ = queries[q]
        if ep is None:
            fn(o, d, a, b, tables, outs[label][q])
        else:
            with entry_point(name, ep):
                fn(o, d, a, b, tables, outs[label][q])

    for label in runs:
        for q in queries:
            launch(label, q)
    torch.cuda.synchronize()
    parent = next(iter(runs))
    for label in runs:
        for q in queries:
            same = [torch.equal(bits(x), bits(y))
                    for x, y in zip(outs[parent][q], outs[label][q])]
            if not all(same):
                raise SystemExit(f"torch_walk_ab: {tag}: {label}'s {q} outputs differ from "
                                 f"the parent's (equal: {same})")
    for q in timed:
        labels = list(runs)
        times = chip_smoke.alternating_ms([lambda k=k: launch(k, q) for k in labels], reps,
                                          chip_smoke.PROBE_ROUNDS)
        rec = {k: chip_smoke.spread(t) for k, t in zip(labels, times)}
        base = rec[parent][0]
        res[f"{tag}, {q}"] = dict(bit_equal=True, hits=int((near[1] >= 0).sum()), ms=rec,
                                  ratio={k: v[0] / base for k, v in rec.items()})
        print(f"{tag}, {q} query, every output of every build bit-equal to the parent's: "
              + "; ".join(f"{k} {v[0]:.4f} ms [{v[1][0]:.4f}, {v[1][1]:.4f}] "
                          f"{v[0] / base:.3f}x" for k, v in rec.items())
              + f"  [{card}]", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python tools/torch_walk_ab.py")
    ap.add_argument("--parent", required=True, type=Path,
                    help="a checkout of the earlier tree")
    ap.add_argument("--cases", choices=("k3", "aov", "all"), default="all")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_walk_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from lumillyrender_tpu_torch.accel.pack import build_tri_bvh
    from lumillyrender_tpu_torch.integrator.render import default_spp_chunk
    from lumillyrender_tpu_torch.ops import cuda_bounce, cuda_bvh, intersect
    from lumillyrender_tpu_torch.scene.compiler import compile_scene_file
    from lumillyrender_tpu_torch.scene.data import Bvh, tensor_of

    parent = args.parent.resolve() / "lumillyrender_tpu_torch" / "csrc"
    here = REPO / "lumillyrender_tpu_torch" / "csrc"
    jobs = {"parent bvh": (parent / "bvh.cu", []), "change bvh": (here / "bvh.cu", []),
            "change aov": (here / "bvh_aov.cu", [])}
    if (parent / "bvh_aov.cu").exists():
        jobs["parent aov"] = (parent / "bvh_aov.cu", [])
    else:
        jobs.update({"parent wide": (parent / "bvh_wide.cu", []),
                     "parent streamed": (parent / "bvh_streamed.cu", [])})
    built = build_sources(jobs)
    card = chip_smoke.gpu_line()
    res = {"card": card, "rounds": chip_smoke.PROBE_ROUNDS, "reps": REPS, "k3_reps": K3_REPS,
           "ptxas": {label: kernel_lines(log, "kernel") for label, (_, log) in built.items()}}
    for label, lines in res["ptxas"].items():
        for kernel, rec in lines.items():
            print(f"{label} {chip_smoke.kernel_instance(kernel)}: {rec['ptxas']} "
                  f"({rec['blocks_per_sm']} blocks of 128 per SM)")
    print(card, flush=True)
    earlier = "const int32_t* counts" not in (parent / "bvh.cu").read_text()
    lib = lambda label: built[label][0]
    aov = {name: entry(lib("parent aov" if "parent aov" in built else
                           f"parent {name.split('_')[1]}"), f"llr_{name}")
           for name in ("bvh_wide", "bvh_streamed")}

    if args.cases in ("k3", "all"):
        k3 = cuda_bvh.intersect_tris_launch
        runs = {"parent": (k3, "bvh", entry(lib("parent bvh"), "llr_bvh", earlier)),
                "change": (k3, "bvh", entry(lib("change bvh"), "llr_bvh"))}
        geo = compile_scene_file(REPO / "assets" / "welcome-geo.toml", device="cuda")
        n = geo.settings.width * geo.settings.height * default_spp_chunk(geo.settings)
        o, d, _, _ = cuda_bounce.generate_rays(geo.data, geo.settings, chip_smoke.SEED, 0, n)
        bvh = geo.data.bvh
        run_case(f"kernel 3 welcome-geo K={bvh.blk_p0.shape[1]}, camera rays", runs, o, d, bvh,
                 cuda_bvh.tables_of(bvh), ("nearest", "shade"), K3_REPS, res, card)
        del geo, o, d, bvh
        path = chip_smoke.write_terrain("terrain-1m", chip_smoke.BIG_TRIS["terrain-1m"])[0]
        c = compile_scene_file(path, device="cuda")
        n = c.settings.width * c.settings.height * default_spp_chunk(c.settings)
        o, d = chip_smoke.terrain_rays(c, n)["camera"]
        run_case(f"kernel 3 terrain-1m K={c.data.bvh.blk_p0.shape[1]}, camera rays, unsorted",
                 runs, o, d, c.data.bvh, cuda_bvh.tables_of(c.data.bvh), ("nearest",), REPS,
                 res, card)
        del c, o, d
        torch.cuda.empty_cache()

    if args.cases in ("aov", "all"):
        scenes = {}
        for name, scene, k in AOV_CASES:
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
            launch = {"bvh_wide": cuda_bvh.intersect_tris_wide_launch,
                      "bvh_streamed": cuda_bvh.intersect_tris_streamed_launch}[name]
            runs = {"parent": (launch, name, aov[name]),
                    "change": (launch, name, entry(lib("change aov"), f"llr_{name}"))}
            n = c.settings.width * c.settings.height * default_spp_chunk(c.settings)
            for key, (o0, d0) in chip_smoke.terrain_rays(c, n).items():
                if key == "axis-aligned":
                    continue
                for srt in (False, True):
                    o, d = o0, d0
                    if srt:
                        perm, _ = intersect.sort_rays(o, d, bvh)
                        o, d = o[perm].contiguous(), d[perm].contiguous()
                    tag = (f"{name} {scene} K={k}, {key} rays, "
                           f"{'sorted' if srt else 'unsorted'}")
                    run_case(tag, runs, o, d, bvh, cuda_bvh.tables_of(bvh), ("nearest",), REPS,
                             res, card)
            del bvh
            torch.cuda.empty_cache()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
