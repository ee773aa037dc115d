"""The bounce kernels of two trees of the PyTorch/CUDA port, on the same
states, in turns on one card.

    python tools/torch_bounce_ab.py --parent DIR

builds DIR's `lumillyrender_tpu_torch/csrc/bounce_bvh.cu` and `bounce.cu`
(a checkout of an earlier commit of the port; its own headers beside them)
with this tree's nvcc flags into this tree's `lumillyrender_tpu_torch/
build/` under other library names, beside this tree's kernels, and loads
them. The BVH bounce (kernel 4) runs on terrain-1m (scene/terrain.py at 1M
triangles, K=128 leaves, written as chip_smoke.py writes it) and on
welcome-geo (K=32), the brute-force bounce (kernel 2, whose body
csrc/bounce_body.cuh it shares) on new-cbox. On each scene one chunk is
traced with this tree's kernel and the first state of each stage width
kept (2,097,152 / 262,144 / 32,768 / 4,096 lanes on terrain-1m; 2,072,576
/ 259,072 / 32,512 / 4,096 on welcome-geo; 2,097,152 / 32,768 / 4,096 on
new-cbox). On each, both trees' kernels write their own outputs, which
must be bit-equal on every tensor (o, d, throughput, accum, alive, rays);
then both bare launches are captured in CUDA graphs of `REPS` launches
and replayed in turns, `chip_smoke.PROBE_ROUNDS` replays each with the
order reversed every other round (`chip_smoke.alternating_ms`). Prints
both trees' ptxas lines of the kernels (registers, shared memory, spills)
and the blocks per SM their registers allow, the card's name and power
limit, per width the median and [min, max] ms per launch of each, and one
JSON line of all of it.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
# (kernel library, scene) in the order they run.
CASES = (("bounce_bvh", "terrain-1m"), ("bounce_bvh", "welcome-geo"), ("bounce", "new-cbox"))
REPS = 5  # launches per CUDA graph


def build_parent(src: Path, name: str, tag: str = "parent") -> tuple:
    """The source of library `name` in the tree at `src` (the earlier tree
    unless told otherwise) built into this tree's build directory as
    lib<name>-<tag>.so: (its entry point, nvcc's -Xptxas -v output)."""
    from lumillyrender_tpu_torch.ops import cuda_build

    cu = src / "lumillyrender_tpu_torch" / "csrc" / cuda_build.SOURCES[name]
    out = cuda_build.BUILD_DIR / f"lib{name}-{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
                        "-o", str(out), str(cu)], capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {cu}:\n{r.stdout}{r.stderr}")
    fn = getattr(ctypes.CDLL(str(out)), f"llr_{name}")
    fn.argtypes, fn.restype = cuda_build.ARGTYPES[f"llr_{name}"], ctypes.c_int
    return fn, r.stdout + r.stderr


@contextlib.contextmanager
def entry_point(name: str, fn):
    """cuda_bounce's launches of library `name`'s kernel go to `fn` while
    open."""
    from lumillyrender_tpu_torch.ops import cuda_build

    entry = f"llr_{name}"
    saved = cuda_build._fns.get(entry)
    cuda_build._fns[entry] = fn
    try:
        yield
    finally:
        if saved is None:
            del cuda_build._fns[entry]
        else:
            cuda_build._fns[entry] = saved


def kernel_lines(log: str, match: str = "bounce_kernel") -> dict:
    """{kernel: ptxas line, registers, blocks of 128 threads per SM it
    allows (chip_smoke.blocks_per_sm)} for the kernels whose name holds
    `match` in nvcc's -Xptxas -v output."""
    import re

    import chip_smoke

    out = {}
    for name, props in chip_smoke.ptxas_kernels(log).items():
        if match not in name:
            continue
        m = re.search(r"(\d+) registers", props)
        out[name] = dict(ptxas=props, registers=int(m.group(1)) if m else 0,
                         blocks_per_sm=chip_smoke.blocks_per_sm(props))
    return out


def stage_states(c, spp_chunk: int, name: str, tables: dict) -> dict:
    """{width: the first state of that stage} of one chunk traced with this
    tree's kernel of library `name`."""
    import chip_smoke
    from lumillyrender_tpu_torch.ops import cuda_bounce

    kernel = getattr(cuda_bounce, name)
    first = {}

    def step(state):
        first.setdefault(state.o.shape[0], state)
        return kernel(c.data, c.settings, chip_smoke.SEED, state, tables)

    chip_smoke.trace_chunk(c, 0, spp_chunk, cuda_bounce.generate_rays, step)
    torch.cuda.synchronize()
    return first


def outputs(n: int) -> tuple:
    f3 = lambda: torch.empty((n, 3), dtype=torch.float32, device="cuda")
    return (f3(), f3(), f3(), f3(), torch.empty(n, dtype=torch.bool, device="cuda"),
            torch.empty(n, dtype=torch.float32, device="cuda"))


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python tools/torch_bounce_ab.py")
    ap.add_argument("--parent", required=True, type=Path,
                    help="a checkout of the earlier tree")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_bounce_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from lumillyrender_tpu_torch.integrator.render import default_spp_chunk
    from lumillyrender_tpu_torch.ops import cuda_bounce, cuda_build
    from lumillyrender_tpu_torch.scene.compiler import compile_scene_file

    names = sorted({name for name, _ in CASES})
    cuda_build.build(tuple(names), verbose=True)
    mine = {name: cuda_build.fn(name) for name in names}
    parent, logs = {}, {}
    for name in names:
        parent[name], logs[name] = build_parent(args.parent.resolve(), name)
    card = chip_smoke.gpu_line()
    res = {"card": card, "rounds": chip_smoke.PROBE_ROUNDS, "reps": REPS,
           "ptxas": {who: {name: kernel_lines(log) for name, log in by_name.items()}
                     for who, by_name in (("parent", logs), ("change", {
                         name: cuda_build.LOGS.get(name, "") for name in names}))}}
    for who, by_name in res["ptxas"].items():
        for lines in by_name.values():
            for kernel, rec in lines.items():
                print(f"{who} {kernel}: {rec['ptxas']} ({rec['blocks_per_sm']} blocks of 128 "
                      "per SM by registers)")
    print(card)
    paths = {"terrain-1m": chip_smoke.write_terrain("terrain-1m", chip_smoke.BIG_TRIS[
        "terrain-1m"])[0], "welcome-geo": REPO / "assets" / "welcome-geo.toml",
        "new-cbox": REPO / "assets" / "new-cbox.toml"}
    for name, scene in CASES:
        c = compile_scene_file(paths[scene], device="cuda")
        st = c.settings
        bvh = name == "bounce_bvh"
        tables = cuda_bounce.pack_tables(c.data, bvh=bvh)
        launch_fn = getattr(cuda_bounce, f"{name}_launch")
        tag = f"{name} {scene}" + (f" K={tables['bvh']['k']}" if bvh else "")
        res[tag] = {}
        for w, s0 in sorted(stage_states(c, default_spp_chunk(st), name, tables).items(),
                            reverse=True):
            outs = {"parent": outputs(w), "change": outputs(w)}

            def launch(who, s0=s0):
                fn = parent[name] if who == "parent" else mine[name]
                with entry_point(name, fn):
                    launch_fn(c.data, st, chip_smoke.SEED, s0, tables, outs[who])

            launch("parent")
            launch("change")
            torch.cuda.synchronize()
            same = [torch.equal(bits(a), bits(b)) for a, b in zip(outs["parent"],
                                                                  outs["change"])]
            if not all(same):
                raise SystemExit(f"torch_bounce_ab: {tag} width {w}: the outputs differ "
                                 f"(o, d, throughput, accum, alive, rays equal: {same})")
            times = chip_smoke.alternating_ms([lambda: launch("parent"),
                                               lambda: launch("change")],
                                              REPS, chip_smoke.PROBE_ROUNDS)
            rec = {who: chip_smoke.spread(t) for who, t in zip(("parent", "change"), times)}
            rec.update(live=float(s0.alive.sum()), bit_equal=True,
                       ratio=rec["change"][0] / rec["parent"][0])
            res[tag][str(w)] = rec
            print(f"{tag}, width {w} ({rec['live']:.0f} live), every output bit-equal: "
                  f"parent {rec['parent'][0]:.4f} ms [{rec['parent'][1][0]:.4f}, "
                  f"{rec['parent'][1][1]:.4f}], change {rec['change'][0]:.4f} ms "
                  f"[{rec['change'][1][0]:.4f}, {rec['change'][1][1]:.4f}]: "
                  f"{rec['ratio']:.3f}x  [{card}]", flush=True)
        del c, tables
        torch.cuda.empty_cache()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
