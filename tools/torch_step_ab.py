"""The training step of two trees of the PyTorch/CUDA port, in turns on one
card.

    python tools/torch_step_ab.py --parent DIR [--steps 3] [--rounds 4]

Starts one worker process for each tree, this one and DIR (a checkout of
an earlier commit of the port), each importing its own tree's package and
building its own kernels into its own build directory. Each worker
compiles welcome-geo at 512x368 x 4 spp (chip_smoke.py's phase-25 step)
and welcome at 2138x1536 x 1 spp (one 3,283,968-lane chunk, phase 30's
hero step), renders the target at the true parameters and moves the
albedo to 0.8 of its value. Then, round by round, the two workers in
turns, the order reversed every other round (parent, this tree, this
tree, parent, ...), each times `--steps` calls of `film_and_grads` (the
training step a user calls: the hybrid step forward, autograd of the
recompute backward), each at its own seed, the same seeds in both trees,
after one warm-up step: the host clock around each step, which ends in a
synchronize. A tree whose `film_and_grads` runs a captured training plan
(`diff.render.TrainPlan`, which keeps one plan) captures anew at the
warm-up step of each request, since the requests alternate between the
scenes, and its timed steps are replays. Only one worker runs at a time; the other waits on its pipe.
Prints the card's name and power limit, each round's ms a step, the
median of each tree and scene over every step of every round, whether
the two trees' losses are bit-equal step by step, and one JSON line,
which it also writes to chiprun_out/step_ab.json.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SEED = 7
# name: (asset, width, height, spp)
SCENES = {"welcome-geo 512x368 x 4": ("welcome-geo", 512, 368, 4),
          "welcome 2138x1536 x 1": ("welcome", 2138, 1536, 1)}


def worker(tree: Path) -> None:
    """Serves "<scene> <steps> <seed>" lines on stdin with one JSON line of
    step times and losses each, until its input ends."""
    sys.path.insert(0, str(tree))
    import dataclasses

    import torch
    from lumillyrender_tpu_torch.diff import film_and_grads, params_of, render_diff
    from lumillyrender_tpu_torch.scene.compiler import compile_scene_file

    work = {}
    for name, (asset, w, h, spp) in SCENES.items():
        c = compile_scene_file(tree / "assets" / f"{asset}.toml", device="cuda")
        st = dataclasses.replace(c.settings, width=w, height=h, spp=spp)
        p_true = params_of(c.data)
        with torch.no_grad():
            target = render_diff(c.data, st, p_true, SEED, spp)
        p = p_true._replace(materials=dataclasses.replace(
            p_true.materials, color=p_true.materials.color * 0.8))
        film_and_grads(c.data, st, p, target, SEED + 1, spp)  # builds, warms up
        torch.cuda.synchronize()
        work[name] = (c.data, st, p, target, spp)
    print(json.dumps({"ready": str(tree)}), flush=True)
    for line in sys.stdin:
        name, steps, seed = line.rsplit(" ", 2)
        scene, st, p, target, spp = work[name]
        film_and_grads(scene, st, p, target, int(seed) - 1, spp)
        torch.cuda.synchronize()
        ms, losses = [], []
        for k in range(int(steps)):
            t0 = time.monotonic()
            loss, _, _ = film_and_grads(scene, st, p, target, int(seed) + k, spp)
            torch.cuda.synchronize()
            ms.append((time.monotonic() - t0) * 1e3)
            losses.append(float(loss).hex())
        print(json.dumps({"ms": ms, "losses": losses}), flush=True)


def reply(proc, key):
    """The worker's next JSON line holding `key`; other lines are echoed."""
    for line in proc.stdout:
        if line.startswith("{") and key in (got := json.loads(line)):
            return got
        print(f"  worker: {line.rstrip()}", flush=True)
    raise RuntimeError("the worker ended")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        worker(a.worker.resolve())
        return 0
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"gpu: {gpu}", flush=True)
    trees = {"parent": a.parent.resolve(), "change": REPO}
    procs = {k: subprocess.Popen([sys.executable, __file__, "--worker", str(t)], cwd=t,
                                 stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
             for k, t in trees.items()}
    try:
        for k, p in procs.items():
            print(f"{k}: ready, {reply(p, 'ready')['ready']}", flush=True)
        out = {k: {s: {"ms": [], "losses": []} for s in SCENES} for k in trees}
        for r in range(a.rounds):
            order = ["parent", "change"] if r % 2 == 0 else ["change", "parent"]
            for s in SCENES:
                seed = SEED + 100 * (r + 1)
                for k in order:
                    procs[k].stdin.write(f"{s} {a.steps} {seed}\n")
                    procs[k].stdin.flush()
                    got = reply(procs[k], "ms")
                    out[k][s]["ms"] += got["ms"]
                    out[k][s]["losses"] += got["losses"]
                    print(f"round {r} {s} {k}: " + ", ".join(f"{v:.1f}" for v in got["ms"])
                          + " ms", flush=True)
    finally:
        for p in procs.values():  # end of input ends the worker
            p.stdin.close()
            try:
                p.wait(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
    rec = {"gpu": gpu, "steps": a.steps, "rounds": a.rounds, "scenes": {}}
    for s in SCENES:
        med = {k: statistics.median(out[k][s]["ms"]) for k in trees}
        same = out["parent"][s]["losses"] == out["change"][s]["losses"]
        rec["scenes"][s] = {k: out[k][s]["ms"] for k in trees} | {
            "median_ms": med, "change_over_parent": med["change"] / med["parent"],
            "losses_bit_equal": same}
        print(f"{s}: median ms a step, parent {med['parent']:.1f}, change {med['change']:.1f} "
              f"(x{med['change'] / med['parent']:.4f}); losses bit-equal: {same}  [{gpu}]")
    (REPO / "chiprun_out").mkdir(exist_ok=True)
    (REPO / "chiprun_out" / "step_ab.json").write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
