"""Capability-probe kernels of two trees of the PyTorch/CUDA port, timed in
turns on one card.

    python tools/torch_probe_ab.py --parent DIR

builds DIR's `lumillyrender_tpu_torch/csrc/probes.cu` (a checkout of an
earlier commit of the port) with this tree's nvcc flags into this tree's
`lumillyrender_tpu_torch/build/`, beside this tree's own probes, and loads
both. For each probe that reads its table straight from L2
(`chip_smoke.DIRECT_PROBES`), on this tree's inputs: the earlier kernel,
this tree's kernel and the probe's one PyTorch call must each equal the
plain version bit for bit; then the three are captured in CUDA graphs of
`chip_smoke.PROBE_REPS` launches and replayed in turns,
`chip_smoke.PROBE_ROUNDS` replays each with the order reversed every other
round (`chip_smoke.alternating_ms`), as phase 20 of chip_smoke.py times
them. Prints each kernel's shared memory (the earlier one's ptxas line;
this tree's as the loaded kernel reports it, and its ptxas line where it is
built in this run), the card's name and power limit, and one JSON line: per
probe the median and [min, max] ms per launch of each, and an empty
kernel's launch timed the same way.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def build_parent(src: Path) -> tuple:
    """The earlier tree's probes.cu built into this tree's build directory:
    (ctypes library, nvcc's -Xptxas -v output)."""
    from lumillyrender_tpu_torch.ops import cuda_build

    csrc = src / "lumillyrender_tpu_torch" / "csrc"
    out = cuda_build.BUILD_DIR / "libprobes-parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
                        "-o", str(out), str(csrc / "probes.cu")],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {csrc / 'probes.cu'}:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(str(out)), r.stdout + r.stderr


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python tools/torch_probe_ab.py")
    ap.add_argument("--parent", required=True, type=Path,
                    help="a checkout of the earlier tree")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_probe_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from lumillyrender_tpu_torch import probes
    from lumillyrender_tpu_torch.ops import cuda_build

    dev = torch.device("cuda")
    cuda_build.build(("probes",), verbose=True)
    lib, log = build_parent(args.parent.resolve())
    mine = chip_smoke.direct_probe_smem(cuda_build.LOGS.get("probes", ""))
    theirs = chip_smoke.ptxas_kernels(log)
    card = chip_smoke.gpu_line()
    print(card)
    rounds = chip_smoke.PROBE_ROUNDS
    res = {"card": card, "rounds": rounds, "reps": chip_smoke.PROBE_REPS}
    res["empty"] = chip_smoke.spread(chip_smoke.alternating_ms(
        [probes.launch_empty], chip_smoke.PROBE_REPS, rounds)[0])
    by_name = {p.name: p for p in probes.PROBES}
    for name in chip_smoke.DIRECT_PROBES:
        probe = by_name[name]
        static, props = mine[name]
        print(f"probe_{name}: parent (ptxas) {theirs.get(f'probe_{name}')}; change "
              f"{static} bytes static shared memory (cudaFuncGetAttributes), ptxas {props}")
        entry = getattr(lib, f"llr_probe_{name}")
        entry.argtypes, entry.restype = cuda_build.PROBE_ARGS, ctypes.c_int
        ins = probe.inputs(dev)
        outs, outs_parent = probe.outputs(dev), probe.outputs(dev)
        b = ins[1].data_ptr() if len(ins) > 1 else None

        def parent():
            rc = entry(ins[0].data_ptr(), b, None, outs_parent[0].data_ptr(),
                       ins[0].shape[0], cuda_build.stream())
            cuda_build.check(rc, f"parent {name}")

        fns = [parent, lambda: probe.launch(ins, outs), probe.library(ins)]
        want = probe.compute(*ins).view(torch.int32)
        parent()
        probe.launch(ins, outs)
        got = dict(parent=outs_parent[0], change=outs[0], library=fns[2]())
        torch.cuda.synchronize()
        for tag, t in got.items():
            if not torch.equal(t.expand(want.shape).contiguous().view(torch.int32), want):
                raise SystemExit(f"torch_probe_ab: {tag} {name} differs from the plain version")
        times = chip_smoke.alternating_ms(fns, chip_smoke.PROBE_REPS, rounds)
        res[name] = {tag: chip_smoke.spread(t)
                     for tag, t in zip(("parent", "change", "library"), times)}
        print(f"{name}: " + ", ".join(f"{tag} {m:.6f} ms [{lo:.6f}, {hi:.6f}]"
                                      for tag, (m, (lo, hi)) in res[name].items()))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
