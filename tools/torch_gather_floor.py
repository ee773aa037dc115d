"""The floors of the take_along_axis_axis0 probe (8e), timed beside it on one
card.

    python tools/torch_gather_floor.py

builds `tools/torch_gather_floor.cu` with the port's nvcc flags into
`lumillyrender_tpu_torch/build/`, beside the port's probes. On the probe's
own inputs (the tool's table and idx), it times in turns, as phase 20 of
chip_smoke.py times the probes (CUDA graphs of `chip_smoke.PROBE_REPS`
launches, `chip_smoke.PROBE_ROUNDS` replays, the order reversed every other
round): the empty kernel; a stream of idx to out with 8e's grid and
16-byte accesses; the same with a dependent full-sector table read (what a
gather that read each table sector once would take); 8e's kernel itself,
which reads a 32-byte sector for every output. Prints the card's name and
power limit and one JSON line of medians and [min, max] in ms.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "tools" / "torch_gather_floor.cu"
KINDS = ("stream", "chain")


def build() -> ctypes.CDLL:
    from lumillyrender_tpu_torch.ops import cuda_build

    out = cuda_build.BUILD_DIR / "libgather_floor.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
                        "-o", str(out), str(SOURCE)], capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{r.stdout}{r.stderr}")
    print(r.stdout + r.stderr, end="")
    lib = ctypes.CDLL(str(out))
    p = ctypes.c_void_p
    lib.llr_gather_floor.argtypes = [ctypes.c_int, p, p, p, p]
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_gather_floor: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from lumillyrender_tpu_torch import probes
    from lumillyrender_tpu_torch.ops import cuda_build

    dev = torch.device("cuda")
    cuda_build.build(("probes",))
    lib = build()
    card = chip_smoke.gpu_line()
    print(card)
    probe = probes.pallas.take_along_axis_axis0
    ins, outs = probe.inputs(dev), probe.outputs(dev)
    table, idx = ins

    def floor(kind):
        return lambda: cuda_build.check(lib.llr_gather_floor(
            kind, table.data_ptr(), idx.data_ptr(), outs[0].data_ptr(), cuda_build.stream()),
            KINDS[kind])

    floor(0)()
    torch.cuda.synchronize()
    if not torch.equal(outs[0], idx.float()):
        raise SystemExit("torch_gather_floor: the stream kernel did not copy idx")
    floor(1)()
    torch.cuda.synchronize()
    if not torch.equal(outs[0], table):
        raise SystemExit("torch_gather_floor: the chain kernel did not copy the table")
    fns = {"empty": probes.launch_empty, "stream": floor(0), "chain": floor(1),
           "take_along_axis_axis0": lambda: probe.launch(ins, outs)}
    times = chip_smoke.alternating_ms(list(fns.values()), chip_smoke.PROBE_REPS,
                                      chip_smoke.PROBE_ROUNDS)
    res = {"card": card, **{k: chip_smoke.spread(t) for k, t in zip(fns, times)}}
    print(", ".join(f"{k} {m:.6f} ms [{lo:.6f}, {hi:.6f}]" for k, (m, (lo, hi)) in
                    ((k, res[k]) for k in fns)))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
