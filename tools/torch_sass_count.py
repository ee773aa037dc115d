"""SASS instruction counts of the bounce kernels' instances, and the time
the card would take to issue them (a diagnosis, not a bound).

    python tools/torch_sass_count.py [--lanes 2097152 4096]

builds the port's kernels (lumillyrender_tpu_torch/ops/cuda_build.py) if
they are not built, disassembles bounce.cu, bounce_bwd.cu and
bounce_bvh.cu with `cuobjdump -sass`, and counts each kernel function's
instructions (every SASS instruction but NOP). For each instance it prints
that count and, at each lane count, count x lanes / (SMs x 4 schedulers x
32 threads x SM clock): the time to issue one lane's instructions for
every lane if each instruction issued once a lane with no stall. The count
is static: an unrolled sweep (SmallIsect) counts the tests past nt and ns
that a launch skips, a loop (BruteIsect, GroupIsect) counts its body once
where a lane runs it nt + ns times, and every branch counts whether a lane
takes it or not. The SM clock is nvidia-smi's clocks.max.sm. Needs a card
and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SCHEDULERS = 4  # warp schedulers an SM, each issuing one warp instruction a cycle


def sass_counts(lib: Path) -> dict:
    """{kernel function: non-NOP SASS instructions} of one library."""
    import chip_smoke

    return {fn: len(code) for fn, code in chip_smoke.sass_functions(lib).items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python tools/torch_sass_count.py")
    ap.add_argument("--lanes", type=int, nargs="+", default=[2097152, 1048576, 4096])
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    import chip_smoke
    from lumillyrender_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        print("torch_sass_count: no CUDA device", file=sys.stderr)
        return 2
    names = ("bounce", "bounce_bwd", "bounce_bvh")
    cuda_build.build(names)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60)
    mhz = float(r.stdout.strip().splitlines()[0])
    card = chip_smoke.gpu_line()
    print(f"{card}; {sms} SMs, max SM clock {mhz:.0f} MHz")
    res = {"card": card, "sms": sms, "sm_mhz": mhz, "kernels": {}}
    rate = sms * SCHEDULERS * 32 * mhz * 1e6  # thread instructions a second
    for name in names:
        for fn, n in sass_counts(cuda_build.lib_path(name)).items():
            label = f"{name}.cu {chip_smoke.kernel_instance(fn)}"
            est = {lanes: n * lanes / rate * 1e3 for lanes in args.lanes}
            res["kernels"][label] = dict(instructions=n, issue_ms=est)
            print(f"{label}: {n} instructions; issue estimate "
                  + ", ".join(f"{v:.4f} ms at {k} lanes" for k, v in est.items()))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
