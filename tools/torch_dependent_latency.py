"""The dependent latencies that price the while_walk_smem probe (8d), on one
card.

    python tools/torch_dependent_latency.py

builds `tools/dependent_latency.cu` with the port's nvcc flags into
`lumillyrender_tpu_torch/build/`, beside the port's probes; then one warp
times four dependent chains by clock64: a float add chain, two
interleaved, a shared-memory pointer chase, a shuffle. Prints the card's
name and power limit and one JSON line of clocks a dependent step.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "tools" / "dependent_latency.cu"
CHAINS = ("float add", "two float adds", "shared-memory load", "shuffle + integer add")


def build() -> ctypes.CDLL:
    from lumillyrender_tpu_torch.ops import cuda_build

    out = cuda_build.BUILD_DIR / "libdependent_latency.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
                        "-o", str(out), str(SOURCE)], capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{r.stdout}{r.stderr}")
    print(r.stdout + r.stderr, end="")
    lib = ctypes.CDLL(str(out))
    p = ctypes.c_void_p
    lib.llr_latency.argtypes = [p, p, p, p]
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_dependent_latency: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from lumillyrender_tpu_torch.ops import cuda_build

    dev = torch.device("cuda")
    lib = build()
    steps = lib.llr_latency_steps()
    card = chip_smoke.gpu_line()
    print(card)
    f = torch.rand(128, device=dev) + 1.0
    sink = torch.empty(32, dtype=torch.int32, device=dev)
    clocks = torch.zeros(len(CHAINS), dtype=torch.int64, device=dev)
    cuda_build.check(lib.llr_latency(f.data_ptr(), sink.data_ptr(), clocks.data_ptr(),
                                     cuda_build.stream()), "latency chains")
    torch.cuda.synchronize()
    res = {"card": card, "steps": steps,
           "clocks_a_step": {k: c / steps for k, c in zip(CHAINS, clocks.tolist())}}
    print("clocks a dependent step: " + ", ".join(
        f"{k} {v:.2f}" for k, v in res["clocks_a_step"].items()))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
