"""Run every capability probe once: `python -m lumillyrender_tpu_torch.probes
[--device cuda|cpu]` (default cuda; without a card it raises unless
`--device cpu` is given).

Prints the card's name and power limit, then one `OK <name>: <first
values>` line per probe run (smem_input at each of its four table sizes),
as the JAX tools do, or `FAIL <name>: <reason>` where smem_input's sum is
not its exact value; a kernel that fails to launch raises. Exits 1 on any
FAIL, 0 otherwise.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import torch

from ..scene.data import resolve_device
from . import cases


def _card_line(device: torch.device) -> str:
    if device.type != "cuda":
        return f"device: {device} (the plain PyTorch versions)"
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return f"gpu: {r.stdout.strip().splitlines()[0]}"


def smem_input_sum(rows: int) -> int:
    """smem_input's exact sum: integers below 2^24, so float32 adds them
    without rounding."""
    return sum(((i * 977) % rows) * 8 + i % 8 for i in range(64))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m lumillyrender_tpu_torch.probes")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(_card_line(dev), flush=True)
    failed = 0
    for tag, probe, params in cases():
        first = probe(dev, *params).reshape(-1)[:4].tolist()
        if params and first[0] != smem_input_sum(params[0]):
            print(f"FAIL {tag}: {first[0]} is not the exact sum {smem_input_sum(params[0])}")
            failed += 1
            continue
        print(f"OK {tag}: {first}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
