"""Run every capability probe once: `python -m lumillyrender_tpu_torch.probes
[--device cuda|cpu]` (default cuda; without a card it raises unless
`--device cpu` is given).

Prints the card's name and power limit, then one `OK <name>: <first
values>` or `FAIL <name>: <reason>` line per probe, as the JAX tools do.
The one refusal expected is smem_input's at table sizes past the card's
opt-in shared memory: predicted from the card's limit before the launch,
then made by the card itself when the kernel asks for that memory.
Exits 1 if any outcome differs from the prediction (or smem_input's sum
from its exact value), 0 otherwise.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import torch

from ..scene.data import resolve_device
from . import SharedMemoryLimit, cases, smem_limit


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
    limit = smem_limit(dev)
    if limit is not None:
        print(f"shared memory a block may opt in to: {limit} bytes")
    unexpected = 0
    for tag, probe, params in cases():
        ins = probe.inputs(dev, *params)
        if not probe.fits(ins, limit):
            try:
                probe.run(ins)
            except SharedMemoryLimit as e:
                print(f"FAIL {tag}: SharedMemoryLimit: {e} (expected on this card)")
                continue
            print(f"FAIL {tag}: ran although its table exceeds the card's limit")
            unexpected += 1
            continue
        out = probe.run(ins)
        first = out.reshape(-1)[:4].tolist()
        if params and first[0] != smem_input_sum(params[0]):
            print(f"FAIL {tag}: {first[0]} is not the exact sum {smem_input_sum(params[0])}")
            unexpected += 1
            continue
        print(f"OK {tag}: {first}")
    return 1 if unexpected else 0


if __name__ == "__main__":
    sys.exit(main())
