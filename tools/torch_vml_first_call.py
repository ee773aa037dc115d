"""How often PyTorch's first split call into MKL's vector math (VML) goes
wrong on the CPU, with and without the port imported first.

    python tools/torch_vml_first_call.py [--procs 6] [--rounds 10]

Each round starts `--procs` fresh Python processes at once, for each of two
setups, and each process:
* brings up JAX's CPU backend (8 host devices, as tests/conftest.py does)
  and moves an array onto it, as the port's parity tests do;
* sets PyTorch to 2 intra-op threads;
* with `port`, imports `lumillyrender_tpu_torch` (which makes one VML call
  on one thread at import); with `bare`, does not;
* takes `torch.sqrt` of 6,000 ones, a call PyTorch splits over both
  threads, and reports how many results are not exactly 1.
Prints, per setup, the processes whose first call went wrong out of those
run, and one JSON line with the counts. Needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

CHILD = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
import torch
torch.set_num_threads(2)
jnp.asarray(np.ones(1500, np.float32)).block_until_ready()
if sys.argv[1] == "port":
    import lumillyrender_tpu_torch
y = torch.sqrt(torch.full((6000,), 1.0))
print(int((y != 1.0).sum()))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python tools/torch_vml_first_call.py")
    ap.add_argument("--procs", type=int, default=6, help="processes started at once")
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args(argv)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(REPO))
    res = {}
    for setup in ("bare", "port"):
        wrong = runs = 0
        for _ in range(args.rounds):
            procs = [subprocess.Popen([sys.executable, "-c", CHILD, setup], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                                      text=True) for _ in range(args.procs)]
            for p in procs:
                out, _ = p.communicate(timeout=300)
                if p.returncode != 0:
                    raise SystemExit(f"a {setup} process exited {p.returncode}")
                runs += 1
                wrong += int(out.split()[-1]) > 0
        res[setup] = {"wrong": wrong, "runs": runs}
        print(f"{setup}: the first split sqrt went wrong in {wrong} of {runs} processes")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
