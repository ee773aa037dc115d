"""Capability-probe kernels of two trees of the PyTorch/CUDA port, timed in
turns on one card.

    python tools/torch_probe_ab.py --parent DIR

builds DIR's `lumillyrender_tpu_torch/csrc/probes.cu` (a checkout of an
earlier commit of the port) with this tree's nvcc flags into this tree's
`lumillyrender_tpu_torch/build/`, beside this tree's own probes, and loads
both. For every run of the probe entry point (`probes.cases()`: each
probe, smem_input at each table size), on this tree's inputs: the earlier
kernel, this tree's kernel and the probe's one PyTorch call, where it has
one, must each equal the plain version bit for bit; then they are captured
(both trees' kernels launching into the same output buffer) in CUDA graphs
of `chip_smoke.PROBE_REPS` launches and replayed in turns,
`chip_smoke.PROBE_ROUNDS` replays each with the order reversed every other
round (`chip_smoke.alternating_ms`), as phase 20 of chip_smoke.py times
them. An earlier scatter_add entry gets a (2048, 128) float32 scratch of
its own (it zeroes and adds into one; this tree's reads none). Where the
earlier entry returns cudaErrorInvalidValue for smem_input (its table
staged in shared memory past the card's opt-in limit), the refusal is
printed and this tree's kernel and the call are timed without it; any
other error fails the run. Prints each kernel's ptxas line of both trees
(this tree's where it is built in this run), the shared memory of the
kernels that read L2 directly as the loaded library reports it, the
card's name and power limit, and one JSON line: per run the median and
[min, max] ms per launch of each, and an empty kernel's launch timed the
same way.
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
# The scratch an earlier tree's entry needs, by probe: scatter_add zeroed a
# (2048, 128) float32 buffer, added into it and copied rows 0:8 out.
PARENT_SCRATCH = {"scatter_add": (2048, 128)}
# cudaErrorInvalidValue: an earlier smem_input entry's refusal of a table
# past the card's opt-in shared memory.
REFUSED = 1


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
    mine = chip_smoke.ptxas_kernels(cuda_build.LOGS.get("probes", ""))
    theirs = chip_smoke.ptxas_kernels(log)
    for name in probes.DIRECT_PROBES:
        print(f"probe_{name} (reads L2 directly): change {probes.static_smem(name)} bytes "
              f"static shared memory (cudaFuncGetAttributes)")
    card = chip_smoke.gpu_line()
    print(card)
    rounds, reps = chip_smoke.PROBE_ROUNDS, chip_smoke.PROBE_REPS
    res = {"card": card, "rounds": rounds, "reps": reps}
    res["empty"] = chip_smoke.spread(chip_smoke.alternating_ms(
        [probes.launch_empty], reps, rounds)[0])
    for tag, probe, params in probes.cases():
        kernel = f"probe_{probe.name}"
        print(f"{tag}: ptxas parent {theirs.get(kernel)}; change "
              f"{chip_smoke.ptxas_line(mine, kernel)}")
        ins = probe.inputs(dev, *params)
        entry = getattr(lib, f"llr_probe_{probe.name}")
        entry.argtypes, entry.restype = cuda_build.PROBE_ARGS, ctypes.c_int
        outs, outs_parent = probe.outputs(dev), probe.outputs(dev)
        b = ins[1].data_ptr() if len(ins) > 1 else None
        shape = PARENT_SCRATCH.get(probe.name)
        scratch = None if shape is None else torch.empty(shape, dtype=torch.float32, device=dev)

        def parent(outs, entry=entry, ins=ins, b=b, scratch=scratch):
            return entry(ins[0].data_ptr(), b, cuda_build.ptr(scratch), outs[0].data_ptr(),
                         ins[0].shape[0], cuda_build.stream())

        # Timed, both trees launch into the same output buffer: a gap between
        # them is then the kernels', not where their buffers lie.
        fns = {"parent": lambda parent=parent, outs=outs, tag=tag: cuda_build.check(
                   parent(outs), f"parent {tag}"),
               "change": lambda probe=probe, ins=ins, outs=outs: probe.launch(ins, outs)}
        if probe.library is not None:
            fns["library"] = probe.library(ins)
        want = probe.compute(*ins).view(torch.int32)
        rc = parent(outs_parent)
        got = dict(change=outs[0])
        if rc == REFUSED and probe is probes.mosaic.smem_input:
            print(f"{tag}: the parent's entry refuses the table (CUDA error {rc}: past the "
                  f"card's opt-in shared memory); this tree's kernel timed alone")
            del fns["parent"]
        else:
            cuda_build.check(rc, f"parent {tag}")
            got["parent"] = outs_parent[0]
        probe.launch(ins, outs)
        if "library" in fns:
            got["library"] = fns["library"]()
        torch.cuda.synchronize()
        for who, t in got.items():
            if not torch.equal(t.expand(want.shape).contiguous().view(torch.int32), want):
                raise SystemExit(f"torch_probe_ab: {who} {tag} differs from the plain version")
        times = chip_smoke.alternating_ms(list(fns.values()), reps, rounds)
        res[tag] = {who: chip_smoke.spread(t) for who, t in zip(fns, times)}
        print(f"{tag}: " + ", ".join(f"{who} {m:.6f} ms [{lo:.6f}, {hi:.6f}]"
                                     for who, (m, (lo, hi)) in res[tag].items()))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
