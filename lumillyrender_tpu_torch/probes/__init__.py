"""The Mosaic capability probes of the JAX package (`tools/probe_mosaic.py`,
`tools/pallas_probe.py`, `tools/probe_wide.py`) as hand-written Hopper
kernels (csrc/probes.cu), each beside its plain PyTorch version.

A TPU probe asks whether Mosaic lowers one access pattern; on the card the
question is what the pattern costs, and chip_smoke.py times each kernel
beside its bound. Modules `mosaic`, `pallas` and `wide` hold one `Probe`
each per JAX probe, named as there; run them all with
`python -m lumillyrender_tpu_torch.probes [--device cuda|cpu]`.
"""

from __future__ import annotations

from . import mosaic, pallas, wide
from .kernel import (Probe, launch_empty, launch_empty_cluster, onehot_geometry, smem_limit,
                     static_smem)
from .mosaic import SMEM_ROWS

PROBES: tuple[Probe, ...] = mosaic.PROBES + pallas.PROBES + wide.PROBES
# The probes whose kernels read their inputs straight from global memory (L2)
# and must use no shared memory: each loaded kernel reports its static
# (`static_smem`), and their entries launch with no dynamic.
DIRECT_PROBES = ("vmem_dyn_sublane_static_lane", "vmem_dyn_lane", "smem_input",
                 "take_along_axis_axis0", "take_rowgather", "vmem_scalar_dynamic_read",
                 "ref_ds_row_read", "scatter_add", "scalar_broadcast", "dyn_row_vector_read")


def cases() -> list:
    """(tag, probe, params) for every run the entry point makes: each probe
    once, smem_input at each of its tool's four table sizes."""
    out = []
    for p in PROBES:
        if p is mosaic.smem_input:
            out += [(f"smem_input({rows})", p, (rows,)) for rows in SMEM_ROWS]
        else:
            out.append((p.name, p, ()))
    return out


def reset_counts():
    for p in PROBES:
        p.launches = 0


def counts() -> dict:
    return {p.name: p.launches for p in PROBES}


__all__ = ["DIRECT_PROBES", "PROBES", "Probe", "SMEM_ROWS", "cases", "counts",
           "launch_empty", "launch_empty_cluster", "onehot_geometry", "reset_counts",
           "smem_limit", "static_smem"]
