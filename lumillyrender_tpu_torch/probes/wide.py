"""The probes of the JAX package's `tools/probe_wide.py`: the access patterns
of the wide-leaf BVH kernel (a dynamic row read, narrow output blocks, a
lane reduction, a tile built from scalars).

Each probe `<name>(device)` launches its kernel (csrc/probes.cu) on a CUDA
device and runs `plain_<name>(device)` on the CPU; inputs are built as the
tool builds them.
"""

from __future__ import annotations

import torch

from .kernel import Probe, bag_sum_call

F32, I32 = torch.float32, torch.int32
TOOL = "tools/probe_wide.py"


def _arange(rows, cols, device):
    return torch.arange(rows * cols, dtype=F32, device=device).reshape(rows, cols)


def _dyn_rows_inputs(device):
    return (_arange(64, 128, device),
            torch.arange(8, dtype=I32, device=device).reshape(1, 8) * 7)


def _dyn_rows(tab, idx):
    acc = torch.zeros((1, 128), dtype=F32, device=tab.device)
    for row in tab[idx[0].long()]:
        acc = acc + row
    return acc


dyn_row_vector_read = Probe(
    "dyn_row_vector_read", "probe_dyn_row_vector_read", f"{TOOL}:34",
    _dyn_rows_inputs, _dyn_rows, (1, 128),
    work=lambda ins: (8 * 128 * 4 + 8 * 4 + 128 * 4, 8 * 128),
    library=lambda ins: bag_sum_call(ins[0], ins[1].reshape(-1).long()))
plain_dyn_row_vector_read = dyn_row_vector_read.plain


def _add_call(x):
    out = torch.empty((16, 8), dtype=F32, device=x.device)
    return lambda: torch.add(x[:, :8], 1.0, out=out)


narrow_out_block = Probe(
    "narrow_out_block", "probe_narrow_out_block", f"{TOOL}:58",
    lambda device: (_arange(16, 128, device),), lambda x: x[:, :8] + 1.0, (16, 8),
    work=lambda ins: (2 * 16 * 8 * 4, 16 * 8), library=lambda ins: _add_call(ins[0]))
plain_narrow_out_block = narrow_out_block.plain


def _amin_call(x):
    out = torch.empty((x.shape[0], 1), dtype=F32, device=x.device)
    return lambda: torch.amin(x, dim=1, keepdim=True, out=out)


lane_min_broadcast = Probe(
    "lane_min_broadcast", "probe_lane_min_broadcast", f"{TOOL}:74",
    lambda device: (_arange(8, 128, device),),
    lambda x: x.amin(dim=1, keepdim=True).expand(8, 128).contiguous(), (8, 128),
    work=lambda ins: (2 * 8 * 128 * 4, 8 * 128),
    library=lambda ins: _amin_call(ins[0]))
plain_lane_min_broadcast = lane_min_broadcast.plain


def _row_fill_inputs(device):
    return ((torch.arange(8, dtype=F32, device=device).reshape(8, 1) * 10).repeat(1, 8),)


def _copy_call(r):
    out = torch.empty((8, 128), dtype=F32, device=r.device)
    return lambda: out.copy_(r[:, :1])


scalar_row_fill = Probe(
    "scalar_row_fill", "probe_scalar_row_fill", f"{TOOL}:88",
    _row_fill_inputs, lambda r: r[:, :1].expand(8, 128).contiguous(), (8, 128),
    work=lambda ins: (8 * 4 + 8 * 128 * 4, 0), library=lambda ins: _copy_call(ins[0]))
plain_scalar_row_fill = scalar_row_fill.plain

PROBES = (dyn_row_vector_read, narrow_out_block, lane_min_broadcast, scalar_row_fill)
