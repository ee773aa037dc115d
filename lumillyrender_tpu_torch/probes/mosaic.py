"""The probes of the JAX package's `tools/probe_mosaic.py`: scalar reads at
dynamic indices, how large a table the fast memory holds, and a
link-following walk.

Each probe `<name>(device)` launches its kernel (csrc/probes.cu) on a CUDA
device and runs `plain_<name>(device)` on the CPU; inputs are built as the
tool builds them. `smem_input` takes the table's row count as well (and
runs on seeded_smem_tab's tables too), and `while_walk_smem` may take the
name of a seeded link table (LINK_TABLES, CYCLIC_TABLES), walked over
seeded rays.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernel import Probe, bag_sum_call

F32, I32 = torch.float32, torch.int32
TOOL = "tools/probe_mosaic.py"
# The table sizes the tool tries: 32 KiB, 256 KiB, 1 MiB and 4 MiB.
SMEM_ROWS = (1024, 8192, 32768, 131072)


def _tab(device):
    return torch.arange(64 * 128, dtype=F32, device=device).reshape(64, 128)


def _in_order(vals: torch.Tensor) -> torch.Tensor:
    """0.0 plus each value in turn, in float32: the probes' fori_loop sums."""
    acc = torch.zeros((), dtype=F32, device=vals.device)
    for v in vals:
        acc = acc + v
    return acc.reshape(1, 1)


# Row of seeded_tab whose column 5 and a seeded quarter of whose lanes hold
# -0.0: the first row each seeded index set reads.
NEG_ZERO_ROW = 17


def seeded_tab(device="cpu") -> torch.Tensor:
    """A (64, 128) float32 table of seeded normal values (both signs, full
    mantissas) in place of the tools' arange, with -0.0 at column 5 and a
    seeded quarter of the lanes of row NEG_ZERO_ROW; for the tests of
    vmem_dyn_sublane_static_lane and dyn_row_vector_read on the card and
    here."""
    g = np.random.default_rng(18)
    t = g.standard_normal((64, 128)).astype(np.float32)
    t[NEG_ZERO_ROW, g.random(128) < 0.25] = -0.0
    t[NEG_ZERO_ROW, 5] = -0.0
    return torch.from_numpy(t).to(device)


def seeded_index_sets(length: int, sets: int = 128, device="cpu") -> torch.Tensor:
    """`sets` seeded (1, length) int32 index sets into seeded_tab's rows:
    each starts at NEG_ZERO_ROW and repeats its second index at its end;
    set 0 reads NEG_ZERO_ROW alone (its sums are zeros, whose sign is the
    starting value's), set 1 starts, after NEG_ZERO_ROW, with rows 0 and 63."""
    idx = np.random.default_rng(length).integers(0, 64, (sets, 1, length)).astype(np.int32)
    idx[:, 0, 0] = NEG_ZERO_ROW
    idx[1, 0, 1:3] = (0, 63)
    idx[:, 0, -1] = idx[:, 0, 1]
    idx[0] = NEG_ZERO_ROW
    return torch.from_numpy(idx).to(device)


def _dyn_sublane_inputs(device):
    return _tab(device), torch.arange(16, dtype=I32, device=device).reshape(1, 16)


def _dyn_sublane(tab, idx):
    return _in_order(tab[idx[0].long(), 5])


vmem_dyn_sublane_static_lane = Probe(
    "vmem_dyn_sublane_static_lane", "probe_vmem_dyn_sublane_static_lane", f"{TOOL}:34",
    _dyn_sublane_inputs, _dyn_sublane, (1, 1),
    work=lambda ins: (16 * 4 + 16 * 4 + 4, 16),
    library=lambda ins: bag_sum_call(ins[0].view(-1, 1), ins[1].reshape(-1).long() * 128 + 5))
plain_vmem_dyn_sublane_static_lane = vmem_dyn_sublane_static_lane.plain


def _dyn_lane_inputs(device):
    return _tab(device), torch.tensor([[7]], dtype=I32, device=device)


def _dyn_lane(tab, idx):
    return tab[3][idx[0].long()].reshape(1, 1)


def _dyn_lane_call(tab, idx):
    index = idx.reshape(1).long()
    out = torch.empty(1, dtype=F32, device=tab.device)
    return lambda: torch.index_select(tab[3], 0, index, out=out).view(1, 1)


vmem_dyn_lane = Probe(
    "vmem_dyn_lane", "probe_vmem_dyn_lane", f"{TOOL}:55",
    _dyn_lane_inputs, _dyn_lane, (1, 1), work=lambda ins: (12, 0),
    library=lambda ins: _dyn_lane_call(*ins))
plain_vmem_dyn_lane = vmem_dyn_lane.plain


def _smem_inputs(device, rows):
    return (torch.arange(rows * 8, dtype=F32, device=device).reshape(rows, 8),)


def _smem_sum(tab):
    rows = tab.shape[0]
    i = torch.arange(64, device=tab.device)
    return _in_order(tab[(i * 977) % rows, i % 8])


def seeded_smem_tab(rows: int, device="cpu") -> torch.Tensor:
    """A (rows, 8) float32 table of seeded values in place of the tool's
    arange, for smem_input: both signs, full mantissas, magnitudes spread
    over 2^-24 to 2^24 (so the 64 in-order adds round, and another order of
    them gives other bits), and -0.0 at [0, 0], the first element the probe
    reads at every table size."""
    g = np.random.default_rng(rows)
    t = g.standard_normal((rows, 8)) * 2.0 ** g.integers(-24, 25, (rows, 8))
    t = t.astype(np.float32)
    t[0, 0] = -0.0
    return torch.from_numpy(t).to(device)


def _smem_call(tab):
    i = torch.arange(64, device=tab.device)
    return bag_sum_call(tab.view(-1, 1), 8 * ((977 * i) % tab.shape[0]) + i % 8)


smem_input = Probe(
    "smem_input", "probe_smem_input", f"{TOOL}:73",
    _smem_inputs, _smem_sum, (1, 1), work=lambda ins: (64 * 4 + 4, 64),
    library=lambda ins: _smem_call(ins[0]))
plain_smem_input = smem_input.plain


# Seeded link tables of the tool's size (n = 100) for while_walk_smem, by
# name: the tool's chain; a seeded permutation that visits every node; a
# walk that ends after 40 nodes, a cycle among the nodes it leaves
# unvisited; 0 -> -1 at once; a walk that ends on a link of -5.
LINK_TABLES = ("chain", "permutation", "short", "at_once", "minus5")
# Tables whose walk from 0 never ends: one that loops back into its own
# path, and one whose path reaches a link past the table (the kernel takes
# it as a link to itself). The plain version never returns on the first
# and fails on the index of the second; the kernel writes NaN.
CYCLIC_TABLES = ("cycle", "past")
LINK_NODES = 100


def link_table(device="cpu", name: str = "chain") -> torch.Tensor:
    """A (100, 1) int32 link table of LINK_TABLES or CYCLIC_TABLES."""
    n = LINK_NODES
    g = np.random.default_rng(19 + (LINK_TABLES + CYCLIC_TABLES).index(name))
    links = g.integers(0, n, n).astype(np.int32)  # where no walk from 0 goes
    rest = 1 + g.permutation(n - 1)
    if name == "chain":
        links = np.append(np.arange(1, n), -1).astype(np.int32)
    elif name == "at_once":
        links[0] = -1
    else:
        visits = {"permutation": n - 1, "short": 39, "minus5": 69, "cycle": 29, "past": 49}[name]
        path = np.concatenate([[0], rest[:visits]])
        links[path[:-1]] = path[1:]
        links[path[-1]] = {"permutation": -1, "short": -1, "minus5": -5, "cycle": path[10],
                           "past": n}[name]
        if name == "short":  # the unvisited nodes, one cycle
            left = rest[visits:]
            links[left] = np.roll(left, -1)
    return torch.from_numpy(links.reshape(n, 1)).to(device)


def seeded_rays(device="cpu") -> torch.Tensor:
    """(8, 128) float32 seeded normal values (both signs, full mantissas) in
    place of the tool's ones, with -0.0 at a seeded eighth of the elements:
    the first add (cursor 0) makes those +0.0, and every later add rounds,
    so the order of the adds shows in the result."""
    g = np.random.default_rng(27)
    r = g.standard_normal((8, 128)).astype(np.float32)
    r[g.random((8, 128)) < 0.125] = -0.0
    return torch.from_numpy(r).to(device)


def _walk_inputs(device, table=None):
    if table is not None:
        return link_table(device, table), seeded_rays(device)
    links = torch.cat([torch.arange(1, 100, dtype=I32, device=device),
                       torch.tensor([-1], dtype=I32, device=device)]).reshape(100, 1)
    return links, torch.ones((8, 128), dtype=F32, device=device)


def walk_cursors(links) -> list:
    """The cursors the walk adds (those whose successor is >= 0), in order;
    the links are scalar memory, read on the host."""
    nxt = links[:, 0].tolist()
    added, cur = [], 0
    while cur >= 0:
        if nxt[cur] >= 0:
            added.append(cur)
        cur = nxt[cur]
    return added


def _walk(links, rays):
    out = rays.clone()
    for cur in walk_cursors(links):
        out = out + cur
    return out


def _walk_work(ins):
    steps = len(walk_cursors(ins[0]))
    return (4 * (steps + 1) + 2 * ins[1].numel() * 4, steps * ins[1].numel())


while_walk_smem = Probe(
    "while_walk_smem", "probe_while_walk_smem", f"{TOOL}:89",
    _walk_inputs, _walk, (8, 128), work=_walk_work)
plain_while_walk_smem = while_walk_smem.plain

PROBES = (vmem_dyn_sublane_static_lane, vmem_dyn_lane, smem_input, while_walk_smem)
