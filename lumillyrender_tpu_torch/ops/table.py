"""Small-table row selection.

The JAX package selects rows of its small tables (materials, lights,
spheres) by a one-hot compare-and-sum, because a per-lane gather is slow on
its hardware. An indexed read is the plain form here; both give the row
values (the one-hot sum of one row and zeros is exact).

The gather's gradient adds each lane's cotangent row into its table row.
Autograd's own backward of an indexed read is `index_put_(accumulate=True)`,
which on CUDA sorts the indices and adds each row's run of lanes serially:
on a table of a few rows a run holds most of the lanes (753,664 lanes into
2 rows took 77.6 ms on an H100, PERF.md §6.14). `index_add_` adds with
atomics, in an order that changes between runs. So on CUDA a table that
requires grad is read through `_TakeRows`, whose backward (`scatter_rows`)
splits the lanes into blocks, adds each block's runs as index_put_ does,
and sums the blocks' partial tables in a fixed order: the same gradient
every run, no run longer than a block. On the CPU the read is plain
indexing and its gradient autograd's own.
"""

from __future__ import annotations

import math

import torch

# Lanes a block of `scatter_rows` adds into its partial table, and the
# largest partial table (elements); a table of many rows takes fewer,
# longer blocks (its runs are shorter).
SCATTER_BLOCK = 256
SCATTER_PARTIAL = 1 << 22


def scatter_rows(idx: torch.Tensor, rows: torch.Tensor, m: int) -> torch.Tensor:
    """The (m, *rows.shape[1:]) table whose row r is the sum of the `rows`
    at the lanes where `idx` (int64, in [0, m)) is r: index_put_ with
    accumulate over blocks of SCATTER_BLOCK lanes, then the sum over the
    blocks. Deterministic: each block adds its runs in lane order, and the
    sum over blocks has a fixed order."""
    n = idx.shape[0]
    width = math.prod(rows.shape[1:])
    blocks = min(-(-n // SCATTER_BLOCK), max(1, SCATTER_PARTIAL // max(m * width, 1)))
    out = torch.zeros((max(blocks, 1), m) + tuple(rows.shape[1:]), dtype=rows.dtype,
                      device=rows.device)
    block = torch.arange(n, device=idx.device) // max(-(-n // max(blocks, 1)), 1)
    return out.index_put_((block, idx), rows, accumulate=True).sum(dim=0)


class _TakeRows(torch.autograd.Function):
    """`table[idx]` whose backward is `scatter_rows`."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return scatter_rows(idx, g.contiguous(), ctx.rows), None


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of `table` ((M,) or (M, C)) at `idx`, clamped to [0, M)."""
    m = table.shape[0]
    i = torch.clamp(idx.long(), 0, m - 1)
    if table.requires_grad and table.device.type == "cuda":
        return _TakeRows.apply(table, i)
    return table[i]
