"""The probes of the JAX package's `tools/pallas_probe.py`: gathers, a
one-hot product, in-kernel random bits, loops with vector state, a
scatter-add, the packet-walk core, reductions and scalar reads.

Each probe `<name>(device)` launches its kernel (csrc/probes.cu) on a CUDA
device and runs `plain_<name>(device)` on the CPU; inputs are built as the
tool's `main` builds them (M, S, L = 2048, 8, 128; `table` (M, L) and
`table8` (M, 8) float32 aranges, `idx` = 7 k % M over (S, L), `idx_flat` =
13 k % M over (L,)).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import rng
from .kernel import Probe, bag_sum_call

F32, I32 = torch.float32, torch.int32
M, S, L = 2048, 8, 128
TOOL = "tools/pallas_probe.py"


def _table(device):
    return torch.arange(M * L, dtype=F32, device=device).reshape(M, L)


def _table8(device):
    return torch.arange(M * 8, dtype=F32, device=device).reshape(M, 8)


def _idx(device):
    return (torch.arange(S * L, dtype=I32, device=device).reshape(S, L) * 7) % M


def _idx_flat(device):
    return (torch.arange(L, dtype=I32, device=device) * 13) % M


def _rows_bcast(row: torch.Tensor) -> torch.Tensor:
    """A (L,) row broadcast to a contiguous (S, L) tile."""
    return row.reshape(1, -1).expand(S, -1).contiguous()


def _full(v: torch.Tensor) -> torch.Tensor:
    """A one-element tensor broadcast to a contiguous (S, L) tile."""
    return v.reshape(1, 1).expand(S, L).contiguous()


_OUT = S * L * 4  # bytes of an (S, L) float32 output


def _distinct_bytes(positions: torch.Tensor) -> int:
    """Bytes of the distinct float32 elements at `positions`: what a gather
    must read of its table."""
    return 4 * torch.unique(positions).numel()


# --- take_along_axis axis0: out[i, j] = table[idx_full[i, j], j] ---------


def jax_rows(i: torch.Tensor, rows: int) -> tuple:
    """JAX's index rule for a gather over `rows` rows, as `jnp.take` and
    `jnp.take_along_axis` apply it by default: an index in [-rows, 0) reads
    row i + rows, one in [0, rows) row i, and any other gives NaN. Returns
    (the int64 row to read, clamped into the table, and where the index is
    in range)."""
    i = i.long()
    i = torch.where(i < 0, i + rows, i)
    ok = (i >= 0) & (i < rows)
    return i.clamp(0, rows - 1), ok


def _nan_where_out(got: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """`got` with NaN (bits 0x7fc00000, JAX's fill) where `ok` is false."""
    return torch.where(ok, got, torch.full_like(got, float("nan")))


def _take_along0(t, i):
    row, ok = jax_rows(i, t.shape[0])
    return _nan_where_out(torch.gather(t, 0, row), ok)


def _gather_call(t, dim, index):
    out = torch.empty(index.shape, dtype=t.dtype, device=t.device)
    return lambda: torch.gather(t, dim, index, out=out)


def _axis0_inputs(device):
    rows = torch.arange(M, dtype=I32, device=device)[:, None] * 7
    lanes = torch.arange(L, dtype=I32, device=device)[None, :]
    return _table(device), (rows + lanes) % M


take_along_axis_axis0 = Probe(
    "take_along_axis_axis0", "take_along_axis axis0 full-shape (M,L)[idx (M,L)]",
    f"{TOOL}:53", _axis0_inputs, _take_along0, (M, L),
    # Row (7 i + j) % M over i covers every row: the whole table is read.
    work=lambda ins: (3 * M * L * 4, 0),
    library=lambda ins: _gather_call(ins[0], 0, ins[1].long()))
plain_take_along_axis_axis0 = take_along_axis_axis0.plain

# --- take_along_axis axis1: out[s, l] = table[s, idx[s, l] % L] ----------

take_along_axis_axis1 = Probe(
    "take_along_axis_axis1", "take_along_axis axis1 lane-lookup (S,L)[idx (S,L)]",
    f"{TOOL}:67", lambda device: (_table(device)[:S], _idx(device)),
    lambda t, i: torch.gather(t, 1, (i % L).long()), (S, L),
    work=lambda ins: (_distinct_bytes(
        torch.arange(S, device=ins[1].device)[:, None] * L + ins[1] % L) + 2 * _OUT, 0),
    library=lambda ins: _gather_call(ins[0], 1, (ins[1] % L).long()))
plain_take_along_axis_axis1 = take_along_axis_axis1.plain

# --- jnp.take rowgather: out = table8[idx_flat] ---------------------------


def _index_select_call(t, index):
    out = torch.empty((index.shape[0], t.shape[1]), dtype=t.dtype, device=t.device)
    return lambda: torch.index_select(t, 0, index, out=out)


def _take_rows(t, i):
    row, ok = jax_rows(i, t.shape[0])
    return _nan_where_out(torch.index_select(t, 0, row), ok[:, None])


take_rowgather = Probe(
    "take_rowgather", "jnp.take axis0 rowgather (M,8)[idx (L,)]", f"{TOOL}:76",
    lambda device: (_table8(device), _idx_flat(device)), _take_rows, (L, 8),
    work=lambda ins: (_distinct_bytes(ins[1][:, None] * 8 + torch.arange(
        8, device=ins[1].device)) + L * 4 + L * 32, 0),
    library=lambda ins: _index_select_call(ins[0], ins[1]))
plain_take_rowgather = take_rowgather.plain


def seeded_rows(device="cpu") -> torch.Tensor:
    """128 int32 row indices into table8, drawn from a numpy seed, with its
    first row and its last: rows that the tool's `idx_flat` (13 k % M) never
    reaches, for the tests of take_rowgather, onehot_matmul_gather,
    ref_ds_row_read and scalar_broadcast on the card and here."""
    idx = np.random.default_rng(6).integers(0, M, L).astype(np.int32)
    idx[0], idx[-1] = 0, M - 1
    return torch.from_numpy(idx).to(device)


# Seeded int32 index sets for the gathers take_along_axis_axis0 ((M, L))
# and take_rowgather ((L,)), by name: seeded in [0, M) with rows 0 and
# M - 1; seeded in [-M, 0) with -M and -1, which wrap; seeded in [-M, M)
# with a quarter past the table (M, -M - 1, 5000, far values, int32's
# ends); every index past the table (all NaN).
INDEX_SETS = ("in_range", "negatives", "mixed", "outside")
INT32_MIN, INT32_MAX = -2**31, 2**31 - 1
_OUTSIDE = np.array([M, -M - 1, 5000, -5000, 2**20, -2**30, INT32_MAX, INT32_MIN])


def index_set(name: str, shape: tuple, device="cpu") -> torch.Tensor:
    """An int32 index set of INDEX_SETS of `shape` into M rows, its edges
    first (in flat order)."""
    g = np.random.default_rng(30 + INDEX_SETS.index(name) + 10 * len(shape))
    if name == "in_range":
        idx, edges = g.integers(0, M, shape), (0, M - 1)
    elif name == "negatives":
        idx, edges = g.integers(-M, 0, shape), (-M, -1)
    elif name == "mixed":
        idx = g.integers(-M, M, shape)
        out = g.random(shape) < 0.25
        idx[out] = g.choice(_OUTSIDE, out.sum())
        edges = (0, M - 1, -1, -M, M, -M - 1, INT32_MIN, INT32_MAX)
    else:
        idx = np.where(g.random(shape) < 0.5, g.integers(M, INT32_MAX, shape, endpoint=True),
                       g.integers(INT32_MIN, -M - 1, shape, endpoint=True))
        edges = (M, -M - 1, INT32_MIN, INT32_MAX)
    idx = idx.astype(np.int32)
    idx.reshape(-1)[:len(edges)] = edges
    return torch.from_numpy(idx).to(device)


def take_along_sets(device="cpu") -> dict:
    """{name: (M, L) int32 index set} of INDEX_SETS, for take_along_axis_axis0
    on the tool's table, on the card and here."""
    return {name: index_set(name, (M, L), device) for name in INDEX_SETS}


def take_rows_sets(device="cpu") -> dict:
    """{name: (L,) int32 index set} of INDEX_SETS, for take_rowgather on the
    tool's table8, on the card and here."""
    return {name: index_set(name, (L,), device) for name in INDEX_SETS}


def seeded_table8(device="cpu") -> torch.Tensor:
    """A (M, 8) float32 table of seeded normal values: no zeros, both signs,
    full mantissas, where the tools' arange table has one zero and
    integers; for the tests of onehot_matmul_gather and scalar_broadcast."""
    t = np.random.default_rng(8).standard_normal((M, 8)).astype(np.float32)
    return torch.from_numpy(t).to(device)


# --- vmem scalar dynamic read: sum over j < 4 of table8[idx[0, j], 0] -----


def _sum4(t, i):
    acc = torch.zeros((), dtype=F32, device=t.device)
    for v in t[i[0, :4].long(), 0]:
        acc = acc + v
    return acc.reshape(1, 1)


vmem_scalar_dynamic_read = Probe(
    "vmem_scalar_dynamic_read", "vmem scalar dynamic read t_ref[i, 0]", f"{TOOL}:83",
    lambda device: (_table8(device), _idx(device).reshape(1, -1)[:, :L].contiguous()),
    _sum4, (1, 1), work=lambda ins: (4 * 4 + 4 * 4 + 4, 4),
    library=lambda ins: bag_sum_call(ins[0].view(-1, 1), ins[1][0, :4].long() * 8))
plain_vmem_scalar_dynamic_read = vmem_scalar_dynamic_read.plain

# Row of sum4_table8 whose column 0 holds -0.0: the first row each of
# sum4_sets reads.
SUM4_FIRST_ROW = 1234


def sum4_table8(device="cpu") -> torch.Tensor:
    """seeded_table8 (seeded normal values: both signs, full mantissas) with
    -0.0 at column 0 of row SUM4_FIRST_ROW; for the tests of
    vmem_scalar_dynamic_read on the card and here."""
    t = seeded_table8(device).clone()
    t[SUM4_FIRST_ROW, 0] = -0.0
    return t


def sum4_sets(sets: int = 128, device="cpu") -> torch.Tensor:
    """`sets` seeded (1, 4) int32 index sets into sum4_table8's rows, each
    starting at SUM4_FIRST_ROW: set 0 reads that row alone (its sum is
    0 + -0 + -0 + -0 + -0, +0.0), set 1 repeats row 0 and reaches the
    table's last row."""
    idx = np.random.default_rng(19).integers(0, M, (sets, 1, 4)).astype(np.int32)
    idx[:, 0, 0] = SUM4_FIRST_ROW
    idx[0] = SUM4_FIRST_ROW
    idx[1, 0, 1:] = (0, M - 1, 0)
    return torch.from_numpy(idx).to(device)

# --- ref ds-row read: table8[i, :] broadcast to (S, 8) -------------------

ref_ds_row_read = Probe(
    "ref_ds_row_read", "ref ds-row read t_ref[pl.ds(i,1), :] (scalar from SMEM)",
    f"{TOOL}:101",
    lambda device: (torch.tensor([5], dtype=I32, device=device), _table8(device)),
    lambda i, t: t[i.long()].expand(S, 8).contiguous(), (S, 8),
    work=lambda ins: (4 + 32 + S * 8 * 4, 0),
    library=lambda ins: _index_select_call(ins[1], ins[0].long().expand(S).contiguous()))
plain_ref_ds_row_read = ref_ds_row_read.plain

# --- one-hot matmul gather: onehot(idx_flat, M) @ table8 -----------------


def _onehot(i):
    return (torch.arange(M, device=i.device)[None, :] == i[:, None]).to(F32)


def _matmul_call(t, i):
    oh = _onehot(i)
    out = torch.empty((L, 8), dtype=F32, device=t.device)
    return lambda: torch.matmul(oh, t, out=out)


onehot_matmul_gather = Probe(
    "onehot_matmul_gather", "one-hot matmul gather (S*L onehot @ table8)", f"{TOOL}:117",
    lambda device: (_table8(device), _idx_flat(device)),
    lambda t, i: _onehot(i) @ t, (L, 8),
    work=lambda ins: (ins[0].numel() * 4 + L * 4 + L * 32, 2 * L * M * 8),
    library=lambda ins: _matmul_call(ins[0], ins[1]))
plain_onehot_matmul_gather = onehot_matmul_gather.plain

# --- prng_random_bits: pcg4d in place of the TPU's generator --------------


def _prng(seed):
    """(S, L) int32 random bits >> 8 (arithmetic), as float32: the first
    word of the port's pcg4d (ops/rng.py) on the counters (lane = flat
    index, ctr = 0, seed, the renderer's salt). This replaces the TPU's
    hardware generator (`pltpu.prng_random_bits`) and does not reproduce its
    bits; no CPU can."""
    dev = seed.device
    lane = torch.arange(S * L, dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    salt = torch.tensor(rng._SALT, dtype=torch.int64, device=dev)
    w = rng.pcg4d(lane, zero, rng.as_u32(seed[0]), salt)[0]
    signed = torch.where(w >= 2**31, w - 2**32, w)
    return (signed >> 8).to(F32).reshape(S, L)


prng_random_bits = Probe(
    "prng_random_bits", "pltpu.prng_random_bits (S,L)", f"{TOOL}:130",
    lambda device: (torch.tensor([42], dtype=I32, device=device),), _prng, (S, L),
    work=lambda ins: (4 + _OUT, 35 * S * L))
plain_prng_random_bits = prng_random_bits.plain

# --- while_loop with vector state: ten times acc += table[0:S] ------------


def _ten_adds(t):
    x = t[:S]
    acc = torch.zeros((S, L), dtype=F32, device=t.device)
    for _ in range(10):
        acc = acc + x
    return acc


while_loop_vector_state = Probe(
    "while_loop_vector_state", "while_loop with vector state in kernel", f"{TOOL}:144",
    lambda device: (_table(device),), _ten_adds, (S, L),
    work=lambda ins: (2 * _OUT, 10 * S * L))
plain_while_loop_vector_state = while_loop_vector_state.plain

# --- scatter-add: zeros (M, L) + 1.0 at (idx, 0), rows 0:S ---------------


def _scatter(t, i):
    """JAX's `.at[i, 0].add(1.0)`: an index in [-M, 0) stands for row
    i + M; one outside [-M, M) is dropped (index_put_ would raise on it)."""
    flat = i.reshape(-1).long()
    flat = torch.where(flat < 0, flat + M, flat)
    flat = flat[(flat >= 0) & (flat < M)]
    buf = torch.zeros((M, L), dtype=F32, device=t.device)
    buf.index_put_((flat, torch.zeros_like(flat)),
                   torch.ones(flat.shape, dtype=F32, device=t.device), accumulate=True)
    return buf[:S].clone()


# Seeded (S, L) int32 index sets for scatter_add, by name: the tool's; all
# 1,024 in rows 0-7 (row 5 more than half of them); seeded in [0, M) with
# repeats; negatives in [-M, -M + 8) mixed with rows 0-7, -1 and M - 1;
# none in rows 0-7 (every output +0.0); seeded in [-M, M) with indices
# past the table (M, 5000, -M - 1 and int32's ends), which JAX drops.
SCATTER_SETS = ("tool", "low_rows", "seeded", "negatives", "none", "dropped")


def scatter_set(name: str, device="cpu") -> torch.Tensor:
    """An (S, L) int32 index set of SCATTER_SETS."""
    if name == "tool":
        return _idx(device)
    g = np.random.default_rng(20 + SCATTER_SETS.index(name))
    if name == "low_rows":
        idx = g.integers(0, S, (S, L))
        idx[g.random((S, L)) < 0.6] = 5
    elif name == "seeded":
        idx = g.integers(0, M, (S, L))
        idx[0, :6] = (0, 0, 7, 3, 3, 3)
    elif name == "negatives":
        idx = g.choice(np.r_[-M:-M + S, 0:S, -1, M - 1], (S, L))
    elif name == "none":
        idx = np.where(g.random((S, L)) < 0.5, g.integers(S, M, (S, L)),
                       g.integers(-M + S, 0, (S, L)))
    else:
        idx = g.integers(-M, M, (S, L))
        out = g.random((S, L)) < 0.25
        idx[out] = g.choice([M, 5000, -M - 1, 2**31 - 1, -2**31], out.sum())
        idx[0, :4] = (0, -M, M, -M - 1)
    return torch.from_numpy(idx.astype(np.int32)).to(device)


def _index_put_call(t, i):
    buf = torch.zeros((M, L), dtype=F32, device=t.device)
    flat = i.reshape(-1).long()
    where = (flat, torch.zeros_like(flat))
    ones = torch.ones(flat.shape, dtype=F32, device=t.device)

    def call():
        buf.zero_()
        return buf.index_put_(where, ones, accumulate=True)[:S]
    return call


scatter_add = Probe(
    "scatter_add", "scatter-add o_ref[idx] += v (per-lane)", f"{TOOL}:162",
    lambda device: (_table(device), _idx(device)), _scatter, (S, L),
    work=lambda ins: (ins[1].numel() * 4 + _OUT, ins[1].numel()),
    library=lambda ins: _index_put_call(*ins))
plain_scatter_add = scatter_add.plain

# --- packet-walk core: a uniform cursor steered by an any-vote -----------


def walk_path(t) -> list:
    """The packet-walk core's cursors, in order: from 0, +7 after a row with
    any lane above 0.5 M L, else +1, until the cursor reaches M."""
    hit = (t > 0.5 * (M * L)).any(dim=1).tolist()
    path, cur = [], 0
    while cur >= 0:
        path.append(cur)
        nxt = cur + 7 if hit[cur] else cur + 1
        cur = -1 if nxt >= M else nxt
    return path


def _walk(t):
    acc = torch.zeros(L, dtype=F32, device=t.device)
    for cur in walk_path(t):
        acc = acc + t[cur]
    return _rows_bcast(acc)


# Rows a tile of the packet-walk kernel (csrc/probes.cu, kWalkTile): the
# seeded tables put votes at its edges.
WALK_TILE = 32
WALK_TABLES = ("none", "all", "edges", "scattered")


def walk_votes(pattern: str) -> np.ndarray:
    """The rows that vote in seeded walk table `pattern` (see `walk_table`)."""
    rows = np.arange(M)
    if pattern == "none":
        return rows[:0]
    if pattern == "all":
        return rows
    if pattern == "edges":
        # Each tile's first row, one of its last 7 (so a +7 lands at offsets
        # 0-6 of the next tile), and the table's last 7 rows.
        tile = rows[::WALK_TILE]
        late = tile + WALK_TILE - 7 + (tile // WALK_TILE) % 7
        return np.unique(np.concatenate([tile, late, rows[-7:]]))
    if pattern == "scattered":
        return rows[np.random.default_rng(14).random(M) < 0.1]
    raise ValueError(f"no walk table {pattern!r}; one of {WALK_TABLES}")


def walk_table(device="cpu", pattern: str | None = None) -> torch.Tensor:
    """The packet-walk core's table: the tool's arange for pattern None, else
    a seeded (M, L) float32 table whose rows `walk_votes(pattern)` vote:
    "none" (M steps of +1), "all" (+7 from row 0), "edges", "scattered" (a
    seeded tenth of the rows). Values are seeded uniforms in (-T/4, T), T =
    0.5 M L the vote's threshold: both signs, full mantissas, so every add
    rounds and the sums pass 2^24, and the order of the adds shows in the
    result; a voting row has one seeded lane at T + (1 .. 2^20)."""
    if pattern is None:
        return _table(device)
    thresh = 0.5 * (M * L)
    g = np.random.default_rng(WALK_TABLES.index(pattern) + 20)
    t = g.uniform(-thresh / 4, thresh, (M, L)).astype(np.float32)
    votes = walk_votes(pattern)
    t[votes, g.integers(0, L, votes.size)] = (
        thresh + g.uniform(1.0, 2.0**20, votes.size)).astype(np.float32)
    return torch.from_numpy(t).to(device)


packet_walk_core = Probe(
    "packet_walk_core", "packet-walk core: SMEM cursor while_loop + dyn-slice + any()",
    f"{TOOL}:171", lambda device, pattern=None: (walk_table(device, pattern),), _walk, (S, L),
    work=lambda ins: (len(walk_path(ins[0])) * L * 4 + _OUT,
                      2 * len(walk_path(ins[0])) * L))
plain_packet_walk_core = packet_walk_core.plain

# --- wide 2D ops + argmin: min over axis 0 of (16, 256), plus its argmin --


def _min_argmin(x):
    v, i = torch.min(x, dim=0)
    return (v + i.to(F32)).reshape(1, 256)


wide_2d_argmin = Probe(
    "wide_2d_argmin", "wide 2D ops (16, 256) + argmin", f"{TOOL}:197",
    lambda device: (torch.arange(16 * 256, dtype=F32, device=device).reshape(16, 256),),
    _min_argmin, (1, 256), work=lambda ins: (16 * 256 * 4 + 256 * 4, 2 * 16 * 256))
plain_wide_2d_argmin = wide_2d_argmin.plain

# --- scalar broadcast from a VMEM element: table8[i, 3] ------------------


def _take_call(t, index):
    """torch.take of `t` at the flat positions `index` (S, L)."""
    out = torch.empty((S, L), dtype=F32, device=t.device)
    return lambda: torch.take(t, index, out=out)


scalar_broadcast = Probe(
    "scalar_broadcast", "scalar broadcast from VMEM element t_ref[i, j]", f"{TOOL}:210",
    lambda device: (torch.tensor([5], dtype=I32, device=device), _table8(device)),
    lambda i, t: _full(t[i.long(), 3]), (S, L),
    work=lambda ins: (8 + _OUT, 0),
    library=lambda ins: _take_call(ins[1], (ins[0].long() * 8 + 3).expand(S, L).contiguous()))
plain_scalar_broadcast = scalar_broadcast.plain

# --- dynamic row and lane scalar read: table[i[0], i[1]] -----------------

dynamic_row_lane_scalar = Probe(
    "dynamic_row_lane_scalar", "dynamic ROW+LANE scalar read t_ref[i, j] (both traced)",
    f"{TOOL}:226",
    lambda device: (torch.tensor([3, 77], dtype=I32, device=device), _table(device)),
    lambda i, t: _full(t[i[0].long(), i[1].long()]), (S, L),
    work=lambda ins: (12 + _OUT, 0),
    library=lambda ins: _take_call(
        ins[1], (ins[0][0].long() * L + ins[0][1]).expand(S, L).contiguous()))
plain_dynamic_row_lane_scalar = dynamic_row_lane_scalar.plain

# --- while_loop + pl.when: even rows c < 20 whose vote passes, in order ---


def _when_loop(t):
    hit = (t[:20] > -1.0).any(dim=1).tolist()
    acc = torch.zeros(L, dtype=F32, device=t.device)
    for c in range(20):
        if hit[c % M] and c % 2 == 0:
            acc = acc + t[c % M]
    return _rows_bcast(acc)


while_loop_when = Probe(
    "while_loop_when", "while_loop(scalar carry) mutating out_ref via pl.when",
    f"{TOOL}:243", lambda device: (_table(device),), _when_loop, (S, L),
    work=lambda ins: (20 * L * 4 + _OUT, 30 * L))
plain_while_loop_when = while_loop_when.plain

# --- int32 bit ops: rotl(uint32(int32(x)), 13) >> 8 ----------------------


def _bit_ops(x):
    u = x.to(I32).to(torch.int64) & 0xFFFFFFFF
    u = ((u << 13) | (u >> 19)) & 0xFFFFFFFF
    return (u >> 8).to(F32)


int32_bit_ops = Probe(
    "int32_bit_ops", "int32 bit ops (threefry core)", f"{TOOL}:265",
    lambda device: (_table(device)[:S],), _bit_ops, (S, L),
    work=lambda ins: (2 * _OUT, 6 * S * L))
plain_int32_bit_ops = int32_bit_ops.plain

PROBES = (take_along_axis_axis0, take_along_axis_axis1, take_rowgather,
          vmem_scalar_dynamic_read, ref_ds_row_read, onehot_matmul_gather,
          prng_random_bits, while_loop_vector_state, scatter_add, packet_walk_core,
          wide_2d_argmin, scalar_broadcast, dynamic_row_lane_scalar, while_loop_when,
          int32_bit_ops)
