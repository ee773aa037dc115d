"""The port's capability probes (lumillyrender_tpu_torch/probes/) against
the JAX package's Mosaic probes (tools/probe_mosaic.py, tools/pallas_probe.py,
tools/probe_wide.py), run in interpret mode on the CPU.

Every plain version is bit-equal to its JAX probe on the same inputs
(tolerance 0: the sums add in the probes' loop order, one row at a time).
`pltpu.prng_random_bits` has no CPU lowering; its counterpart draws the
port's pcg4d instead and is held bit for bit against the JAX package's
pcg4d on the same counters. The kernels themselves are held against the
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py
phase 20).
"""

import functools
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lumillyrender_tpu.ops import rng as jax_rng
from lumillyrender_tpu_torch import probes
from lumillyrender_tpu_torch.probes import mosaic
from lumillyrender_tpu_torch.probes.__main__ import main, smem_input_sum

REPO = Path(__file__).resolve().parents[1]
_PALLAS_CALL = pl.pallas_call

# Every probe that runs in interpret mode, smem_input at its four sizes.
CASES = [(tag, p.name, params) for tag, p, params in probes.cases()
         if p.name != "prng_random_bits"]


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(f"_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_probes():
    """label -> the JAX probe (a function of the probe's params)."""
    found = {}
    mos, wid, pal = (_load_tool(n) for n in ("probe_mosaic", "probe_wide", "pallas_probe"))
    for mod in (mos, wid):
        found.update({k: v for k, v in vars(mod).items() if k.startswith("probe_")})

    def collect(name):
        def deco(fn):
            found[name] = fn
            return fn
        return deco

    pal.probe = collect  # main() decorates each probe's closure with `probe`
    pal.main()
    return found


@pytest.mark.parametrize("tag,name,params", CASES, ids=[c[0] for c in CASES])
def test_plain_probe_matches_jax_probe(jax_probes, monkeypatch, tag, name, params):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(_PALLAS_CALL, interpret=True))
    probe = next(p for p in probes.PROBES if p.name == name)
    want = np.asarray(jax_probes[probe.label](*params))
    got = probe.plain("cpu", *params)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    # On the CPU the wrapper is the plain version and launches nothing.
    assert torch.equal(probe("cpu", *params), got) and probe.launches == 0


def test_prng_counterpart_is_pcg4d_of_the_jax_package():
    got = probes.pallas.plain_prng_random_bits("cpu")
    lane = jnp.arange(8 * 128, dtype=jnp.uint32)
    word = jax_rng.pcg4d(lane, jnp.uint32(0), jnp.uint32(42), jnp.uint32(0xB5297A4D))[0]
    want = (np.asarray(word).view(np.int32) >> 8).astype(np.float32).reshape(8, 128)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert (want < 0).any() and (want > 0).any()  # the shift is arithmetic


def test_smem_input_split_and_refusal():
    """smem_input runs at each of its tool's four table sizes (its kernel
    reads the table from L2 and stages nothing, so no size is refused for
    its shared memory), each plain sum its exact value; an entry's error,
    cudaErrorInvalidValue (1) among them, is a failed launch."""
    smem = mosaic.smem_input
    assert [tag for tag, p, _ in probes.cases() if p is smem] == [
        f"smem_input({rows})" for rows in probes.SMEM_ROWS]
    for rows in probes.SMEM_ROWS:
        assert mosaic.plain_smem_input("cpu", rows).item() == smem_input_sum(rows)
    smem.check(0)
    for rc in (1, 2):
        with pytest.raises(RuntimeError, match=f"CUDA error {rc}"):
            smem.check(rc)


def _numpy_smem_sum(t: np.ndarray, order=range(64)) -> np.ndarray:
    """smem_input in numpy, written from the tool's kernel
    (tools/probe_mosaic.py:74-78): from float32 0, t[(977 i) % rows, i % 8]
    for i < 64 in turn (in `order`)."""
    acc = np.float32(0.0)
    for i in order:
        acc = np.float32(acc + t[(i * 977) % t.shape[0], i % 8])
    return np.full((1, 1), acc, np.float32)


def test_seeded_smem_tabs():
    """smem_input's seeded tables: (rows, 8) at each table size, both
    signs, full mantissas, magnitudes over many powers of 2, -0.0 at [0, 0]
    (the first element read); another order of the 64 adds gives other
    bits at some size."""
    differs = False
    for rows in probes.SMEM_ROWS:
        t = mosaic.seeded_smem_tab(rows).numpy()
        assert t.shape == (rows, 8) and t.dtype == np.float32
        assert (t < 0).any() and (t > 0).any()
        assert (t.view(np.int32) & 0xFFFF != 0).mean() > 0.99
        e = np.log2(np.abs(t[t != 0]))
        assert e.max() - e.min() > 40
        assert t[0, 0] == 0 and np.signbit(t[0, 0])
        want = _numpy_smem_sum(t)
        differs |= bool((_numpy_smem_sum(t, reversed(range(64))).view(np.int32)
                         != want.view(np.int32)).any())
    assert differs


@pytest.mark.parametrize("rows", probes.SMEM_ROWS)
def test_smem_plain_version_is_numpy_sum_on_seeded_tabs(rows):
    """The plain version the smem_input kernel is held against on the
    card, bit for bit against numpy's in-order float32 sum on the seeded
    table of each size; its embedding_bag call with it."""
    probe = mosaic.smem_input
    tab = mosaic.seeded_smem_tab(rows)
    got = probe.compute(tab)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 1)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  _numpy_smem_sum(tab.numpy()).view(np.int32))
    assert probe.library_agrees((tab,))
    # The sum starts from +0.0: on a table of -0.0 it is +0.0.
    zeros = probe.compute(torch.full_like(tab, -0.0))
    assert zeros.item() == 0 and not np.signbit(zeros.numpy()).any()


def _numpy_scatter(idx: np.ndarray) -> np.ndarray:
    """scatter_add in numpy: np.add.at of 1.0 into column 0 of float32
    zeros (2048, 128), rows 0:8; an index in [-2048, 0) taken as i + 2048,
    one outside [-2048, 2048) dropped, as JAX's scatter does."""
    i = idx.reshape(-1).astype(np.int64)
    i = np.where(i < 0, i + 2048, i)
    i = i[(i >= 0) & (i < 2048)]
    buf = np.zeros((2048, 128), np.float32)
    np.add.at(buf, (i, 0), np.float32(1.0))
    return buf[:8]


def test_scatter_sets():
    """scatter_add's seeded index sets: (8, 128) int32 each; the tool's;
    one all in rows 0-7 with a row past 512 hits; one with repeats and
    hits; negatives that wrap onto rows 0-7; one with no hit (+0.0
    everywhere); one with indices past the table, which are dropped."""
    sets = {name: probes.pallas.scatter_set(name).numpy() for name in probes.pallas.SCATTER_SETS}
    assert all(s.shape == (8, 128) and s.dtype == np.int32 for s in sets.values())
    np.testing.assert_array_equal(sets["tool"], probes.pallas.scatter_add.inputs("cpu")[1])
    counts = {name: _numpy_scatter(s)[:, 0] for name, s in sets.items()}
    assert ((sets["low_rows"] >= 0) & (sets["low_rows"] < 8)).all()
    assert counts["low_rows"].max() > 512 and counts["low_rows"].sum() == 1024
    assert np.unique(sets["seeded"]).size < 1024 and counts["seeded"].sum() > 0
    neg = sets["negatives"]
    assert {-2048, -2041, -1, 2047} <= set(neg.ravel().tolist())
    assert counts["negatives"].sum() == ((neg >= -2048) & (neg < -2040)).sum() + (
        (neg >= 0) & (neg < 8)).sum()
    assert not counts["none"].any() and (sets["none"] < 0).any()
    d = sets["dropped"]
    assert {2048, 5000, -2049, 2**31 - 1, -2**31} <= set(d.ravel().tolist())
    assert counts["dropped"].any()


@pytest.mark.parametrize("name", probes.pallas.SCATTER_SETS)
def test_scatter_plain_version_matches_numpy_and_jax(name):
    """The plain version the scatter_add kernel is held against on the
    card, bit for bit against np.add.at and against JAX's
    zeros((2048, 128)).at[idx, 0].add(1.0)[:8] on each seeded index set:
    negative indices wrap, indices past the table are dropped."""
    probe = probes.pallas.scatter_add
    idx = probes.pallas.scatter_set(name)
    got = probe.compute(probe.inputs("cpu")[0], idx)
    assert got.dtype == torch.float32 and tuple(got.shape) == (8, 128)
    want = _numpy_scatter(idx.numpy())
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    jax_out = jnp.zeros((2048, 128), jnp.float32).at[jnp.asarray(idx.numpy()), 0].add(1.0)[:8]
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(jax_out).view(np.int32))
    assert not np.signbit(got.numpy()).any()


def test_dyn_lane_plain_version_is_numpy_indexing_at_every_lane():
    """The plain version the vmem_dyn_lane kernel is held against on the
    card, at each lane index 0..127 of row 3."""
    probe = mosaic.vmem_dyn_lane
    tab, _ = probe.inputs("cpu")
    want = tab.numpy()[3]
    for lane in range(128):
        got = probe.compute(tab, torch.tensor([[lane]], dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want[lane].reshape(1, 1).view(np.int32))


def test_rowgather_plain_version_is_numpy_indexing():
    """The plain version the take_rowgather kernel is held against on the
    card, on seeded rows with both ends of the table."""
    probe = probes.pallas.take_rowgather
    table8, _ = probe.inputs("cpu")
    idx = probes.pallas.seeded_rows().numpy()
    assert idx.shape == (128,) and {0, 2047} <= set(idx.tolist())
    got = probe.compute(table8, torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  table8.numpy()[idx].view(np.int32))


# The gathers' seeded index sets: the (M, L) sets of take_along_axis_axis0
# and the (L,) sets of take_rowgather, by name.
GATHER_SETS = {"take_along_axis_axis0": probes.pallas.take_along_sets,
               "take_rowgather": probes.pallas.take_rows_sets}
NAN_BITS = 0x7FC00000


def _numpy_gather(t: np.ndarray, idx: np.ndarray, name: str) -> np.ndarray:
    """The gather in numpy by JAX's index rule: an index in [-M, 0) reads row
    i + M, one outside [-M, M) gives float32 NaN; take_along_axis_axis0
    reads table[row, l] for each (m, l), take_rowgather the whole row."""
    rows = t.shape[0]
    i = idx.astype(np.int64)
    i = np.where(i < 0, i + rows, i)
    ok = (i >= 0) & (i < rows)
    r = np.where(ok, i, 0)
    if name == "take_rowgather":
        return np.where(ok[:, None], t[r], np.float32(np.nan))
    return np.where(ok, t[r, np.arange(t.shape[1])[None, :]], np.float32(np.nan))


def _jax_gather(t: np.ndarray, idx: np.ndarray, name: str) -> tuple:
    """The JAX probe's kernel body on (t, idx), run as its tool runs it (a
    pallas_call over VMEM refs), in interpret mode, and the same jnp call
    outside any kernel."""
    if name == "take_rowgather":
        def take(x, i):
            return jnp.take(x, i, axis=0)
        shape = (idx.shape[0], t.shape[1])
    else:
        def take(x, i):
            return jnp.take_along_axis(x, i, axis=0)
        shape = idx.shape

    def k(t_ref, i_ref, o_ref):
        o_ref[:] = take(t_ref[:], i_ref[:])

    kernel = _PALLAS_CALL(
        k, out_shape=jax.ShapeDtypeStruct(shape, jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True)(t, idx)
    return np.asarray(kernel), np.asarray(take(jnp.asarray(t), jnp.asarray(idx)))


def test_gather_index_sets_hold_what_they_say():
    """The gathers' seeded index sets, (2048, 128) for take_along_axis_axis0
    and (128,) for take_rowgather: in range with rows 0 and 2047; in
    [-2048, 0) with -2048 and -1; mixed, with in-range, negative and
    out-of-range indices (2048, -2049, values far out, int32's ends); all
    out of range."""
    m = 2048
    for name, sets in GATHER_SETS.items():
        got = {k: v.numpy() for k, v in sets().items()}
        assert list(got) == list(probes.pallas.INDEX_SETS)
        shape = (m, 128) if name == "take_along_axis_axis0" else (128,)
        assert all(v.shape == shape and v.dtype == np.int32 for v in got.values())
        r = got["in_range"]
        assert ((r >= 0) & (r < m)).all() and {0, m - 1} <= set(r.ravel().tolist())
        n = got["negatives"]
        assert ((n >= -m) & (n < 0)).all() and {-m, -1} <= set(n.ravel().tolist())
        x = got["mixed"].ravel()
        assert {0, m - 1, -1, -m, m, -m - 1, -2**31, 2**31 - 1} <= set(x.tolist())
        outside = (x < -m) | (x >= m)
        assert 0.15 < outside.mean() < 0.35 and (x[outside] > 4096).any()
        assert ((x >= 0) & (x < m)).any() and ((x >= -m) & (x < 0)).any()
        o = got["outside"].ravel()
        assert ((o < -m) | (o >= m)).all() and {m, -m - 1, -2**31, 2**31 - 1} <= set(o.tolist())


@pytest.mark.parametrize("set_name", probes.pallas.INDEX_SETS)
@pytest.mark.parametrize("name", list(GATHER_SETS))
def test_gather_plain_version_follows_jax_index_rule(name, set_name):
    """The plain versions the take_along_axis_axis0 and take_rowgather
    kernels are held against on the card, bit for bit against the JAX
    probe's kernel body (interpret mode), the jnp call itself and numpy, on
    the tool's table at each seeded index set: negative indices in
    [-2048, 0) wrap, every other index outside [0, 2048) gives NaN with the
    bits 0x7fc00000. On the CPU the wrapper is the plain version."""
    probe = next(p for p in probes.PROBES if p.name == name)
    table = probe.inputs("cpu")[0]
    idx = GATHER_SETS[name]()[set_name]
    got = probe.compute(table, idx)
    assert got.dtype == torch.float32 and tuple(got.shape) == probe.out_shape
    bits = got.numpy().view(np.int32)
    want = _numpy_gather(table.numpy(), idx.numpy(), name)
    np.testing.assert_array_equal(bits, want.view(np.int32))
    for jax_out in _jax_gather(table.numpy(), idx.numpy(), name):
        np.testing.assert_array_equal(bits, jax_out.view(np.int32))
    nan = np.isnan(got.numpy())
    assert (bits[nan] == NAN_BITS).all()
    assert nan.all() if set_name == "outside" else (nan.any() == (set_name == "mixed"))
    assert torch.equal(probe.run((table, idx)).view(torch.int32), got.view(torch.int32))
    assert probe.launches == 0


def test_rowgather_takes_no_shared_memory_and_raises_on_misalignment():
    """take_rowgather reads its table straight from L2 (a probe of
    DIRECT_PROBES), and its entry's cudaErrorMisalignedAddress (716) for a
    table or output off 16 bytes is a failed launch."""
    probe = probes.pallas.take_rowgather
    assert probe.name in probes.DIRECT_PROBES
    probe.check(0)
    for rc in (716, 1):
        with pytest.raises(RuntimeError, match=f"CUDA error {rc}"):
            probe.check(rc)


def test_onehot_plain_version_is_numpy_indexing():
    """The plain version the onehot_matmul_gather kernel is held against on
    the card is numpy's row gather, bit for bit, on a table with no zeros,
    both signs and full mantissas, at seeded rows with both ends of it:
    every output row has one non-zero product, so the sum is exact in any
    order."""
    probe = probes.pallas.onehot_matmul_gather
    table8 = probes.pallas.seeded_table8()
    idx = probes.pallas.seeded_rows()
    t = table8.numpy()
    assert (t != 0).all() and (t < 0).any() and (t > 0).any()
    assert (t.view(np.int32) & 0xFFFF != 0).mean() > 0.99  # low mantissa bits in use
    assert {0, 2047} <= set(idx.tolist())
    got = probe.compute(table8, idx)
    np.testing.assert_array_equal(got.numpy().view(np.int32), t[idx.numpy()].view(np.int32))


def test_scalar_broadcast_plain_version_is_numpy_indexing():
    """The plain version the scalar_broadcast kernel is held against on the
    card: table8[i, 3] in every element, for each seeded row i (0 and 2047
    among them) of the seeded table."""
    probe = probes.pallas.scalar_broadcast
    table8 = probes.pallas.seeded_table8()
    rows = probes.pallas.seeded_rows().tolist()
    assert {0, 2047} <= set(rows)
    for i in rows:
        got = probe.compute(torch.tensor([i], dtype=torch.int32), table8)
        assert got.dtype == torch.float32 and tuple(got.shape) == (8, 128)
        want = np.full((8, 128), table8.numpy()[i, 3], np.float32)
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_ref_ds_row_read_plain_version_is_numpy_indexing_at_every_row():
    """The plain version the ref_ds_row_read kernel is held against on the
    card: row i of table8 in each of the 8 output rows, at every row
    0..2047 of the tool's table and of the seeded table."""
    probe = probes.pallas.ref_ds_row_read
    for table8 in (probe.inputs("cpu")[1], probes.pallas.seeded_table8()):
        t = table8.numpy()
        for i in range(t.shape[0]):
            got = probe.compute(torch.tensor([i], dtype=torch.int32), table8)
            assert got.dtype == torch.float32 and tuple(got.shape) == (8, 8)
            want = np.broadcast_to(t[i], (8, 8))
            np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


def _numpy_walk(t: np.ndarray) -> tuple:
    """The packet-walk core in numpy, written from the tool's kernel: the
    (8, 128) float32 sum of the rows visited, in order, and the steps."""
    hit = (t > np.float32(0.5 * t.shape[0] * t.shape[1])).any(axis=1)
    acc, cur, steps = np.zeros(t.shape[1], np.float32), 0, 0
    while cur < t.shape[0]:
        acc = acc + t[cur]
        cur, steps = cur + (7 if hit[cur] else 1), steps + 1
    return np.broadcast_to(acc, (8, t.shape[1])), steps


# Steps of each walk: 1,024 of +1 then 147 of +7 on the arange table, 2,048
# of +1 with no vote, ceil(2048 / 7) with every row voting.
WALK_STEPS = {None: 1171, "none": 2048, "all": 293}


@pytest.mark.parametrize("pattern", (None,) + probes.pallas.WALK_TABLES)
def test_walk_plain_version_is_a_numpy_walk(pattern):
    """The plain version the packet_walk_core kernel is held against on the
    card, on the tool's arange table (None) and on each seeded table, bit
    for bit against a numpy walk; the sums depend on their order."""
    probe = probes.pallas.packet_walk_core
    (t,) = probe.inputs("cpu", pattern)
    want, steps = _numpy_walk(t.numpy())
    got = probe.compute(t)
    assert got.dtype == torch.float32 and tuple(got.shape) == (8, 128)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert len(probes.pallas.walk_path(t)) == steps == WALK_STEPS.get(pattern, steps)
    backwards = np.zeros(128, np.float32)
    for cur in reversed(probes.pallas.walk_path(t)):
        backwards = backwards + t.numpy()[cur]
    assert (backwards != want[0]).any()


def test_walk_tables_vote_where_they_say():
    """The seeded walk tables vote on exactly their rows: none, all, each
    kernel tile's first row with one of its last 7 and the table's last 7,
    a seeded tenth; every other value lies below the threshold."""
    tile = probes.pallas.WALK_TILE
    for pattern in probes.pallas.WALK_TABLES:
        t = probes.pallas.walk_table("cpu", pattern).numpy()
        votes = probes.pallas.walk_votes(pattern)
        hit = np.flatnonzero((t > np.float32(0.5 * 2048 * 128)).any(axis=1))
        np.testing.assert_array_equal(hit, votes)
        assert (t < 0).any() and (t.view(np.int32) & 0xFF != 0).mean() > 0.9
    edges = set(probes.pallas.walk_votes("edges").tolist())
    assert set(range(0, 2048, tile)) <= edges and set(range(2041, 2048)) <= edges
    assert {r % tile for r in edges} >= set(range(tile - 7, tile))
    assert 150 < probes.pallas.walk_votes("scattered").size < 260


@pytest.mark.parametrize("name", probes.DIRECT_PROBES)
def test_direct_probes_take_no_shared_memory_and_raise_on_misalignment(name):
    """The probes that read their inputs straight from L2 (scalar_broadcast,
    smem_input, take_along_axis_axis0 and scatter_add among them): on the CPU, at each of their
    entry point's runs, the wrapper is the plain version and launches
    nothing; their kernels get one output and no scratch; an entry's
    cudaErrorMisalignedAddress (716) is a failed launch."""
    probe = next(p for p in probes.PROBES if p.name == name)
    runs = [params for _, p, params in probes.cases() if p is probe]
    assert runs
    for params in runs:
        ins = probe.inputs("cpu", *params)
        got = probe.run(ins)
        assert tuple(got.shape) == probe.out_shape and torch.equal(got, probe.compute(*ins))
    assert probe.launches == 0
    assert [tuple(o.shape) for o in probe.outputs("cpu")] == [probe.out_shape]
    probe.check(0)
    for rc in (716, 1):
        with pytest.raises(RuntimeError, match=f"CUDA error {rc}"):
            probe.check(rc)


LIBRARY_CASES = [(tag, p, params) for tag, p, params in probes.cases() if p.library is not None]


@pytest.mark.parametrize("tag,probe,params", LIBRARY_CASES, ids=[c[0] for c in LIBRARY_CASES])
def test_library_call_matches_plain(tag, probe, params):
    """The one PyTorch call each probe is timed against computes the same
    function, bit for bit (here on the CPU; on the card in chip_smoke.py),
    smem_input's at each of its table sizes."""
    assert probe.library_agrees(probe.inputs(torch.device("cpu"), *params))


# The four probes that sum reads in order, and the reads of each bag.
BAG_PROBES = {"vmem_dyn_sublane_static_lane": 16, "smem_input": 64,
              "vmem_scalar_dynamic_read": 4, "dyn_row_vector_read": 8}


@pytest.mark.parametrize("name", list(BAG_PROBES))
def test_in_order_sums_are_timed_against_one_embedding_bag(monkeypatch, name):
    """The four probes that sum reads in order are timed against exactly one
    embedding_bag(mode="sum") call, made over one bag of their reads."""
    probe = next(p for p in probes.PROBES if p.name == name)
    ins = probe.inputs("cpu", *([probes.SMEM_ROWS[0]] if probe is mosaic.smem_input else []))
    bag = torch.nn.functional.embedding_bag
    seen = []

    def counted(index, weight, offsets, **kw):
        seen.append((tuple(index.shape), tuple(offsets.tolist()), kw.get("mode")))
        return bag(index, weight, offsets, **kw)

    call = probe.library(ins)
    monkeypatch.setattr(torch.nn.functional, "embedding_bag", counted)
    assert torch.equal(call(), probe.compute(*ins))
    assert seen == [((BAG_PROBES[name],), (0,), "sum")]


# The in-order sums of 8a (16 elements of column 5) and 8t (8 rows), each on
# seeded_tab at its seeded index sets.
IN_ORDER = {"vmem_dyn_sublane_static_lane": 16, "dyn_row_vector_read": 8}


def _numpy_in_order(t: np.ndarray, idx: np.ndarray, name: str) -> np.ndarray:
    """The probe's sum in numpy, from float32 zeros, one read at a time in
    index order: (1, 1) for column 5, (1, 128) for whole rows."""
    acc = np.zeros((1, 1) if name == "vmem_dyn_sublane_static_lane" else (1, 128), np.float32)
    for i in idx.reshape(-1):
        acc = acc + (t[i, 5] if name == "vmem_dyn_sublane_static_lane" else t[i])
    return acc


def test_seeded_tab_and_index_sets():
    """The seeded table has full mantissas, both signs and -0.0 where each
    index set first reads; the sets repeat an index, reach rows 0 and 63,
    and their sums depend on the order of the adds."""
    t = mosaic.seeded_tab().numpy()
    assert t.shape == (64, 128) and (t < 0).any() and (t > 0).any()
    assert (t.view(np.int32) & 0xFFFF != 0).mean() > 0.7  # low mantissa bits in use
    z = t[mosaic.NEG_ZERO_ROW]
    assert np.signbit(z[5]) and z[5] == 0 and 16 < (np.signbit(z) & (z == 0)).sum() < 64
    for name, length in IN_ORDER.items():
        sets = mosaic.seeded_index_sets(length).numpy()
        assert sets.shape == (128, 1, length) and sets.dtype == np.int32
        assert (sets[:, 0, 0] == mosaic.NEG_ZERO_ROW).all()
        assert (sets[:, 0, -1] == sets[:, 0, 1]).all()
        assert {0, 63} <= set(sets[1, 0].tolist())
        backwards = [_numpy_in_order(t, s[0, ::-1], name) for s in sets]
        forwards = [_numpy_in_order(t, s, name) for s in sets]
        assert any((b.view(np.int32) != f.view(np.int32)).any()
                   for b, f in zip(backwards, forwards))


@pytest.mark.parametrize("name", list(IN_ORDER))
def test_in_order_plain_version_is_numpy_sum_on_seeded_sets(name):
    """The plain versions the vmem_dyn_sublane_static_lane and
    dyn_row_vector_read kernels are held against on the card, bit for bit
    against numpy's in-order float32 sum from zeros, at each of 128 seeded
    index sets of the seeded table: +0.0 where set 0 reads -0.0 alone."""
    probe = next(p for p in probes.PROBES if p.name == name)
    tab = mosaic.seeded_tab()
    t = tab.numpy()
    for k, idx in enumerate(mosaic.seeded_index_sets(IN_ORDER[name])):
        got = probe.compute(tab, idx)
        assert got.dtype == torch.float32 and tuple(got.shape) == probe.out_shape
        want = _numpy_in_order(t, idx.numpy(), name)
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
        if k == 0:
            zeros = got.numpy()[got.numpy() == 0]
            assert zeros.size and not np.signbit(zeros).any()


@pytest.mark.parametrize("name", list(IN_ORDER))
def test_embedding_bag_matches_plain_on_seeded_sets(name):
    """The embedding_bag call of vmem_dyn_sublane_static_lane (the table's
    flat view at 128 idx + 5) and of dyn_row_vector_read (the table's rows
    at idx) bit-equal to the plain version at each of 128 seeded index sets
    of the seeded table."""
    probe = next(p for p in probes.PROBES if p.name == name)
    tab = mosaic.seeded_tab()
    for idx in mosaic.seeded_index_sets(IN_ORDER[name]):
        assert probe.library_agrees((tab, idx))


def _numpy_sum4(t: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """vmem_scalar_dynamic_read in numpy, written from the tool's kernel
    (tools/pallas_probe.py:83-99): from float32 0, t[idx[0, j], 0] for
    j < 4 in turn."""
    acc = np.float32(0.0)
    for j in range(4):
        acc = np.float32(acc + t[idx[0, j], 0])
    return np.full((1, 1), acc, np.float32)


def test_sum4_table_and_sets():
    """The seeded table8 of vmem_scalar_dynamic_read has full mantissas,
    both signs and -0.0 at column 0 of the row each set reads first; set 0
    reads that row alone, set 1 repeats an index and reaches both ends;
    another order of the adds gives other bits on some set."""
    t = probes.pallas.sum4_table8().numpy()
    assert t.shape == (2048, 8) and (t < 0).any() and (t > 0).any()
    assert (t.view(np.int32) & 0xFFFF != 0).mean() > 0.99
    first = probes.pallas.SUM4_FIRST_ROW
    assert t[first, 0] == 0 and np.signbit(t[first, 0])
    sets = probes.pallas.sum4_sets().numpy()
    assert sets.shape == (128, 1, 4) and sets.dtype == np.int32
    assert (sets[:, 0, 0] == first).all() and (sets[0] == first).all()
    assert len(set(sets[1, 0].tolist())) < 4 and {0, 2047} <= set(sets[1, 0].tolist())
    assert any((_numpy_sum4(t, s[:, ::-1]).view(np.int32) != _numpy_sum4(t, s).view(np.int32))
               .any() for s in sets)


def test_sum4_plain_version_is_numpy_sum_on_seeded_sets():
    """The plain version the vmem_scalar_dynamic_read kernel is held against
    on the card, bit for bit against the numpy sum at each of 128 seeded
    index sets of the seeded table8, and its embedding_bag call with it:
    +0.0 where set 0 reads -0.0 alone."""
    probe = probes.pallas.vmem_scalar_dynamic_read
    tab = probes.pallas.sum4_table8()
    for k, idx in enumerate(probes.pallas.sum4_sets()):
        got = probe.compute(tab, idx)
        assert got.dtype == torch.float32 and tuple(got.shape) == (1, 1)
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      _numpy_sum4(tab.numpy(), idx.numpy()).view(np.int32))
        assert probe.library_agrees((tab, idx))
        if k == 0:
            assert got.item() == 0 and not np.signbit(got.numpy()).any()


def _numpy_link_walk(links: np.ndarray, rays: np.ndarray) -> tuple:
    """while_walk_smem in numpy, written from the tool's kernel
    (tools/probe_mosaic.py:89-119): out = rays; from cursor 0 until it is
    negative, out + float32(cursor) where the successor is >= 0. Returns
    the output and the cursors added, in order."""
    out, cur, added = rays.copy(), 0, []
    while cur >= 0:
        nxt = int(links[cur, 0])
        if nxt >= 0:
            out = out + np.float32(cur)
            added.append(cur)
        cur = nxt
    return out, added


# Cursors each seeded table's walk adds: the tool's chain 0..98, every node
# but the last of a permutation, 39 of a 40-node walk, none, 69 of 70.
LINK_ADDS = {None: 99, "chain": 99, "permutation": 99, "short": 39, "at_once": 0,
             "minus5": 69}


@pytest.mark.parametrize("table", (None,) + mosaic.LINK_TABLES)
def test_link_walk_plain_version_is_a_numpy_walk(table):
    """The plain version the while_walk_smem kernel is held against on the
    card, on the tool's inputs (None) and on each seeded link table with
    seeded rays, bit for bit against a numpy walk."""
    probe = mosaic.while_walk_smem
    links, rays = probe.inputs("cpu", *(() if table is None else (table,)))
    want, added = _numpy_link_walk(links.numpy(), rays.numpy())
    got = probe.compute(links, rays)
    assert got.dtype == torch.float32 and tuple(got.shape) == (8, 128)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert len(added) == LINK_ADDS[table]
    if table is not None and added:  # the first add (cursor 0) turns -0.0 into +0.0
        r = rays.numpy()
        assert (np.signbit(r) & (r == 0)).any() and not np.signbit(got.numpy()[r == 0]).any()


def test_link_tables_walk_where_they_say():
    """The seeded link tables: 100 links each; the permutation visits every
    node; the short walk's unvisited nodes form one cycle; the minus5 walk
    ends on -5; each cyclic table's walk from 0 never ends (or leaves the
    table); and another order of the adds gives other bits on some
    table."""
    rays = mosaic.seeded_rays().numpy()
    assert (rays < 0).any() and (rays > 0).any() and 64 < (np.signbit(rays) & (rays == 0)).sum()
    assert (rays.view(np.int32) & 0xFFFF != 0).mean() > 0.8
    differs = False
    for table in mosaic.LINK_TABLES:
        links = mosaic.link_table(name=table).numpy()
        assert links.shape == (100, 1) and links.dtype == np.int32 and (links < 100).all()
        want, added = _numpy_link_walk(links, rays)
        backwards = rays.copy()
        for cur in reversed(added):
            backwards = backwards + np.float32(cur)
        differs |= bool((backwards.view(np.int32) != want.view(np.int32)).any())
        path = added + [int(links[added[-1], 0])] if added else [0]
        if table == "permutation":
            assert sorted(path) == list(range(100))
        if table == "short":
            left = sorted(set(range(100)) - set(path))
            cur, seen = left[0], []
            while cur not in seen:
                seen.append(cur)
                cur = int(links[cur, 0])
            assert cur == left[0] and sorted(seen) == left
        if table == "minus5":
            assert links[path[-1], 0] == -5
    assert differs
    for table in mosaic.CYCLIC_TABLES:
        links = mosaic.link_table(name=table)[:, 0].tolist()
        cur, seen = 0, set()
        while 0 <= cur < 100 and cur not in seen:
            seen.add(cur)
            cur = links[cur]
        assert cur >= 0, table


def test_entry_point_on_the_cpu(capsys):
    probes.reset_counts()
    assert main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    ok = [ln for ln in lines if ln.startswith("OK ")]
    assert len(ok) == 26 and not [ln for ln in lines if ln.startswith("FAIL")]
    assert "OK smem_input(131072): [15757280.0]" in lines
    assert set(probes.counts().values()) == {0}


def test_entry_point_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])


def test_wrappers_refuse_other_devices():
    with pytest.raises(ValueError, match="CUDA tensors"):
        mosaic.vmem_dyn_lane.launch(mosaic.vmem_dyn_lane.inputs("cpu"),
                                    mosaic.vmem_dyn_lane.outputs("cpu"))


def test_dependent_latency_tool_needs_a_card(monkeypatch):
    """tools/torch_dependent_latency.py times chains on a card only: without
    one it exits 2 before building anything."""
    tool = _load_tool("torch_dependent_latency")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main() == 2


def test_gather_floor_tool_needs_a_card(monkeypatch):
    """tools/torch_gather_floor.py times 8e's floors on a card only: without
    one it exits 2 before building anything."""
    tool = _load_tool("torch_gather_floor")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main() == 2


def test_probes_import_no_jax():
    code = ("import sys, lumillyrender_tpu_torch.probes.__main__; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'lumillyrender_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
