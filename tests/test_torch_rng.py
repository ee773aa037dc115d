"""The port's RNG is bit-exact with the JAX package's under both mixers,
including uint32 wrap of seed, lane and counter (tolerance 0): pcg4d (the
default) and threefry (`LLR_RNG=threefry`, set here as `rng._MIXER` on
both sides, as tests/test_regressions.py sets it)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from lumillyrender_tpu.ops import rng as jax_rng
from lumillyrender_tpu_torch.ops import rng

torch.set_num_threads(2)

U32 = st.integers(min_value=0, max_value=2**32 - 1)


def _lanes(lane0: int, n: int = 64) -> np.ndarray:
    # Consecutive lane ids starting anywhere, wrapping past 2^32 - 1.
    return ((lane0 + np.arange(n, dtype=np.uint64)) % 2**32).astype(np.uint32)


@settings(max_examples=40, deadline=None)
@given(seed=U32, lane0=U32, ctr=U32)
def test_uniform4_bit_exact(seed, lane0, ctr):
    lanes = _lanes(lane0)
    want = jax_rng.uniform4(seed, jnp.asarray(lanes), ctr)
    got = rng.uniform4(seed, torch.from_numpy(lanes.view(np.int32)), ctr)
    for w, g in zip(want, got):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@settings(max_examples=40, deadline=None)
@given(a=U32, b=U32, c=U32, d=U32)
def test_pcg4d_bit_exact(a, b, c, d):
    want = jax_rng.pcg4d(*(jnp.uint32(x) for x in (a, b, c, d)))
    got = rng.pcg4d(*(torch.tensor(x, dtype=torch.int64) for x in (a, b, c, d)))
    assert [int(g) for g in got] == [int(w) for w in want]


def test_uniform_and_uniform2_follow_uniform4():
    lanes = torch.from_numpy(_lanes(2**32 - 8).view(np.int32))
    four = rng.uniform4(7, lanes, 0x50000001)
    two = rng.uniform2(7, lanes, 0x50000001)
    assert torch.equal(two[0], four[0]) and torch.equal(two[1], four[1])
    assert torch.equal(rng.uniform(7, lanes, 0x50000001), four[0])
    want = jax_rng.uniform(7, jnp.asarray(_lanes(2**32 - 8)), 0x50000001)
    np.testing.assert_array_equal(four[0].numpy(), np.asarray(want))


# Seeds and counters at the uint32 edges and the camera rays' counter.
EDGES = (0, 0x7FFFFFFF, 0xFFFFFFFF, 0x40000000)
WIDE = 65536


@pytest.fixture
def threefry(monkeypatch):
    monkeypatch.setattr(jax_rng, "_MIXER", "threefry")
    monkeypatch.setattr(rng, "_MIXER", "threefry")
    jax.clear_caches()
    yield
    jax.clear_caches()


def _wide_lanes():
    lanes = _lanes(2**32 - WIDE // 2, WIDE)  # wraps past 2^32 - 1
    return lanes, torch.from_numpy(lanes.view(np.int32))


@settings(max_examples=40, deadline=None)
@given(a=U32, b=U32, c=U32, d=U32)
def test_threefry2x32_bit_exact(a, b, c, d):
    want = jax_rng.threefry2x32(*(jnp.uint32(x) for x in (a, b, c, d)))
    got = rng.threefry2x32(*(torch.tensor(x, dtype=torch.int64) for x in (a, b, c, d)))
    assert [int(g) for g in got] == [int(w) for w in want]


@pytest.mark.parametrize("seed", EDGES)
def test_threefry_uniforms_bit_exact(threefry, seed):
    lanes, t_lanes = _wide_lanes()
    for ctr in EDGES + (torch.tensor(-7, dtype=torch.int32),):
        j_ctr = jnp.int32(-7) if isinstance(ctr, torch.Tensor) else ctr
        for name in ("uniform4", "uniform2"):
            want = getattr(jax_rng, name)(seed, jnp.asarray(lanes), j_ctr)
            got = getattr(rng, name)(seed, t_lanes, ctr)
            assert len(got) == len(want)
            for w, g in zip(want, got):
                assert g.dtype == torch.float32
                np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        np.testing.assert_array_equal(rng.uniform(seed, t_lanes, ctr).numpy(),
                                      np.asarray(jax_rng.uniform(seed, jnp.asarray(lanes), j_ctr)))


def test_threefry_blocks_of_uniform4_and_uniform2(threefry):
    """uniform2 draws one block of its own on (lane, ctr): the same two
    words as uniform4's first block (in the JAX package too), without its
    second block, which is drawn on (lane, ctr ^ 0x80000000). Under
    threefry every word differs from pcg4d's."""
    lanes, t_lanes = _wide_lanes()
    four = rng.uniform4(5, t_lanes, 0x40000000)
    two = rng.uniform2(5, t_lanes, 0x40000000)
    assert torch.equal(two[0], four[0]) and torch.equal(two[1], four[1])
    second = rng.uniform2(5, t_lanes, 0x40000000 ^ 0x80000000)
    assert torch.equal(second[0], four[2]) and torch.equal(second[1], four[3])
    j_four = jax_rng.uniform4(5, jnp.asarray(lanes), 0x40000000)
    j_two = jax_rng.uniform2(5, jnp.asarray(lanes), 0x40000000)
    np.testing.assert_array_equal(np.asarray(j_two[0]), np.asarray(j_four[0]))
    rng._MIXER = "pcg4d"
    pcg = rng.uniform4(5, t_lanes, 0x40000000)
    for a, b in zip(four, pcg):
        assert (a != b).float().mean() > 0.99


def test_threefry_takes_tensor_seed_and_counter(threefry):
    """A seed and a counter given as int64 tensors (as `as_u32` makes them
    for a captured draw) give the Python ints' bits."""
    _, t_lanes = _wide_lanes()
    want = rng.uniform(9, t_lanes[:256], 0x50000003)
    got = rng.uniform(rng.as_u32(9), t_lanes[:256], rng.as_u32(0x50000003))
    assert torch.equal(got, want)
