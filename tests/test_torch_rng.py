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


# Kernel 1's per-launch constants (ops/cuda_bounce.py: raygen_consts,
# threefry_schedule, magic_divisor), used as csrc/raygen.cu uses them,
# modelled in numpy uint64 holding uint32 values.
M32 = np.uint64(0xFFFFFFFF)


def _u32_lanes(n: int, seed: int) -> np.ndarray:
    """n seeded uint32 values (as uint64) with 0 and 2^32 - 1 among them."""
    x = np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64)
    x[:2] = (0, 2**32 - 1)
    return x


def _kernel_threefry(x0, x1, k0, k1):
    """raygen.cu's threefry_rounds: x0 and x1 enter with their first
    injection added; k0, k1 are the schedule's later injections."""
    rot = (13, 15, 26, 6, 17, 29, 16, 24)
    for i in range(20):
        x0 = (x0 + x1) & M32
        r = np.uint64(rot[i % 8])
        x1 = (((x1 << r) | (x1 >> (np.uint64(32) - r))) & M32) ^ x0
        if i % 4 == 3:
            x0 = (x0 + np.uint64(k0[i // 4])) & M32
            x1 = (x1 + np.uint64(k1[i // 4])) & M32
    return x0, x1


@pytest.mark.parametrize("seed", (0, 1, 0x9E3779B9, 0x1BD11BDA, 0xFFFFFFFF))
def test_raygen_key_schedule_is_threefry(seed):
    """The wrapper's key schedule, run through the kernel's rounds from x0
    = lane + seed, gives both blocks of `rng.threefry2x32` and of the JAX
    package's `threefry2x32` keyed (seed, seed ^ 0x9E3779B9), on seeded
    uint32 lanes with 0 and 2^32 - 1, at kernel 1's counter and at 0 and
    2^32 - 1."""
    from lumillyrender_tpu_torch.ops import cuda_bounce

    lanes = _u32_lanes(4096, seed & 0xFFFF)
    key2 = seed ^ 0x9E3779B9
    for ctr in (cuda_bounce.RAYGEN_CTR, 0, 0xFFFFFFFF):
        x1, k0, k1 = cuda_bounce.threefry_schedule(seed, ctr)
        for block, c in enumerate((ctr, ctr ^ 0x80000000)):
            got = _kernel_threefry((lanes + np.uint64(seed)) & M32,
                                   np.full_like(lanes, x1[block]), k0, k1)
            want = rng.threefry2x32(torch.tensor(seed), torch.tensor(key2),
                                    torch.from_numpy(lanes.astype(np.int64)), torch.tensor(c))
            j_want = jax_rng.threefry2x32(jnp.uint32(seed), jnp.uint32(key2),
                                          jnp.asarray(lanes.astype(np.uint32)), jnp.uint32(c))
            for g, w, jw in zip(got, want, j_want):
                np.testing.assert_array_equal(g, w.numpy().astype(np.uint64))
                np.testing.assert_array_equal(g, np.asarray(jw).astype(np.uint64))


def _film_dims():
    """(width, height) of every film the repo renders: each asset's, the
    terrain scenes' default and the raster-order film of the card tests."""
    import tomllib
    from pathlib import Path

    from lumillyrender_tpu_torch.scene import terrain

    assets = Path(__file__).resolve().parents[1] / "assets"
    dims = {p.stem: tuple(tomllib.loads(p.read_text())["film"]["resolution"])
            for p in sorted(assets.glob("*.toml"))}
    sig = __import__("inspect").signature(terrain.terrain_scene_toml)
    dims["terrain"] = tuple(sig.parameters["resolution"].default)
    dims["raster 100x75"] = (100, 75)
    return dims


FILMS = _film_dims()


@pytest.mark.parametrize("film", list(FILMS))
def test_raygen_divisors_decode_the_plain_pixels(film):
    """Every divisor of the film's pixel decode (w, h, w h and, in tile
    order, the tile's width, height and size and the tiles a row) divides
    seeded uint32 values with 0 and 2^32 - 1 as `//` and `%` do, through
    its magic numbers; and the decode the kernel makes from the launch's
    constants gives the plain version's (px, py) of every lane kind."""
    import types

    from lumillyrender_tpu_torch.integrator.render import tile_decode, tile_dims
    from lumillyrender_tpu_torch.ops import cuda_bounce

    w, h = FILMS[film]
    st = types.SimpleNamespace(width=w, height=h)
    tiles = tile_dims(st)
    divisors = {w, h, w * h} | ({tiles[0], tiles[1], tiles[0] * tiles[1], w // tiles[0]}
                                if tiles else set())
    n = _u32_lanes(8192, w * h)

    def udiv(x, q):
        m, s1, s2, _ = (np.uint64(v) for v in q)
        t = (m * x) >> np.uint64(32)
        return (t + ((x - t) >> s1)) >> s2

    for d in sorted(divisors):
        q = cuda_bounce.magic_divisor(d)
        near = (np.arange(1, 64, dtype=np.uint64) * np.uint64(d)) % np.uint64(2**32)
        for x in (n, near, (near - np.uint64(1)) & M32, (np.uint64(2**32) - near) & M32):
            np.testing.assert_array_equal(udiv(x, q), x // np.uint64(d), err_msg=str(d))

    k = cuda_bounce.raygen_consts(st, 7)
    assert len(k) == 28
    wh, a, b, c = (k[4 * i:4 * i + 4] for i in range(4))
    assert wh[3] == w * h and a[3] == (tiles[0] * tiles[1] if tiles else w)
    lane = n % np.uint64(2**31)  # the kernel's lane index is an int
    pixel = lane - udiv(lane, wh) * np.uint64(w * h)
    if tiles is None:
        py = udiv(pixel, a)
        px = pixel - py * np.uint64(w)
        want_x, want_y = lane % np.uint64(w), (lane // np.uint64(w)) % np.uint64(h)
    else:
        tile = udiv(pixel, a)
        within = pixel - tile * np.uint64(a[3])
        ty, wy = udiv(tile, b), udiv(within, c)
        px = (tile - ty * np.uint64(b[3])) * np.uint64(tiles[0]) + within - wy * np.uint64(c[3])
        py = ty * np.uint64(tiles[1]) + wy
        want_x, want_y = (t.numpy() for t in tile_decode(st)(
            torch.from_numpy((lane % np.uint64(w * h)).astype(np.int64))))
    np.testing.assert_array_equal(px, want_x)
    np.testing.assert_array_equal(py, want_y)
