"""The port's huge-mesh path against the JAX package's, on the CPU.

* (a) `_ray_sort_key` bit-equal to the JAX key; `sort_rays`' permutation is
  the stable argsort and its inverse undoes it.
* (b) The native SAH builder against the numpy one and the JAX package's
  builder: every field equal; `build_tri_bvh` at K=32 and K=128 equal to
  the JAX package's, leaf for leaf.
* (c) The plain walk `_walk_tris` at K=128 against the JAX wide-leaf kernel
  (`pallas_bvh_wide.intersect_tris_wide`, interpret mode), and (d) at K=32
  and K=128 against the JAX streamed packet kernel
  (`intersect_tris_pallas(streamed=True)`, interpret mode): coherent and
  random rays, t_init pruning, capped occlusion queries, shade outputs.
  t within T_RTOL relative; prim equal except on exact-t ties (the JAX wide
  kernel breaks them by lane slot, the walks by visit order), on fewer
  than parity.py's 0.4% of lanes; material and normal where prims agree;
  occlusion verdicts equal on every lane.
* (e) The port's wide admission equal to `pallas_bvh_wide.supported`, on
  both sides of the cap.
* (f) A terrain scene compiled at K=128 (WIDE_MIN_TRIS lowered in both
  packages): the compiled tables equal leaf for leaf, the plain bounce
  step against the JAX XLA step under tests/test_fused_bounce.py's lane
  rules, and a pt-direct and a depth film against the JAX package's under
  tests/test_torch_render.py's statistical bounds.
* (g) `intersect` on every route (`streamed`, `reorder`) on the CPU gives
  the plain walk's results unchanged.
The CUDA kernels against the plain walk: tests/test_torch_cuda.py.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumillyrender_tpu.accel import pack as jax_pack
from lumillyrender_tpu.integrator.render import render as jax_render
from lumillyrender_tpu.integrator.wavefront import make_bounce_step as jax_step
from lumillyrender_tpu.ops import intersect as jax_isect
from lumillyrender_tpu.ops import pallas_bvh, pallas_bvh_wide
from lumillyrender_tpu.scene.compiler import compile_scene_file as jax_compile
from lumillyrender_tpu.scene.data import Bvh as JaxBvh
from lumillyrender_tpu_torch.accel import native, sah
from lumillyrender_tpu_torch.accel import pack
from lumillyrender_tpu_torch.constants import EPS, INF
from lumillyrender_tpu_torch.convert import state_from_numpy, state_to_numpy
from lumillyrender_tpu_torch.integrator import wavefront
from lumillyrender_tpu_torch.integrator.render import render
from lumillyrender_tpu_torch.ops import cuda_bounce, cuda_bvh
from lumillyrender_tpu_torch.ops import intersect as isect
from lumillyrender_tpu_torch.scene import terrain
from lumillyrender_tpu_torch.scene.compiler import compile_scene_file
from lumillyrender_tpu_torch.scene.data import Bvh, Geometry, tensor_of
from test_fused_bounce import _assert_states_close, _mk_state, _random_state
from test_torch_render import BLOCK_REL, MEAN_REL, WITHIN_FRAC

torch.set_num_threads(2)

SEED = 7
# t of the walks against the JAX kernels (XLA may contract the
# Moller-Trumbore products into fused multiply-adds; the port rounds each):
# terrain hits lie at t < 60, where a few float32 ulps are < 1e-5 relative.
T_RTOL = 1e-5
TIE_SHARE = 0.004  # parity.py's tie-flip limit


def _terrain_arrays(n_tris):
    p0, e1, e2, nrm = terrain.make_terrain(n_tris)
    mat = (np.arange(p0.shape[0]) % 3).astype(np.int32)
    return p0, e1, e2, nrm, mat


def _pair(n_tris, k):
    """(JAX Bvh, port Bvh, tri_n, tri_mat) of a terrain, both from the JAX
    package's builder."""
    p0, e1, e2, nrm, mat = _terrain_arrays(n_tris)
    arrays = jax_pack.build_tri_bvh(p0, e1, e2, tri_n=nrm, tri_mat=mat, max_leaf=k)
    jbvh = JaxBvh(**{f: jnp.asarray(v) for f, v in arrays.items()})
    pbvh = Bvh(**{f: tensor_of(arrays[f]) for f in Bvh.__dataclass_fields__})
    return jbvh, pbvh, nrm, mat


def _rays(n, seed):
    """n/2 camera-like rays from the terrain scene's eye towards the
    terrain, n/2 random rays from its box; a quarter of the random ones with
    t_init pruning (a random finite t_init) and a quarter capped occlusion
    queries (t_init = dist + 2 EPS, t_stop = t_init - 4 EPS, where half of
    them put dist on their nearest hit). Returns numpy (o, d, t_init,
    t_stop, dist, occl)."""
    rng = np.random.default_rng(seed)
    h = n // 2
    tgt = rng.uniform([-10, -1.5, -10], [10, 1.5, 10], size=(h, 3))
    oc = np.tile([[0.0, 8.0, 30.0]], (h, 1))
    dc = tgt - oc
    o = np.concatenate([oc, rng.uniform([-10, -2, -10], [10, 4, 10], size=(n - h, 3))])
    d = np.concatenate([dc, rng.normal(size=(n - h, 3))])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    t_init = np.full(n, INF, np.float32)
    t_stop = np.full(n, -INF, np.float32)
    prune = np.zeros(n, bool)
    prune[h::4] = True
    t_init[prune] = rng.uniform(0.5, 15.0, size=prune.sum()).astype(np.float32)
    occl = np.zeros(n, bool)
    occl[h + 1::4] = True
    dist = rng.uniform(0.5, 15.0, size=n).astype(np.float32)
    return o, d, t_init, t_stop, dist, occl, prune


def _with_occlusion(rays, pbvh):
    """Fill in the occlusion lanes' caps: half of them at their nearest hit
    (from the plain walk), so both verdicts occur."""
    o, d, t_init, t_stop, dist, occl, _ = rays
    t, p = isect._walk_tris(*(torch.from_numpy(x) for x in (o, d, t_init, t_stop)),
                            pbvh, False)
    on = occl & (p.numpy() >= 0) & (np.arange(o.shape[0]) % 8 == 1)
    dist[on] = t.numpy()[on]
    t_init[occl] = dist[occl] + np.float32(2.0 * EPS)
    t_stop[occl] = t_init[occl] - np.float32(4.0 * EPS)
    return o, d, t_init, t_stop, dist, occl


def _assert_walks_agree(ref, got, dist, occl, tri_n, tag):
    """ref, got: (t, prim[, mat, n (N,3)]) as numpy. Nearest-hit lanes: t
    within T_RTOL, prim equal but on exact-t ties, mat and n where prims
    agree; occlusion lanes: verdicts equal."""
    t_r, p_r = ref[0], ref[1]
    t_g, p_g = got[0], got[1]
    near = ~occl
    rel = np.abs(t_r - t_g) / np.maximum(np.abs(t_r), 1.0)
    assert rel[near].max() <= T_RTOL, f"{tag}: t rel {rel[near].max():.2e}"
    same = p_r == p_g
    assert np.all(same[near] | (rel[near] <= T_RTOL)), f"{tag}: prim flips off ties"
    assert (~same[near]).mean() < TIE_SHARE, f"{tag}: {int((~same[near]).sum())} tie lanes"
    verdict = lambda t, p: (p >= 0) & (np.abs(t - dist) <= EPS)
    np.testing.assert_array_equal(verdict(t_g, p_g)[occl], verdict(t_r, p_r)[occl], tag)
    assert verdict(t_g, p_g)[occl].any() and not verdict(t_g, p_g)[occl].all()
    if len(ref) > 2:
        keep = same & near
        np.testing.assert_array_equal(got[2][keep], ref[2][keep])
        np.testing.assert_array_equal(got[3][keep], ref[3][keep])
        assert np.abs(got[3][keep & (p_g >= 0)] - tri_n[p_g[keep & (p_g >= 0)]]).max() == 0
    assert (p_g[near] >= 0).mean() > 0.2, f"{tag}: too few hits to test"


def _plain(pbvh, o, d, t_init, t_stop, shade):
    outs = isect._walk_tris(*(torch.from_numpy(x) for x in (o, d, t_init, t_stop)),
                            pbvh, shade)
    return tuple(x.numpy() for x in outs)


# ---------------------------------------------------------------------------
# (a) the ray sort key
# ---------------------------------------------------------------------------


def test_ray_sort_key_is_the_jax_key_and_sorting_round_trips():
    jbvh, pbvh, _, _ = _pair(3000, 128)
    rng = np.random.default_rng(1)
    n = 4096
    # Origins inside, on and outside the root box; directions with zero
    # components, so every clip and octant case occurs.
    lo, hi = np.asarray(jbvh.node_min[0]), np.asarray(jbvh.node_max[0])
    o = rng.uniform(lo - 2.0, hi + 2.0, size=(n, 3)).astype(np.float32)
    o[:64] = lo
    o[64:128] = hi
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[::7, rng.integers(0, 3)] = 0.0
    want = np.asarray(jax_isect._ray_sort_key(jnp.asarray(o), jnp.asarray(d), jbvh))
    got = isect._ray_sort_key(torch.from_numpy(o), torch.from_numpy(d), pbvh)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert np.unique(want).size > 200
    perm, inv = isect.sort_rays(torch.from_numpy(o), torch.from_numpy(d), pbvh)
    np.testing.assert_array_equal(perm.numpy(), np.argsort(want, kind="stable"))
    x = torch.from_numpy(o)
    assert torch.equal(x[perm][inv], x)
    assert torch.equal(inv[perm], torch.arange(n))


# ---------------------------------------------------------------------------
# (b) the native builder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [32, 128])
def test_native_builder_equals_numpy_and_jax_builders(k):
    p0, e1, e2, nrm, mat = _terrain_arrays(20000)
    p1, p2 = p0 + e1, p0 + e2
    mins = np.minimum(np.minimum(p0, p1), p2)
    maxs = np.maximum(np.maximum(p0, p1), p2)
    cent = (mins + maxs) / 2.0
    got = native.build_ranges(mins, maxs, cent, k)
    for ref in (sah.build_ranges(mins, maxs, cent, k),
                jax_pack._build_ranges(mins, maxs, cent, k)):
        for f in dataclasses.fields(got):
            a, b = getattr(got, f.name), getattr(ref, f.name)
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    want = jax_pack.build_tri_bvh(p0, e1, e2, tri_n=nrm, tri_mat=mat, max_leaf=k)
    have = pack.build_tri_bvh(p0, e1, e2, tri_n=nrm, tri_mat=mat, max_leaf=k)
    assert set(have) <= set(want)
    for f, v in have.items():
        assert v.dtype == want[f].dtype, f
        np.testing.assert_array_equal(v, want[f], err_msg=f)
    assert have["blk_p0"].shape[1] == k and (have["blk_prim"] >= 0).sum() == p0.shape[0]


def test_native_builder_builds_into_the_package(tmp_path, monkeypatch):
    """A fresh build directory gets the library; a failed compile raises
    with the compiler's output instead of falling back."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    path = native.build()
    assert path.parent == tmp_path / "build" and path.exists()
    monkeypatch.setattr(native, "SOURCE", tmp_path / "broken.cpp")
    (tmp_path / "broken.cpp").write_text("int broken(\n")
    with pytest.raises(RuntimeError, match="failed to build"):
        native.build()


# ---------------------------------------------------------------------------
# (c), (d) the plain walk against the JAX packet kernels
# ---------------------------------------------------------------------------


def test_plain_walk_matches_jax_wide_kernel():
    jbvh, pbvh, nrm, mat = _pair(3000, 128)
    assert pallas_bvh_wide.supported(jbvh) and cuda_bvh.wide_admitted(pbvh)
    o, d, t_init, t_stop, dist, occl = _with_occlusion(_rays(512, 2), pbvh)
    J = jnp.asarray
    ref = pallas_bvh_wide.intersect_tris_wide(
        J(o), J(d), J(t_init), jbvh, J(nrm), want_shade=True, interpret=True,
        t_stop=J(t_stop), tri_mat=J(mat))
    ref = tuple(np.asarray(x) for x in ref[:3]) + (np.stack([np.asarray(x) for x in ref[3:]], 1),)
    got = _plain(pbvh, o, d, t_init, t_stop, True)
    _assert_walks_agree(ref, got, dist, occl, nrm, "K=128 vs the wide kernel")


@pytest.mark.parametrize("n_tris,k,shade", [(3000, 32, True), (400, 128, False)])
def test_plain_walk_matches_jax_streamed_kernel(n_tris, k, shade):
    """K=128 on a 4-leaf terrain and without the shade outputs (which K=32
    and the wide kernel cover): the JAX kernel unrolls its 128-triangle leaf
    test, which interpret mode compiles and runs op by op (~40 s)."""
    jbvh, pbvh, nrm, mat = _pair(n_tris, k)
    assert pallas_bvh.supported_streamed(jbvh)
    o, d, t_init, t_stop, dist, occl = _with_occlusion(_rays(512, 3 + k), pbvh)
    J = jnp.asarray
    ref = pallas_bvh.intersect_tris_pallas(
        J(o), J(d), J(t_init), jbvh, J(nrm), want_shade=shade, interpret=True,
        streamed=True, t_stop=J(t_stop))
    ref = tuple(np.asarray(x) for x in ref)
    if shade:
        ref = ref[:3] + (np.stack(ref[3:], 1),)
    got = _plain(pbvh, o, d, t_init, t_stop, shade)
    _assert_walks_agree(ref, got, dist, occl, nrm, f"K={k} vs the streamed kernel")


# ---------------------------------------------------------------------------
# (e) wide admission
# ---------------------------------------------------------------------------


def test_wide_admission_is_the_jax_packages(monkeypatch):
    jbvh, pbvh, _, _ = _pair(3000, 128)
    j32, p32, _, _ = _pair(3000, 32)
    size = pallas_bvh_wide.table_vmem_bytes(jbvh)
    assert cuda_bvh.wide_table_bytes(pbvh) == size
    assert not pallas_bvh_wide.supported(j32) and not cuda_bvh.wide_admitted(p32)
    for cap in (size, size - 1, 96 * 1024 * 1024):
        monkeypatch.setattr(pallas_bvh_wide, "WIDE_VMEM_BYTES", cap)
        monkeypatch.setattr(cuda_bvh, "WIDE_TABLE_BYTES", cap)
        assert cuda_bvh.wide_admitted(pbvh) == pallas_bvh_wide.supported(jbvh) == (cap >= size)
        want = "wide" if cap >= size else "streamed"
        assert isect.bvh_route(pbvh) == (want, False)
        assert isect.bvh_route(pbvh, reorder=True) == (want, True)
        assert isect.bvh_route(pbvh, streamed=False)[0] == ("wide" if cap >= size else "thread")


# ---------------------------------------------------------------------------
# (f) the slice as a whole: a terrain scene at K=128
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def wide_terrain(tmp_path_factory):
    """(JAX compiled scene, port compiled scene) of the terrain scene with a
    3k-triangle terrain, both compilers told to build 128-wide leaves."""
    d = tmp_path_factory.mktemp("bigmesh")
    terrain.write_obj(d / "terrain.obj", *terrain.make_terrain(3000)[:3])
    (d / "scene.toml").write_text(terrain.terrain_scene_toml(
        resolution=(16, 16), samples=4, **terrain.TERRAIN_VIEW))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pack, "WIDE_MIN_TRIS", 1000)
        mp.setattr(pack, "WIDE_MIN_TRIS", 1000)
        ref = jax_compile(d / "scene.toml")
        port = compile_scene_file(d / "scene.toml", device="cpu")
    return ref, port


def test_compiled_wide_scene_equals_jax(wide_terrain):
    ref, port = wide_terrain
    assert port.data.bvh.blk_p0.shape[1] == 128
    for group in dataclasses.fields(port.data):
        part = getattr(port.data, group.name)
        for f in dataclasses.fields(part):
            want = np.asarray(getattr(getattr(ref.data, group.name), f.name))
            np.testing.assert_array_equal(getattr(part, f.name).numpy(), want,
                                          err_msg=f"{group.name}.{f.name}")
    assert cuda_bounce.supported(port.data, port.settings) == (True, "")


def test_plain_step_matches_jax_step_at_k128(wide_terrain):
    ref, port = wide_terrain
    step_ref = jax.jit(jax_step(ref.data, ref.settings, SEED, allow_fused=False))
    rng = np.random.default_rng(17)
    for bounce in (0, 3, 7, 70):
        parts = _random_state(rng, ref.data, n=768)
        want = step_ref(_mk_state(parts, bounce))
        got = wavefront.plain_bounce_step(port.data, port.settings, SEED,
                                          state_from_numpy(bounce, *parts))
        _assert_states_close(want, types.SimpleNamespace(**state_to_numpy(got)),
                             f"terrain K=128@b{bounce}")


@pytest.mark.parametrize("integrator", ["pt-direct", "depth"])
def test_films_match_jax_at_k128(wide_terrain, integrator):
    ref, port = wide_terrain
    ref = dataclasses.replace(ref, settings=dataclasses.replace(ref.settings,
                                                                integrator=integrator))
    port = dataclasses.replace(port, settings=dataclasses.replace(port.settings,
                                                                  integrator=integrator))
    want = np.asarray(jax_render(ref, seed=1234).film)
    film = render(port, seed=1234, device="cpu").film
    assert film.shape == want.shape == (16, 16, 3) and np.isfinite(film).all()
    scale = float(np.abs(want).max())
    mean_rel = abs(film.mean() - want.mean()) / want.mean()
    block = lambda x: x.reshape(2, 8, 2, 8, 3).mean(axis=(1, 3))
    block_rel = np.abs(block(film) - block(want)).max() / float(np.abs(block(want)).max())
    within = (np.abs(film - want) <= 1e-4 * scale).mean()
    assert mean_rel < MEAN_REL and block_rel < BLOCK_REL and within >= WITHIN_FRAC, (
        mean_rel, block_rel, within)


# ---------------------------------------------------------------------------
# (g) every route on the CPU is the plain walk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [32, 128])
def test_every_route_gives_the_plain_walk_on_the_cpu(k):
    _, pbvh, nrm, mat = _pair(3000, k)
    o, d, t_init, t_stop, _, _ = _with_occlusion(_rays(1024, 5), pbvh)
    f3 = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    geom = Geometry(tri_p0=torch.zeros((nrm.shape[0], 3)), tri_e1=torch.zeros((nrm.shape[0], 3)),
                    tri_e2=torch.zeros((nrm.shape[0], 3)), tri_n=f3(nrm),
                    tri_mat=torch.from_numpy(mat), sph_c=torch.zeros((0, 3)),
                    sph_r=torch.zeros(0), sph_mat=torch.zeros(0, dtype=torch.int32))
    cuda_bounce.reset_counts()
    for occlusion in (False, True):
        want = isect.intersect_bvh(f3(o), f3(d), geom, pbvh, want_shade=True,
                                   t_cap=f3(t_init), occlusion=occlusion, plain=True)
        for streamed in (None, True, False):
            for reorder in (None, True, False):
                got = isect.intersect_bvh(f3(o), f3(d), geom, pbvh, want_shade=True,
                                          t_cap=f3(t_init), occlusion=occlusion,
                                          streamed=streamed, reorder=reorder)
                for a, b in zip(tuple(got[0]) + tuple(got[1]),
                                tuple(want[0]) + tuple(want[1])):
                    assert torch.equal(a, b), (occlusion, streamed, reorder)
    assert sum(cuda_bounce.counts().values()) == 0
