"""The AOV chunk (`--aov depth`, `--aov normal`) as the card's `ForwardPlan`
captures it, on the CPU.

On the card a `ChunkRenderer` renders every chunk as a captured plan, the
AOVs too: raygen writes the plan's rays, and the graph holds the query
(the sphere pre-pass and the walk `ops/intersect.py::bvh_route` picks:
kernel 3, 6 or 7, the sort where `LLR_REORDER=1` asks for it) and the bank,
`wavefront.bank_ordered`: a reshape-sum over the chunk's samples, each film
row written once, so that two runs give the same film bit for bit (the
index_add it replaces adds with atomics on CUDA). These tests hold:

* `bank_ordered` against the JAX package's `.at[pix].add` on the same lane
  values, depth and normal, on a raster film (24x20: no 8x8 tile) and a
  tiled one (32x32), within 1e-6 of the film's largest magnitude (the two
  sum each pixel's samples in their own order); and the port's AOV films
  against the JAX package's `render` on the same scenes under
  tests/test_torch_render.py's film gate (MEAN_REL, BLOCK_REL, WITHIN_FRAC),
  new-cbox (brute force) and welcome-geo (its K=32 BVH);
* the capture guard of tests/test_torch_train_plan.py (`HostReads`) over a
  plan's traced AOV work, with the CPU's stand-in for the walk kernels
  (`cuda_bvh.walk`, the plain walk, a host loop) paused: nothing read to
  the host, no tensor made from host data, the walk reached through the
  route, and the film bit-equal to the eager chunk's; under LLR_REORDER=1
  the sort too; a read planted in the query, or a tensor made from a list
  in the bank, makes the guard fire;
* `ChunkRenderer` on a CUDA device captures depth and normal chunks
  (`graphed`), checked by its constructor's rule with no card.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumillyrender_tpu.integrator.render import render as jax_render
from lumillyrender_tpu.integrator.render import tile_decode as jax_tile_decode
from lumillyrender_tpu.scene.compiler import compile_scene_file as jax_compile
from lumillyrender_tpu_torch.integrator import render as render_mod
from lumillyrender_tpu_torch.integrator import wavefront
from lumillyrender_tpu_torch.integrator.render import ChunkRenderer, ForwardPlan, render
from lumillyrender_tpu_torch.ops import cuda_bounce, cuda_bvh
from lumillyrender_tpu_torch.ops import intersect as isect
from lumillyrender_tpu_torch.scene.compiler import compile_scene_file
from lumillyrender_tpu_torch.scene.data import SceneData
from test_torch_render import BLOCK_REL, MEAN_REL, WITHIN_FRAC
from test_torch_train_plan import HostReads, _unguarded

torch.set_num_threads(2)

CPU = "cpu"
SEED = 1234
# film: (width, height); raster has no 8x8 tile (render.tile_dims).
FILMS = {"raster": (24, 20), "tiled": (32, 32)}
SPP = 2
BANK_RTOL = 1e-6


@functools.lru_cache(maxsize=None)
def _scene(path, spp):
    """(the port's compiled scene on the CPU, the JAX package's), compiled once."""
    return compile_scene_file(path, spp=spp, device=CPU), jax_compile(path, spp=spp)


def _compiled(assets_dir, name, integrator, film, spp=SPP):
    """`_scene` at `film` under `integrator`."""
    w, h = FILMS[film]
    return [dataclasses.replace(c, settings=dataclasses.replace(
        c.settings, width=w, height=h, integrator=integrator))
        for c in _scene(assets_dir / f"{name}.toml", spp)]


@pytest.mark.parametrize("film", list(FILMS))
@pytest.mark.parametrize("integrator", ["depth", "normal"])
def test_ordered_bank_matches_jax_scatter(assets_dir, integrator, film):
    port, ref = _compiled(assets_dir, "welcome-geo", integrator, film)
    st = port.settings
    w, h = st.width, st.height
    assert (render_mod.tile_dims(st) is None) == (film == "raster")
    n = w * h * SPP
    o, d, _, _ = cuda_bounce.plain_generate_rays(port.data, st, SEED, 0, n)
    val = wavefront.aov(port.data, st, o, d)
    got = wavefront.bank_ordered(torch.zeros((w * h, 3)), val, render_mod._pixel_fn(st))
    lane = jnp.arange(n, dtype=jnp.uint32)
    decode = jax_tile_decode(ref.settings)
    if decode is None:
        pix = (lane % (w * h)).astype(jnp.int32)
    else:
        px, py = decode(lane % jnp.uint32(w * h))
        pix = (py * w + px).astype(jnp.int32)
    want = np.asarray(jnp.zeros((w * h, 3), jnp.float32).at[pix].add(jnp.asarray(val.numpy())))
    scale = float(np.abs(want).max())
    assert scale > 0 and (want.max(axis=1) > 0).mean() > 0.3  # pixels that hit
    assert np.abs(got.numpy() - want).max() <= BANK_RTOL * scale


@pytest.mark.parametrize("name,integrator,film", [
    ("new-cbox", "depth", "raster"), ("new-cbox", "normal", "tiled"),
    ("welcome-geo", "depth", "tiled"), ("welcome-geo", "normal", "raster")])
def test_aov_film_matches_jax_render(assets_dir, name, integrator, film):
    port, ref = _compiled(assets_dir, name, integrator, film)
    want = np.asarray(jax_render(ref, seed=SEED).film)
    got = render(port, seed=SEED, device=CPU).film
    w, h = FILMS[film]
    assert got.shape == want.shape == (h, w, 3) and np.isfinite(got).all()
    mean_rel = abs(got.mean() - want.mean()) / want.mean()
    block = lambda x: x.reshape(h // 4, 4, w // 4, 4, 3).mean(axis=(1, 3))  # noqa: E731
    block_rel = np.abs(block(got) - block(want)).max() / float(np.abs(block(want)).max())
    within = (np.abs(got - want) <= 1e-4 * np.abs(want).max()).mean()
    assert mean_rel < MEAN_REL and block_rel < BLOCK_REL and within >= WITHIN_FRAC, (
        mean_rel, block_rel, within)


def _aov_plan(assets_dir, name, integrator, film="tiled", spp=SPP):
    """A ForwardPlan of the AOV chunk on the CPU, its rays written as the
    card's raygen writes them, and the eager chunk's film at offset 0."""
    port, _ = _compiled(assets_dir, name, integrator, film, spp)
    scene, st = port.data, port.settings
    plan = ForwardPlan(scene, st, SEED, None, spp)
    o, d, _, _ = cuda_bounce.plain_generate_rays(scene, st, SEED, 0, plan.n)
    plan.o.copy_(o)
    plan.d.copy_(d)
    want, rays = ChunkRenderer(scene, st, SEED, CPU).chunk(0, spp)
    assert float(rays) == plan.n
    return plan, want


def _guarded_trace(plan, monkeypatch):
    """The plan's traced work under the guard, the walk's CPU stand-in
    paused: (film_flat, the guard's hits, walks)."""
    guard = HostReads()
    walks = []
    _unguarded(guard, monkeypatch, cuda_bvh, "walk")
    inner = cuda_bvh.walk
    monkeypatch.setattr(cuda_bvh, "walk", lambda *a, **k: walks.append(a[0]) or inner(*a, **k))
    with guard:
        film, rays = plan._trace()
    assert float(rays) == 0.0
    return film, guard.hits, walks


@pytest.mark.parametrize("name,integrator,reorder", [
    ("welcome-geo", "depth", False), ("welcome-geo", "normal", False),
    ("welcome-geo", "depth", True), ("new-cbox", "normal", False)])
def test_aov_plan_reads_nothing_to_the_host(assets_dir, monkeypatch, name, integrator, reorder):
    if reorder:
        monkeypatch.setenv("LLR_REORDER", "1")
    plan, want = _aov_plan(assets_dir, name, integrator)
    sorted_ = []
    key = isect._ray_sort_key
    monkeypatch.setattr(isect, "_ray_sort_key", lambda *a: sorted_.append(1) or key(*a))
    film, hits, walks = _guarded_trace(plan, monkeypatch)
    assert hits == []
    assert walks == (["bvh"] if name == "welcome-geo" else [])  # kernel 3's route
    assert len(sorted_) == (1 if reorder else 0)
    assert torch.equal(film.reshape(want.shape), want)
    assert film.abs().sum() > 0


@pytest.mark.parametrize("planted", ["float", "list"])
def test_capture_guard_fires_on_the_aov_chunk(assets_dir, monkeypatch, planted):
    plan, _ = _aov_plan(assets_dir, "welcome-geo", "depth")
    if planted == "float":
        shade_point = wavefront.shade_point

        def with_read(o, d, hit, geom):
            float(hit.t.sum())  # a value read to the host
            return shade_point(o, d, hit, geom)

        monkeypatch.setattr(wavefront, "shade_point", with_read)
    else:
        bank = render_mod.bank_ordered

        def with_list(film, vals, *a):
            return bank(film + film.new_tensor([0.0, 0.0, 0.0]), vals, *a)

        monkeypatch.setattr(render_mod, "bank_ordered", with_list)
    _, hits, _ = _guarded_trace(plan, monkeypatch)
    assert hits and set(hits) == {"aten._local_scalar_dense" if planted == "float"
                                  else "aten.lift_fresh"}


@pytest.mark.parametrize("integrator", ["depth", "normal"])
def test_chunk_renderer_captures_aov_chunks_on_a_card(assets_dir, monkeypatch, integrator):
    """The constructor's rule, with no card: on a CUDA device `graphed` is
    true for the AOVs (`captures_chunks`, as for pt and pt-direct); on the
    CPU it is false."""
    port, _ = _compiled(assets_dir, "new-cbox", integrator, "tiled")
    assert not ChunkRenderer(port.data, port.settings, SEED, CPU).graphed
    assert render_mod.captures_chunks(torch.device("cuda"))
    assert not render_mod.captures_chunks(torch.device(CPU))
    monkeypatch.setattr(render_mod, "resolve_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(SceneData, "to", lambda self, device: self)
    renderer = ChunkRenderer(port.data, port.settings, SEED, "cuda")
    assert renderer.graphed and renderer.aov and renderer.step is None
