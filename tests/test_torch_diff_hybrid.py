"""The hybrid differentiable step (`cuda_bounce.make_step_hybrid`) on the CPU,
for the scenes that take it on the card besides the brute-force ones under
a uniform sky: BVH scenes (welcome-geo, BASELINE config 5), the IBL sky and
the simple sky. On the CPU it runs the plain step forward and autograd of
`cuda_bounce.recompute` backward, the code the card runs with the bounce
kernel forward and kernel 3 in the recompute's walk.

* One bounce on a random state of 512 lanes at bounce 2, in four scenes
  (welcome-geo under its IBL sky and under the simple sky, ibl-material:
  brute force, IBL, all five families; new-cbox under the simple sky): the
  outputs bit-equal to `plain_bounce_step`, the gradients in o, d,
  throughput, accum, the material colours and emissions and the sky's
  leaves (`color`; `color` and `color2`; `ibl`) bit-equal to autograd of
  `plain_bounce_step(..., plain_walk=False)` (the walk through `_TriHit`'s
  plane-equation VJP; on a brute-force scene the option changes nothing).
  On welcome-geo, autograd of the plain walk itself (through its triangle
  tests) on parity.py's comparable lanes within `parity.AUTOGRAD_BWD_RTOL`:
  measured 1.1e-7 (o) and 6.8e-8 (d) under both skies, every other
  gradient bit-equal: two derivatives of one plane equation.
* `film_and_grads` on the card's route (`make_step_diff` replaced by the
  card's dispatch, which takes the hybrid for welcome-geo) against the JAX
  package's `film_and_grads`, welcome-geo at 12x9 x 2 spp and two bounces,
  under its IBL sky and under the simple sky. The two packages' camera
  rays differ in the last bit on a few lanes (5 of 216 here: PyTorch's and
  XLA's float operations), which moves those lanes' pixels by up to 1.8e-3
  of the film max, while every other pixel agrees within 5.8e-9. As
  parity.py's rules exclude flipped lanes, the pixels whose forward films
  differ by more than 1e-5 of the film max (5 of 108; at most 8% may) get
  a target equal to each side's own film, so that they add nothing to
  either loss. Then the loss within 1e-4 (measured 2.0e-7 / 9.7e-8), the
  film and every float leaf's gradient, `sky.ibl` included, within 1e-3 of
  the leaf's largest magnitude (the gate of tests/test_torch_diff.py);
  measured at most 8.5e-6 under the IBL sky (camera.position; sky.ibl
  1.9e-6) and 5.5e-5 under the simple sky (camera.focus_distance).
* The example `examples/invert_materials_torch.py` runs on the CPU.

Inputs are compiled by the JAX package and carried across with
`convert.py`.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumillyrender_tpu.diff.render import film_and_grads as jax_film_and_grads
from lumillyrender_tpu.diff.render import params_of as jax_params_of
from lumillyrender_tpu.diff.render import render_diff as jax_render_diff
from lumillyrender_tpu.scene.compiler import compile_scene_file as jax_compile
from lumillyrender_tpu.scene.data import SKY_SIMPLE
from lumillyrender_tpu_torch import parity
from lumillyrender_tpu_torch.convert import params_from_numpy, scene_from_numpy, state_from_numpy
from lumillyrender_tpu_torch.diff import film_and_grads, render_diff
from lumillyrender_tpu_torch.integrator import wavefront
from lumillyrender_tpu_torch.ops import cuda_bounce, intersect
from test_fused_bounce import _random_state
from test_torch_diff import WHOLE_PATH_RTOL, _assert_params_close
from torch_diff_steps import step_grads

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SEED = 77
N = 512
MERIDIAN, HORIZON = (0.1, 0.2, 0.9), (0.9, 0.8, 0.7)
# Pixels whose forward films differ by more than this share of the film max
# carry a lane whose decisions flipped between the packages; at most
# parity.py's share of excluded lanes may.
FLIP = 1e-5


def _simple_sky(c):
    c.data = dataclasses.replace(c.data, sky=dataclasses.replace(
        c.data.sky, color=jnp.asarray(MERIDIAN, jnp.float32),
        color2=jnp.asarray(HORIZON, jnp.float32)))
    c.settings = dataclasses.replace(c.settings, sky_kind=SKY_SIMPLE)
    return c


@pytest.fixture(scope="module")
def compiled(assets_dir):
    """name -> a factory of the JAX-compiled scene (welcome-geo's obj and
    BVH are loaded once)."""
    geo = jax_compile(assets_dir / "welcome-geo.toml", spp=2)
    cbox = jax_compile(assets_dir / "new-cbox.toml", spp=1)
    ibl = jax_compile(assets_dir / "ibl-material.toml", spp=1)
    copy = lambda c: dataclasses.replace(c)
    return {"welcome-geo": lambda: copy(geo),
            "welcome-geo-simple": lambda: _simple_sky(copy(geo)),
            "ibl-material": lambda: copy(ibl),
            "new-cbox-simple": lambda: _simple_sky(copy(cbox))}


@pytest.mark.parametrize("name", ["welcome-geo", "welcome-geo-simple", "ibl-material",
                                  "new-cbox-simple"])
def test_hybrid_bounce_is_autograd_of_the_plain_step(compiled, name):
    c = compiled[name]()
    scene, st = scene_from_numpy(c.data), c.settings
    assert cuda_bounce.diff_step_kind(scene, st, on_card=True) == "hybrid"
    rng = np.random.default_rng(5)
    state = state_from_numpy(2, *_random_state(rng, c.data, N))
    cot = [torch.from_numpy(rng.normal(size=(N, 3)).astype(np.float32)) for _ in range(4)]
    step = lambda plain_walk: lambda live, m: lambda s: wavefront.plain_bounce_step(
        live, st, SEED, s, m, plain_walk=plain_walk)
    out, got = step_grads(lambda live, m: cuda_bounce.make_step_hybrid(live, st, SEED, m),
                       scene, st, state, cot)
    ref, want = step_grads(step(False), scene, st, state, cot)
    fwd = wavefront.plain_bounce_step(scene, st, SEED, state)
    for k in ("o", "d", "throughput", "accum", "alive", "rays_traced"):
        assert torch.equal(getattr(out, k), getattr(fwd, k)), k
        assert torch.equal(getattr(ref, k), getattr(fwd, k)), k
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert got[4].abs().sum() > 0 and got[-1].abs().sum() > 0  # colours, sky
    if name.startswith("welcome-geo"):
        _, plain = step_grads(step(True), scene, st, state, cot)
        _, sp = intersect.intersect_shade(state.o, state.d, scene.geometry, scene.bvh,
                                          st.intersector, plain=True)
        keep = parity.bwd_comparable(fwd, fwd, sp.normal)
        errs = parity.bwd_errors(
            dict(o=plain[0], d=plain[1], throughput=plain[2], albedo=plain[4],
                 emission=plain[5], sky=plain[6]),
            dict(o=got[0], d=got[1], throughput=got[2], albedo=got[4], emission=got[5],
                 sky=got[6]), keep)
        assert keep.mean() > parity.BWD_LIMITS["comparable"]
        assert not parity.bwd_failures(errs, parity.AUTOGRAD_BWD_RTOL), errs


@pytest.mark.parametrize("sky", ["ibl", "simple"])
def test_film_and_grads_on_the_cards_route_matches_jax(compiled, monkeypatch, sky):
    c = compiled["welcome-geo" if sky == "ibl" else "welcome-geo-simple"]()
    c.settings = dataclasses.replace(c.settings, width=12, height=9, max_bounces=2)
    scene, st = scene_from_numpy(c.data), c.settings
    p_true = params_from_numpy(jax_params_of(c.data))
    assert cuda_bounce.diff_step_kind(scene, st, on_card=True) == "hybrid"
    assert cuda_bounce.diff_step_kind(scene, st, on_card=False) == "plain"
    monkeypatch.setattr(cuda_bounce, "make_step_diff", cuda_bounce.make_step_hybrid)
    target = render_diff(scene, st, p_true, 33, 2, device="cpu")
    color = p_true.materials.color.clone()
    color[0, 0] = 0.3
    p = p_true._replace(materials=dataclasses.replace(p_true.materials, color=color))
    jp = jax_params_of(c.data)
    jp = jp._replace(materials=dataclasses.replace(
        jp.materials, color=jp.materials.color.at[0, 0].set(0.3)))

    film = render_diff(scene, st, p, 33, 2, device="cpu").numpy()
    j_film = np.asarray(jax_render_diff(c.data, st, jp, 33, 2))
    flipped = np.abs(film - j_film).max(axis=2) > FLIP * np.abs(j_film).max()
    assert flipped.mean() < parity.LIMITS["excluded"], int(flipped.sum())
    keep = ~flipped[..., None]
    t_port = np.where(keep, target.numpy(), film)
    t_jax = np.where(keep, target.numpy(), j_film)

    loss, f, grads = film_and_grads(scene, st, p, torch.from_numpy(t_port), 33, 2,
                                    device="cpu")
    j_loss, j_f, j_grads = jax_film_and_grads(c.data, st, jp, jnp.asarray(t_jax), 33, 2)
    assert abs(float(loss) - float(j_loss)) <= 1e-4 * float(j_loss)
    assert np.array_equal(f.numpy(), film)
    assert np.abs(np.where(keep, film - np.asarray(j_f), 0)).max() <= FLIP * np.abs(film).max()
    _assert_params_close(grads, j_grads, WHOLE_PATH_RTOL)
    names = cuda_bounce.SKY_LEAVES[st.sky_kind]
    assert all(getattr(grads.sky, k).abs().sum() > 0 for k in names)


def test_example_runs_on_the_cpu():
    r = subprocess.run(
        [sys.executable, "examples/invert_materials_torch.py", "--cpu", "--steps", "3",
         "--size", "16", "--spp", "1"],
        cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert lines[0].startswith("observable materials: ")
    assert lines[-2].startswith("initial max albedo error ")
    assert lines[-1] in ("recovered: error reduced by >2x",
                         "WARNING: optimization made <2x progress")


@pytest.mark.parametrize("m,width,n", [(2, 3, 5000), (7, 1, 5000), (8192, 3, 20000),
                                       (3, 3, 100), (5, 3, 0)])
def test_scatter_rows_is_the_gathers_gradient(m, width, n):
    """`ops/table.py::scatter_rows`, the backward of a row gather on the
    card (blocks of lanes, each added as index_put_ adds, then summed in a
    fixed order), against the sum autograd's own backward gives, in float64
    (the two add in different orders)."""
    from lumillyrender_tpu_torch.ops.table import scatter_rows

    rng = np.random.default_rng(m + n)
    idx = torch.from_numpy(rng.integers(0, m, size=n))
    rows = torch.from_numpy(rng.normal(size=(n, width) if width > 1 else (n,)).astype(np.float32))
    got = scatter_rows(idx, rows, m)
    want = torch.zeros((m,) + tuple(rows.shape[1:]), dtype=torch.float64).index_put_(
        (idx,), rows.double(), accumulate=True)
    assert got.shape == want.shape and got.dtype == rows.dtype
    torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-5 * max(1.0, n ** 0.5))
    assert torch.equal(got, scatter_rows(idx, rows, m))


@pytest.mark.parametrize("name", sorted(p.stem for p in (REPO / "assets").glob("*.toml")))
def test_every_asset_has_a_step_on_the_card(name):
    """Every asset the card's forward path serves has a differentiable step
    there, under its own sky and under the simple sky: the backward
    kernel's (Lambert-only brute force under a uniform sky) or the hybrid,
    never autograd of the plain step, which the card does not run."""
    from lumillyrender_tpu_torch.scene.compiler import compile_scene_file
    from lumillyrender_tpu_torch.scene.data import SKY_SIMPLE as SIMPLE

    c = compile_scene_file(REPO / "assets" / f"{name}.toml", spp=1, device="cpu")
    assert cuda_bounce.supported(c.data, c.settings) == (True, "")
    kind = cuda_bounce.diff_step_kind(c.data, c.settings, on_card=True)
    assert kind == ("bwd" if cuda_bounce.diff_supported(c.data, c.settings)[0] else "hybrid")
    simple = dataclasses.replace(c.settings, sky_kind=SIMPLE)
    assert cuda_bounce.diff_step_kind(c.data, simple, on_card=True) == "hybrid"
