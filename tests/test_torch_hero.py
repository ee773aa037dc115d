"""The bunny scenes on the CPU, the port against the JAX package: sample
(BASELINE config 1: bunny in the cbox, pure pt, Lambert, uniform sky),
welcome (hero render: GGX bunny, an off-scene quad light, pt-direct, IBL,
thin lens) and ridaisai (hero render: two refractive bunnies of 163,842
triangles, pure pt, IBL with a longitude offset, thin lens under two
camera transforms).

* The plain bounce step against the JAX package's plain step on random
  states (768 lanes, bounces 0, 3, 7, 70), under tests/test_fused_bounce.py's
  lane rules.
* The plain bounce step against one bounce of the TPU kernel itself
  (`pallas_bounce.make_step_bvh`, interpret mode) on ridaisai and welcome:
  refraction through closed meshes and GGX on triangles.
* 16x12 x 2-spp films, port CPU against JAX CPU, seed 1234.
The CUDA kernels against these plain versions: tests/test_torch_cuda.py
and chip_smoke.py's phase 28.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from lumillyrender_tpu.integrator.render import render as jax_render
from lumillyrender_tpu.integrator.wavefront import make_bounce_step as jax_step
from lumillyrender_tpu.ops import pallas_bounce
from lumillyrender_tpu.scene.compiler import compile_scene_file as jax_compile
from lumillyrender_tpu_torch.convert import scene_from_numpy, state_from_numpy, state_to_numpy
from lumillyrender_tpu_torch.integrator import wavefront
from lumillyrender_tpu_torch.integrator.render import render
from lumillyrender_tpu_torch.scene.compiler import compile_scene_file
from test_fused_bounce import _assert_states_close, _mk_state, _random_state

torch.set_num_threads(2)

HEROES = ["sample", "welcome", "ridaisai"]
SEED = 7
BOUNCES = (0, 3, 7, 70)
FILM = (16, 12, 2)  # w, h, spp
FILM_SEED = 1234


@pytest.fixture(scope="module")
def compiled(assets_dir):
    """The JAX compiler's scene of each hero, compiled once."""
    return {name: jax_compile(assets_dir / f"{name}.toml") for name in HEROES}


@pytest.mark.parametrize("name", HEROES)
def test_plain_step_matches_jax_step(compiled, name):
    ref = compiled[name]
    scene = scene_from_numpy(ref.data)
    assert scene.geometry.tri_p0.shape[0] > 8192  # the BVH path
    step_ref = jax.jit(jax_step(ref.data, ref.settings, SEED, allow_fused=False))
    rng = np.random.default_rng(len(name))
    for bounce in BOUNCES:
        parts = _random_state(rng, ref.data, n=768)
        want = step_ref(_mk_state(parts, bounce))
        got = wavefront.plain_bounce_step(scene, ref.settings, SEED,
                                          state_from_numpy(bounce, *parts))
        _assert_states_close(want, types.SimpleNamespace(**state_to_numpy(got)),
                             f"{name}@b{bounce}")


@pytest.mark.parametrize("name", ["ridaisai", "welcome"])
def test_plain_step_matches_tpu_bvh_kernel(compiled, name):
    """One bounce of the TPU kernel (`make_step_bvh`, interpret mode, every
    material family and the IBL epilogue) at 1,024 lanes, same rules."""
    ref = compiled[name]
    assert pallas_bounce.supported_bvh(ref.data, ref.settings)
    scene = scene_from_numpy(ref.data)
    kernel = pallas_bounce.make_step_bvh(ref.data, ref.settings, SEED, interpret=True)
    parts = _random_state(np.random.default_rng(12 + len(name)), ref.data, n=1024)
    want = jax.jit(kernel)(_mk_state(parts, 1))
    got = wavefront.plain_bounce_step(scene, ref.settings, SEED, state_from_numpy(1, *parts))
    _assert_states_close(want, types.SimpleNamespace(**state_to_numpy(got)),
                         f"{name}@b1 vs tpu kernel")


# The films' bounds, set from this measurement (port CPU vs JAX CPU, 16x12
# x 2 spp, seed 1234):
#   scene     |mean| rel  4x4 block max rel  pixels within 1e-4 of the max
#   sample    7.5e-3      0.0435             0.934
#   welcome   1.2e-3      0.0051             0.925
#   ridaisai  0           0                  1.000 (max rel 2.7e-7)
# Per lane the two agree to the last bits (the tests above); a last-bit
# difference of XLA's fused multiply-adds and its own transcendentals
# flips a discrete decision now and then (roulette, a tie), and from there
# the two paths are different valid samples, as tests/test_torch_render.py
# sets out. ridaisai's paths did not fork at this size: it keeps the
# goldens' 1e-4 bound on every pixel.
MEAN_REL = 0.02
BLOCK_REL = 0.1
WITHIN_FRAC = 0.85
EXACT = {"ridaisai"}


@pytest.mark.parametrize("name", HEROES)
def test_cpu_film_matches_jax(compiled, assets_dir, name):
    w, h, spp = FILM
    ref = compiled[name]
    ref = dataclasses.replace(ref, settings=dataclasses.replace(
        ref.settings, width=w, height=h, spp=spp))
    want = np.asarray(jax_render(ref, seed=FILM_SEED).film)
    c = compile_scene_file(assets_dir / f"{name}.toml", spp=spp, device="cpu")
    c.settings = dataclasses.replace(c.settings, width=w, height=h)
    got = render(c, seed=FILM_SEED, device="cpu").film
    assert got.shape == want.shape == (h, w, 3) and np.isfinite(got).all()
    rel = np.abs(got - want) / max(float(np.abs(want).max()), 1e-6)
    if name in EXACT:
        assert rel.max() < 1e-4, f"{name}: max rel {rel.max():.2e}"
        return
    mean_rel = abs(got.mean() - want.mean()) / want.mean()
    block = lambda x: x.reshape(h // 4, 4, w // 4, 4, 3).mean(axis=(1, 3))
    block_rel = np.abs(block(got) - block(want)).max() / float(np.abs(block(want)).max())
    within = (rel <= 1e-4).mean()
    assert mean_rel < MEAN_REL, f"{name}: mean rel {mean_rel:.2e}"
    assert block_rel < BLOCK_REL, f"{name}: 4x4 block rel {block_rel:.3f}"
    assert within >= WITHIN_FRAC, f"{name}: {within:.3f} of pixels within 1e-4"
