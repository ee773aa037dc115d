"""The backward pass of one bounce: the port against the JAX package.

* `plain_bounce_bwd` (the plain version of the CUDA backward kernel)
  against the JAX package's hand-written backward kernel
  (`pallas_bounce.make_step_diff`, interpret mode) and against `jax.vjp` of
  its XLA step, on new-cbox, debug-nee (a sphere light: the shadow hit's
  normal chain) and primitive (pure pt: sky terms and the main hit's sphere
  chain). The JAX package's own gate (tests/test_fused_bounce.py::
  _compare_bwd): N = 1536 random lanes at bounce 6, random cotangents
  zeroed on the lanes `parity.bwd_comparable` excludes, then every lane
  cotangent and table gradient compared. The gate's tolerances are 8e-3 of
  a cotangent's largest magnitude and 5e-3 of a table's; measured here
  (CPU) the largest error is 9.5e-7, so these tests hold 1e-5.
* Autograd of the port's plain step (the hybrid step's backward) against
  `jax.vjp` of the XLA step, on the glossy scene of
  tests/test_fused_bounce.py and the mixed scene of tests/test_diff.py,
  every material column included: measured at most 1.7e-5 (d on the mixed
  scene, GGX roughness 1.3e-5), held to 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumillyrender_tpu.diff.render import params_of
from lumillyrender_tpu.integrator.wavefront import PathState as JaxState
from lumillyrender_tpu.ops import pallas_bounce
from lumillyrender_tpu.scene.compiler import compile_scene as jax_compile_scene
from lumillyrender_tpu.scene.compiler import compile_scene_file as jax_compile
from lumillyrender_tpu.scene.loader import parse_config as jax_parse
from lumillyrender_tpu_torch import parity
from lumillyrender_tpu_torch.convert import scene_from_numpy, state_from_numpy, state_to_numpy
from lumillyrender_tpu_torch.integrator import wavefront
from lumillyrender_tpu_torch.ops import cuda_bounce
from lumillyrender_tpu_torch.ops.bounce_bwd import plain_bounce_bwd
from lumillyrender_tpu_torch.ops.intersect import intersect_shade_brute
from test_diff import SCENE as MIXED_SCENE
from test_fused_bounce import GLOSSY_DIFF_SCENE, N, _mk_state, _random_state, _xla_step_fn

torch.set_num_threads(2)

SEED = 77
BOUNCE = 6
RTOL_CLOSED_FORM = 1e-5
RTOL_AUTOGRAD = 1e-4


def _case(compiled, tag):
    """(JAX state, port scene, port state, cotangents (numpy (N,3) x4))."""
    rng = np.random.default_rng(sum(map(ord, tag)))
    parts = _random_state(rng, compiled.data)
    cot = [rng.normal(size=(N, 3)).astype(np.float32) for _ in range(4)]
    return (_mk_state(parts, BOUNCE), scene_from_numpy(compiled.data),
            state_from_numpy(BOUNCE, *parts), cot)


def _jax_pullback(pull, state, cot):
    f0 = lambda x: np.zeros(np.shape(x), jax.dtypes.float0)
    g = JaxState(bounce=f0(state.bounce), o=jnp.asarray(cot[0]), d=jnp.asarray(cot[1]),
                 throughput=jnp.asarray(cot[2]), accum=jnp.asarray(cot[3]),
                 alive=f0(state.alive), rays_traced=jnp.float32(0.0), lane=f0(state.lane))
    return pull(g)


def _keep(out_ref, out_port, scene, st):
    _, sp = intersect_shade_brute(st.o, st.d, scene.geometry)
    keep = parity.bwd_comparable(out_ref, state_to_numpy(out_port), sp.normal)
    assert keep.mean() > parity.BWD_LIMITS["comparable"], keep.mean()
    return keep


@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("name", ["new-cbox", "debug-nee", "primitive"])
def test_plain_bwd_matches_jax(assets_dir, name, ref):
    c = jax_compile(assets_dir / f"{name}.toml", spp=1)
    assert cuda_bounce.diff_supported(scene_from_numpy(c.data), c.settings)[0]
    state, scene, st, cot = _case(c, name)
    params = params_of(c.data)
    if ref == "xla":
        run = _xla_step_fn(c.data, c.settings, SEED)
    else:
        def run(s, m, sky):
            sc = dataclasses.replace(c.data, sky=sky)
            return pallas_bounce.make_step_diff(sc, c.settings, SEED, m, interpret=True)(s)
    out_ref, pull = jax.vjp(run, state, params.materials, params.sky)
    out_port = wavefront.plain_bounce_step(scene, c.settings, SEED, st)
    keep = _keep(out_ref, out_port, scene, st)
    cot = [g * keep[:, None] for g in cot]
    sb, mb, kb = _jax_pullback(pull, state, cot)
    got = plain_bounce_bwd(scene, c.settings, SEED, st, *map(torch.from_numpy, cot))
    np.testing.assert_array_equal(got.alive.numpy()[keep], np.asarray(out_ref.alive)[keep])
    want = dict(o=sb.o, d=sb.d, throughput=sb.throughput, albedo=mb.color,
                emission=mb.emission, sky=kb.color)
    errs = parity.bwd_errors(want, got, keep)
    assert max(errs.values()) < RTOL_CLOSED_FORM, errs
    np.testing.assert_array_equal(np.asarray(sb.accum), cot[3])  # accum passes through


@pytest.mark.parametrize("name", ["glossy", "mixed"])
def test_autograd_plain_step_matches_jax_vjp(name):
    """The hybrid step's backward: autograd of the plain step with the
    evaluation table and the sky live, against jax.vjp of the XLA step."""
    toml = GLOSSY_DIFF_SCENE if name == "glossy" else MIXED_SCENE.replace(
        "INTEGRATOR", "pt-direct")
    c = jax_compile_scene(jax_parse(toml), spp=1)
    state, scene, st, cot = _case(c, name)
    assert cuda_bounce.hybrid_supported(scene, c.settings)[0]
    params = params_of(c.data)
    out_ref, pull = jax.vjp(_xla_step_fn(c.data, c.settings, SEED), state,
                            params.materials, params.sky)
    out_port = wavefront.plain_bounce_step(scene, c.settings, SEED, st)
    keep = _keep(out_ref, out_port, scene, st)
    cot = [g * keep[:, None] for g in cot]
    sb, mb, kb = _jax_pullback(pull, state, cot)

    leaves = [st.o, st.d, st.throughput, st.accum, scene.materials.color,
              scene.materials.emission, scene.materials.alpha, scene.materials.ior,
              scene.sky.color]
    xs = [t.clone().requires_grad_() for t in leaves]
    mats = dataclasses.replace(scene.materials, color=xs[4], emission=xs[5], alpha=xs[6],
                               ior=xs[7])
    sc = dataclasses.replace(scene, sky=dataclasses.replace(scene.sky, color=xs[8]))
    out = wavefront.plain_bounce_step(
        sc, c.settings, SEED, dataclasses.replace(st, o=xs[0], d=xs[1], throughput=xs[2],
                                                  accum=xs[3]), mats)
    grads = torch.autograd.grad((out.o, out.d, out.throughput, out.accum), xs,
                                [torch.from_numpy(g) for g in cot], allow_unused=True)
    want = [sb.o, sb.d, sb.throughput, sb.accum, mb.color, mb.emission, mb.alpha, mb.ior,
            kb.color]
    for k, (g, w) in enumerate(zip(grads, want)):
        g = np.zeros(np.shape(w), np.float32) if g is None else g.numpy()
        w = np.asarray(w)
        if k < 4:
            g, w = g[keep], w[keep]
        assert np.isfinite(g).all(), k
        rel = np.abs(g - w).max(initial=0.0) / max(np.abs(w).max(initial=0.0), 1e-6)
        assert rel < RTOL_AUTOGRAD, (k, rel)
