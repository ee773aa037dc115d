"""Checkpoint/resume of the port on the CPU (utils/checkpoint.py): a resumed
render is bit-equal to an uninterrupted one, a checkpoint of another render
is refused, and a checkpoint that the JAX package wrote resumes in the
port (one way: the JAX package's load compares its `mat_types` tuple with
the saved list and refuses the port's checkpoints)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from lumillyrender_tpu.integrator.render import render as jax_render
from lumillyrender_tpu.scene.compiler import compile_scene as jax_compile
from lumillyrender_tpu.scene.loader import parse_config as jax_parse
from lumillyrender_tpu.utils import checkpoint as jax_ckpt
from lumillyrender_tpu_torch.integrator.render import ChunkRenderer, render
from lumillyrender_tpu_torch.scene.compiler import compile_scene
from lumillyrender_tpu_torch.scene.loader import parse_config
from lumillyrender_tpu_torch.utils import checkpoint as ckpt
from test_checkpoint import SCENE

torch.set_num_threads(2)


def scene(spp=None, **settings):
    c = compile_scene(parse_config(SCENE), device="cpu")
    if spp is not None:
        settings["spp"] = spp
    c.settings = dataclasses.replace(c.settings, **settings)
    return c


@pytest.mark.parametrize("every", [0, 4])
def test_resume_is_exact(tmp_path, every):
    """tests/test_checkpoint.py::test_resume_is_exact: 8 spp at chunk 2
    against 4 spp, checkpointed, then resumed to 8. The checkpoint really
    holds the first half, so the resume renders only the second."""
    ref = render(scene(), seed=42, spp_chunk=2, device="cpu")
    ck = tmp_path / "r.ckpt.npz"
    half = render(scene(4), seed=42, spp_chunk=2, device="cpu", checkpoint=str(ck),
                  checkpoint_every=every)
    saved = ckpt.load(ck, scene().settings, 42)
    assert saved is not None
    film_sum, done, rays = saved
    assert done == 4 and rays == half.rays
    assert np.array_equal(film_sum, half.film * 4)  # 4 is a power of two
    resumed = render(scene(), seed=42, spp_chunk=2, device="cpu", checkpoint=str(ck))
    assert np.array_equal(ref.film, resumed.film)
    assert resumed.rays == ref.rays  # whole-number sums, exact in float64
    assert ckpt.load(ck, scene().settings, 42)[1] == 8


def test_checkpoint_rejects_mismatched_config(tmp_path):
    ck = tmp_path / "r.ckpt.npz"
    c = scene()
    render(c, seed=1, spp_chunk=4, device="cpu", checkpoint=str(ck))
    assert ckpt.load(ck, c.settings, 1) is not None
    assert ckpt.load(ck, scene(16).settings, 1) is not None  # more spp: extends
    assert ckpt.load(ck, scene(width=32).settings, 1) is None  # resolution
    assert ckpt.load(ck, scene(max_bounces=5).settings, 1) is None
    assert ckpt.load(ck, c.settings, 2) is None  # seed
    assert ckpt.load(tmp_path / "absent.npz", c.settings, 1) is None
    with np.load(ck) as z:
        film, meta = z["film_sum"], json.loads(str(z["meta"]))
    meta["version"] = ckpt.FORMAT_VERSION + 1
    other = tmp_path / "v2.npz"
    with open(other, "wb") as f:
        np.savez_compressed(f, film_sum=film, meta=json.dumps(meta))
    assert ckpt.load(other, c.settings, 1) is None  # format version


def test_port_resumes_a_jax_checkpoint(tmp_path):
    """The JAX package's save, the port's load: the same film sum, sample
    counter and ray count, and a resume that adds the port's chunks to that
    film exactly as render adds them."""
    ck = tmp_path / "jax.ckpt.npz"
    jc = jax_compile(jax_parse(SCENE))
    jc.settings = dataclasses.replace(jc.settings, spp=4)
    jax_half = jax_render(jc, seed=42, spp_chunk=2, checkpoint=str(ck))
    with np.load(ck) as z:
        want_film = np.asarray(z["film_sum"])
        want_meta = json.loads(str(z["meta"]))
    assert "fused" in want_meta["settings"]
    saved = ckpt.load(ck, scene().settings, 42)
    assert saved is not None
    film_sum, done, rays = saved
    assert np.array_equal(film_sum, want_film)
    assert done == 4 == want_meta["samples_done"]
    assert rays == want_meta["total_rays"] == jax_half.rays

    resumed = render(scene(), seed=42, spp_chunk=2, device="cpu", checkpoint=str(ck))
    c = scene()
    chunks = ChunkRenderer(c.data, c.settings, 42, "cpu")
    film = torch.from_numpy(want_film.copy())
    for offset in (4, 6):
        film += chunks.chunk(offset, 2)[0]
    assert np.array_equal(resumed.film, film.numpy() / 8)

    # One way only: the JAX package's load compares its `mat_types` tuple
    # with the list the port's checkpoint holds.
    port_ck = tmp_path / "port.ckpt.npz"
    render(scene(4), seed=42, spp_chunk=2, device="cpu", checkpoint=str(port_ck))
    assert jax_ckpt.load(port_ck, jc.settings, 42) is None
