"""The PyTorch port's scene compiler against the JAX package's: every
compiled table is equal, leaf for leaf (the JAX package's TPU-only `pk_*`
BVH layouts excepted), and so are the render settings."""

import dataclasses

import numpy as np
import pytest
import torch

from lumillyrender_tpu.scene.compiler import compile_scene_file as jax_compile
from lumillyrender_tpu_torch.convert import scene_from_numpy
from lumillyrender_tpu_torch.scene.compiler import compile_scene_file
from lumillyrender_tpu_torch.scene.data import SceneData

torch.set_num_threads(2)

# Every asset scene but welcome-geo (tests/test_torch_render.py holds its
# film): the bunny scenes sample (BASELINE config 1), welcome and ridaisai
# (the JAX package's hero renders; two bunnies, 163,842 triangles) too.
SCENES = ["primitive", "debug-nee", "brdf", "new-cbox", "many-light",
          "ibl-material", "vr", "sample", "welcome", "ridaisai"]


def _leaves(scene: SceneData):
    for group in dataclasses.fields(scene):
        part = getattr(scene, group.name)
        for f in dataclasses.fields(part):
            yield f"{group.name}.{f.name}", getattr(part, f.name)


@pytest.mark.parametrize("name", SCENES)
def test_scene_tables_equal_jax(assets_dir, name):
    """Exact equality (tolerance 0): both compile the same float64 numpy
    tables and round them to float32 once."""
    ref = jax_compile(assets_dir / f"{name}.toml")
    port = compile_scene_file(assets_dir / f"{name}.toml", device="cpu")
    for path, t in _leaves(port.data):
        group, field = path.split(".")
        want = np.asarray(getattr(getattr(ref.data, group), field))
        got = t.numpy()
        assert got.shape == want.shape, (path, got.shape, want.shape)
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=path)

    ref_settings = {f.name: getattr(ref.settings, f.name)
                    for f in dataclasses.fields(port.settings)}
    assert dataclasses.asdict(port.settings) == ref_settings
    assert port.stats["polygons"] == ref.stats["polygons"]


def test_scene_from_numpy_round_trip(assets_dir):
    """convert.scene_from_numpy of the JAX scene's leaves gives the same
    tensors as compiling with the port."""
    ref = jax_compile(assets_dir / "new-cbox.toml")
    port = compile_scene_file(assets_dir / "new-cbox.toml", device="cpu")
    conv = scene_from_numpy(ref.data)
    for (path, a), (_, b) in zip(_leaves(port.data), _leaves(conv)):
        assert torch.equal(a, b), path


def test_compile_without_device_needs_a_card(assets_dir):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_scene_file(assets_dir / "new-cbox.toml")
