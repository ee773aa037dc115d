"""The port's estimator gates on the CPU plain path: the counterparts of
tests/test_render.py's statistical gates, at its sizes and bounds.

The white and gray furnaces are exact identities; pt and pt-direct are two
unbiased estimators of one image (film means, quadrants, and a per-pixel
Welch z with a planted-bias control that must fail); the compaction's
population-control reweighting is unbiased on overflow; tiled and raster
lane order are two labelings of one estimator; pt and pt-direct agree
through a 256-light NEE pick. The scenes are tools/torch_oracle_gate.py's
copies of tests/test_render.py's (tests/test_torch_oracle.py holds them
equal), compiled by the port; chip_smoke.py's phase 29 runs the same gates
through the kernels on the card. The gates that resample or relabel lanes
(compaction overflow, tiled vs raster order) are in
tests/test_torch_estimator_lanes.py.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from lumillyrender_tpu_torch.integrator.render import render  # noqa: E402
from tools import torch_oracle_gate as tg  # noqa: E402

torch.set_num_threads(2)


def _films(c, seeds):
    return np.stack([render(c, seed=s, device="cpu").film for s in seeds])


def test_white_furnace_exact():
    r = render(tg.furnace_scene(1.0, device="cpu"), seed=3, device="cpu")
    assert np.abs(r.film - 1.0).max() < 1e-3, (r.film.min(), r.film.max())


def test_white_furnace_at_full_width_as_jax():
    """At one full chunk (256^2 x 32 spp) the identity holds sample by
    sample, except for the few samples a float32 hit point traps inside the
    sphere (they come back 0), in the JAX package as in the port: every
    pixel lies on the 32-sample lattice, and each loses fewer than
    tg.FURNACE_LOST_SHARE of the samples."""
    import test_render
    from lumillyrender_tpu.integrator.render import render as jax_render

    ref = test_render.furnace_scene(1.0, spp=32)
    ref.settings = dataclasses.replace(ref.settings, width=256, height=256)
    port = tg.furnace_scene(1.0, spp=32, device="cpu", width=256, height=256)
    for film in (np.asarray(jax_render(ref, seed=3).film),
                 render(port, seed=3, device="cpu").film):
        lattice_max, lost = tg.furnace_lost_samples(film, 32)
        assert lattice_max < 1e-3, lattice_max
        assert lost < tg.FURNACE_LOST_SHARE * 256 * 256 * 32, lost


def test_gray_furnace_exact():
    """Every sample is exactly 0.37 (sphere) or 1 (sky): every pixel lies on
    the 8-sample mixture lattice, and the sphere is seen."""
    spp = 8
    r = render(tg.furnace_scene(0.37, spp=spp, device="cpu"), seed=4, device="cpu")
    assert tg.gray_lattice_max(r.film, spp, 0.37) < 1e-3
    assert np.abs(r.film - 0.37).min() < 1e-3


def test_pt_vs_nee_agree():
    a = render(tg.nee_scene("pt", 768, "cpu"), seed=11, device="cpu").film.mean(axis=2)
    b = render(tg.nee_scene("pt-direct", 192, "cpu"), seed=12, device="cpu").film.mean(axis=2)
    r = tg.means_gap(a, b)
    assert tg.means_agree(r), r


def test_pt_vs_nee_perpixel_ztest():
    """The enlarged-lamp scene at 16x16: 16-seed stacks of pt (768 spp) and
    pt-direct (256 spp) look like noise to the per-pixel Welch z, and a
    +50% bias on ~5% of the lit pixels fails the same gate."""
    fa = _films(tg.big_lamp_scene("pt", 768, "cpu"), range(300, 316))
    fb = _films(tg.big_lamp_scene("pt-direct", 256, "cpu"), range(400, 416))
    r = tg.perpixel_z(fa, fb)
    assert r["untestable"] < 0.02 and r["frac_bad"] < 0.008, r  # measured null: 0
    assert 4 <= r["planted_pixels"] <= 0.1 * 16 * 16, r
    assert r["planted_frac_bad"] > 0.008, r
    assert tg.perpixel_z_holds(r, 16 * 16)


def test_many_light_pt_vs_nee_agree(assets_dir):
    """pt (which never picks a light) against pt-direct picking among the
    256 light triangles of many-light.toml, at 32x32. The films are
    rendered through the plain BVH walk: on the CPU it gives the brute
    force's film bit for bit (held at 2 spp first) in a twelfth of the
    time."""
    for integ in ("pt", "pt-direct"):
        brute, bvh = (render(tg.many_light_scene(integ, 2, "cpu", intersector=i), seed=5,
                             device="cpu").film for i in ("auto", "bvh"))
        np.testing.assert_array_equal(bvh, brute)
    c = tg.many_light_scene("pt-direct", 192, "cpu", intersector="bvh")
    assert int(c.data.lights.prim.shape[0]) == 256
    a = render(tg.many_light_scene("pt", 768, "cpu", intersector="bvh"), seed=21,
               device="cpu").film
    b = render(c, seed=22, device="cpu").film
    r = tg.means_gap(a.mean(axis=2), b.mean(axis=2))
    assert tg.means_agree(r), r


@pytest.mark.parametrize("albedo", [1.0, 0.37])
def test_furnace_scene_compiles_as_jax(albedo):
    """The furnace scene the port compiles from the copied string has the
    JAX package's tables (tolerance 0)."""
    import test_render

    ref = test_render.furnace_scene(albedo)
    port = tg.furnace_scene(albedo, device="cpu")
    for group in dataclasses.fields(port.data):
        part, want = getattr(port.data, group.name), getattr(ref.data, group.name)
        for f in dataclasses.fields(part):
            np.testing.assert_array_equal(getattr(part, f.name).numpy(),
                                          np.asarray(getattr(want, f.name)),
                                          err_msg=f"{group.name}.{f.name}")
