"""The port's films against the independent scalar oracle (tools/oracle.py),
on the CPU: the counterpart of tests/test_oracle.py.

tools/torch_oracle_gate.py compiles the JAX gate's six configs with the
port, and tests/oracle_stacks.npz holds the oracle's seed stacks of them
(written by `python tools/torch_oracle_gate.py --write`). Here: the
configs' tables equal the JAX gate's (tolerance 0) at both sizes, so the
oracle renders the same scenes for either package; the committed stacks
are the oracle's (one film regenerated live, the full stacks' means equal
to ORACLE.json's `mean_oracle` within 1e-6 relative); the port's plain
stacks pass tests/test_oracle.py's bounds against the committed CI
stacks; the port's BSDF eval matches the oracle's scalar `mat_brdf`; the
scene strings the tool copies equal their originals.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from lumillyrender_tpu_torch.ops import bsdf as B  # noqa: E402
from lumillyrender_tpu_torch.scene.data import MAT_BLINN_PHONG, MAT_PHONG  # noqa: E402
from tools import oracle_gate  # noqa: E402
from tools import torch_oracle_gate as tg  # noqa: E402
from tools.oracle import OracleScene  # noqa: E402

torch.set_num_threads(2)


def _jax_scenes(size):
    s = tg.SIZES[size]
    scenes = oracle_gate.build_scenes(res=s["res"], spp=s["spp"])
    if s["omni_spp"] != s["spp"]:
        scenes["omni"] = oracle_gate.build_scenes(res=s["res"], spp=s["omni_spp"])["omni"]
    return scenes


@pytest.fixture(scope="module")
def ci_scenes(assets_dir):
    return tg.sized_scenes("ci", "cpu")


@pytest.mark.parametrize("size", ["ci", "full"])
def test_gate_scenes_equal_jax(assets_dir, size):
    """Every compiled table of the six configs equals the JAX gate's
    (tolerance 0), and so do the render settings."""
    ref, port = _jax_scenes(size), tg.sized_scenes(size, "cpu")
    assert list(port) == list(tg.CONFIGS) and set(ref) == set(port)
    for name, c in port.items():
        for group in dataclasses.fields(c.data):
            part, want_part = getattr(c.data, group.name), getattr(ref[name].data, group.name)
            for f in dataclasses.fields(part):
                got = getattr(part, f.name).numpy()
                want = np.asarray(getattr(want_part, f.name))
                path = f"{name} {group.name}.{f.name}"
                assert got.shape == want.shape and got.dtype == want.dtype, path
                np.testing.assert_array_equal(got, want, err_msg=path)
        want_settings = {f.name: getattr(ref[name].settings, f.name)
                         for f in dataclasses.fields(c.settings)}
        assert dataclasses.asdict(c.settings) == want_settings, name


def test_scene_strings_equal_originals():
    """The strings the tool (and chip_smoke.py's phase 29) compile are
    tools/oracle_gate.py's and tests/test_render.py's."""
    import test_render

    for name in ("PT_SPHERES", "NEE_PHONG", "IBL_REFR"):
        assert getattr(tg, name) == getattr(oracle_gate, name), name
    assert tg.FURNACE == test_render.FURNACE
    assert tg.NEE_SCENE == test_render.NEE_SCENE
    for asset in ("brdf.toml", "new-cbox.toml", "vr.toml"):
        assert tg._asset(asset) == oracle_gate._asset(asset)
        for res, spp in ((16, 16), 24), ((32, 32), 32), ((32, 16), 128):
            assert tg._shrink(tg._asset(asset), res, spp) == oracle_gate._shrink(
                oracle_gate._asset(asset), res, spp)


@pytest.mark.parametrize("name", tg.CONFIGS)
def test_full_stacks_mean_equals_oracle_json(name):
    """The committed full-size stacks are the oracle's: their means equal
    ORACLE.json's `mean_oracle`, which the JAX gate computed."""
    films, meta = tg.load_stacks("full")[name]
    s = tg.SIZES["full"]
    spp = s["omni_spp"] if name == "omni" else s["spp"]
    res = [s["res"][0], s["res"][1] // 2] if name == "omni" else list(s["res"])
    assert meta["config"] == name and meta["resolution"] == res and meta["spp"] == spp
    assert meta["seeds"] == list(s["oracle_seeds"])
    assert films.dtype == np.float32 and films.shape == (len(meta["seeds"]), res[1], res[0], 3)
    want = tg.oracle_json_rows()[name]["mean_oracle"]
    got = float(films.astype(np.float64).mean())
    assert abs(got - want) <= 1e-6 * abs(want), (got, want)


def test_ci_stack_film_regenerated(ci_scenes):
    """One committed film rendered again, live: pt-spheres at the CI size,
    oracle seed 100, from the port's compiled scene."""
    films, meta = tg.load_stacks("ci")["pt-spheres"]
    assert meta["seeds"][0] == 100 and meta["resolution"] == [16, 16] and meta["spp"] == 24
    film = OracleScene(ci_scenes["pt-spheres"]).render(100)
    np.testing.assert_array_equal(film.astype(np.float32), films[0])


@pytest.mark.parametrize("name", tg.CONFIGS)
def test_port_plain_stack_matches_oracle(ci_scenes, name):
    """tests/test_oracle.py's bounds: <= 2 of 256 pixels past |z| = 5,
    untestable < 45%, film means within 6% (15% for the dark, glossy ggx
    config), the port's CPU plain stack (seeds 9000-9005) against the
    committed CI stack (oracle seeds 100-105)."""
    r = tg.run_gate(name, ci_scenes[name], tg.SIZES["ci"]["seeds"], "cpu", "ci")
    assert r["seeds"] == 6
    assert r["frac_abs_z_gt5"] <= 2 / 256, r
    assert r["frac_untestable"] < 0.45, r
    assert r["rel_mean_diff"] < (0.15 if name == "ggx" else 0.06), r
    assert r["passed"], r


def test_gate_fails_a_quadrant_bias(ci_scenes):
    """The gate's control: pt-spheres' port stack passes it, and fails it
    with its top-left quadrant x1.2 (the sky pixels there, of zero variance
    on both sides, no longer agree)."""
    c = ci_scenes["pt-spheres"]
    fo, _ = tg.load_stacks("ci")["pt-spheres"]
    seeds = tg.SIZES["ci"]["seeds"]
    fr = tg.renderer_films(c, seeds, "cpu")
    assert tg.passes(tg.gate_fields("pt-spheres", fr, fo, seeds, c), "ci")
    bad = tg.gate_fields("pt-spheres", tg.quadrant_bias(fr, 0), fo, seeds, c)
    assert not tg.passes(bad, "ci"), bad


def test_oracle_brdf_eval_parity(ci_scenes):
    """ops/bsdf.py's eval against the oracle's scalar per-material brdf()
    on random direction pairs, for every material of the six configs.

    Excluded lanes: Phong / Blinn-Phong back-lobe directions, where the
    port's `_pow_clamped` (the JAX package's) gives 0 and IEEE pow of a
    negative base with an integral exponent a signed value."""
    rng = np.random.default_rng(7)
    n = 256

    def rand_dir(k):
        v = rng.normal(size=(k, 3))
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    for name, compiled in ci_scenes.items():
        osc = OracleScene(compiled)
        out, inn, nrm = rand_dir(n), rand_dir(n), rand_dir(n)
        pos = rng.uniform(-300, 300, size=(n, 3))
        for m in range(osc.mat_type.shape[0]):
            g = B.gather(compiled.data.materials, torch.full((n,), m, dtype=torch.int32))
            got = B.eval_brdf(g, f32(out), f32(inn), f32(nrm), f32(pos)).numpy()
            want = np.stack([osc.mat_brdf(m, out[i], inn[i], nrm[i], pos[i])
                             for i in range(n)])
            mask = np.ones(n, bool)
            t = int(osc.mat_type[m])
            if t in (MAT_PHONG, MAT_BLINN_PHONG):
                on = np.where((np.einsum("ij,ij->i", nrm, out) < 0)[:, None], -nrm, nrm)
                if t == MAT_PHONG:
                    r = -out + on * 2 * np.einsum("ij,ij->i", out, on)[:, None]
                    cos = np.einsum("ij,ij->i", r, inn)
                else:
                    h = inn + out
                    h = h / np.linalg.norm(h, axis=1, keepdims=True)
                    cos = np.einsum("ij,ij->i", h, on)
                mask &= cos > 0.0
            rel = np.abs(got[mask] - want[mask]) / (np.abs(want[mask]) + 1e-5)
            assert rel.max() < 5e-3, (name, m, t, float(rel.max()))


def test_stacks_record_their_settings():
    """Each committed stack names its config, size, resolution, spp and
    oracle seeds, at both sizes."""
    for size, s in tg.SIZES.items():
        for name, (films, meta) in tg.load_stacks(size).items():
            assert meta["size"] == size and meta["config"] == name
            assert meta["seeds"] == list(s["oracle_seeds"])
            assert films.shape[0] == len(meta["seeds"])
            assert np.isfinite(films).all() and films.max() > 0, (size, name)
