"""Telemetry, the profiler and the forward stage loop of the port on the CPU:
`RenderTelemetry` against the JAX package's, `bounce_occupancy` against the
JAX function on tests/test_camera.py's scene and rays, the CLI's
--checkpoint, --telemetry and --profile, and the invariant the card's
captured stage loop rests on: a bounce leaves dead lanes as they are, so a
stage run to its full step count gives the host loop's film and rays bit
for bit.

Tolerance: the occupancy counts agree within parity.py's accum-flip
allowance (0.5% of the lanes): the port rounds each PyTorch op on its own
where XLA fuses multiply-adds, which flips a lane's RR or hit decision now
and then (tests/test_torch_bounce.py)."""

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumillyrender_tpu.ops import camera as jax_cam, rng as jax_rng
from lumillyrender_tpu.scene.compiler import compile_scene as jax_compile
from lumillyrender_tpu.scene.compiler import compile_scene_file as jax_compile_file
from lumillyrender_tpu.scene.loader import parse_config as jax_parse
from lumillyrender_tpu.utils.telemetry import RenderTelemetry as JaxTelemetry
from lumillyrender_tpu.utils.telemetry import bounce_occupancy as jax_occupancy
from lumillyrender_tpu_torch import parity
from lumillyrender_tpu_torch.cli import main as cli_main
from lumillyrender_tpu_torch.integrator import wavefront
from lumillyrender_tpu_torch.integrator.render import global_lanes, render
from lumillyrender_tpu_torch.ops import cuda_bounce
from lumillyrender_tpu_torch.scene.compiler import compile_scene, compile_scene_file
from lumillyrender_tpu_torch.scene.loader import parse_config
from lumillyrender_tpu_torch.utils import checkpoint as ckpt
from lumillyrender_tpu_torch.utils.telemetry import (
    TRACE_FILE, RenderTelemetry, bounce_occupancy,
)
from test_camera import BASE, LOOKAT

torch.set_num_threads(2)

ASSETS = Path(__file__).resolve().parents[1] / "assets"
SEED = 1234


def test_summary_matches_the_jax_package(capsys):
    port, ref = RenderTelemetry(), JaxTelemetry()
    for t in (port, ref):
        t.log("start", scene="x")
        t.log("chunk", spp=2, done=2, rays=1000.0, seconds=0.5)
        t.log("chunk", spp=2, done=4, rays=3000.0, seconds=1.5)
    assert port.summary() == ref.summary() == dict(
        chunks=2, rays=4000.0, seconds=2.0, rays_per_second=2000.0)
    lines = [json.loads(x) for x in capsys.readouterr().err.splitlines()]
    assert [x["event"] for x in lines] == ["start", "chunk", "chunk"] * 2
    assert RenderTelemetry().summary() == {}


def _occupancy_pair(jc, c, max_bounces):
    """bounce_occupancy of the JAX package and of the port on the same
    pinhole camera rays (drawn as tests/test_camera.py draws them)."""
    s = jc.settings
    n = s.width * s.height
    lane = jnp.arange(n, dtype=jnp.uint32)
    px = (lane % s.width).astype(jnp.int32)
    py = ((lane // s.width) % s.height).astype(jnp.int32)
    u, v = jax_rng.uniform2(0, lane, 1)
    o, d, _, _ = jax_cam.sample_rays(jc.data.camera, s.camera_kind, px, py,
                                     s.width, s.height, u, v, u, v)
    want = np.asarray(jax_occupancy(jc.data, s, o, d, lane, 0, max_bounces=max_bounces))
    got = bounce_occupancy(c.data, c.settings, torch.tensor(np.asarray(o)),
                           torch.tensor(np.asarray(d)),
                           torch.tensor(np.asarray(lane).astype(np.int64)), 0,
                           max_bounces=max_bounces)
    return got, want, n


def test_bounce_occupancy_matches_the_jax_function():
    """tests/test_camera.py::test_bounce_occupancy_telemetry's scene and
    rays (33x33 pinhole lanes; its black sphere under a white sky ends
    every path at the first bounce, so both count 0), then new-cbox at
    48x48 (tests/test_torch_render.py's golden size), whose paths live on:
    the two differ by at most a lane or two there."""
    toml = BASE.replace("CAMERA", 'type = "ideal-pinhole"\nfov = 40' + LOOKAT).replace(
        "SPP", "1")
    got, want, n = _occupancy_pair(jax_compile(jax_parse(toml)),
                                   compile_scene(parse_config(toml), device="cpu"), 6)
    assert got.shape == want.shape == (6,)
    assert np.array_equal(got, want) and got[0] <= n and (np.diff(got) <= 0).all()

    jc = jax_compile_file(ASSETS / "new-cbox.toml")
    jc.settings = dataclasses.replace(jc.settings, width=48, height=48)
    c = compile_scene_file(ASSETS / "new-cbox.toml", device="cpu")
    c.settings = dataclasses.replace(c.settings, width=48, height=48)
    got, want, n = _occupancy_pair(jc, c, 12)
    assert got.shape == (12,) and (np.diff(got) <= 0).all()
    assert got[0] > 0 and got[-1] < got[0]  # some lanes live on, some die
    assert np.abs(got - want).max() <= parity.LIMITS["accum_flip"] * n


def test_cli_writes_checkpoint_telemetry_and_profile(tmp_path, capsys):
    out, ck, prof = tmp_path / "p.png", tmp_path / "c.npz", tmp_path / "prof"
    argv = [str(ASSETS / "new-cbox.toml"), "--device", "cpu", "--spp", "4",
            "--spp-chunk", "2", "--resolution", "24", "24", "--out", str(out),
            "--checkpoint", str(ck), "--checkpoint-every", "2", "--telemetry",
            "--profile", str(prof)]
    assert cli_main(argv) == 0
    cap = capsys.readouterr()
    chunks = [json.loads(x) for x in cap.err.splitlines() if x.startswith("{")]
    assert [(e["event"], e["done"]) for e in chunks] == [("chunk", 2), ("chunk", 4)]
    summary = [json.loads(x) for x in cap.out.splitlines() if x.startswith("{")]
    assert summary[-1]["chunks"] == 2
    assert summary[-1]["rays"] == pytest.approx(sum(e["rays"] for e in chunks))
    assert out.exists()
    c = compile_scene_file(ASSETS / "new-cbox.toml", spp=4, device="cpu")
    c.settings = dataclasses.replace(c.settings, width=24, height=24)
    saved = ckpt.load(ck, c.settings, 0)
    assert saved is not None and saved[1] == 4 and saved[2] == summary[-1]["rays"]
    trace = json.loads((prof / TRACE_FILE).read_text())
    assert any(e.get("name", "").startswith("aten::") for e in trace["traceEvents"])

    # Run again: the checkpoint is complete, so the render resumes at 4/4.
    assert cli_main(argv) == 0
    assert "resumed at 4/4 spp" in capsys.readouterr().out


def _state(c, n, seed):
    st = c.settings
    o, d, _, _ = cuda_bounce.plain_generate_rays(c.data, st, seed, 0, n)
    return wavefront.PathState(
        bounce=0, o=o, d=d, throughput=torch.ones((n, 3)),
        accum=torch.zeros((n, 3)), alive=torch.ones(n, dtype=torch.bool),
        rays_traced=torch.zeros(()), lane=global_lanes(st, 0, n, "cpu"))


@pytest.mark.parametrize("name", ["new-cbox", "welcome-geo"])
def test_a_bounce_leaves_dead_lanes_as_they_are(name):
    """The plain step (the kernels' plain version) on a state whose lanes
    are all dead returns it unchanged, ray count included, at any bounce."""
    c = compile_scene_file(ASSETS / f"{name}.toml", device="cpu")
    c.settings = dataclasses.replace(c.settings, width=16, height=16)
    st = c.settings
    step = wavefront.make_bounce_step(c.data, st, SEED)
    live = _state(c, 256, SEED)
    for _ in range(3):
        live = step(live)
    assert 0 < int(live.alive.sum()) < 256  # some lanes died on their own
    dead = dataclasses.replace(live, alive=torch.zeros_like(live.alive),
                               rays_traced=torch.tensor(123.0))
    for _ in range(2):
        out = step(dead)
        assert out.bounce == dead.bounce + 1
        for k in ("o", "d", "throughput", "accum", "alive", "rays_traced", "lane"):
            assert torch.equal(getattr(out, k), getattr(dead, k)), k
        dead = out


@pytest.mark.parametrize("name,spp", [("new-cbox", 4), ("welcome-geo", 2)])
def test_full_stages_give_the_host_loops_film(monkeypatch, name, spp):
    """trace_film with every stage run to its full step count (what the
    card's captured loop does) against the host loop that stops where no
    lane is alive: film and ray count bit-equal, and the full stages took
    more steps."""
    c = compile_scene_file(ASSETS / f"{name}.toml", device="cpu")
    c.settings = dataclasses.replace(c.settings, width=16, height=16)
    st = c.settings
    n = 256 * spp
    base = cuda_bounce.make_step(c.data, st, SEED)
    calls = []

    def step(state):
        calls.append(state.bounce)
        return base(state)

    def run(runner):
        calls.clear()
        if runner is not None:
            monkeypatch.setattr(wavefront, "run_stage", runner)
        o, d, pdf, g = cuda_bounce.plain_generate_rays(c.data, st, SEED, 0, n)
        film, rays = wavefront.trace_film(
            c.data, st, o, d, global_lanes(st, 0, n, "cpu"), SEED,
            g * c.data.camera.sensor_sensitivity / pdf, 256, step=step)
        return film, rays, len(calls)

    def full(step_fn, state, b1):
        for _ in range(b1 - state.bounce):
            state = step_fn(state)
        return state

    film, rays, steps = run(None)
    film_full, rays_full, steps_full = run(full)
    assert steps_full == st.max_bounces > steps
    assert torch.equal(film, film_full) and torch.equal(rays, rays_full)
