"""The port's sample-batch data parallelism on the CPU (parallel/shard.py,
the CLI's --devices) against the JAX package's `parallel/shard.py`.

Two gloo ranks in two processes (tests/torch_shard_worker.py, started on a
free port) render tests/multihost_worker.py's NEE scene, as
tests/test_multihost.py's two JAX processes do:

* the film within 1e-5 of the film's max of JAX `render_sharded(n_devices=2,
  spp_per_device=2)` on the conftest's virtual CPU mesh, and the padded
  tail (6 spp in chunks of 4: the film divided by 8) likewise. The port's
  one-device film is as far from JAX's one-device film (4.1e-5 at a lamp
  of 12: XLA contracts multiply-adds, the port rounds each op), so the
  gate is relative; against the port's own one-device render, which
  differs only in the order of the sums, the 2-rank film is held to 1e-5
  absolute;
* one `sharded_train_step` against JAX `build_sharded_train_step` on a
  2-device mesh: the loss and every float gradient within
  tests/test_torch_diff.py's tolerance for the single-device step;
* `cli.run(["--devices", "2", "--device", "cpu", ...])` writes one image,
  rank 0's, whose film is the workers' bit for bit;
* --checkpoint, --telemetry and --profile are refused with --devices 2.
"""

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_shard_worker as worker
from lumillyrender_tpu.diff.render import params_of as jax_params_of
from lumillyrender_tpu.parallel.shard import (
    build_sharded_train_step,
    make_mesh,
    put_sharded,
    render_sharded,
)
from lumillyrender_tpu.scene.compiler import compile_scene as jax_compile_scene
from lumillyrender_tpu.scene.loader import parse_config as jax_parse
from lumillyrender_tpu_torch import cli
from lumillyrender_tpu_torch.integrator.render import render
from lumillyrender_tpu_torch.io.image import read_png, to_color
from lumillyrender_tpu_torch.scene.compiler import compile_scene
from lumillyrender_tpu_torch.scene.loader import parse_config
from multihost_worker import SCENE, SEED
from test_torch_diff import WHOLE_PATH_RTOL

REPO = Path(__file__).resolve().parents[1]
FILM_ATOL = 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory):
    """What rank 0 of the two worker ranks saved."""
    tmp = tmp_path_factory.mktemp("torch_shard")
    out = tmp / "ranks.npz"
    port = _free_port()
    procs, logs = [], []
    for pid in range(2):
        env = dict(os.environ, LLR_COORDINATOR=f"127.0.0.1:{port}", LLR_NUM_PROCESSES="2",
                   LLR_PROCESS_ID=str(pid), LLR_TEST_OUT=str(out))
        log = open(tmp / f"rank{pid}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "torch_shard_worker.py")],
            env=env, stdout=log, stderr=subprocess.STDOUT, cwd=str(REPO)))
    try:
        for p in procs:
            assert p.wait(timeout=300) == 0, "".join(
                (tmp / f"rank{i}.log").read_text() for i in range(2))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for log in logs:
            log.close()
    return dict(np.load(out))


def _jax_film(spp=None):
    c = jax_compile_scene(jax_parse(SCENE), spp=spp)
    return render_sharded(c, seed=SEED, n_devices=2,
                          spp_per_device=worker.SPP_PER_DEVICE).film


def _close(got, want):
    return np.abs(got - want).max() < FILM_ATOL * np.abs(want).max()


def test_two_ranks_match_jax_render_sharded(ranks_out):
    want = _jax_film()
    got = ranks_out["film"]
    assert got.shape == want.shape == (24, 24, 3) and got.max() > 0
    assert _close(got, want)
    one = render(compile_scene(parse_config(SCENE), device="cpu"), seed=SEED,
                 spp_chunk=worker.SPP_PER_DEVICE, device="cpu").film
    assert np.abs(got - one).max() < FILM_ATOL


def test_padded_tail_matches_jax(ranks_out):
    """6 spp in chunks of 2 ranks x 2: the second chunk renders samples 4-7
    and the film is divided by 8, not 6."""
    want = _jax_film(worker.TAIL_SPP)
    got = ranks_out["tail_film"]
    assert _close(got, want)
    # Not the 16-spp film, nor that film's first 6 samples' mean.
    assert np.abs(got - ranks_out["film"]).max() > 1e-3


def test_two_rank_train_step_matches_jax(ranks_out):
    c = jax_compile_scene(jax_parse(SCENE))
    settings = dataclasses.replace(c.settings, max_bounces=worker.TRAIN_MAX_BOUNCES)
    p = jax_params_of(c.data)
    p = p._replace(materials=dataclasses.replace(p.materials, color=p.materials.color.at[
        worker.TRAIN_ROW, 0].set(worker.TRAIN_VALUE)))
    mesh = make_mesh(2)
    step = build_sharded_train_step(mesh, settings, worker.TRAIN_SPP_LOCAL)
    offsets = put_sharded(np.arange(2 * worker.TRAIN_SPP_LOCAL, dtype=np.int32),
                          NamedSharding(mesh, P("dp")))
    target = jnp.full((settings.height, settings.width, 3), worker.TARGET, jnp.float32)
    loss, grads = step(c.data, p, target, offsets)
    assert abs(float(ranks_out["loss"]) - float(loss)) <= 1e-4 * float(loss)
    checked = 0
    for part in ("materials", "camera", "sky"):
        for f in dataclasses.fields(getattr(grads, part)):
            want = np.asarray(getattr(getattr(grads, part), f.name))
            if not np.issubdtype(want.dtype, np.floating):
                continue
            got = ranks_out[f"grad.{part}.{f.name}"]
            assert got.shape == want.shape and np.isfinite(got).all(), (part, f.name)
            err = np.abs(got - want).max(initial=0.0)
            assert err < WHOLE_PATH_RTOL * max(np.abs(want).max(initial=0.0), 1e-12) \
                or err < 1e-9, (part, f.name, err)
            checked += 1
    assert checked > 0
    assert np.abs(ranks_out["grad.materials.color"][worker.TRAIN_ROW]).max() > 0


def test_cli_devices_writes_one_image(ranks_out, tmp_path):
    scene = tmp_path / "scene.toml"
    scene.write_text(SCENE)
    out = tmp_path / "img"
    out.mkdir()
    result = cli.run([str(scene), "--devices", "2", "--device", "cpu", "--seed", str(SEED),
                      "--spp-chunk", str(worker.SPP_PER_DEVICE),
                      "--out", str(out / "film.png")])
    assert sorted(p.name for p in out.iterdir()) == ["film.png"]
    assert result.rank == 0 and result.world == 2 and result.reduce_ms is not None
    np.testing.assert_array_equal(result.film, ranks_out["film"])
    gamma = parse_config(SCENE).film.gamma
    np.testing.assert_array_equal(read_png(out / "film.png"), to_color(result.film, gamma))


@pytest.mark.parametrize("flag", [["--checkpoint", "x.npz"], ["--telemetry"],
                                  ["--profile", "prof"]])
def test_devices_refuses_single_process_flags(tmp_path, capsys, flag):
    """Refused before any rank starts, with the reason, and nothing written."""
    flag = [flag[0]] + [str(tmp_path / a) for a in flag[1:]]
    with pytest.raises(SystemExit):
        cli.run([str(REPO / "assets" / "primitive.toml"), "--devices", "2",
                 "--device", "cpu", "--out", str(tmp_path / "img.png"), *flag])
    err = capsys.readouterr().err
    assert flag[0] in err and "one device" in err
    assert not list(tmp_path.iterdir())


def test_devices_reports_a_failed_rank(tmp_path):
    """Ranks that fail (here: no such scene) end the CLI with their exit
    codes, and write nothing."""
    with pytest.raises(SystemExit, match="ranks exited with"):
        cli.run([str(tmp_path / "missing.toml"), "--devices", "2", "--device", "cpu",
                 "--out", str(tmp_path / "img.png")])
    assert not list(tmp_path.iterdir())
