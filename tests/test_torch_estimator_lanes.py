"""The port's estimator gates that resample or relabel lanes, on the CPU
plain path: the counterparts of tests/test_render.py's
test_compaction_overflow_is_unbiased and
test_tiled_matches_raster_statistically, at their sizes and bounds (the
rest are in tests/test_torch_estimator.py). Both compare per-image film
means over many seeds within 4 combined standard errors.
"""

import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from lumillyrender_tpu_torch.integrator import render as render_mod  # noqa: E402
from lumillyrender_tpu_torch.integrator import wavefront  # noqa: E402
from lumillyrender_tpu_torch.integrator.render import render  # noqa: E402
from tools import torch_oracle_gate as tg  # noqa: E402

torch.set_num_threads(2)


def test_compaction_overflow_is_unbiased(monkeypatch):
    """A stage plan forced to 256 slots from bounce 2 on, in a closed
    high-albedo shell where ~10x that many paths are alive there: the
    compacted film means over 40 seeds agree with the uncompacted ones
    within 4 combined standard errors, and the overflow branch of
    `_compact` is shown to run."""
    c = tg.compile_toml(tg.shell_toml(), "cpu")
    c_off = tg.compile_toml(tg.shell_toml(), "cpu", compaction="off")
    seeds = range(100, 140)
    means_plain = [float(render(c_off, seed=s, device="cpu").film.mean()) for s in seeds]

    n_lanes = 16 * 16 * 16
    forced = ((n_lanes, 0, 2), (256, 2, c.settings.max_bounces))
    monkeypatch.setattr(wavefront, "_stage_plan", lambda n, s, **kw: forced)
    overflowed = []
    orig = wavefront._compact

    def spy(state, width, seed, ctr, salt=None):
        overflowed.append(int(state.alive.sum()) > width)
        return orig(state, width, seed, ctr, salt=salt)

    monkeypatch.setattr(wavefront, "_compact", spy)
    means_comp = [float(render(c, seed=s, device="cpu").film.mean()) for s in seeds]
    assert len(overflowed) == len(seeds) and all(overflowed)
    z = tg.z_of_means(means_plain, means_comp)
    assert z < 4.0, (np.mean(means_plain), np.mean(means_comp), z)


def test_tiled_matches_raster_statistically(monkeypatch):
    """64x64 films are issued in tile order; raster order relabels the RNG
    streams of the same estimator: per-image means of 12 seeds each agree
    within 4 combined standard errors."""
    c = tg.nee_scene("pt-direct", 16, "cpu", width=64, height=64)
    assert render_mod.tile_decode(c.settings) is not None
    means_t = [float(render(c, seed=50 + s, device="cpu").film.mean()) for s in range(12)]
    monkeypatch.setattr(render_mod, "tile_dims", lambda s: None)
    assert render_mod.tile_decode(c.settings) is None
    means_r = [float(render(c, seed=150 + s, device="cpu").film.mean()) for s in range(12)]
    z = tg.z_of_means(means_t, means_r)
    assert z < 4.0, (np.mean(means_t), np.mean(means_r), z)
