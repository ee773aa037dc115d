"""parity.agreement and parity.failures (the lane rules every kernel-4 check
on the card goes through) on CPU states with planted ties, checker-texel
flips, accum flips and alive mismatches: the shares and maxima are the
planted ones, and equal to those of a numpy implementation of the same
rules (`_agreement_numpy`, the rules as the JAX package's
tests/test_fused_bounce.py::_assert_states_close states them)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from lumillyrender_tpu_torch import parity
from lumillyrender_tpu_torch.ops import bsdf

N = 4000


def _agreement_numpy(ref, got, rtol=parity.LIMITS["rtol"]):
    """The lane rules in numpy on dicts of numpy arrays, fields (lanes, 3)."""
    o_r, o_g = ref["o"], got["o"]
    scale = np.abs(o_r).max() + 1.0
    tie = (np.abs(o_r - o_g).max(axis=1) / scale) > 1e-3
    ck = lambda o: bsdf.checker(torch.from_numpy(o[:, 0].copy()),
                                torch.from_numpy(o[:, 2].copy())).numpy()
    bad = tie | (ck(o_r) != ck(o_g))
    keep = ~bad

    def err(name):
        a, b = ref[name][keep], got[name][keep]
        e = np.abs(a.astype(np.float64) - b)  # (lanes, 3)
        r = e / np.maximum(np.abs(a), 1.0)
        return e.max(axis=1, initial=0.0), r.max(axis=1, initial=0.0)

    out = dict(lanes=len(o_r), tie=float(tie.mean()), excluded=float(bad.mean()),
               max_rel={}, max_abs={})
    for name in ("o", "d", "throughput", "accum"):
        e, r = err(name)
        if name == "accum":
            flip = r > rtol
            out["accum_flip"] = float(flip.mean()) if r.size else 0.0
            e, r = e[~flip], r[~flip]
        out["max_rel"][name] = float(r.max(initial=0.0))
        out["max_abs"][name] = float(e.max(initial=0.0))
    out["alive_mismatch"] = int((ref["alive"][keep] != got["alive"][keep]).sum())
    out["rays"] = [float(ref["rays_traced"]), float(got["rays_traced"])]
    out["rays_allowed"] = float(bad.sum()) + 0.5
    return out


def _states(seed, ties, checkers, accum_flips, alive_flips):
    """(ref, got, planted) as dicts of numpy arrays: `got` is `ref` with
    float32 noise of ~1e-5 relative on every lane, then `ties` lanes moved
    by 1 (1e-3 of the scene scale is ~0.2), `checkers` lanes moved across
    the checker's line at x = 2 by 0.02 (no tie), `accum_flips` kept lanes'
    accum off by 10% and `alive_flips` kept lanes' alive flipped."""
    rng = np.random.default_rng(seed)
    ref = dict(o=rng.uniform(-200, 200, (N, 3)).astype(np.float32),
               d=rng.normal(size=(N, 3)).astype(np.float32),
               throughput=rng.uniform(0.1, 1.5, (N, 3)).astype(np.float32),
               accum=rng.uniform(0.0, 3.0, (N, 3)).astype(np.float32),
               alive=rng.random(N) < 0.85, rays_traced=np.float32(3 * N))
    # No lane of ref lies within 0.05 of a checker line: the noise below
    # flips no texel by itself.
    for k in (0, 2):
        x = ref["o"][:, k]
        for period, width in ((150.0, 2.0), (30.0, 1.0), (300.0, 150.0)):
            m = np.mod(x, period)
            near = (np.abs(m - width) < 0.05) | (m < 0.05) | (m > period - 0.05)
            x[near] += 0.2
    got = {k: (v * (1 + rng.uniform(-1e-5, 1e-5, v.shape)).astype(np.float32)
               if v.dtype == np.float32 and v.ndim == 2 else np.copy(v))
           for k, v in ref.items()}
    lanes = rng.permutation(N)
    tie, ck, acc, alive = np.split(lanes[:ties + checkers + accum_flips + alive_flips],
                                   np.cumsum([ties, checkers, accum_flips]))
    got["o"][tie, 1] += 1.0
    ref["o"][ck, 0], got["o"][ck, 0] = 1.99, 2.01
    ref["o"][ck, 2], got["o"][ck, 2] = 70.0, 70.0
    got["accum"][acc] = ref["accum"][acc] * 1.1 + 0.1
    got["alive"][alive] = ~ref["alive"][alive]
    got["rays_traced"] = np.float32(3 * N + ties + checkers)
    return ref, got, dict(tie=len(tie), excluded=len(tie) + len(ck), accum_flip=len(acc),
                          alive=len(alive))


def _as(states, kind):
    if kind == "numpy":
        return states
    return {k: torch.as_tensor(v) for k, v in states.items()}


@pytest.mark.parametrize("kind", ["torch", "numpy"])
@pytest.mark.parametrize("planted", [(0, 0, 0, 0), (12, 30, 9, 5), (40, 400, 30, 0)],
                         ids=["clean", "within_limits", "over_limits"])
def test_agreement_counts_planted_lanes(planted, kind):
    ref, got, p = _states(7, *planted)
    m = parity.agreement(_as(ref, kind), _as(got, kind))
    want = _agreement_numpy(ref, got)
    assert m == want
    assert m["tie"] == p["tie"] / N
    assert m["excluded"] == p["excluded"] / N
    assert m["accum_flip"] == p["accum_flip"] / (N - p["excluded"])
    assert m["alive_mismatch"] == p["alive"]
    assert m["rays_allowed"] == p["excluded"] + 0.5
    assert 5e-6 < m["max_rel"]["throughput"] < 2e-5
    assert m["max_rel"]["accum"] < 2e-5


def test_failures_name_each_broken_rule():
    ref, got, _ = _states(7, 0, 0, 0, 0)
    assert parity.failures(parity.agreement(ref, got)) == []
    ref, got, _ = _states(7, 12, 30, 9, 0)
    assert parity.failures(parity.agreement(ref, got)) == []
    ref, got, _ = _states(7, 12, 30, 9, 5)
    assert parity.failures(parity.agreement(ref, got)) == ["alive mismatch on 5 lanes"]
    ref, got, _ = _states(7, 40, 400, 30, 0)
    f = parity.failures(parity.agreement(ref, got))
    assert [x.split(" ")[0] for x in f] == ["tie", "excluded", "accum"], f
    ref, got, _ = _states(7, 0, 0, 0, 0)
    ref["throughput"][3, 1], got["throughput"][3, 1] = 0.5, 0.51
    got["rays_traced"] = np.float32(3 * N + 1)
    f = parity.failures(parity.agreement(ref, got))
    assert f == ["throughput max rel 1.00e-02", f"rays {3 * N:.1f} vs {3 * N + 1:.1f}"], f


def test_agreement_with_every_lane_excluded():
    ref, got, _ = _states(8, N, 0, 0, 0)
    m = parity.agreement(_as(ref, "torch"), _as(got, "torch"))
    assert m == _agreement_numpy(ref, got)
    assert m["excluded"] == 1.0 and m["accum_flip"] == 0.0
    assert m["max_rel"] == dict.fromkeys(("o", "d", "throughput", "accum"), 0.0)


def test_tie_scale_is_the_scene_extent_plus_one():
    """In a scene of extent 0.5 the tie threshold is 1e-3 of 1.5: a move of
    1.2e-3 is no tie, one of 2e-3 is."""
    rng = np.random.default_rng(9)
    ref = dict(o=rng.uniform(0.1, 0.5, (N, 3)).astype(np.float32),
               d=rng.normal(size=(N, 3)).astype(np.float32),
               throughput=np.ones((N, 3), np.float32), accum=np.zeros((N, 3), np.float32),
               alive=np.ones(N, bool), rays_traced=np.float32(N))
    got = {k: np.copy(v) for k, v in ref.items()}
    got["o"][:10, 1] += 1.2e-3
    got["o"][10:30, 1] += 2e-3
    m = parity.agreement(_as(ref, "torch"), _as(got, "torch"))
    assert m == _agreement_numpy(ref, got)
    assert m["tie"] == 20 / N and m["excluded"] == 20 / N
