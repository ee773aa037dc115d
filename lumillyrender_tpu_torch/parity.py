"""Lane-by-lane agreement of two PathStates after the same bounce.

Two correct implementations of the bounce can still disagree on lanes where
float rounding flips a discontinuous decision: which of two equidistant
prims is hit (a tie), which side of a checker line a hit lands on, or the
NEE shadow verdict exactly on the light surface. These rules (the JAX
package's, tests/test_fused_bounce.py::_assert_states_close) exclude such
lanes and bound how many there may be:

* tie flips (hit point moved by more than 1e-3 of the scene scale) < 0.4%;
* tie or checker-texel flips together < 8%, and excluded from the rest;
* on the kept lanes o, d and throughput agree to rtol 2e-3 (relative to
  max(|x|, 1)), accum too except on at most 0.5% of lanes (shadow
  verdicts), alive exactly, and the ray counts to within the excluded
  lanes.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import bsdf

LIMITS = dict(tie=0.004, excluded=0.08, accum_flip=0.005, rtol=2e-3)


def _np(state, name):
    x = getattr(state, name) if not isinstance(state, dict) else state[name]
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _on(state, name, dev):
    """A field of `state` (a PathState, or a dict or namespace of its
    fields, tensors or numpy arrays) as a tensor on `dev`."""
    return torch.as_tensor(getattr(state, name) if not isinstance(state, dict)
                           else state[name], device=dev)


def agreement(ref, got, rtol: float = LIMITS["rtol"]) -> dict:
    """Measured shares of `got` against `ref` (PathStates or dicts of their
    fields): tie, excluded and accum_flip fractions, the max relative and
    absolute error of each field on kept lanes, alive mismatches and the
    ray counts. Computed where `ref.o` lies (on the card for card states:
    a 3M-lane state's rules took ~3 s on the host), shares and errors in
    float64."""
    o_r = ref["o"] if isinstance(ref, dict) else ref.o
    dev = o_r.device if isinstance(o_r, torch.Tensor) else torch.device("cpu")
    o_r, o_g = _on(ref, "o", dev), _on(got, "o", dev)
    scale = o_r.abs().max() + 1.0
    tie = ((o_r - o_g).abs().amax(dim=1) / scale) > 1e-3
    ck = lambda o: bsdf.checker(o[:, 0], o[:, 2])
    bad = tie | (ck(o_r) != ck(o_g))
    keep = ~bad
    share = lambda m: float(m.double().mean()) if m.numel() else 0.0
    lane_max = lambda x: float(x.max()) if x.numel() else 0.0

    def err(name):
        a, b = _on(ref, name, dev)[keep], _on(got, name, dev)[keep]
        e = (a.double() - b.double()).abs().flatten(1)
        r = e / torch.clamp(a.abs(), min=1.0).double().flatten(1)
        return e.amax(dim=1), r.amax(dim=1)

    out = dict(lanes=int(len(o_r)), tie=share(tie), excluded=share(bad), max_rel={},
               max_abs={})
    for name in ("o", "d", "throughput", "accum"):
        e, r = err(name)
        if name == "accum":  # shadow-verdict flips are counted, not bounded
            flip = r > rtol
            out["accum_flip"] = share(flip)
            e, r = e[~flip], r[~flip]
        out["max_rel"][name] = lane_max(r)
        out["max_abs"][name] = lane_max(e)
    out["alive_mismatch"] = int((_on(ref, "alive", dev)[keep]
                                 != _on(got, "alive", dev)[keep]).sum())
    out["rays"] = [float(_np(ref, "rays_traced")), float(_np(got, "rays_traced"))]
    out["rays_allowed"] = float(bad.sum()) + 0.5
    return out


def failures(m: dict, rtol: float = LIMITS["rtol"]) -> list[str]:
    """The rules `m` (from `agreement`) breaks; empty when it passes."""
    f = []
    if not m["tie"] < LIMITS["tie"]:
        f.append(f"tie flips {m['tie']:.3%}")
    if not m["excluded"] < LIMITS["excluded"]:
        f.append(f"excluded lanes {m['excluded']:.3%}")
    if not m["accum_flip"] <= LIMITS["accum_flip"]:
        f.append(f"accum flips {m['accum_flip']:.3%}")
    for name, v in m["max_rel"].items():
        if not v < rtol:
            f.append(f"{name} max rel {v:.2e}")
    if m["alive_mismatch"]:
        f.append(f"alive mismatch on {m['alive_mismatch']} lanes")
    if not abs(m["rays"][0] - m["rays"][1]) <= m["rays_allowed"]:
        f.append(f"rays {m['rays'][0]} vs {m['rays'][1]}")
    return f


# ---------------------------------------------------------------------------
# Backward passes of one bounce
# ---------------------------------------------------------------------------

# The JAX package's gate for its backward kernel
# (tests/test_fused_bounce.py::_compare_bwd): a lane is comparable unless
# its forward outputs show a flipped decision (tie: the hit point moved by
# more than 1e-5 of the scene scale; checker texel; NEE verdict: accum off
# by more than 1e-4 relative; throughput likewise) or its sampled direction
# grazes the surface (|cos| < 3e-2, where autodiff's two cancelling cos/pdf
# terms are noise and the closed form is exactly zero). At least 85% of
# lanes must be comparable. Cotangents agree to 8e-3 of their largest
# magnitude on comparable lanes, the table gradients to 5e-3.
BWD_LIMITS = dict(tie=1e-5, flip=1e-4, grazing=3e-2, comparable=0.85,
                  lanes=8e-3, tables=5e-3)
# Two backward passes of the port are held tighter than the JAX gate.
# The backward kernel follows plain_bounce_bwd formula for formula: its
# cotangents measured bit-equal on the H100, its tables within 7e-7 (the
# order of the sums). Autograd of the plain step differs from the closed
# form where cos/pdf cancels: measured within 7.5e-6 on the H100 and 1.7e-5
# against the JAX package's autodiff on the CPU.
KERNEL_BWD_RTOL = 1e-5
AUTOGRAD_BWD_RTOL = 1e-4


def bwd_comparable(ref, got, normal) -> np.ndarray:
    """(N,) bool: the lanes on which two backward passes of one bounce can
    be compared. `ref` and `got` are the two forward outputs of the bounce
    (PathStates or dicts of their fields) and `normal` the (N,3) hit normal
    of its input rays."""
    o_r, o_g = _np(ref, "o"), _np(got, "o")
    scale = np.abs(o_r).max() + 1.0
    tie = (np.abs(o_r - o_g).max(axis=1) / scale) > BWD_LIMITS["tie"]
    ck = lambda o: bsdf.checker(torch.from_numpy(o[:, 0].copy()),
                                torch.from_numpy(o[:, 2].copy())).numpy()
    bad = tie | (ck(o_r) != ck(o_g))
    for name in ("accum", "throughput"):
        a, b = _np(ref, name), _np(got, name)
        rel = np.abs(a - b) / np.maximum(np.abs(a), 1.0)
        bad |= rel.max(axis=1) > BWD_LIMITS["flip"]
    if isinstance(normal, torch.Tensor):
        normal = normal.detach().cpu().numpy()
    cos = np.abs(np.sum(_np(ref, "d") * normal, axis=1))
    bad |= _np(ref, "alive") & (cos < BWD_LIMITS["grazing"])
    return ~bad


def bwd_errors(ref, got, keep) -> dict:
    """Relative errors of `got`'s backward pass against `ref`'s (objects or
    dicts with o, d, throughput ((N,3) lane cotangents), albedo, emission
    ((nm,3)) and sky ((3,))): each lane cotangent's largest difference on
    the `keep` lanes over its largest magnitude there, each table's over
    its largest magnitude (floored at 1e-6)."""
    out = {}
    for name in ("o", "d", "throughput", "albedo", "emission", "sky"):
        a = _np(ref, name).astype(np.float64)
        b = _np(got, name).astype(np.float64)
        if name in ("o", "d", "throughput"):
            a, b = a[keep], b[keep]
        out[name] = float(np.abs(a - b).max(initial=0.0)
                          / max(np.abs(a).max(initial=0.0), 1e-6))
    return out


def bwd_failures(errs: dict, rtol: float | None = None) -> list[str]:
    """The tolerances that `errs` (from `bwd_errors`) breaks: `rtol` on
    every cotangent and table, or BWD_LIMITS' by default."""
    f = []
    for name, v in errs.items():
        lim = rtol if rtol is not None else BWD_LIMITS[
            "lanes" if name in ("o", "d", "throughput") else "tables"]
        if not v < lim:
            f.append(f"{name} rel {v:.2e} (limit {lim:g})")
    return f
