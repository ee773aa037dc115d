"""Which PyTorch op forks the plain bounce step on the card from the CPU's.

    python tools/torch_device_fork.py [--lanes N] [--other cuda|cpu] [--out FILE]

Takes one state of each of three scenes, built on the CPU with the port's
own code from a seed: a random bounce-3 state of new-cbox (drawn as
chip_smoke.py draws its random states), and a camera chunk's state after
two bounces of ridaisai and of welcome (the lanes of a full-size chunk
taken at an even stride, so the sample covers the film).
Then, for each state:

1. the whole step: `wavefront.plain_bounce_step` on the CPU and on the
   other device from the same state, and the lanes whose outputs differ;
2. op by op: the CPU step again under a dispatch mode that runs every aten
   op a second time on the other device, on copies of the same inputs,
   and compares the two results bit for bit. An op whose results differ
   from equal inputs is a fork; it is reported with the line of the port
   that called it, its calls, the calls that differed, the elements that
   differed and the largest distance in float32 ulps. The first fork in
   program order is named.

`--other cpu` runs the second copy on the CPU too (a check of the tool: it
must find no fork). Needs a card otherwise. Imports nothing of JAX. Prints
one JSON line at the end and writes it to `--out`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import traceback
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SEED = 1234
PORT = str(REPO / "lumillyrender_tpu_torch")
# Ops whose result is memory the op did not write, or an alias of its input.
SKIP = ("empty", "set_", "resize_", "_local_scalar_dense")


def ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in float32 ulps (the distance of their ordered bit patterns);
    two NaNs are 0 apart."""
    def ordered(x):
        i = x.view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    d = (ordered(a) - ordered(b)).abs()
    return torch.where(torch.isnan(a) & torch.isnan(b), torch.zeros_like(d), d)


def differs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise: not the same value (NaN equals NaN, -0.0 differs from
    +0.0)."""
    if a.dtype.is_floating_point:
        return ulps(a.float(), b.float()) != 0
    return a != b


def caller() -> str:
    """The innermost line of the port on the stack."""
    for frame in reversed(traceback.extract_stack()):
        if frame.filename.startswith(PORT):
            return f"{Path(frame.filename).relative_to(REPO)}:{frame.lineno}"
    return "?"


class Mirror(TorchDispatchMode):
    """Runs each aten op on the CPU and again on `other` on copies of the
    same inputs, and records the ops whose results differ. Tensors of the
    scene (`keep`: their storages stay alive throughout) are copied once."""

    def __init__(self, other: torch.device, keep):
        super().__init__()
        self.other = other
        self.keep = {t.untyped_storage().data_ptr() for t in keep}
        self.cache = {}
        self.calls = 0
        self.forks = {}  # (op, line) -> record, in order of first fork

    def copy(self, x):
        if not isinstance(x, torch.Tensor):
            return x
        ptr = x.untyped_storage().data_ptr()
        if ptr in self.keep:
            key = (ptr, x.storage_offset(), tuple(x.shape), tuple(x.stride()), x.dtype)
            if key not in self.cache:
                self.cache[key] = self.same_layout(x)
            return self.cache[key]
        return self.same_layout(x)

    def same_layout(self, x):
        """A copy of `x` on `other` with its storage, offset and strides: a
        CPU op can round otherwise on a strided input than on a contiguous
        one (a vectorised or a scalar loop)."""
        raw = torch.empty(0, dtype=torch.uint8).set_(x.untyped_storage())
        raw = raw.to(self.other, copy=True)
        return torch.empty(0, dtype=x.dtype, device=self.other).set_(
            raw.untyped_storage(), x.storage_offset(), x.shape, x.stride())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func.overloadpacket)
        if any(s in name for s in SKIP):
            return func(*args, **kwargs)
        m_args, m_kwargs = tree_map(self.copy, (args, kwargs))
        out = func(*args, **kwargs)
        m_out = func(*m_args, **m_kwargs)
        self.calls += 1
        got, _ = tree_flatten(m_out)
        want, _ = tree_flatten(out)
        for g, w in zip(got, want):
            if not isinstance(w, torch.Tensor) or g.shape != w.shape:
                continue
            bad = differs(g.to("cpu"), w)
            key = (str(func), caller())
            rec = self.forks.get(key)
            if rec is None and not bool(bad.any()):
                continue
            if rec is None:
                rec = self.forks[key] = dict(op=key[0], line=key[1], order=self.calls,
                                             calls=0, forked_calls=0, elements=0,
                                             compared=0, max_ulps=0)
            rec["calls"] += 1
            rec["compared"] += w.numel()
            n_bad = int(bad.sum())
            if n_bad:
                rec["forked_calls"] += 1
                rec["elements"] += n_bad
                if w.dtype == torch.float32:
                    rec["max_ulps"] = max(rec["max_ulps"],
                                          int(ulps(g.to("cpu"), w)[bad].max()))
        return out


def scene_tensors(scene):
    for group in dataclasses.fields(scene):
        part = getattr(scene, group.name)
        if part is None:
            continue
        for f in dataclasses.fields(part):
            t = getattr(part, f.name)
            if isinstance(t, torch.Tensor):
                yield t


def random_state(scene, n, seed, bounce):
    """`n` random lanes in the box around the scene's triangles and spheres
    (the huge ground spheres aside): uniform origins, unit directions."""
    from lumillyrender_tpu_torch.convert import state_from_numpy

    g = scene.geometry
    pts = torch.cat([g.tri_p0, g.sph_c]).numpy()
    pts = pts[np.abs(pts).max(axis=1) < 1e4]
    rng = np.random.default_rng(seed)
    o = rng.uniform(pts.min(0) - 1, pts.max(0) + 1, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    thr = rng.uniform(0.1, 1.5, size=(n, 3)).astype(np.float32)
    acc = rng.uniform(0.0, 0.5, size=(n, 3)).astype(np.float32)
    alive = rng.random(n) < 0.85
    lane = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    return state_from_numpy(bounce, o, d, thr, acc, alive, lane, device="cpu")


def camera_state(c, n, bounces):
    """`n` lanes of the scene's first full-size chunk (1 spp), taken at an
    even stride, after `bounces` plain bounces on the CPU."""
    from lumillyrender_tpu_torch.integrator import wavefront
    from lumillyrender_tpu_torch.integrator.render import global_lanes
    from lumillyrender_tpu_torch.ops import cuda_bounce

    scene, st = c.data, c.settings
    full = st.width * st.height
    o, d, pdf, g = cuda_bounce.plain_generate_rays(scene, st, SEED, 0, full)
    pick = torch.arange(n) * (full // n)
    weight = (g * scene.camera.sensor_sensitivity / pdf)[pick]
    state = wavefront.PathState(
        0, o[pick].contiguous(), d[pick].contiguous(), torch.ones((n, 3)) * weight[:, None],
        torch.zeros((n, 3)), torch.ones(n, dtype=torch.bool), torch.zeros(()),
        global_lanes(st, 0, full, "cpu")[pick].contiguous())
    for _ in range(bounces):
        state = wavefront.plain_bounce_step(scene, st, SEED, state)
    return state


FIELDS = ("o", "d", "throughput", "accum", "alive", "lane", "rays_traced")


def whole_step(c, state, other) -> dict:
    """The step on the CPU and on `other` from the same state: per field,
    the lanes that differ and the largest ulp distance."""
    from lumillyrender_tpu_torch.integrator import wavefront

    want = wavefront.plain_bounce_step(c.data, c.settings, SEED, state)
    moved = dataclasses.replace(state, **{k: getattr(state, k).to(other) for k in FIELDS})
    got = wavefront.plain_bounce_step(c.data.to(other), c.settings, SEED, moved)
    rec = {}
    for k in FIELDS:
        g, w = getattr(got, k).to("cpu"), getattr(want, k)
        bad = differs(g, w)
        lanes = bad.reshape(bad.shape[0], -1).any(1) if bad.dim() else bad
        rec[k] = dict(lanes=int(lanes.sum()),
                      max_ulps=int(ulps(g, w).max()) if w.dtype == torch.float32 else None)
    rec["lanes"] = int(state.o.shape[0])
    return rec


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--lanes", type=int, default=1 << 16)
    p.add_argument("--other", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--out", type=Path, default=REPO / "chiprun_out" / "device_fork.json")
    a = p.parse_args()
    if a.other == "cuda" and not torch.cuda.is_available():
        print("torch_device_fork: no CUDA device", file=sys.stderr)
        return 2
    from lumillyrender_tpu_torch.integrator import wavefront
    from lumillyrender_tpu_torch.scene.compiler import compile_scene_file

    other = torch.device(a.other)
    report = dict(other=a.other, lanes=a.lanes, device=(
        torch.cuda.get_device_name(0) if a.other == "cuda" else "cpu"), states={})
    cases = (("new-cbox@b3 random", "new-cbox", None),
             ("ridaisai@b2 camera", "ridaisai", 2),
             ("welcome@b2 camera", "welcome", 2))
    for tag, name, bounces in cases:
        c = compile_scene_file(REPO / "assets" / f"{name}.toml", device="cpu")
        state = (random_state(c.data, a.lanes, 3, 3) if bounces is None
                 else camera_state(c, a.lanes, bounces))
        rec = dict(alive=int(state.alive.sum()), whole_step=whole_step(c, state, other))
        mode = Mirror(other, list(scene_tensors(c.data)))
        with mode:
            wavefront.plain_bounce_step(c.data, c.settings, SEED, state)
        forks = sorted((r for r in mode.forks.values() if r["forked_calls"]),
                       key=lambda r: r["order"])
        rec.update(ops=mode.calls, forks=forks, first_fork=forks[0] if forks else None)
        report["states"][tag] = rec
        print(f"{tag}: {rec['alive']} of {a.lanes} lanes alive; whole step, lanes that "
              f"differ by field: " + ", ".join(
                  f"{k} {v['lanes']}" + (f" (max {v['max_ulps']} ulps)" if v.get("max_ulps")
                                         else "")
                  for k, v in rec["whole_step"].items() if isinstance(v, dict)), flush=True)
        print(f"  {mode.calls} ops mirrored, {len(forks)} op sites fork:")
        for r in forks:
            print(f"  {r['op']:40s} {r['line']:48s} calls {r['forked_calls']}/{r['calls']}, "
                  f"elements {r['elements']}/{r['compared']}, max {r['max_ulps']} ulps")
    a.out.parent.mkdir(parents=True, exist_ok=True)
    line = json.dumps(report)
    a.out.write_text(line)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
