"""The bounce kernels and kernel 1 (raygen) of two trees of the
PyTorch/CUDA port, on the same states, in turns on one card.

    python tools/torch_bounce_ab.py --parent DIR [--cases all|bounce|raygen]

builds DIR's `lumillyrender_tpu_torch/csrc/bounce_bvh.cu`, `bounce.cu` and
`bounce_bwd.cu` (a checkout of an earlier commit of the port; its own
headers beside them) with this tree's nvcc flags into this tree's
`lumillyrender_tpu_torch/build/` under other library names, beside this
tree's kernels, and loads them (an entry point of an earlier signature,
before the brute-force kernels took an instance or kernel 4 the leaves'
valid counts, or the forward entries the simple sky's arguments, or the
bounce entries their step values (seed, sky colours, longitude) in an
argument block on the card, is called with it: by value, those of the
launch).

Forward cases, on one chunk traced with this tree's kernel, the first state
of each stage width kept:
  * kernel 4 (the BVH bounce) on terrain-1m (scene/terrain.py at 1M
    triangles, K=128 leaves, written as chip_smoke.py writes it; 2,097,152
    / 262,144 / 32,768 / 4,096 lanes) and welcome-geo (K=32; 2,072,576 /
    259,072 / 32,512 / 4,096): it shares csrc/bounce_body.cuh;
  * kernel 2 (the brute-force bounce, one table) on new-cbox (2,097,152 /
    32,768 / 4,096).
Training cases, on the first state of each stage width of one new-cbox
256^2 film_and_grads at 16 spp (1,048,576 / 131,072 / 16,384 / 4,096
lanes) and at 4 spp (262,144 / 32,768 / 4,096), with the tables and
cotangents of that launch:
  * kernel 2's two-table instance;
  * kernel 5 (the backward): the parent's kernel plus its wrapper's
    `sum(dim=0)` of the per-block table against this tree's one launch.
On each, both trees write their own outputs: kernel 2's and 4's must be
bit-equal on every tensor (o, d, throughput, accum, alive, rays); kernel
5's per-lane cotangents and recomputed alive' bit-equal, its row table
within parity.KERNEL_BWD_RTOL of the parent's largest magnitude. Then the
bare launches are captured in CUDA graphs of `REPS` launches and replayed
in turns, `chip_smoke.PROBE_ROUNDS` replays each with the order reversed
every other round (`chip_smoke.alternating_ms`): the parent, this tree as
it chooses (`cuda_bounce.launch_instance`), and for kernels 2 and 5 this
tree's other instances (each element of the redesign alone: the small
sweep against the general one, Lambert-only shading against all
families, one thread a lane where the choice takes a group), each checked
bit-equal first. Prints both trees' ptxas lines of every instance
(registers, stack, spills) and the blocks per SM their registers allow,
the card's name and power limit, per case the median and [min, max] ms
per launch of each, and one JSON line of all of it.

Raygen cases (`--cases raygen` runs only these): DIR's
`lumillyrender_tpu_torch/csrc/raygen.cu` built beside this tree's, on the
cameras of new-cbox (the ideal pinhole, tile order), ibl-material (the
thin lens) and vr (the omnidirectional camera), 2,097,152 lanes whose ids
pass 2^32, under each mixer (its pcg4d and threefry instances): o, d, g
and the four random words of every lane bit-equal between the trees, then
the bare launches timed in turns as above.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
# (kernel library, scene) of the forward cases, in the order they run.
CASES = (("bounce_bvh", "terrain-1m"), ("bounce_bvh", "welcome-geo"), ("bounce", "new-cbox"))
TRAIN_SPP = (16, 4)
RAYGEN_SCENES = ("new-cbox", "ibl-material", "vr")
RAYGEN_LANES = 1 << 21
REPS = 5  # launches per CUDA graph

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_SHADE = [_P, _I, _P, _P, _I, _P, _I, _F, _I, _I, _U, _I, _F]
# The entry points before the brute-force kernels took an instance (the
# last three arguments before the stream), kernel 5 summed its row table
# and kernel 4 took the leaves' valid counts (the argument after ids).
EARLIER_ARGTYPES = {
    "llr_bounce": [_P] * 12 + [_P, _I] + _SHADE + [_F, _F, _F, _P, _I, _I, _F, _P],
    "llr_bounce_bwd": [_P] * 14 + [_P, _I] + _SHADE + [_F, _F, _F, _P],
    "llr_bounce_bvh": [_P] * 12 + [_P, _P, _P, _I] + _SHADE + [_F, _F, _F, _P, _I, _I, _F, _P],
    # before the launch's constants (raygen_consts), the 14th argument
    "llr_raygen": [_P, _P, _P, _P, _I, _U, _U, _I, _I, _I, _I, _I, _P, _I, _P],
}
# The simple sky's four arguments (horizon colour, the flag) of the forward
# entries, by position; a source without `hor_r` predates them and is called
# without them.
SIMPLE_SKY_ARGS = {"bounce": range(34, 38), "bounce_bvh": range(37, 41)}
# What a source of the current signature holds and an earlier one lacks.
CURRENT_MARK = {"bounce": "small_rows", "bounce_bwd": "small_rows",
                "bounce_bvh": "const int32_t* counts", "raygen": "RaygenConsts"}
# The bounce entry points before their step values (seed, sky colours,
# longitude) moved into an argument block on the card: those values by
# value, in this order, where the block's pointer now stands.
_SHADE_BY_VALUE = [_P, _I, _P, _P, _I, _P, _I, _F, _I, _I, _U, _I, _F]
_SKY_BY_VALUE = [_F, _F, _F, _P, _I, _I, _F, _F, _F, _F, _I, _P]
BY_VALUE_ARGTYPES = {
    "llr_bounce": [_P] * 12 + [_P, _I] + _SHADE_BY_VALUE + _SKY_BY_VALUE[:-1] + [_I, _I, _P, _P],
    "llr_bounce_bvh": [_P] * 12 + [_P, _P, _P, _P, _I] + _SHADE_BY_VALUE + _SKY_BY_VALUE,
    "llr_bounce_bwd": [_P] * 14 + [_P, _I] + _SHADE_BY_VALUE + [_F, _F, _F, _I, _P, _P, _I, _P,
                                                                   _P],
}
# The argument block's position in the current entries' arguments.
ARGS_AT = {"bounce": 24, "bounce_bvh": 27, "bounce_bwd": 26}
BLOCK_MARK = "const uint32_t* args"


def earlier_signature(src: Path, name: str) -> bool:
    """Whether the parent's entry of library `name` has the earlier
    signature (EARLIER_ARGTYPES)."""
    from lumillyrender_tpu_torch.ops import cuda_build

    if name not in CURRENT_MARK:
        return False
    cu = (src / "lumillyrender_tpu_torch" / "csrc" / cuda_build.SOURCES[name]).read_text()
    return CURRENT_MARK[name] not in cu


def takes_values(src: Path, name: str) -> bool:
    """Whether the parent's bounce entry of library `name` takes its step
    values by value (BY_VALUE_ARGTYPES) rather than in a block on the card."""
    from lumillyrender_tpu_torch.ops import cuda_build

    if name not in ARGS_AT:
        return False
    csrc = src / "lumillyrender_tpu_torch" / "csrc"
    cu = (csrc / cuda_build.SOURCES[name]).read_text() + (csrc / "bounce_body.cuh").read_text()
    return BLOCK_MARK not in cu


def values_entry(name: str, fn, seed: int, sky: list):
    """`fn`, an entry of library `name` that takes its step values by value,
    as this tree's wrapper calls it (the argument block's pointer where
    those values stood): `seed` and `sky` (cuda_bounce.sky_values, on the
    host) in the block's place."""
    at = ARGS_AT[name]
    col, hor, lon = sky[:3], sky[3:6], sky[6]
    seed = int(seed) & 0xFFFFFFFF
    if name == "bounce_bwd":
        return lambda *a: fn(*a[:at], seed, *a[at + 1:at + 3], *col, *a[at + 3:])
    return lambda *a: fn(*a[:at], seed, *a[at + 1:at + 3], *col, *a[at + 3:at + 6], lon, *hor,
                         *a[at + 6:])


def build_sources(jobs: dict) -> dict:
    """{label: (source, extra nvcc flags)} built with this tree's nvcc flags
    into this tree's build directory, one nvcc each, all at once: {label:
    (the loaded library, nvcc's -Xptxas -v output)}."""
    from lumillyrender_tpu_torch.ops import cuda_build

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (label, (cu, flags)) in enumerate(jobs.items()):
        out = cuda_build.BUILD_DIR / f"libab{i}-{Path(cu).stem}.so"
        procs[label] = (subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-Xptxas", "-v", "-o",
             str(out), str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            out, cu)
    built = {}
    for label, (p, out, cu) in procs.items():
        log, _ = p.communicate(timeout=900)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {cu} ({label}):\n{log}")
        built[label] = (ctypes.CDLL(str(out)), log)
    return built


def build_parents(src: Path, names) -> dict:
    """The sources of libraries `names` in the tree at `src`, built by
    `build_sources`: {name: (its entry point, nvcc's -Xptxas -v output,
    earlier signature)}."""
    from lumillyrender_tpu_torch.ops import cuda_build

    libs = build_sources({name: (src / "lumillyrender_tpu_torch" / "csrc" /
                                 cuda_build.SOURCES[name], []) for name in names})
    built = {}
    for name, (lib, log) in libs.items():
        earlier = earlier_signature(src, name)
        fn = getattr(lib, f"llr_{name}")
        fn.argtypes = (EARLIER_ARGTYPES if earlier else BY_VALUE_ARGTYPES
                       if takes_values(src, name) else cuda_build.ARGTYPES)[f"llr_{name}"]
        fn.restype = ctypes.c_int
        cu = (src / "lumillyrender_tpu_torch" / "csrc" / cuda_build.SOURCES[name]).read_text()
        if not earlier and name in SIMPLE_SKY_ARGS and "hor_r" not in cu:
            drop = SIMPLE_SKY_ARGS[name]
            fn.argtypes = [t for i, t in enumerate(fn.argtypes) if i not in drop]
            fn = (lambda f, drop: lambda *a: f(*(x for i, x in enumerate(a) if i not in drop)))(
                fn, drop)
        built[name] = (fn, log, earlier, takes_values(src, name))
    return built


@contextlib.contextmanager
def entry_point(name: str, fn):
    """cuda_bounce's launches of library `name`'s kernel go to `fn` while
    open."""
    from lumillyrender_tpu_torch.ops import cuda_build

    entry = f"llr_{name}"
    saved = cuda_build._fns.get(entry)
    cuda_build._fns[entry] = fn
    try:
        yield
    finally:
        if saved is None:
            del cuda_build._fns[entry]
        else:
            cuda_build._fns[entry] = saved


def forward_entry(name: str, parent: tuple, tables: dict | None = None):
    """The parent's forward entry as this tree's wrapper calls it: one that
    takes the step values by value gets those of chip_smoke.SEED and
    `tables["sky"]` in the argument block's place (`values_entry`); an
    earlier llr_bounce drops the instance, group and small rows, an earlier
    llr_bounce_bvh the leaves' valid counts, an earlier llr_raygen the
    launch's constants."""
    import chip_smoke

    fn, _, earlier, by_value = parent
    if earlier:
        if name == "raygen":
            fn = (lambda f: lambda *a: f(*a[:13], *a[14:]))(fn)
        elif name == "bounce_bvh":
            fn = (lambda f: lambda *a: f(*a[:15], *a[16:]))(fn)
        else:
            fn = (lambda f: lambda *a: f(*a[:-4], a[-1]))(fn)
    if by_value:
        fn = values_entry(name, fn, chip_smoke.SEED, tables["sky"].tolist())
    return fn


def kernel_lines(log: str, match: str = "bounce") -> dict:
    """{instance: ptxas line, registers, blocks of 128 threads per SM it
    allows (chip_smoke.blocks_per_sm)} for the kernels whose name holds
    `match` in nvcc's -Xptxas -v output."""
    import re

    import chip_smoke

    out = {}
    for name, props in chip_smoke.ptxas_kernels(log).items():
        if match not in name:
            continue
        m = re.search(r"(\d+) registers", props)
        out[chip_smoke.kernel_instance(name)] = dict(
            ptxas=props, registers=int(m.group(1)) if m else 0,
            blocks_per_sm=chip_smoke.blocks_per_sm(props))
    return out


def stage_states(c, spp_chunk: int, name: str, tables: dict) -> dict:
    """{width: the first state of that stage} of one chunk traced with this
    tree's kernel of library `name`."""
    import chip_smoke
    from lumillyrender_tpu_torch.ops import cuda_bounce

    kernel = getattr(cuda_bounce, name)
    first = {}

    def step(state):
        first.setdefault(state.o.shape[0], state)
        return kernel(c.data, c.settings, chip_smoke.SEED, state, tables)

    chip_smoke.trace_chunk(c, 0, spp_chunk, cuda_bounce.generate_rays, step)
    torch.cuda.synchronize()
    return first


def training_states(c, spp: int) -> tuple[dict, dict]:
    """One new-cbox training step at `spp` from a perturbed albedo, run
    eagerly so that its launches are seen (as chip_smoke.py's phase 12): ({width: (first forward state, its
    tables)}, {width: (first backward state, cotangents, tables)}). The
    backward runs from the last bounce to the first, so its last launch at
    a width is its stage's first."""
    import chip_smoke
    from lumillyrender_tpu_torch.diff import eager_film_and_grads, params_of, render_diff
    from lumillyrender_tpu_torch.ops import cuda_bounce

    p = params_of(c.data)
    with torch.no_grad():
        target = render_diff(c.data, c.settings, p, chip_smoke.SEED, spp)
    p = p._replace(materials=dataclasses.replace(p.materials, color=p.materials.color * 0.8))
    fwd, bwd = {}, {}
    launch, launch_bwd = cuda_bounce.bounce_launch, cuda_bounce.bounce_bwd_launch

    def keep_fwd(scene, settings, seed, state, tables, out):
        fwd.setdefault(state.o.shape[0], (state, tables))
        return launch(scene, settings, seed, state, tables, out)

    def keep_bwd(scene, settings, seed, state, cot, tables, out):
        bwd[state.o.shape[0]] = (state, [g.clone() for g in cot], tables)
        return launch_bwd(scene, settings, seed, state, cot, tables, out)

    cuda_bounce.bounce_launch, cuda_bounce.bounce_bwd_launch = keep_fwd, keep_bwd
    try:
        eager_film_and_grads(c.data, c.settings, p, target, chip_smoke.SEED, spp)
        torch.cuda.synchronize()
    finally:
        cuda_bounce.bounce_launch, cuda_bounce.bounce_bwd_launch = launch, launch_bwd
    return fwd, bwd


def outputs(n: int) -> tuple:
    f3 = lambda: torch.empty((n, 3), dtype=torch.float32, device="cuda")
    return (f3(), f3(), f3(), f3(), torch.empty(n, dtype=torch.bool, device="cuda"),
            torch.empty(n, dtype=torch.float32, device="cuda"))


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def variants(name: str, tables: dict, width: int) -> dict:
    """{label: tables} of this tree's instances to time beside the parent:
    its choice first (`cuda_bounce.launch_instance`), then, for the
    brute-force kernels, every other sweep and shading the scene allows
    at one thread a lane (each element alone: the small sweep against
    the general one, Lambert-only shading against all families, and one
    thread a lane where the choice takes a group)."""
    from lumillyrender_tpu_torch.ops import cuda_bounce

    if name == "bounce_bvh":
        return {"change": tables}
    backward = name == "bounce_bwd"
    inst, group = cuda_bounce.launch_instance(tables, width, backward)
    out = {f"change ({inst.label(group)})": tables}
    sweeps = ("small", "general") if tables.get("small") is not None else ("general",)
    shadings = ("lambert",) if backward else (
        ("lambert", "all") if inst.shading == "lambert" else ("all",))
    for sweep in sweeps:
        for shading in shadings:
            alt = cuda_bounce.Instance(sweep, shading)
            if (alt, 1) != (inst, group):
                out[alt.label()] = dict(tables, instance=alt, group=1)
    return out


def time_case(tag: str, fns: dict, res: dict, card: str):
    """Replay `fns` ({label: launch}) in turns and print and keep the
    medians and ranges, each against the parent's."""
    import chip_smoke

    labels = list(fns)
    times = chip_smoke.alternating_ms([fns[k] for k in labels], REPS, chip_smoke.PROBE_ROUNDS)
    rec = {k: chip_smoke.spread(t) for k, t in zip(labels, times)}
    parent = rec["parent"][0]
    line = "; ".join(f"{k} {v[0]:.4f} ms [{v[1][0]:.4f}, {v[1][1]:.4f}] {v[0] / parent:.3f}x"
                     for k, v in rec.items())
    print(f"{tag}: {line}  [{card}]", flush=True)
    res[tag] = dict(res.get(tag, {}), ms=rec)


def forward_case(tag, c, settings, state, tables, name, parent, res, card):
    """Kernel 2 or 4 on one state: every instance bit-equal to the parent on
    every output, then timed in turns."""
    import chip_smoke
    from lumillyrender_tpu_torch.ops import cuda_bounce

    w = state.o.shape[0]
    launch_fn = getattr(cuda_bounce, f"{name}_launch")
    pfn = forward_entry(name, parent, tables)
    runs = {"parent": (pfn, tables), **{k: (None, t) for k, t in
                                         variants(name, tables, w).items()}}
    outs = {k: outputs(w) for k in runs}

    def launch(k):
        fn, t = runs[k]
        if fn is None:
            launch_fn(c.data, settings, chip_smoke.SEED, state, t, outs[k])
        else:
            with entry_point(name, fn):
                launch_fn(c.data, settings, chip_smoke.SEED, state, t, outs[k])

    for k in runs:
        launch(k)
    torch.cuda.synchronize()
    for k in runs:
        same = [torch.equal(bits(a), bits(b)) for a, b in zip(outs["parent"], outs[k])]
        if not all(same):
            raise SystemExit(f"torch_bounce_ab: {tag}, {k}: the outputs differ from the "
                             f"parent's (o, d, throughput, accum, alive, rays equal: {same})")
    res[tag] = dict(live=float(state.alive.sum()), bit_equal=True)
    time_case(tag, {k: (lambda k=k: launch(k)) for k in runs}, res, card)


def backward_case(tag, c, settings, state, cot, tables, parent, res, card):
    """Kernel 5 on one state: the parent's kernel and its sum(dim=0)
    against each of this tree's instances; per-lane cotangents and alive'
    bit-equal, the row table within KERNEL_BWD_RTOL; timed in turns."""
    import chip_smoke
    from lumillyrender_tpu_torch import parity
    from lumillyrender_tpu_torch.ops import cuda_bounce, cuda_build
    from lumillyrender_tpu_torch.ops.cuda_build import ptr

    w = state.o.shape[0]
    dev = state.o.device
    nm = tables["mats"].shape[0]
    fn, _, earlier, by_value = parent
    if by_value and not earlier:
        fn = values_entry("bounce_bwd", fn, chip_smoke.SEED, tables["sky"].tolist())
    f3 = lambda: torch.empty((w, 3), dtype=torch.float32, device=dev)
    mine = {k: (t, (f3(), f3(), f3(), torch.empty(6 * nm + 3, dtype=torch.float32, device=dev),
                    torch.empty(w, dtype=torch.bool, device=dev)))
            for k, t in variants("bounce_bwd", tables, w).items()}
    p_out = (f3(), f3(), f3(), torch.empty(w, dtype=torch.bool, device=dev))
    p_blocks = -(-w // 128)
    p_partial = torch.empty((p_blocks, 6 * nm + 3), dtype=torch.float32, device=dev)
    p_rows = torch.empty(6 * nm + 3, dtype=torch.float32, device=dev)
    flags, rr_scale = cuda_bounce._flags(settings, state.bounce)
    sky = tables["sky"].tolist()

    def launch_parent():
        if not earlier:
            with entry_point("bounce_bwd", fn):
                cuda_bounce.bounce_bwd_launch(c.data, settings, chip_smoke.SEED, state, cot,
                                              tables, (*p_out[:3], p_rows, p_out[3]))
            return
        rc = fn(ptr(state.o), ptr(state.d), ptr(state.throughput), ptr(state.alive),
                ptr(state.lane), *(ptr(g) for g in cot), *(ptr(t) for t in p_out[:3]),
                ptr(p_partial), ptr(p_out[3]), ptr(tables["tris"]), tables["tris"].shape[0],
                ptr(tables["sph"]), tables["sph"].shape[0], ptr(tables["mats"]),
                ptr(tables["mats_eval"]), nm, ptr(tables["lights"]),
                tables["lights"].shape[0], tables["total_area"], w, state.bounce,
                chip_smoke.SEED & 0xFFFFFFFF, flags, rr_scale, sky[0], sky[1], sky[2],
                cuda_build.stream())
        cuda_build.check(rc, "parent bounce_bwd")
        torch.sum(p_partial, dim=0, out=p_rows)

    def launch(k):
        t, out = mine[k]
        cuda_bounce.bounce_bwd_launch(c.data, settings, chip_smoke.SEED, state, cot, t, out)

    launch_parent()
    for k in mine:
        launch(k)
    torch.cuda.synchronize()
    scale = p_rows.abs().max().clamp(min=1e-30)
    rec = dict(live=float(state.alive.sum()), bit_equal_lanes=True, rows_rel={})
    for k, (_, out) in mine.items():
        same = [torch.equal(bits(a), bits(b)) for a, b in zip(p_out, (*out[:3], out[4]))]
        if not all(same):
            raise SystemExit(f"torch_bounce_ab: {tag}, {k}: the per-lane outputs differ from "
                             f"the parent's (o, d, throughput, alive equal: {same})")
        rel = float((out[3] - p_rows).abs().max() / scale)
        rec["rows_rel"][k] = rel
        if not rel < parity.KERNEL_BWD_RTOL:
            raise SystemExit(f"torch_bounce_ab: {tag}, {k}: the row table differs from the "
                             f"parent's by {rel:.2e} of its largest magnitude")
    print(f"{tag} ({rec['live']:.0f} live): per-lane cotangents and alive' bit-equal; row "
          "table vs the parent's, max |diff| / max |parent|: "
          + ", ".join(f"{k} {v:.2e}" for k, v in rec["rows_rel"].items()), flush=True)
    res[tag] = rec
    time_case(tag, {"parent": launch_parent, **{k: (lambda k=k: launch(k)) for k in mine}},
              res, card)


def raygen_case(scene: str, c, parent: tuple, res: dict, card: str):
    """Kernel 1 of both trees on `c`'s camera, RAYGEN_LANES lanes from the
    sample offset whose lane ids pass 2^32, under each mixer: every output
    bit-equal between the trees, then timed in turns."""
    from lumillyrender_tpu_torch.ops import cuda_bounce, rng
    from lumillyrender_tpu_torch.ops.camera import samples_aperture

    st, n = c.settings, RAYGEN_LANES
    off = 2**32 // (st.width * st.height) - 16
    aperture = samples_aperture(st.camera_kind)
    outs = {who: (torch.empty((n, 3), device="cuda"), torch.empty((n, 3), device="cuda"),
                  torch.empty(n, device="cuda") if aperture else None,
                  torch.empty((n, 4), device="cuda")) for who in ("parent", "change")}

    def launch(who, mixer, uniforms):
        def run():
            rng._MIXER = mixer
            ctx = (entry_point("raygen", forward_entry("raygen", parent)) if who == "parent"
                   else contextlib.nullcontext())
            try:
                with ctx:
                    o, d, g, u = outs[who]
                    cuda_bounce.raygen_launch(c.data, st, 1234, off, o, d, g,
                                              u if uniforms else None)
            finally:
                rng._MIXER = "pcg4d"
        return run

    for mixer in ("pcg4d", "threefry"):
        tag = f"raygen {scene} ({'thin lens' if aperture else 'no aperture'}), {mixer}"
        for who in outs:
            launch(who, mixer, True)()
        torch.cuda.synchronize()
        for a, b, what in zip(outs["parent"], outs["change"], ("o", "d", "g", "words")):
            if a is not None and not torch.equal(bits(a), bits(b)):
                raise SystemExit(f"torch_bounce_ab: {tag}: {what} differs from the parent's")
        print(f"{tag}: o, d, g and the random words bit-equal to the parent's", flush=True)
        time_case(f"{tag}, {n} lanes", {who: launch(who, mixer, False) for who in outs}, res,
                  card)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python tools/torch_bounce_ab.py")
    ap.add_argument("--parent", required=True, type=Path,
                    help="a checkout of the earlier tree")
    ap.add_argument("--cases", choices=("all", "bounce", "raygen"), default="all",
                    help="the bounce kernels' cases, kernel 1's, or both")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_bounce_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from lumillyrender_tpu_torch.integrator.render import default_spp_chunk
    from lumillyrender_tpu_torch.ops import cuda_bounce, cuda_build
    from lumillyrender_tpu_torch.scene.compiler import compile_scene_file

    names = (("bounce", "bounce_bvh", "bounce_bwd") if args.cases != "raygen" else ()) + (
        ("raygen",) if args.cases != "bounce" else ())
    cuda_build.build(names, verbose=True)
    parent = build_parents(args.parent.resolve(), names)
    card = chip_smoke.gpu_line()
    res = {"card": card, "rounds": chip_smoke.PROBE_ROUNDS, "reps": REPS,
           "ptxas": {who: {name: kernel_lines(log, "raygen" if name == "raygen" else "bounce")
                           for name, log in by_name.items()}
                     for who, by_name in (("parent", {n: p[1] for n, p in parent.items()}),
                                          ("change", {n: cuda_build.LOGS.get(n, "")
                                                      for n in names}))}}
    for who, by_name in res["ptxas"].items():
        for name, lines in by_name.items():
            for kernel, rec in lines.items():
                print(f"{who} {name}.cu {kernel}: {rec['ptxas']} ({rec['blocks_per_sm']} "
                      "blocks of 128 per SM by registers)")
    print(card)
    if "raygen" in names:
        for scene in RAYGEN_SCENES:
            c = compile_scene_file(REPO / "assets" / f"{scene}.toml", device="cuda")
            raygen_case(scene, c, parent["raygen"], res, card)
    if "bounce" not in names:
        print(json.dumps(res))
        return 0
    paths = {"terrain-1m": chip_smoke.write_terrain("terrain-1m", chip_smoke.BIG_TRIS[
        "terrain-1m"])[0], "welcome-geo": REPO / "assets" / "welcome-geo.toml",
        "new-cbox": REPO / "assets" / "new-cbox.toml"}
    for name, scene in CASES:
        c = compile_scene_file(paths[scene], device="cuda")
        bvh = name == "bounce_bvh"
        tables = cuda_bounce.pack_tables(c.data, bvh=bvh)
        tag = f"{name} {scene}" + (f" K={tables['bvh']['k']}" if bvh else "")
        for w, s0 in sorted(stage_states(c, default_spp_chunk(c.settings), name,
                                         tables).items(), reverse=True):
            forward_case(f"{tag}, width {w}", c, c.settings, s0, tables, name,
                         parent[name], res, card)
        del c, tables
        torch.cuda.empty_cache()
    c = compile_scene_file(paths["new-cbox"], device="cuda")
    for spp in TRAIN_SPP:
        fwd, bwd = training_states(c, spp)
        for w, (s0, tables) in sorted(fwd.items(), reverse=True):
            forward_case(f"bounce new-cbox two tables (training step, {spp} spp), width {w}",
                         c, c.settings, s0, tables, "bounce", parent["bounce"], res, card)
        for w, (s0, cot, tables) in sorted(bwd.items(), reverse=True):
            backward_case(f"bounce_bwd new-cbox (training step, {spp} spp), width {w}", c,
                          c.settings, s0, cot, tables, parent["bounce_bwd"], res, card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
