"""The port's estimator gates: its films against the independent scalar
oracle (tools/oracle.py), the counterpart of tools/oracle_gate.py.

    python tools/torch_oracle_gate.py [--device cuda|cpu] [--size full|ci]
    python tools/torch_oracle_gate.py --write [--workers 8]

The six configs are oracle_gate's: the five BASELINE.json configs, shrunk
(analytic spheres for the bunnies), plus the omnidirectional camera. Each
is compiled by the port from the same TOML; the strings below are copies
of tools/oracle_gate.py's and tests/test_render.py's, held equal to them
by tests/test_torch_oracle.py. The oracle's seed stacks are rendered once
(`--write`, in a process pool, about 10 minutes on 8 cores) and kept in
tests/oracle_stacks.npz (float32):

- "ci": 16x16 x 24 spp (omni 16x8), oracle seeds 100-105;
- "full": ORACLE.json's settings, 32x32 x 32 spp (omni 32x16 x 128 spp),
  oracle seeds 100-109, whose means equal ORACLE.json's `mean_oracle`.

Without `--write`, the tool renders the port's stack (seeds 9000-9009 at
"full", 9000-9005 at "ci") on `--device` through `render`, compares it
with the committed oracle stack by the per-pixel Welch z of `zmap`, and
prints one JSON line a config with ORACLE.json's fields and whether it
passes ORACLE.json's gate (frac(|z|>5) < 0.008, untestable < 0.05) and
tests/test_oracle.py's mean bound (0.06; 0.15 for ggx). Exit code 1 if a
config fails. Nothing here imports JAX; only `--write` imports the oracle.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
ASSETS = REPO / "assets"
STACKS = REPO / "tests" / "oracle_stacks.npz"
sys.path.insert(0, str(REPO))

CONFIGS = ("pt-spheres", "nee-phong-blinn", "ggx", "mesh-thinlens",
           "ibl-refraction", "omni")
# Each size: film resolution, spp (omni's apart), the oracle's seeds and the
# port's. "full" is ORACLE.json's; "ci" is tests/test_oracle.py's.
SIZES = {
    "full": dict(res=(32, 32), spp=32, omni_spp=128, oracle_seeds=tuple(range(100, 110)),
                 seeds=tuple(range(9000, 9010))),
    "ci": dict(res=(16, 16), spp=24, omni_spp=24, oracle_seeds=tuple(range(100, 106)),
               seeds=tuple(range(9000, 9006))),
}
# ORACLE.json's gate, and tests/test_oracle.py's bounds at the "ci" size.
GATE = {"full": dict(frac_bad=0.008, untestable=0.05),
        "ci": dict(frac_bad=2 / 256, untestable=0.45)}
MEAN_BOUND = {"ggx": 0.15}
MEAN_BOUND_DEFAULT = 0.06
# The fields of an ORACLE.json row that compare the renderer with the oracle.
ORACLE_FIELDS = ("mean_renderer", "rel_mean_diff", "max_abs_z", "frac_abs_z_gt5",
                 "frac_untestable")


def _shrink(toml: str, res, spp: int) -> str:
    toml = re.sub(
        r"resolution = \[\d+, \d+\]", f"resolution = [{res[0]}, {res[1]}]",
        toml,
    )
    return re.sub(r"samples = \d+", f"samples = {spp}", toml)


def _asset(name: str) -> str:
    return (ASSETS / name).read_text()


# ----------------------------------------------------- oracle_gate's scenes
# 1. pure pt, sphere-only Cornell box, Lambert, pinhole (BASELINE config 1).
PT_SPHERES = """
[renderer]
samples = SPP
depth = 5
depth-limit = 64
no-direct-emitter = false
threads = 0
integrator = "pt"

[film]
resolution = [RESX, RESY]
output = "png"
gamma = 2.2

[sky]
type = "uniform"
color = [0.6, 0.7, 0.8]

[camera]
type = "ideal-pinhole"
fov = 39.3077
[[camera.transform]]
type = "look-at"
origin = [278, 273, -800]
target = [278, 273, 0]
up = [0, 1, 0]

[[light]]
type = "area"
object = "lamp"
emission = [36, 30, 24]

[[object]]
mesh = "big"
material = "floor"
[[object.transform]]
type = "translate"
vector = [278, -9750, 278]

[[object]]
mesh = "ball"
material = "blue"
[[object.transform]]
type = "translate"
vector = [180, 120, 280]

[[object]]
mesh = "ball2"
material = "white"
[[object.transform]]
type = "translate"
vector = [400, 90, 200]

[[object]]
name = "lamp"
mesh = "lampball"
material = "black"
[[object.transform]]
type = "translate"
vector = [278, 640, 278]

[[material]]
name = "floor"
type = "lambert"
albedo = [0.74, 0.74, 0.73]

[[material]]
name = "blue"
type = "lambert"
albedo = [0.25, 0.3, 0.65]

[[material]]
name = "white"
type = "lambert"
albedo = [0.7, 0.7, 0.7]

[[material]]
name = "black"
type = "lambert"
albedo = [0, 0, 0]

[[mesh]]
name = "big"
type = "sphere"
radius = 10000

[[mesh]]
name = "ball"
type = "sphere"
radius = 120

[[mesh]]
name = "ball2"
type = "sphere"
radius = 90

[[mesh]]
name = "lampball"
type = "sphere"
radius = 220
"""

# 2. pt-direct (NEE) on debug-nee with Phong / Blinn-Phong (BASELINE config
#    2): a phong floor and a tilted blinn-phong panel, front faces only.
NEE_PHONG = """
[renderer]
samples = SPP
depth = 5
depth-limit = 64
no-direct-emitter = false
threads = 0
integrator = "pt-direct"

[film]
resolution = [RESX, RESY]
output = "png"
gamma = 2.2

[sky]
type = "uniform"
color = [0, 0, 0]

[camera]
type = "ideal-pinhole"
fov = 39.3077
[[camera.transform]]
type = "look-at"
origin = [278, 273, -800]
target = [278, 273, 0]
up = [0, 1, 0]

[[light]]
type = "area"
object = "light"
emission = [15, 15, 15]

[[object]]
name = "light"
mesh = "light"
material = "lightmat"
[[object.transform]]
type = "translate"
vector = [278, 460, 278]

[[object]]
mesh = "quad"
material = "glossy"
[[object.transform]]
type = "scale"
vector = [250, 250, 250]
[[object.transform]]
type = "translate"
vector = [278, 0, 278]

[[object]]
mesh = "quad"
material = "brushed"
[[object.transform]]
type = "scale"
vector = [250, 250, 250]
[[object.transform]]
type = "axis-angle"
axis = [1, 0, 0]
angle = -70
[[object.transform]]
type = "translate"
vector = [278, 170, 430]

[[material]]
name = "lightmat"
type = "lambert"
albedo = [0, 0, 0]

[[material]]
name = "glossy"
type = "phong"
reflectance = [0.8, 0.75, 0.7]
alpha = 12

[[material]]
name = "brushed"
type = "blinn-phong"
reflectance = [0.7, 0.75, 0.8]
alpha = 16

[[mesh]]
name = "quad"
type = "obj"
path = "models/simple/quad.obj"

[[mesh]]
name = "light"
type = "sphere"
radius = 80
"""

# 5. IBL sky + full scene, hdr output (BASELINE config 5), with the
#    refraction material: cbox, a glass sphere and a quad light.
IBL_REFR = """
[renderer]
samples = SPP
depth = 5
depth-limit = 64
no-direct-emitter = false
threads = 0
integrator = "pt-direct"

[film]
resolution = [RESX, RESY]
output = "hdr"
gamma = 2.2

[sky]
type = "ibl"
path = "models/ibl/test_sky.hdr"
longitude-offset = 6.0

[camera]
type = "ideal-pinhole"
fov = 39.3077
[[camera.transform]]
type = "look-at"
origin = [278, 273, -800]
target = [278, 273, 0]
up = [0, 1, 0]

[[light]]
type = "area"
object = "light"
emission = [20, 17, 14]

[[object]]
mesh = "cbox"

[[object]]
mesh = "glass"
material = "glass"
[[object.transform]]
type = "translate"
vector = [278, 160, 278]

[[object]]
name = "light"
mesh = "lightq"
material = "black"
[[object.transform]]
type = "translate"
vector = [278, 548, 278]

[[material]]
name = "glass"
type = "ideal-refraction"
reflectance = [0.8, 0.85, 0.8]
absorbtance = 0.002
ior = 1.5

[[material]]
name = "black"
type = "lambert"
albedo = [0, 0, 0]

[[mesh]]
name = "cbox"
type = "obj"
path = "models/simple/cbox.obj"

[[mesh]]
name = "glass"
type = "sphere"
radius = 140

[[mesh]]
name = "lightq"
type = "obj"
path = "models/simple/quad.obj"
"""


def _thin_lens_cbox(toml: str) -> str:
    """Config 4: new-cbox (obj mesh, NEE, intensity join) with a thin-lens
    camera focused on the spheres, and the cbox nudged +0.5 in x. The
    stock box puts its green wall exactly on the checker's x=0 band edge,
    so float32 and float64 hit positions land on different sides of a 2x
    BRDF step; half a unit puts the wall inside one band at both
    precisions."""
    out = toml.replace(
        """[camera]
type = "ideal-pinhole"
fov = 39.3077""",
        """[camera]
type = "thin-lens"
fov = 39.3077
focus-distance = 1050
f-number = 6.0""",
    ).replace(
        """[[object]]
mesh = "cbox"
""",
        """[[object]]
mesh = "cbox"
[[object.transform]]
type = "translate"
vector = [0.5, 0, 0]
""",
    )
    assert "thin-lens" in out
    return out


def scene_tomls(res=(32, 32), spp=24) -> dict[str, str]:
    """-> {config: TOML} as tools/oracle_gate.build_scenes compiles them."""
    def fill(toml):
        return (toml.replace("SPP", str(spp)).replace("RESX", str(res[0]))
                .replace("RESY", str(res[1])))

    return {
        "pt-spheres": fill(PT_SPHERES),
        "nee-phong-blinn": fill(NEE_PHONG),
        "ggx": fill(_shrink(_asset("brdf.toml"), res, spp)),
        "mesh-thinlens": _thin_lens_cbox(_shrink(_asset("new-cbox.toml"), res, spp)),
        "ibl-refraction": fill(IBL_REFR),
        "omni": fill(_shrink(_asset("vr.toml"), (res[0], max(res[1] // 2, 8)), spp)),
    }


def build_scenes(res=(32, 32), spp=24, device=None) -> dict:
    """-> {config: CompiledScene}, compiled by the port on `device`."""
    from lumillyrender_tpu_torch.scene.compiler import compile_scene
    from lumillyrender_tpu_torch.scene.loader import parse_config

    return {name: compile_scene(parse_config(toml, base_dir=ASSETS), device=device)
            for name, toml in scene_tomls(res, spp).items()}


def sized_scenes(size: str, device=None, configs=CONFIGS) -> dict:
    """The configs at `size` ("full" or "ci"); omni at its own spp."""
    s = SIZES[size]
    scenes = build_scenes(s["res"], s["spp"], device)
    if s["omni_spp"] != s["spp"] and "omni" in configs:
        scenes["omni"] = build_scenes(s["res"], s["omni_spp"], device)["omni"]
    return {name: scenes[name] for name in configs}


# ------------------------------------------------- tests/test_render.py's
# A lone convex Lambert sphere where the checker is 1 over its whole
# surface: a cosine-sampled bounce weighs exactly the albedo and escapes,
# so L = albedo * sky with no variance.
FURNACE = """
[renderer]
samples = 8
integrator = "pt"

[film]
resolution = [48, 48]
output = "png"
gamma = 1.0

[sky]
type = "uniform"
color = [1, 1, 1]

[camera]
type = "ideal-pinhole"
fov = 40
[[camera.transform]]
type = "look-at"
origin = [165, 0, 135]
target = [165, 0, 165]
up = [0, 1, 0]

[[object]]
material = "m"
mesh = "ball"
[[object.transform]]
type = "translate"
vector = [165, 0, 165]

[[material]]
name = "m"
type = "lambert"
albedo = [ALBEDO, ALBEDO, ALBEDO]

[[mesh]]
name = "ball"
type = "sphere"
radius = 4
"""

NEE_SCENE = """
[renderer]
samples = SPP
integrator = "INTEGRATOR"
depth = 5
depth-limit = 64

[film]
resolution = [32, 32]
output = "png"

[sky]
type = "uniform"
color = [0, 0, 0]

[camera]
type = "ideal-pinhole"
fov = 60
[[camera.transform]]
type = "look-at"
origin = [0, 1, 4]
target = [0, 1, 0]
up = [0, 1, 0]

[[light]]
type = "area"
object = "lamp"
emission = [12, 10, 8]

[[object]]
name = "lamp"
mesh = "ball"
material = "black"
[[object.transform]]
type = "translate"
vector = [0, 3.2, 0]

[[object]]
mesh = "floor"
material = "white"
[[object.transform]]
type = "translate"
vector = [0, -1000, 0]

[[object]]
mesh = "ball"
material = "gray"
[[object.transform]]
type = "translate"
vector = [0.8, 0.6, 0]

[[material]]
name = "black"
type = "lambert"
albedo = [0, 0, 0]

[[material]]
name = "white"
type = "lambert"
albedo = [0.8, 0.8, 0.8]

[[material]]
name = "gray"
type = "lambert"
albedo = [0.5, 0.5, 0.5]

[[mesh]]
name = "ball"
type = "sphere"
radius = 0.6

[[mesh]]
name = "floor"
type = "sphere"
radius = 1000
"""

# test_compaction_overflow_is_unbiased's closed shell around the camera.
SHELL = """
[[object]]
mesh = "shell"
material = "white"

[[mesh]]
name = "shell"
type = "sphere"
radius = 50
"""


# At 256^2 x 32 spp a few of the white furnace's samples come back 0: a
# hit point rounded inside the sphere (float32) sends a grazing cosine
# sample back into it past EPS, its back face turns the normal inward, and
# the path bounces inside until the depth limit. The JAX package loses 7 of
# the 2,097,152 samples at seed 3, the port's plain path 6 (ROADMAP queue 3).
# Every pixel then lies on the spp lattice, and the lost samples are fewer
# than this share of all samples.
FURNACE_LOST_SHARE = 1e-5


def furnace_lost_samples(film, spp: int) -> tuple[float, int]:
    """(max distance of a white furnace film's pixels from the lattice
    (spp - j) / spp, the lost samples j summed over the film)."""
    lost = np.rint((1.0 - film.astype(np.float64).mean(axis=2)) * spp)
    return float(np.abs(film - ((spp - lost) / spp)[..., None]).max()), int(lost.sum())


def shell_toml() -> str:
    """test_compaction_overflow_is_unbiased's scene: NEE_SCENE at 16x16 x
    16 spp, pt-direct, a 0.9 floor, inside a closed shell."""
    return (NEE_SCENE.replace("SPP", "16").replace("INTEGRATOR", "pt-direct")
            .replace("albedo = [0.8, 0.8, 0.8]", "albedo = [0.9, 0.9, 0.9]")
            .replace("resolution = [32, 32]", "resolution = [16, 16]") + SHELL)


def compile_toml(toml: str, device=None, spp=None, **settings):
    """Compile a TOML string with the port; `settings` replace fields of
    the compiled RenderSettings (width, height, integrator, ...)."""
    from lumillyrender_tpu_torch.scene.compiler import compile_scene
    from lumillyrender_tpu_torch.scene.loader import parse_config

    c = compile_scene(parse_config(toml, base_dir=ASSETS), spp=spp, device=device)
    if settings:
        c.settings = dataclasses.replace(c.settings, **settings)
    return c


def furnace_scene(albedo: float, spp=8, device=None, **settings):
    return compile_toml(FURNACE.replace("ALBEDO", str(albedo)), device, spp, **settings)


def nee_scene(integrator: str, spp: int, device=None, **settings):
    return compile_toml(NEE_SCENE.replace("SPP", str(spp)).replace("INTEGRATOR", integrator),
                        device, **settings)


def big_lamp_scene(integrator: str, spp: int, device=None):
    """test_pt_vs_nee_perpixel_ztest's scene: NEE_SCENE with a lamp of
    radius 1.6, at 16x16."""
    toml = NEE_SCENE.replace(
        """[[mesh]]
name = "ball"
type = "sphere"
radius = 0.6""",
        """[[mesh]]
name = "ball"
type = "sphere"
radius = 0.6

[[mesh]]
name = "bigball"
type = "sphere"
radius = 1.6""",
    ).replace(
        """name = "lamp"
mesh = "ball\"""",
        """name = "lamp"
mesh = "bigball\"""",
    ).replace("resolution = [32, 32]", "resolution = [16, 16]")
    return compile_toml(toml.replace("SPP", str(spp)).replace("INTEGRATOR", integrator), device)


def many_light_scene(integrator: str, spp: int, device=None, **settings):
    """test_many_light_pt_vs_nee_agree's scene: many-light.toml (256 light
    triangles) at 32x32."""
    from lumillyrender_tpu_torch.scene.compiler import compile_scene_file

    c = compile_scene_file(ASSETS / "many-light.toml", spp=spp, device=device)
    c.settings = dataclasses.replace(c.settings, width=32, height=32, integrator=integrator,
                                     **settings)
    return c


# ------------------------------------------------------------- statistics
def zmap(fa, fb):
    """Per-pixel Welch z on channel-mean luminance (seeds on axis 0) ->
    (z, testable), as tools/oracle_gate.zmap. Pixels of zero variance on
    both sides that agree to float32 rounding get z = 0; a pixel of zero
    variance on one side whose means differ is untestable."""
    a, b = fa.mean(axis=3), fb.mean(axis=3)
    ma, mb = a.mean(axis=0), b.mean(axis=0)
    va = a.var(axis=0, ddof=1) / a.shape[0]
    vb = b.var(axis=0, ddof=1) / b.shape[0]
    z = (ma - mb) / np.sqrt(va + vb + 1e-12)
    close = np.abs(ma - mb) <= 1e-6 * np.maximum(np.abs(ma), 1.0) + 1e-7
    degenerate = ((va == 0) | (vb == 0)) & ~close
    return np.where((va == 0) & (vb == 0) & close, 0.0, z), ~degenerate


def zmap_exact(fa, fb):
    """tests/test_render.py's `_zmap`: a pixel of zero variance on one side
    is untestable unless the two means are equal."""
    a, b = fa.mean(axis=3), fb.mean(axis=3)
    ma, mb = a.mean(axis=0), b.mean(axis=0)
    va = a.var(axis=0, ddof=1) / a.shape[0]
    vb = b.var(axis=0, ddof=1) / b.shape[0]
    z = (ma - mb) / np.sqrt(va + vb + 1e-12)
    degenerate = ((va == 0) | (vb == 0)) & (ma != mb)
    return z, ~degenerate


def frac_bad(z, ok) -> float:
    return float((np.abs(z[ok]) > 5.0).mean()) if ok.any() else 0.0


def gray_lattice_max(film, spp: int, albedo: float) -> float:
    """Max distance of a gray furnace film's pixels from the mixtures of
    `spp` samples, each exactly `albedo` (sphere) or 1 (sky)."""
    lattice = np.array([(albedo * k + (spp - k)) / spp for k in range(spp + 1)])
    return float(np.abs(film.reshape(-1, 1) - lattice[None, :]).min(axis=1).max())


def means_gap(a, b) -> dict:
    """test_pt_vs_nee_agree's readings of two luminance films: their means,
    the whole image's relative gap and each quadrant's. `means_agree`
    holds them to its bounds: a lit image, 10% and 20%."""
    h, w = a.shape
    quads = [(a[sy, sx].mean(), b[sy, sx].mean())
             for sy in (slice(0, h // 2), slice(h // 2, h))
             for sx in (slice(0, w // 2), slice(w // 2, w))]
    return dict(mean_a=float(a.mean()), mean_b=float(b.mean()),
                rel=float(abs(a.mean() - b.mean()) / max(a.mean(), 1e-9)),
                quadrant_rel=[float(abs(qa - qb) / max(qa, 1e-9)) for qa, qb in quads])


def means_agree(r: dict) -> bool:
    return r["mean_a"] > 0.01 and r["rel"] < 0.1 and max(r["quadrant_rel"]) < 0.2


def z_of_means(a, b) -> float:
    """|mean(a) - mean(b)| of two lists of film means over their combined
    standard error (test_render.py's compaction and tile-order gates)."""
    a, b = np.asarray(a), np.asarray(b)
    se = np.sqrt(a.var() / len(a) + b.var() / len(b))
    return float(abs(a.mean() - b.mean()) / max(se, 1e-12))


def perpixel_z(fa, fb) -> dict:
    """test_pt_vs_nee_perpixel_ztest's readings of a pt stack `fa` against
    a pt-direct stack `fb`: the untestable share, frac(|z|>5) and max |z|
    under `zmap_exact`, and the same gate's frac(|z|>5) once a +50% bias is
    planted on ~10% of the pixels brighter than the median lit one (numpy
    seed 0). `perpixel_z_holds` holds them to its bounds."""
    z, ok = zmap_exact(fa, fb)
    lum = fb.mean(axis=(0, 3))
    lit = lum > np.median(lum[lum > 0])
    mask = (np.random.default_rng(0).random(lum.shape) < 0.1) & lit
    fb_bug = fb.copy()
    fb_bug[:, mask] *= 1.5
    z_bug, ok_bug = zmap_exact(fa, fb_bug)
    return dict(untestable=float((~ok).mean()), frac_bad=frac_bad(z, ok),
                max_abs_z=float(np.abs(z[ok]).max()), planted_pixels=int(mask.sum()),
                planted_frac_bad=frac_bad(z_bug, ok_bug))


def perpixel_z_holds(r: dict, n_pixels: int) -> bool:
    return (r["untestable"] < 0.02 and r["frac_bad"] < 0.008
            and 4 <= r["planted_pixels"] <= 0.1 * n_pixels and r["planted_frac_bad"] > 0.008)


def gate_fields(name, fr, fo, seeds, compiled) -> dict:
    """ORACLE.json's fields for the port's stack `fr` against the oracle's
    `fo`."""
    z, ok = zmap(fr, fo)
    mr, mo = float(fr.astype(np.float64).mean()), float(fo.astype(np.float64).mean())
    return {
        "config": name,
        "resolution": [compiled.settings.width, compiled.settings.height],
        "spp": compiled.settings.spp,
        "seeds": len(seeds),
        "mean_renderer": mr,
        "mean_oracle": mo,
        "rel_mean_diff": abs(mr - mo) / max(mo, 1e-9),
        "max_abs_z": float(np.abs(z[ok]).max()) if ok.any() else 0.0,
        "frac_abs_z_gt5": frac_bad(z, ok),
        "frac_untestable": float((~ok).mean()),
    }


def passes(r: dict, size: str = "full") -> bool:
    g = GATE[size]
    return (r["frac_abs_z_gt5"] < g["frac_bad"] if size == "full"
            else r["frac_abs_z_gt5"] <= g["frac_bad"]) \
        and r["frac_untestable"] < g["untestable"] \
        and r["rel_mean_diff"] < MEAN_BOUND.get(r["config"], MEAN_BOUND_DEFAULT)


def quadrant_bias(films, quadrant: int, factor=1.2):
    """The films with quadrant `quadrant` (0-3: top-left, top-right,
    bottom-left, bottom-right) scaled by `factor`: a regional bias."""
    out = films.copy()
    h, w = out.shape[1:3]
    qy, qx = divmod(quadrant, 2)
    out[:, qy * h // 2:(qy + 1) * h // 2, qx * w // 2:(qx + 1) * w // 2] *= factor
    return out


def sparse_bias(films, factor=1.5, share=0.05, seed=0):
    """The films with `share` of their lit pixels (nonzero mean), drawn with
    numpy seed `seed`, scaled by `factor`: a sparse bias."""
    lit = films.mean(axis=(0, 3)) > 0
    mask = (np.random.default_rng(seed).random(lit.shape) < share) & lit
    out = films.copy()
    out[:, mask] *= factor
    return out


# ------------------------------------------------------------ the stacks
def load_stacks(size: str, path=STACKS) -> dict:
    """-> {config: (films (S,H,W,3) float32, meta)} of the committed oracle
    stacks, meta holding the config, resolution, spp and seeds."""
    out = {}
    with np.load(path) as z:
        for name in CONFIGS:
            k = f"{size}.{name}"
            meta = json.loads(str(z[k + ".meta"]))
            out[name] = (z[k + ".films"], meta)
    return out


def _oracle_film(args):
    state, seed = args
    from tools.oracle import OracleScene

    osc = object.__new__(OracleScene)
    osc.__dict__.update(state)
    return osc.render(seed)


def write_stacks(workers: int = 8, path=STACKS) -> dict:
    """Render every config's oracle stack at both sizes with tools/oracle.py
    in a pool of `workers` processes and write them to `path`."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from tools.oracle import OracleScene

    jobs, meta = [], {}
    for size in SIZES:
        for name, compiled in sized_scenes(size, "cpu").items():
            st = compiled.settings
            seeds = SIZES[size]["oracle_seeds"]
            meta[(size, name)] = dict(config=name, size=size, resolution=[st.width, st.height],
                                      spp=st.spp, seeds=list(seeds))
            state = OracleScene(compiled).__dict__.copy()
            jobs += [((size, name), (state, s)) for s in seeds]
    # The costliest configs first, so the pool ends together.
    cost = {"ibl-refraction": 4, "mesh-thinlens": 3, "ggx": 2, "omni": 2}
    jobs.sort(key=lambda j: -(cost.get(j[0][1], 1) * (4 if j[0][0] == "full" else 1)))
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as ex:
        films = list(ex.map(_oracle_film, [a for _, a in jobs]))
    stacks: dict = {}
    for (key, (_, seed)), film in zip(jobs, films):
        stacks.setdefault(key, {})[seed] = film
    arrays = {}
    for (size, name), m in meta.items():
        k = f"{size}.{name}"
        arrays[k + ".films"] = np.stack(
            [stacks[(size, name)][s] for s in m["seeds"]]).astype(np.float32)
        arrays[k + ".meta"] = np.array(json.dumps(m))
    np.savez_compressed(path, **arrays)
    return arrays


# ------------------------------------------------------------ the gate
def renderer_films(compiled, seeds, device=None) -> np.ndarray:
    """The port's films of `compiled` for each seed, through `render`."""
    from lumillyrender_tpu_torch.integrator.render import render

    return np.stack([render(compiled, seed=s, device=device).film for s in seeds])


def run_gate(name, compiled, seeds, device=None, size="full", stacks=None) -> dict:
    """ORACLE.json's fields for the port's stack of `compiled` (its seeds
    `seeds`, on `device`) against the committed oracle stack at `size`."""
    fo, _ = (stacks or load_stacks(size))[name]
    fr = renderer_films(compiled, seeds, device)
    r = gate_fields(name, fr, fo, seeds, compiled)
    r["passed"] = passes(r, size)
    return r


def oracle_json_rows() -> dict:
    return {r["config"]: r for r in json.loads((REPO / "ORACLE.json").read_text())["configs"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true",
                    help="render the oracle's stacks and write tests/oracle_stacks.npz")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", choices=tuple(SIZES), default="full")
    args = ap.parse_args(argv)
    jax_rows = oracle_json_rows()
    if args.write:
        arrays = write_stacks(args.workers)
        for name in CONFIGS:
            mean = float(arrays[f"full.{name}.films"].astype(np.float64).mean())
            print(json.dumps({"config": name, "mean_oracle": mean,
                              "oracle_json": jax_rows[name]["mean_oracle"]}))
        return 0
    stacks = load_stacks(args.size)
    ok = True
    for name, compiled in sized_scenes(args.size, args.device).items():
        r = run_gate(name, compiled, SIZES[args.size]["seeds"], args.device, args.size, stacks)
        if args.size == "full":
            r["oracle_json"] = {k: jax_rows[name][k] for k in ORACLE_FIELDS}
        print(json.dumps(r), flush=True)
        ok &= r["passed"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
