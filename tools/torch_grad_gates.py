"""The gradient gates of the port's differentiable path: FD against AD, the
cases, their scenes and the helpers that chip_smoke.py (phases 12, 25 and
30) and the port's tests (tests/test_torch_grad_gates.py, against the JAX
package on the CPU; tests/test_torch_cuda.py, on the card) all call.
PyTorch and numpy only. Run as a script, it prints the CPU's readings of
phase 30's kernel-2 cases (`KERNEL2_FD`) through the step the card runs
(`cuda_bounce.make_step_hybrid`: on the CPU the plain step forward and
autograd of `recompute` backward), one line a case beside its limit, as
phase 30 prints the card's; exit 1 if a gate fails.

    python tools/torch_grad_gates.py             # ~15 s on 8 cores
    python tools/torch_grad_gates.py --ior-steps # the glass IOR's central
        # differences at steps 2.5e-3 to 4e-2 beside its AD (~5 s)

A case is (part, field, index, FD step, atol, rtol[, pixels[, sign]]):
central differences at eps/2, eps and 2 eps of the film's mean (the
median), the sampling pinned at theta0, hold when |AD - FD| < atol + rtol
|FD| (tests/test_diff.py::fd_vs_ad). `pixels` narrows both sides to a mask
of the film: "interior", the pixels that cross no boundary inside the
steps; "moved", the pixels whose film the steps move at all (a parameter
of a small object, whose whole-film gradient the test's atol would
swamp). A sign of +1 or -1 requires sign x AD > 0, so that a zero AD or
one of the wrong sign fails.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
FD_SEED = 21
# The card's AD of a kernel-2 case against the CPU's on the same inputs
# (phase 30): the two plain steps differ in the math libraries' last bits.
CARD_CPU_RTOL = 1e-4

# tests/test_diff.py's SCENE under pt-direct (the third ball GGX).
MIXED_DIFF_SCENE = """
[renderer]
samples = 4
integrator = "pt-direct"
depth = 3
depth-limit = 8

[film]
resolution = [12, 12]
output = "png"

[sky]
type = "uniform"
color = [0.4, 0.5, 0.6]

[camera]
type = "ideal-pinhole"
fov = 45
[[camera.transform]]
type = "look-at"
origin = [165, 0, 135]
target = [165, 0, 165]
up = [0, 1, 0]

[[light]]
type = "area"
object = "lamp"
emission = [6, 5, 4]

[[object]]
name = "lamp"
mesh = "ball"
material = "black"
[[object.transform]]
type = "translate"
vector = [165, 9, 165]

[[object]]
mesh = "ball"
material = "diffuse"
[[object.transform]]
type = "translate"
vector = [163, 0, 165]

[[object]]
mesh = "ball"
material = "metal"
[[object.transform]]
type = "translate"
vector = [168, 0, 168]

[[material]]
name = "black"
type = "lambert"
albedo = [0, 0, 0]

[[material]]
name = "diffuse"
type = "lambert"
albedo = [0.6, 0.45, 0.3]

[[material]]
name = "metal"
type = "ggx"
reflectance = [0.9, 0.8, 0.7]
roughness = 0.45
ior = 100

[[mesh]]
name = "ball"
type = "sphere"
radius = 2
"""
# tests/test_fused_bounce.py's GLOSSY_DIFF_SCENE: the second ball GGX, the
# third Lambert (tests/test_torch_grad_gates.py holds both strings equal to
# the JAX tests').
GLOSSY_DIFF_SCENE = MIXED_DIFF_SCENE.replace('material = "metal"', 'material = "gray"').replace(
    """type = "lambert"
albedo = [0.6, 0.45, 0.3]

[[material]]
name = "metal"
type = "ggx"
reflectance = [0.9, 0.8, 0.7]
roughness = 0.45
ior = 100""", """type = "ggx"
reflectance = [0.8, 0.75, 0.7]
roughness = 0.45
ior = 12

[[material]]
name = "gray"
type = "lambert"
albedo = [0.5, 0.5, 0.5]""")

# tests/test_fused_bounce.py's hybrid FD tests on GLOSSY_DIFF_SCENE (row 1,
# GGX): steps and tolerances as there.
GLOSSY_FD = {
    "roughness": ("materials", "alpha", (1,), 4e-2, 2e-4, 0.15, None, -1),
    "reflectance": ("materials", "color", (1, 0), 2e-2, 2e-4, 0.1, None, 1),
}
# ibl-material's rows (compiled order): 4 glass (ideal refraction), 5 metal
# (GGX), 6 shiny (Phong), 7 brushed (Blinn-Phong). Roughness and
# reflectance take tests/test_diff.py's steps and tolerances; the Phong and
# Blinn-Phong exponents (30, 20) a step of 1, 3-5% of the exponent; the
# absorbtance a step of 1e-2 (the central differences drift from -6.689 at
# 5e-3 to -6.976 at 4e-2, the film being exponential in it); the IOR a step
# of 5e-3 (steps 2.5e-3, 5e-3, 1e-2): at 2e-2 and 4e-2 the central
# difference reads +0.014 and +2.23 against AD -0.977, the wider steps
# crossing a lane's discrete decision.
IBL_MATERIAL_FD = {
    "ggx alpha": ("materials", "alpha", (5,), 2e-2, 5e-4, 0.1, None, 1),
    "phong alpha": ("materials", "alpha", (6,), 1.0, 2e-4, 0.1, None, 1),
    "blinn-phong alpha": ("materials", "alpha", (7,), 1.0, 2e-4, 0.1, None, 1),
    "glass absorbtance": ("materials", "absorbtance", (4,), 1e-2, 2e-4, 0.1, None, -1),
    "glass ior": ("materials", "ior", (4,), 5e-3, 1e-6, 0.1, None, -1),
    "glass reflectance": ("materials", "color", (4, 0), 2e-2, 2e-4, 0.08, None, 1),
}
IBL_MATERIAL_SIZE = (32, 24, 4, 5)  # w, h, spp, max_bounces
# KERNEL2_FD's scenes (gate_scenes): GLOSSY_DIFF_SCENE, ibl-material, and
# tests/test_torch_diff.py's FD_CASES that take the hybrid, on
# tests/test_diff.py's mixed scene (pt-direct, and pt for the camera). The
# camera's gradient (~9.4e-5) is under its test's atol (2e-3): its sign and
# phase 30's card-against-CPU rule hold it.
KERNEL2_FD = {
    "glossy": GLOSSY_FD,
    "ibl-material 32x24": IBL_MATERIAL_FD,
    "mixed": {
        "roughness": ("materials", "alpha", (2,), 2e-2, 5e-4, 0.1, None, -1),
        "ior": ("materials", "ior", (2,), 2.0, 1e-6, 0.1, None, 1)},
    "mixed pt": {
        "camera": ("camera", "aperture_position", (2,), 5e-2, 2e-3, 0.25, None, 1)},
}
# welcome's bunny (row 0, GGX, roughness 0.8): tests/test_diff.py's
# roughness and albedo steps and tolerances, over the pixels the bunny's
# row moves (at full width its whole-film gradients, ~1e-4 and ~2e-5, lie
# under the atols).
WELCOME_FD = {
    "glossy alpha": ("materials", "alpha", (0,), 2e-2, 5e-4, 0.1, "moved", -1),
    "glossy reflectance": ("materials", "color", (0, 0), 2e-2, 2e-4, 0.08, "moved", 1),
}
# The heroes at full width (one 1-spp chunk; sample at 512^2): the fields of
# the bunny rows whose gradients must be nonzero, and FD cases through
# kernel 4. A refracted ray's IBL texel moves with the IOR, a boundary term
# the detached-sampling gradient leaves out, so ridaisai's IOR is compared
# over the pixels that cross no boundary inside the steps ("interior"); its
# sign depends on the view (a camera that the bunny fills reads +0.34 at
# 24x18 x 2 spp), its AD (~1e-4 at full width) lies far over its atol.
HERO_WIDTHS = {"welcome": (2138, 1536), "ridaisai": (2138, 1536), "sample": (512, 512)}
HERO_FIELDS = {"welcome": ("color", "alpha"), "ridaisai": ("color", "ior", "absorbtance"),
               "sample": ("color",)}
HERO_FD = {
    "welcome": WELCOME_FD,
    "ridaisai": {
        "orange ior": ("materials", "ior", (0,), 5e-3, 1e-6, 0.1, "interior"),
        "orange absorbtance": ("materials", "absorbtance", (0,), 1e-2, 2e-4, 0.1, "moved", -1),
        "orange reflectance": ("materials", "color", (0, 0), 2e-2, 2e-4, 0.08, "moved", 1)},
}


def set_leaf(p, part, field, idx, v):
    t = getattr(getattr(p, part), field).clone()
    t[idx] = v
    return p._replace(**{part: dataclasses.replace(getattr(p, part), **{field: t})})


def resized(c, w, h, spp):
    """`c` (a CompiledScene) at a w x h film of `spp` samples."""
    return dataclasses.replace(c, settings=dataclasses.replace(
        c.settings, width=w, height=h, spp=spp))


def mean_grad(scene, settings, device, seed=FD_SEED):
    """pixel_grad of the film's mean at the scene's own parameters, the
    sampling pinned there (the FD gate's AD side)."""
    from lumillyrender_tpu_torch.diff import params_of, pixel_grad

    p0 = params_of(scene)
    return pixel_grad(scene, settings, p0, seed, settings.spp, lambda f: f.mean(),
                      params_sample=p0, device=device)


def fd_vs_ad(scene, settings, cases, device, grad=None) -> dict:
    """tests/test_diff.py's gate for each case {tag: (part, field, index,
    eps, atol, rtol[, pixels[, sign]])}: central differences at three steps
    (the median) against pixel_grad of the mean film, the sampling pinned
    at theta0. An index of None takes the element whose AD gradient is
    largest (an IBL texel that the paths reach most). `grad` is
    `mean_grad`'s result, when the caller has it. With pixels "interior",
    both sides take the mean over the pixels whose three central
    differences agree within 10% (no edge or texel border crossed inside
    the steps), where the detached-sampling gradient, which leaves such
    boundary terms out, and FD measure the same thing; at least half the
    pixels must be kept. With "moved", over the pixels whose film a step
    changes. Prints a line a case; returns {tag: reading}, each with `ok`."""
    from lumillyrender_tpu_torch.diff import params_of, pixel_grad, render_diff

    p0 = params_of(scene)
    spp = settings.spp
    film = lambda p: render_diff(scene, settings, p, FD_SEED, spp, params_sample=p0,
                                 device=device)
    ad_of = lambda select: pixel_grad(scene, settings, p0, FD_SEED, spp, select,
                                      params_sample=p0, device=device)
    if grad is None:
        grad = ad_of(lambda f: f.mean())
    out = {}
    for tag, (part, field, idx, eps, atol, rtol, *rule) in cases.items():
        pixels, sign = rule + [None, 0][len(rule):]
        g = grad
        if idx is None:
            ga = getattr(getattr(g, part), field)
            idx = tuple(int(i) for i in np.unravel_index(int(ga.argmax()), tuple(ga.shape)))
        idx = idx if isinstance(idx, tuple) else (idx,)
        v0 = float(getattr(getattr(p0, part), field)[idx])
        fd = torch.stack([(film(set_leaf(p0, part, field, idx, v0 + e))
                           - film(set_leaf(p0, part, field, idx, v0 - e))) / (2 * e)
                          for e in (eps / 2, eps, 2 * eps)])
        if pixels is None:
            keep = torch.ones(fd.shape[1:3], dtype=torch.bool, device=fd.device)
            fds = [float(fd[k].mean()) for k in range(3)]
            g_fd = float(np.median(fds))
        else:
            med = fd.median(dim=0).values
            if pixels == "interior":
                spread = fd.max(dim=0).values - fd.min(dim=0).values
                keep = (spread <= 0.1 * med.abs() + 1e-4 * med.abs().max()).all(dim=-1)
            else:
                assert pixels == "moved", pixels
                keep = (fd != 0).any(dim=0).any(dim=-1)
            mask = keep[..., None].to(med.dtype)
            n = mask.sum() * 3
            g = ad_of(lambda f: (f * mask).sum() / n)
            fds = [float((fd[k] * mask).sum() / n) for k in range(3)]
            g_fd = float((med * mask).sum() / n)
        g_ad = float(getattr(getattr(g, part), field)[idx])
        kept = float(keep.double().mean())
        ok = bool(np.isfinite(g_ad) and np.isfinite(g_fd)
                  and abs(g_ad - g_fd) < atol + rtol * abs(g_fd)
                  and kept >= (0.5 if pixels == "interior" else 0.0) and kept > 0
                  and (sign == 0 or sign * g_ad > 0))
        rel = abs(g_ad - g_fd) / max(abs(g_fd), 1e-30)
        where = {None: "", "interior": " without a boundary crossed",
                 "moved": " the steps move"}[pixels]
        print(f"FD vs AD, {tag} ({part}.{field}{list(idx)}): AD {g_ad:.7g}, FD {g_fd:.7g}, rel "
              f"{rel:.2e} (limit {atol:g} + {rtol:g} |FD|"
              + (f", sign {sign:+d}" if sign else "") + ")"
              + (f", over the {kept:.2%} of pixels{where}" if pixels else "")
              + ("" if ok else "  FAIL"), flush=True)
        out[tag] = dict(ad=g_ad, fd=g_fd, fds=fds, rel=rel, index=list(idx), pixels=pixels,
                        pixels_kept=kept, limit=[atol, rtol], sign=sign, ok=ok)
    return out


def gate_scenes(assets, device) -> tuple:
    """The scenes of KERNEL2_FD on `device` ({name: CompiledScene}) and the
    analytic direct view's (the mixed scene under pt, one bounce, 8 spp)."""
    from lumillyrender_tpu_torch.scene.compiler import compile_scene, compile_scene_file
    from lumillyrender_tpu_torch.scene.loader import parse_config

    def small(toml, spp, bounces, integrator="pt-direct"):
        c = compile_scene(parse_config(toml.replace('integrator = "pt-direct"',
                                                    f'integrator = "{integrator}"')),
                          spp=spp, device=device)
        return dataclasses.replace(c, settings=dataclasses.replace(c.settings,
                                                                   max_bounces=bounces))

    w, h, spp, bounces = IBL_MATERIAL_SIZE
    ibl = compile_scene_file(Path(assets) / "ibl-material.toml", device=device)
    ibl = resized(dataclasses.replace(ibl, settings=dataclasses.replace(
        ibl.settings, max_bounces=bounces)), w, h, spp)
    return ({"glossy": small(GLOSSY_DIFF_SCENE, 4, 5), "ibl-material 32x24": ibl,
             "mixed": small(MIXED_DIFF_SCENE, 4, 5),
             "mixed pt": small(MIXED_DIFF_SCENE, 4, 3, "pt")},
            small(MIXED_DIFF_SCENE, 8, 1, "pt"))


def bunny_rows(scene) -> list:
    """The material rows of the hero scenes' bunnies: every row holding
    more than 1,000 triangles."""
    counts = torch.bincount(scene.geometry.tri_mat.long(),
                            minlength=scene.materials.type_id.shape[0])
    return [int(r) for r in torch.nonzero(counts > 1000).flatten()]


def perturbed_rows(mats, rows):
    """The material table with `rows` moved off their values: reflectance
    x0.8, roughness or exponent x0.8, absorbtance x1.5, IOR - 1 x0.9."""
    new = {k: getattr(mats, k).clone() for k in ("color", "alpha", "ior", "absorbtance")}
    for r in rows:
        new["color"][r] *= 0.8
        new["alpha"][r] *= 0.8
        new["absorbtance"][r] *= 1.5
        new["ior"][r] = 1.0 + (new["ior"][r] - 1.0) * 0.9
    return dataclasses.replace(mats, **new)


def sensor_bounds(cam, points):
    """(x0, x1, y0, y1): the sensor coordinates (sample_rays' sx, sy) where
    the chief rays through the aperture's centre meet `points` (N, 3)."""
    a, pos = cam.aperture_position, cam.position
    t = torch.dot(a - pos, cam.forward) / ((points - a) @ cam.forward)
    s = (a - pos) - t[:, None] * (points - a)
    sx, sy = -(s @ cam.right), s @ cam.up
    return float(sx.min()), float(sx.max()), float(sy.min()), float(sy.max())


def view_of_rows(scene, settings, rows, w, h, spp, margin=1.1):
    """The scene and settings with the camera's sensor narrowed to the
    projected bounds of `rows`' triangles (square pixels, `margin` around
    them) at a w x h film of `spp` samples: a crop of the original view,
    as a sensor of that size and centre gives it."""
    g = scene.geometry
    on = torch.isin(g.tri_mat, torch.tensor(rows, dtype=g.tri_mat.dtype, device=g.tri_mat.device))
    p0, e1, e2 = g.tri_p0[on], g.tri_e1[on], g.tri_e2[on]
    cam = scene.camera
    x0, x1, y0, y1 = sensor_bounds(cam, torch.cat([p0, p0 + e1, p0 + e2]))
    sw = max(x1 - x0, (y1 - y0) * w / h) * margin
    size = torch.tensor([sw, sw * h / w], dtype=cam.sensor_size.dtype,
                        device=cam.sensor_size.device)
    cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
    pos = cam.position - cam.right * cx + cam.up * cy
    scene = dataclasses.replace(scene, camera=dataclasses.replace(cam, position=pos,
                                                                  sensor_size=size))
    return scene, dataclasses.replace(settings, width=w, height=h, spp=spp)


def direct_view(scene, settings, device) -> tuple:
    """tests/test_diff.py's analytic direct view (pt, one bounce): (the lamp
    row's emission gradient of the film's mean, the share of the camera
    samples that hit the lamp, counted from the film with that emission at
    1 and every other emission and the sky at 0)."""
    from lumillyrender_tpu_torch.diff import params_of, render_diff

    g = mean_grad(scene, settings, device).materials.emission[0].cpu().numpy()
    emission = torch.zeros_like(scene.materials.emission)
    emission[0] = 1.0
    dark = dataclasses.replace(
        scene, materials=dataclasses.replace(scene.materials, emission=emission),
        sky=dataclasses.replace(scene.sky, color=torch.zeros_like(scene.sky.color)))
    share = float(render_diff(dark, settings, params_of(dark), FD_SEED, settings.spp,
                              device=device).mean())
    return g, share


def ior_steps(c) -> None:
    """ibl-material's glass IOR (IBL_MATERIAL_FD's case): its central
    difference at each of a range of steps, beside its AD gradient."""
    from lumillyrender_tpu_torch.diff import params_of, render_diff

    part, field, idx = IBL_MATERIAL_FD["glass ior"][:3]
    scene, st = c.data, c.settings
    p0 = params_of(scene)
    f = lambda p: float(render_diff(scene, st, p, FD_SEED, st.spp, params_sample=p0,
                                    device="cpu").mean())
    v0 = float(getattr(getattr(p0, part), field)[idx])
    ad = float(getattr(getattr(mean_grad(scene, st, "cpu"), part), field)[idx])
    for e in (2.5e-3, 5e-3, 1e-2, 2e-2, 4e-2):
        fd = (f(set_leaf(p0, part, field, idx, v0 + e))
              - f(set_leaf(p0, part, field, idx, v0 - e))) / (2 * e)
        print(f"glass ior, step {e:g}: central difference {fd:.7g}, AD {ad:.7g}")


def main() -> int:
    import argparse
    from unittest import mock

    sys.path.insert(0, str(REPO))
    from lumillyrender_tpu_torch.ops import cuda_bounce

    parser = argparse.ArgumentParser(description="The CPU's readings of phase 30's FD cases.")
    parser.add_argument("--ior-steps", action="store_true",
                        help="the glass IOR's central differences at a range of steps")
    args = parser.parse_args()
    scenes, _ = gate_scenes(REPO / "assets", "cpu")
    with mock.patch.object(cuda_bounce, "make_step_diff", cuda_bounce.make_step_hybrid):
        if args.ior_steps:
            ior_steps(scenes["ibl-material 32x24"])
            return 0
        ok = True
        for name, c in scenes.items():
            out = fd_vs_ad(c.data, c.settings, {f"{name} {t}": v
                                                for t, v in KERNEL2_FD[name].items()}, "cpu")
            ok = ok and all(r["ok"] for r in out.values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
