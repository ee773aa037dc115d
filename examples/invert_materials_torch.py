"""Inverse rendering on the PyTorch/CUDA port: recover material albedos from
an image (the counterpart of examples/invert_materials.py).

Renders the flagship scene with its true materials to produce a target
film, perturbs the albedos that the view observes, then runs Adam over the
detached-sampling differentiable renderer (`lumillyrender_tpu_torch.diff`)
to recover them. On the card the training step is the bounce kernel
forward with the hand-written backward kernel (new-cbox is Lambert-only).

    python examples/invert_materials_torch.py [--steps 60] [--size 64] [--spp 4]
        [--lr 5e-2] [--cpu]

It runs on the CUDA card, and raises where there is none; `--cpu` runs the
plain PyTorch path on the CPU instead. Imports PyTorch and the port only.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from lumillyrender_tpu_torch.diff import film_and_grads, params_of, pixel_grad, render_diff  # noqa: E402
from lumillyrender_tpu_torch.scene.compiler import compile_scene_file  # noqa: E402
from lumillyrender_tpu_torch.scene.data import resolve_device  # noqa: E402


def with_color(params, color):
    """`params` with the material colours replaced by `color`."""
    return params._replace(materials=dataclasses.replace(params.materials, color=color))


def main(argv=None) -> tuple[float, float]:
    """Run the example; returns (initial, final) max albedo error over the
    observable materials."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--lr", type=float, default=5e-2)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    dev = resolve_device("cpu" if args.cpu else None)
    compiled = compile_scene_file(REPO / "assets" / "new-cbox.toml", spp=args.spp, device=dev)
    settings = dataclasses.replace(compiled.settings, width=args.size, height=args.size,
                                   max_bounces=8)
    scene = compiled.data

    true_params = params_of(scene)
    # Target at 8x the training spp (averaged over seeds): target noise is
    # per-pixel bias the optimizer would otherwise chase.
    with torch.no_grad():
        target = sum(render_diff(scene, settings, true_params, seed=7 + 1000 * i,
                                 spp=args.spp, device=dev) for i in range(8)) / 8.0

    # Perturb only OBSERVABLE albedos: materials that receive a gradient
    # from this view (emitters and off-camera rows get none: a parameter
    # with no image influence cannot be recovered by any method).
    g0 = pixel_grad(scene, settings, true_params, 13, args.spp,
                    lambda film: torch.mean((film - 0.5) ** 2), device=dev)
    observable = g0.materials.color.abs().sum(dim=1).cpu().numpy() > 0
    print(f"observable materials: {int(observable.sum())}/{observable.shape[0]}")

    rng = np.random.default_rng(0)
    color0 = true_params.materials.color.detach().cpu().numpy()
    guess = np.where(
        observable[:, None],
        np.clip(color0 * rng.uniform(0.3, 1.7, color0.shape), 0.05, 0.95),
        color0,
    ).astype(np.float32)

    # Only the material colours are trained; everything else is frozen.
    # optax's exponential_decay(lr, steps, 0.1): the rate falls to 0.1 of
    # itself over the run.
    color = torch.nn.Parameter(torch.from_numpy(guess).to(dev))
    opt = torch.optim.Adam([color], lr=args.lr)
    decay = torch.optim.lr_scheduler.ExponentialLR(opt, gamma=0.1 ** (1.0 / args.steps))

    def obs_err(c):
        e = np.abs(c.detach().cpu().numpy() - color0).max(axis=1)
        return float(e[observable].max())

    err0 = obs_err(color)
    for i in range(args.steps):
        loss, _, grads = film_and_grads(scene, settings, with_color(true_params, color.detach()),
                                        target, 100 + i, args.spp, device=dev)
        opt.zero_grad()
        color.grad = grads.materials.color
        opt.step()
        decay.step()
        with torch.no_grad():
            color.clamp_(0.0, 1.0)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:3d}  loss {float(loss):.3e}  "
                  f"max |albedo err| {obs_err(color):.4f}", flush=True)
    err = obs_err(color)
    print(f"initial max albedo error {err0:.4f} -> final {err:.4f}")
    if err < err0 * 0.5:
        print("recovered: error reduced by >2x")
    else:
        print("WARNING: optimization made <2x progress")
    return err0, err


if __name__ == "__main__":
    main()
