"""One differentiable bounce and its gradients in every input, for the
port's tests of the hybrid step on BVH, IBL and simple-sky scenes:
tests/test_torch_diff_hybrid.py (on the CPU) and tests/test_torch_cuda.py
(on the card). PyTorch only."""

import dataclasses

import torch

from lumillyrender_tpu_torch.ops import cuda_bounce


def live_leaves(scene, settings):
    """Leaf copies of the material colours and emissions and of the sky's
    `cuda_bounce.SKY_LEAVES`, each requiring grad: (materials, {sky leaf
    name: tensor}, the scene with that sky)."""
    mats = dataclasses.replace(scene.materials,
                               color=scene.materials.color.clone().requires_grad_(),
                               emission=scene.materials.emission.clone().requires_grad_())
    names = cuda_bounce.SKY_LEAVES[settings.sky_kind]
    sky = {k: getattr(scene.sky, k).clone().requires_grad_() for k in names}
    return mats, sky, dataclasses.replace(scene, sky=dataclasses.replace(scene.sky, **sky))


def step_grads(step_of, scene, settings, state, cot):
    """One bounce of `step_of(live scene, materials)` on `state`: its
    outputs and the gradients of (o, d, throughput, accum) against `cot`
    in o, d, throughput, accum, the colours, the emissions and the sky's
    leaves, in that order (zeros where unused)."""
    x = [t.clone().requires_grad_() for t in (state.o, state.d, state.throughput, state.accum)]
    mats, sky, live = live_leaves(scene, settings)
    out = step_of(live, mats)(dataclasses.replace(state, o=x[0], d=x[1], throughput=x[2],
                                                  accum=x[3]))
    ins = x + [mats.color, mats.emission] + list(sky.values())
    grads = torch.autograd.grad((out.o, out.d, out.throughput, out.accum), ins, cot,
                                allow_unused=True)
    return out, [torch.zeros_like(t) if g is None else g for g, t in zip(grads, ins)]
