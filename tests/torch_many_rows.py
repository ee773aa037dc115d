"""A Lambert-only scene past the backward kernel's row cap, and one bounce's
gradients, for the port's tests of the hybrid differentiable step:
tests/test_torch_bounce.py (on the CPU) and tests/test_torch_cuda.py (on
the card). PyTorch only."""

import dataclasses

import torch


def tiled_scene(data, rows: int):
    """`data` with its material table repeated to `rows` rows; rows
    0 .. nm - 1 keep their values, so the scene renders as before."""
    mats = data.materials
    reps = -(-rows // mats.type_id.shape[0])
    return dataclasses.replace(data, materials=dataclasses.replace(mats, **{
        f.name: torch.cat([getattr(mats, f.name)] * reps)[:rows]
        for f in dataclasses.fields(mats)}))


def bounce_grads(step_of, scene, state, cot):
    """The gradients of one bounce's (o, d, throughput, accum) against the
    cotangents `cot`, in the state's o, d and throughput and in the albedo
    rows: `step_of(mats)` is the step with material table `mats`, whose
    color requires grad."""
    x = [t.clone().requires_grad_() for t in (state.o, state.d, state.throughput)]
    mats = dataclasses.replace(scene.materials,
                               color=scene.materials.color.clone().requires_grad_())
    out = step_of(mats)(dataclasses.replace(state, o=x[0], d=x[1], throughput=x[2]))
    return torch.autograd.grad((out.o, out.d, out.throughput, out.accum), x + [mats.color],
                               cot, allow_unused=True)
