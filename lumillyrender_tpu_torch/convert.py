"""Carry state across from numpy: scenes, path states and parameters.

The JAX package and this one can be fed identical inputs through numpy:
`scene_from_numpy` takes the leaves of a compiled scene (any nested mapping
or dataclass of arrays with the JAX package's field names, such as its
`compile_scene_file(p).data` after `np.asarray` of each leaf),
`state_from_numpy` / `state_to_numpy` move a `PathState` either way, and
`params_from_numpy` / `params_to_numpy` move the differentiable parameters
(`diff.DiffParams`) and their gradients, and `settings_from` the render
settings.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .integrator.wavefront import PathState
from .scene.data import (
    CameraData,
    MaterialTable,
    RenderSettings,
    SceneData,
    SkyData,
    scene_from_tree,
    tensor_of,
)

_PARAM_TYPES = {"materials": MaterialTable, "camera": CameraData, "sky": SkyData}


def _as_tree(x):
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _as_tree(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if hasattr(x, "_asdict"):  # a NamedTuple such as DiffParams
        return _as_tree(x._asdict())
    if isinstance(x, dict):
        return {k: _as_tree(v) for k, v in x.items()}
    return np.asarray(x)


def scene_from_numpy(tree, device="cpu") -> SceneData:
    """Compiled-scene leaves (numpy) -> the port's SceneData on `device`."""
    return scene_from_tree(_as_tree(tree)).to(device)


def state_from_numpy(bounce, o, d, throughput, accum, alive, lane,
                     rays_traced=0.0, device="cpu") -> PathState:
    """numpy arrays in the JAX package's layouts -> PathState. `lane` is
    uint32 and is carried as its bit pattern in an int32 tensor."""
    lane = np.asarray(lane, np.uint32).view(np.int32)
    f = lambda a: tensor_of(a).to(device)
    return PathState(
        bounce=int(bounce),
        o=f(o), d=f(d), throughput=f(throughput), accum=f(accum),
        alive=torch.from_numpy(np.array(alive, bool)).to(device),
        rays_traced=torch.tensor(float(rays_traced), dtype=torch.float32,
                                 device=device),
        lane=torch.from_numpy(np.array(lane)).to(device),
    )


def state_to_numpy(state: PathState) -> dict:
    """PathState -> dict of numpy arrays (lane back as uint32)."""
    n = lambda t: t.detach().cpu().numpy()
    return dict(
        bounce=int(state.bounce),
        o=n(state.o), d=n(state.d), throughput=n(state.throughput),
        accum=n(state.accum), alive=n(state.alive),
        rays_traced=float(state.rays_traced),
        lane=n(state.lane).view(np.uint32),
    )


def params_from_numpy(tree, device="cpu"):
    """The JAX package's `DiffParams` (materials, camera, sky; any nested
    mapping, NamedTuple or dataclass of arrays with its field names) ->
    the port's `diff.DiffParams` on `device`."""
    from .diff.render import DiffParams

    t = _as_tree(tree)
    return DiffParams(**{
        name: cls(**{f.name: tensor_of(t[name][f.name]).to(device)
                     for f in dataclasses.fields(cls)})
        for name, cls in _PARAM_TYPES.items()})


def params_to_numpy(params) -> dict:
    """`diff.DiffParams` (of values or gradients) -> {'materials': {field:
    array}, 'camera': ..., 'sky': ...}. Integer leaves come back as zeros
    of their shape (a gradient has none; the JAX package gives them
    float0)."""
    out = {}
    for name, part in params._asdict().items():
        out[name] = {}
        for f in dataclasses.fields(part):
            x = getattr(part, f.name).detach().cpu()
            out[name][f.name] = (x.numpy() if x.is_floating_point()
                                 else np.zeros(tuple(x.shape), np.float32))
    return out


def settings_from(settings) -> RenderSettings:
    """The port's RenderSettings with the values of `settings` (the JAX
    package's RenderSettings, or any object with its field names), its
    `fused` switch and `bwd_remat` policy included; a field `settings`
    lacks keeps the port's default."""
    return RenderSettings(**{f.name: getattr(settings, f.name)
                             for f in dataclasses.fields(RenderSettings)
                             if hasattr(settings, f.name)})
