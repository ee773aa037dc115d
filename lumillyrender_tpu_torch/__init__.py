"""LumillyRender in PyTorch and CUDA: a Monte Carlo path tracer for one
NVIDIA H100.

A port of the JAX package `lumillyrender_tpu`, which stays the reference:
the same TOML scenes, compiled scene tables, counter-based pcg4d RNG, BSDFs
and wavefront bounce loop, with hand-written CUDA kernels for the camera
rays, the fused bounce (brute force or BVH), the BVH walk and the bounce's
backward pass (ops/cuda_bounce.py, ops/cuda_bvh.py), and the JAX package's
Mosaic capability probes as probe kernels (probes/). `render` renders a
film; `render_diff`, `film_and_grads` and `pixel_grad` (diff/) give film
gradients in material, camera and sky parameters. Entry points run on
`cuda` unless the caller passes `device="cpu"`.
"""

import torch

from .diff import DiffParams, film_and_grads, params_of, pixel_grad, render_diff
from .integrator.render import RenderResult, render, render_chunk
from .scene.compiler import CompiledScene, compile_scene, compile_scene_file
from .scene.loader import Config, load_config, parse_config

# MKL's vector math (VML), which PyTorch calls for sqrt, exp, log, sin and
# cos of CPU tensors, sets itself up at its first call in the process. Where
# that first call is split over PyTorch's intra-op threads, a thread that
# enters it while another one sets it up can take a 12-bit path: sqrt(1)
# gave 0.99975586 on half of 6,000 elements, in about one fresh process in
# nine with JAX's CPU backend running beside it. One call on one thread,
# here, sets VML up before any split call, so the plain versions compute the
# same values on every run.
torch.sqrt(torch.ones(1))

__version__ = "0.1.0"

__all__ = [
    "CompiledScene",
    "Config",
    "DiffParams",
    "RenderResult",
    "compile_scene",
    "compile_scene_file",
    "film_and_grads",
    "load_config",
    "params_of",
    "parse_config",
    "pixel_grad",
    "render",
    "render_chunk",
    "render_diff",
]
