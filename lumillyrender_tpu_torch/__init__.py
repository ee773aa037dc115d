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

from .diff import DiffParams, film_and_grads, params_of, pixel_grad, render_diff
from .integrator.render import RenderResult, render, render_chunk
from .scene.compiler import CompiledScene, compile_scene, compile_scene_file
from .scene.loader import Config, load_config, parse_config

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
