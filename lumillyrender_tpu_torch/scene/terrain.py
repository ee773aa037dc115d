"""A displaced-grid terrain mesh and the BVH test scene built on it.

`make_terrain` is the JAX package's benchmark terrain
(tools/bench_bigmesh.py::make_terrain), kept here so that the port needs
nothing outside its package. `terrain_scene_toml` is the ~9k-triangle scene
the JAX package's fused-BVH tests render (tests/test_fused_bvh.py): the
terrain, a GGX ball and a spherical lamp, just past the brute-force
threshold, so it takes the BVH path.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def make_terrain(n_tris: int, seed: int = 0):
    """Displaced-grid terrain with ~n_tris triangles (2 per cell):
    (p0, e1, e2, n) float32 arrays of shape (T, 3)."""
    side = max(2, int(np.sqrt(n_tris / 2)))
    rng = np.random.default_rng(seed)
    xs = np.linspace(-10, 10, side + 1)
    zs = np.linspace(-10, 10, side + 1)
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    Y = np.sin(X * 0.7) * np.cos(Z * 0.6) + 0.15 * rng.standard_normal(X.shape)
    V = np.stack([X, Y, Z], axis=-1).astype(np.float32)
    a = V[:-1, :-1].reshape(-1, 3)
    b = V[1:, :-1].reshape(-1, 3)
    c = V[:-1, 1:].reshape(-1, 3)
    d = V[1:, 1:].reshape(-1, 3)
    p0 = np.concatenate([a, b])
    p1 = np.concatenate([b, d])
    p2 = np.concatenate([c, c])
    e1, e2 = p1 - p0, p2 - p0
    n = np.cross(e1, e2)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    return (p0.astype(np.float32), e1.astype(np.float32),
            e2.astype(np.float32), n.astype(np.float32))


def write_obj(path, p0, e1, e2):
    """Write triangles (p0, p0 + e1, p0 + e2) as an .obj mesh `terrain`."""
    p1 = p0 + e1
    p2 = p0 + e2
    lines = ["o terrain"]
    for a, b, c in zip(p0, p1, p2):
        lines += [f"v {a[0]} {a[1]} {a[2]}", f"v {b[0]} {b[1]} {b[2]}",
                  f"v {c[0]} {c[1]} {c[2]}"]
    lines += [f"f {3 * i + 1} {3 * i + 2} {3 * i + 3}" for i in range(p0.shape[0])]
    Path(path).write_text("\n".join(lines) + "\n")


UNIFORM_SKY = 'type = "uniform"\ncolor = [0.4, 0.5, 0.7]'


def ibl_sky(hdr_path) -> str:
    """The [sky] body of an IBL sky from an equirect .hdr file."""
    return f'type = "ibl"\npath = "{hdr_path}"\nlongitude-offset = 6.0'


_SCENE = """
[renderer]
samples = 4
depth = 5
depth-limit = 64
no-direct-emitter = false
threads = 0
integrator = "INTEGRATOR"

[film]
resolution = [32, 32]
output = "png"
gamma = 2.2

[sky]
SKY

[camera]
type = "ideal-pinhole"
fov = 45
[[camera.transform]]
type = "look-at"
origin = [0, 8, 30]
target = [0, 0, 0]
up = [0, 1, 0]

[[light]]
type = "area"
object = "lamp"
emission = [12, 10, 8]

[[object]]
mesh = "terrain"
material = "ground"

[[object]]
mesh = "ball"
material = "shiny"
[[object.transform]]
type = "translate"
vector = [2, 3, 2]

[[object]]
name = "lamp"
mesh = "lampball"
material = "black"
[[object.transform]]
type = "translate"
vector = [-3, 9, -2]

[[material]]
name = "ground"
type = "lambert"
albedo = [0.6, 0.55, 0.5]

[[material]]
name = "shiny"
type = "ggx"
reflectance = [0.9, 0.85, 0.8]
roughness = 0.4
ior = 20

[[material]]
name = "black"
type = "lambert"
albedo = [0, 0, 0]

[[mesh]]
name = "terrain"
type = "obj"
path = "terrain.obj"

[[mesh]]
name = "ball"
type = "sphere"
radius = 1.5

[[mesh]]
name = "lampball"
type = "sphere"
radius = 1.0
"""


def terrain_scene_toml(integrator: str = "pt-direct", sky: str = UNIFORM_SKY) -> str:
    """The scene's TOML; its mesh is `terrain.obj` beside it (write it with
    `write_obj(dir / "terrain.obj", *make_terrain(9000)[:3])`)."""
    return _SCENE.replace("INTEGRATOR", integrator).replace("SKY", sky)
