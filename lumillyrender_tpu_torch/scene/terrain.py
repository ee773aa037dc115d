"""A displaced-grid terrain mesh and the BVH test scene built on it.

`make_terrain` is the JAX package's benchmark terrain
(tools/bench_bigmesh.py::make_terrain), kept here so that the port needs
nothing outside its package. `terrain_scene_toml` is the scene the JAX
package's fused-BVH tests render (tests/test_fused_bvh.py): the terrain, a
GGX ball and a spherical lamp. With its ~9k-triangle terrain it is just
past the brute-force threshold, so it takes the BVH path; with 1M or 1.5M
triangles (terrain-1m, terrain-1.5m) the compiler builds 128-wide leaves.
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
    """Write triangles (p0, p0 + e1, p0 + e2) as an .obj mesh `terrain`,
    each coordinate to nine significant digits (enough for a float32 to
    read back exactly once rounded to float32). The whole mesh is formatted
    by one %-operation over flat lists: ~3 s for 1M triangles on one CPU
    core, where a line at a time took ~17 s."""
    v = np.stack([p0, p0 + e1, p0 + e2], axis=1).reshape(-1, 3)
    n = p0.shape[0]
    with open(path, "w") as f:
        f.write("o terrain\n")
        f.write(("v %.9g %.9g %.9g\n" * v.shape[0])
                % tuple(v.astype(np.float64).ravel().tolist()))
        f.write(("f %d %d %d\n" * n) % tuple(range(1, 3 * n + 1)))


UNIFORM_SKY = 'type = "uniform"\ncolor = [0.4, 0.5, 0.7]'


def ibl_sky(hdr_path) -> str:
    """The [sky] body of an IBL sky from an equirect .hdr file."""
    return f'type = "ibl"\npath = "{hdr_path}"\nlongitude-offset = 6.0'


_SCENE = """
[renderer]
samples = SAMPLES
depth = 5
depth-limit = 64
no-direct-emitter = false
threads = 0
integrator = "INTEGRATOR"

[film]
resolution = [WIDTH, HEIGHT]
output = "png"
gamma = 2.2

[sky]
SKY

[camera]
type = "ideal-pinhole"
fov = 45
[[camera.transform]]
type = "look-at"
origin = ORIGIN
target = TARGET
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


# A camera that frames the terrain: ~77% of its rays hit it (the test
# scene's default camera at [0, 8, 30] sees only the two spheres). The
# look-at applies the reference's transposed basis (scene/transform.py), which
# mirrors the view direction's height about the eye: this camera looks down
# at [0, 0, -1], whose mirror image about the eye's height is the target.
TERRAIN_VIEW = dict(origin=(0, 14, 12), target=(0, 28, -1))


def terrain_scene_toml(integrator: str = "pt-direct", sky: str = UNIFORM_SKY,
                       resolution: tuple[int, int] = (32, 32), samples: int = 4,
                       origin=(0, 8, 30), target=(0, 0, 0)) -> str:
    """The scene's TOML at `resolution` (width, height), `samples` per pixel
    and a look-at camera from `origin` to `target`; its mesh is
    `terrain.obj` beside it (write it with `write_obj(dir / "terrain.obj",
    *make_terrain(n_tris)[:3])`: 9000 for the JAX package's test scene,
    1_000_000 and 1_500_000, with TERRAIN_VIEW's camera, for the huge-mesh
    scenes terrain-1m and terrain-1.5m, whose 128-wide leaves take the
    packet walks)."""
    w, h = resolution
    vec = lambda v: "[" + ", ".join(str(x) for x in v) + "]"
    return (_SCENE.replace("INTEGRATOR", integrator).replace("SKY", sky)
            .replace("WIDTH", str(w)).replace("HEIGHT", str(h))
            .replace("SAMPLES", str(samples)).replace("ORIGIN", vec(origin))
            .replace("TARGET", vec(target)))
