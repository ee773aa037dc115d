"""Device-side scene representation: SoA tensors + static render settings.

The same tables as the JAX package's `scene/data.py` (one field per array,
the same `(N, 3)` layouts), held as torch tensors (float32 / int32).
Every container has `.to(device)`, which moves all of its tensors.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

# Material type ids (order matches reference material modules).
MAT_LAMBERT = 0
MAT_PHONG = 1
MAT_BLINN_PHONG = 2
MAT_GGX = 3
MAT_REFRACTION = 4

SKY_UNIFORM = 0
SKY_IBL = 1
SKY_SIMPLE = 2  # reference dead code (sky.rs:23-33), reachable here

CAM_IDEAL_PINHOLE = 0
CAM_THIN_LENS = 1
CAM_OMNIDIRECTIONAL = 2
# 'Realistic pinhole' (camera.rs:199-337): implemented but unreachable from
# TOML in the reference (description.rs:50-54); reachable here as `pinhole`.
CAM_PINHOLE = 3


class _Tensors:
    """`.to(device)` for a dataclass whose fields are tensors or _Tensors.
    Like `Tensor.to`, it returns `self` when nothing has to move."""

    def to(self, device):
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in dataclasses.fields(self)}
        if all(v is getattr(self, k) for k, v in moved.items()):
            return self
        return dataclasses.replace(self, **moved)


@dataclass
class MaterialTable(_Tensors):
    """One row per material; `type_id` selects the BSDF branch."""

    type_id: torch.Tensor  # (M,) int32
    color: torch.Tensor  # (M, 3) albedo (lambert) or reflectance (others)
    emission: torch.Tensor  # (M, 3) nonzero only for lambert (quirk #2)
    alpha: torch.Tensor  # (M,) phong/blinn exponent or ggx roughness
    ior: torch.Tensor  # (M,)
    absorbtance: torch.Tensor  # (M,)


@dataclass
class Geometry(_Tensors):
    """Triangle + sphere SoA. Prim ids: [0, T) triangles, [T, T+S) spheres."""

    tri_p0: torch.Tensor  # (T, 3)
    tri_e1: torch.Tensor  # (T, 3)  p1 - p0
    tri_e2: torch.Tensor  # (T, 3)  p2 - p0
    tri_n: torch.Tensor  # (T, 3) unit face normal (p1-p0) x (p2-p0)
    tri_mat: torch.Tensor  # (T,) int32
    sph_c: torch.Tensor  # (S, 3)
    sph_r: torch.Tensor  # (S,)
    sph_mat: torch.Tensor  # (S,) int32


@dataclass
class LightTable(_Tensors):
    """Area-emissive primitives for NEE (`objects.rs:18-51`), with
    light-local copies of the emitter geometry."""

    prim: torch.Tensor  # (L,) int32 prim ids
    area: torch.Tensor  # (L,)
    cdf: torch.Tensor  # (L,) inclusive prefix sum of areas
    total_area: torch.Tensor  # () sum of areas
    is_tri: torch.Tensor  # (L,) int32 1 = triangle, 0 = sphere
    p0: torch.Tensor  # (L, 3) triangle vertex (zeros for spheres)
    e1: torch.Tensor  # (L, 3)
    e2: torch.Tensor  # (L, 3)
    c: torch.Tensor  # (L, 3) sphere center (zeros for triangles)
    r: torch.Tensor  # (L,) sphere radius


@dataclass
class Bvh(_Tensors):
    """Flattened threaded (stackless) treelet BVH over triangles, DFS order
    (`accel/sah.py`, `accel/pack.py`); walked by `ops/intersect.py::
    _walk_tris` and the BVH kernels."""

    node_min: torch.Tensor  # (N, 3)
    node_max: torch.Tensor  # (N, 3)
    node_miss: torch.Tensor  # (N,) int32
    node_leaf: torch.Tensor  # (N,) int32 block id, or -1 for inner nodes
    blk_p0: torch.Tensor  # (L, K, 3)
    blk_e1: torch.Tensor  # (L, K, 3)
    blk_e2: torch.Tensor  # (L, K, 3)
    blk_n: torch.Tensor  # (L, K, 3) precomputed unit face normals
    blk_prim: torch.Tensor  # (L, K) int32 original tri prim id, -1 padding
    blk_mat: torch.Tensor  # (L, K) int32 material row, -1 padding


@dataclass
class SkyData(_Tensors):
    color: torch.Tensor  # (3,) uniform emission / simple-sky meridian
    color2: torch.Tensor  # (3,) simple-sky horizon (zeros otherwise)
    ibl: torch.Tensor  # (H, 2H, 3) equirect texture ((1,2,3) dummy when uniform)
    longitude_offset: torch.Tensor  # () radians


@dataclass
class CameraData(_Tensors):
    """Precomputed camera frame (`camera.rs:33-62,365-409`)."""

    position: torch.Tensor  # (3,) sensor center
    aperture_position: torch.Tensor  # (3,)
    forward: torch.Tensor  # (3,)
    right: torch.Tensor  # (3,)
    up: torch.Tensor  # (3,)
    sensor_size: torch.Tensor  # (2,)
    aperture_radius: torch.Tensor  # ()
    focus_distance: torch.Tensor  # ()
    aperture_sensor_distance: torch.Tensor  # ()
    sensor_sensitivity: torch.Tensor  # ()


@dataclass
class SceneData(_Tensors):
    """Everything the render kernels need."""

    geometry: Geometry
    materials: MaterialTable
    lights: LightTable
    bvh: Bvh
    sky: SkyData
    camera: CameraData


@dataclass(frozen=True)
class RenderSettings:
    """Static (hashable) render configuration."""

    width: int
    height: int
    spp: int
    depth: int = 5
    depth_limit: int = 64
    no_direct_emitter: bool = False
    integrator: str = "pt-direct"
    camera_kind: int = CAM_IDEAL_PINHOLE
    sky_kind: int = SKY_UNIFORM
    has_lights: bool = False
    # Hard cap on the bounce loop: RR decays contribution by
    # 0.5^(d - depth_limit) past depth_limit (`scene.rs:64-76`).
    max_bounces: int = 80
    # "auto" picks brute force for small scenes, the BVH otherwise; "brute"
    # and "bvh" force one (the BVH's walk: a kernel on the card, the plain
    # walk on the CPU); "pallas" forces the BVH through a walk kernel and
    # raises on the CPU and for leaves no walk kernel serves (K not
    # dividing 128).
    intersector: str = "auto"
    # "pop-rr" = staged compaction with population-control Russian roulette
    # on capacity overflow (unbiased); "off" = plain masked loop.
    compaction: str = "pop-rr"
    # Material type ids present in the scene's table: the BSDF code prunes
    # absent families (ops/bsdf.py). None = assume all five.
    mat_types: tuple | None = None
    # The bounce kernels or the plain step (ops/cuda_bounce.py::step_mode):
    # "auto" takes the kernels on the card; "off" the plain step, forward
    # and differentiable, on any device (on the card its BVH walk is a
    # kernel, and a forward chunk runs in the host loop); "on" the kernels
    # wherever they serve the scene, and raises on the CPU.
    fused: str = "auto"
    # Recompute policy of the differentiable bounce loop
    # (integrator/wavefront.py::_run_fixed) for steps without a backward
    # of their own (autograd of the plain step: `fused="off"`, and on the
    # CPU the BVH, IBL and simple-sky scenes): "full" checkpoints every
    # bounce (only its input state is kept, the bounce is recomputed in the
    # backward pass), "none" keeps every bounce's intermediates, "hybrid"
    # keeps them on stages of at most 48k lanes and checkpoints wider ones,
    # "isect" checkpoints every bounce keeping both queries' search results
    # (the recompute walks nothing), "isect+samp" also the BSDF and light
    # samples (the recompute samples nothing). The kernels' steps keep only
    # their input state under every policy.
    bwd_remat: str = "full"


_SCENE_TYPES = {
    "geometry": Geometry, "materials": MaterialTable, "lights": LightTable,
    "bvh": Bvh, "sky": SkyData, "camera": CameraData,
}


def tensor_of(x) -> torch.Tensor:
    """numpy (or scalar) -> CPU tensor: floats as float32, ints as int32."""
    x = np.asarray(x)
    if x.dtype.kind == "f":
        x = x.astype(np.float32)
    elif x.dtype.kind in "iu":
        x = x.astype(np.int32)
    return torch.from_numpy(np.array(x))  # a contiguous copy, 0-d kept


def scene_from_tree(tree: dict) -> SceneData:
    """{'geometry': {'tri_p0': array, ...}, ...} -> SceneData of CPU
    tensors. Keys missing from the port's dataclasses (TPU-only tables)
    are ignored."""
    parts = {}
    for name, cls in _SCENE_TYPES.items():
        leaves = tree[name]
        parts[name] = cls(**{
            f.name: tensor_of(leaves[f.name]) for f in dataclasses.fields(cls)
        })
    return SceneData(**parts)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller asks for
    something else. Asking for nothing with no card present raises; the
    port never quietly runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return dev
