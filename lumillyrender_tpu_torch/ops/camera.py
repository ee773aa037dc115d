"""Vectorized camera ray generation (`src/camera.rs`).

All four camera kinds: ideal pinhole, thin lens, omnidirectional and the
realistic pinhole. Returns (origin, direction, pdf, g_term); the estimator
weights radiance by `g * sensitivity / pdf` (`main.rs:95-102`). This is
also the plain version of the raygen kernel (`ops/cuda_bounce.py`).
"""

from __future__ import annotations

import torch

from ..constants import PI
from ..scene.data import (
    CAM_IDEAL_PINHOLE,
    CAM_OMNIDIRECTIONAL,
    CAM_PINHOLE,
    CameraData,
)
from . import vec


def samples_aperture(kind: int) -> bool:
    """Whether camera `kind` samples a sensor point and an aperture point,
    so that its rays carry `aperture_pdf` and a geometry term g: the thin
    lens and the realistic pinhole. The ideal pinhole and the
    omnidirectional camera have g = pdf = 1."""
    return kind not in (CAM_IDEAL_PINHOLE, CAM_OMNIDIRECTIONAL)


def aperture_pdf(cam: CameraData, width: int, height: int) -> torch.Tensor:
    """Constant sampling pdf of the finite-aperture kinds: sensor area per
    pixel times aperture disk (`camera.rs:411-445`). A 0-d tensor."""
    pdf_s = 1.0 / vec.over(cam.sensor_size[0] * cam.sensor_size[1], width * height)
    pdf_a = 1.0 / (PI * cam.aperture_radius**2)
    return pdf_s * pdf_a


def sample_rays(cam: CameraData, kind: int, px, py, width, height, u, v, u2, v2):
    """Generate rays for pixel indices (px, py) with uniforms u,v,u2,v2.

    px/py: int tensors (lane,). u..v2: float32 (lane,) in [0,1).
    Returns (origin (lane,3), dir (lane,3), pdf (lane,), g (lane,)).
    """
    pxf = px.to(torch.float32)
    pyf = py.to(torch.float32)
    one = torch.ones_like(u)
    if kind == CAM_OMNIDIRECTIONAL:
        # Equirect direction; deliberately ignores the camera basis —
        # quirk #13 (`camera.rs:169-188`).
        p = vec.over(pxf + u, width) * (2.0 * PI)
        t = vec.over(pyf + v, height) * PI
        st, ct = torch.sin(t), torch.cos(t)
        d = torch.stack([st * torch.cos(p), st * torch.sin(p), ct], dim=-1)
        o = cam.aperture_position.expand_as(d)
        return o, d, one, one

    # Shared sensor sampling (`camera.rs:64-81,411-428`): note the MINUS on
    # the right axis (sensor is mirrored through the aperture).
    sx = (vec.over(pxf + u, width) - 0.5) * cam.sensor_size[0]
    sy = (vec.over(pyf + v, height) - 0.5) * cam.sensor_size[1]
    sensor_point = (
        cam.position - cam.right * sx[..., None] + cam.up * sy[..., None]
    )

    if kind == CAM_IDEAL_PINHOLE:
        o = cam.aperture_position.expand_as(sensor_point)
        d = vec.normalize(o - sensor_point)
        return o, d, one, one  # pdf=1, g=1 (`camera.rs:100-119`)

    # Shared finite-aperture sampling (`camera.rs:285-300,430-445`).
    theta = 2.0 * PI * u2
    rad = vec.sqrt(v2) * cam.aperture_radius
    aperture_point = (
        cam.aperture_position
        + cam.right * (torch.cos(theta) * rad)[..., None]
        + cam.up * (torch.sin(theta) * rad)[..., None]
    )
    d0 = vec.normalize(aperture_point - sensor_point)
    cos = vec.dot(d0, cam.forward)
    dist = cam.aperture_sensor_distance / cos
    g = cos * cos / (dist * dist)
    pdf = aperture_pdf(cam, width, height).expand_as(u)

    if kind == CAM_PINHOLE:
        # Realistic pinhole (`camera.rs:312-328`): ray straight through the
        # sampled aperture point, no focus-plane projection.
        return aperture_point, d0, pdf, g

    # thin lens (`camera.rs:458-476`): project the sensor->aperture-center
    # ray onto the focus plane and aim the ray there.
    sensor_center = cam.aperture_position - sensor_point
    object_plane = sensor_center * (
        cam.focus_distance / vec.dot(sensor_center, cam.forward)
    )[..., None]
    d = vec.normalize(cam.aperture_position + object_plane - aperture_point)
    return aperture_point, d, pdf, g
