"""Sky / environment light evaluation (`src/sky.rs`): uniform, IBL and the
reference's unreachable `SimpleSky`."""

from __future__ import annotations

import torch

from ..constants import PI
from ..scene.data import SKY_IBL, SKY_SIMPLE, SkyData
from . import vec
from .table import take_rows


def radiance(sky: SkyData, kind: int, d) -> torch.Tensor:
    """Environment radiance for ray directions d (N,3) -> (N,3)."""
    if kind == SKY_SIMPLE:
        return simple_radiance(sky.color, sky.color2, d)
    if kind != SKY_IBL:
        return sky.color.expand_as(d)
    return take_rows(sky.ibl.reshape(-1, 3), ibl_texel(sky, d))


def ibl_texel(sky: SkyData, d) -> torch.Tensor:
    """(N,) int64 flat texel index of the IBL lookup for directions d (N,3).

    Equirect lookup (`sky.rs:57-79`): y-up, u offset by longitude_offset in
    RADIANS (quirk #14), nearest-neighbor texel, width == 2*height.

    Both divisions are IEEE on every device (`vec.over`): an ulp moves a
    lane across a texel edge."""
    h = sky.ibl.shape[0]
    w = sky.ibl.shape[1]
    theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
    phi = torch.arctan2(d[..., 2], d[..., 0])
    u = torch.remainder(vec.over(phi + PI + sky.longitude_offset, 2.0 * PI), 1.0)
    v = torch.remainder(vec.over(theta, PI), 1.0)
    x = torch.floor(w * u).to(torch.int64)
    y = torch.floor(h * v).to(torch.int64)
    # Reference wraps `index % all` over the flattened image (`sky.rs:73-74`).
    return torch.remainder(y * w + x, w * h)


def simple_radiance(meridian, horizon, d) -> torch.Tensor:
    """`SimpleSky` lerp by |dir . up| (`sky.rs:28-33`)."""
    weight = torch.abs(d[..., 1])[..., None]
    return meridian * weight + horizon * (1.0 - weight)
