"""Batched 3-vector helpers for (..., 3) tensors, and the two roundings
the plain step takes the same on every device (`sqrt`, `over`).

Sums are written out left to right (x + y + z), the order the JAX
package's reductions over a size-3 axis take, so both sides round alike.
"""

from __future__ import annotations

import torch

from ..constants import EPS


def sqrt(x):
    """The IEEE square root of `x` on every device. PyTorch's CPU sqrt of
    float32 goes through MKL's vector math, which misses the correctly
    rounded root by an ulp on about 0.5% of inputs, where the card's sqrtf,
    the kernels' and XLA's round correctly: on the CPU the root is taken in
    float64 and rounded once to float32."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def over(x, c: float):
    """x / c for a host number `c`, an IEEE division on every device:
    PyTorch on CUDA multiplies by the float reciprocal of a host scalar
    divisor, so `c` goes as a tensor on x's device (the CPU, the kernels
    and XLA divide)."""
    return x / torch.full((), float(c), dtype=x.dtype, device=x.device)


_units: dict = {}  # (device, dtype, axis) -> the unit vector `unit` made there


def unit(axis: int, like: torch.Tensor) -> torch.Tensor:
    """The unit vector along `axis` (0, 1, 2), a (3,) tensor of `like`'s
    dtype on its device: made by a fill, not copied from the host, once a
    device and dtype (inside a CUDA graph's capture, in the graph and not
    kept: its values exist only in a replay)."""
    key = (like.device, like.dtype, axis)
    u = _units.get(key)
    if u is None:
        u = torch.zeros(3, dtype=like.dtype, device=like.device)
        u.narrow(0, axis, 1).fill_(1.0)
        if not (u.is_cuda and torch.cuda.is_current_stream_capturing()):
            _units[key] = u
    return u


def dot(a, b):
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def cross(a, b):
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def norm(a):
    return sqrt(torch.clamp(dot(a, a), min=0.0))


def norm_at_zero(a):
    """|a|, `norm`'s value bit for bit, with a finite derivative where a .
    a is 0: there the root's derivative is infinite, and a zero cotangent
    times it is NaN; the root takes 1 there, so the gradient is 0."""
    n2 = torch.clamp(dot(a, a), min=0.0)
    zero = n2 == 0.0
    return torch.where(zero, 0.0, sqrt(torch.where(zero, 1.0, n2)))


def sqr_norm(a):
    return dot(a, a)


def normalize(a):
    return a / norm(a)[..., None]


def safe_normalize(a, eps=1e-20):
    """a / max(|a|, eps), the reference's value bit for bit. Where a . a is
    0 (a half vector of opposite directions), the root's derivative is
    infinite and the max's zero cotangent times it is NaN: the root takes
    1 there and the denominator eps, so the gradient is 1 / eps."""
    n2 = torch.clamp(dot(a, a), min=0.0)
    zero = n2 == 0.0
    den = torch.where(zero, eps, torch.clamp(sqrt(torch.where(zero, 1.0, n2)), min=eps))
    return a / den[..., None]


def orthonormal_basis(w):
    """(tangent, binormal) for unit normal(s) `w` (`util.rs:10-22`):
    tangent = normalize(((0,1,0) if |w.x| > EPS else (1,0,0)) x w);
    binormal = w x tangent. The EPS branch is per-lane."""
    use_y = (torch.abs(w[..., 0]) > EPS)[..., None]
    a = torch.where(use_y, unit(1, w), unit(0, w)).expand_as(w)
    tangent = safe_normalize(cross(a, w))
    binormal = cross(w, tangent)
    return tangent, binormal


def reflect(v, n):
    """Mirror of `v` around `n` (`util.rs:30-32`): -v + 2(v.n)n."""
    return -v + n * (2.0 * dot(v, n))[..., None]


def refract(v, n, eta):
    """Snell refraction (`util.rs:34-43`) -> (direction, valid). On total
    internal reflection `valid` is False and the direction is unspecified.
    eta = n_from / n_to; `v` points away from the surface."""
    dn = dot(v, n)
    cos2 = 1.0 - (eta * eta) * (1.0 - dn * dn)
    valid = cos2 > 0.0
    safe = sqrt(torch.where(valid, cos2, torch.ones_like(cos2)))
    r = -v * eta[..., None] - n * (eta * -dn + safe)[..., None]
    return r, valid


def orienting_normal(out_dir, n):
    """Flip `n` to face `out_dir`'s hemisphere."""
    return torch.where((dot(n, out_dir) < 0.0)[..., None], -n, n)
