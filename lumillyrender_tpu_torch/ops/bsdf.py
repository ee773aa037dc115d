"""Vectorized BSDF table (`src/material/`): all five families evaluated on
the whole wavefront and selected per lane by material type id.

Every branch is computed masked, with the JAX package's guards so masked
branches stay NaN-free. `present` (a tuple of type ids in the scene's
table, None = all five) prunes absent families.

Quirks from the reference: #1 checker-in-Lambert, #15 Blinn-Phong
half-vector pdf without Jacobian, #16 refraction radiance compression +
Beer-Lambert coef.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import PI
from ..scene.data import (
    MAT_BLINN_PHONG,
    MAT_GGX,
    MAT_LAMBERT,
    MAT_PHONG,
    MAT_REFRACTION,
    MaterialTable,
)
from . import vec
from .table import take_rows


class GatheredMaterial(NamedTuple):
    """Per-lane material parameters (rows gathered once per bounce)."""

    type_id: torch.Tensor  # (N,) int32
    color: torch.Tensor  # (N, 3)
    emission: torch.Tensor  # (N, 3)
    alpha: torch.Tensor  # (N,)
    ior: torch.Tensor  # (N,)
    absorbtance: torch.Tensor  # (N,)


def gather(table: MaterialTable, mat_id) -> GatheredMaterial:
    i = torch.clamp(mat_id, min=0)
    return GatheredMaterial(
        type_id=take_rows(table.type_id, i),
        color=take_rows(table.color, i),
        emission=take_rows(table.emission, i),
        alpha=take_rows(table.alpha, i),
        ior=take_rows(table.ior, i),
        absorbtance=take_rows(table.absorbtance, i),
    )


def _where(m, a, b):
    """torch.where that accepts Python floats on either side, as float32
    scalars of the op (no tensor made from host data)."""
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        return torch.where(m, torch.full_like(m, a, dtype=torch.float32), b)
    return torch.where(m, a, b)


# ---------------------------------------------------------------------------
# Lambert checker texture (quirk #1, `lambert.rs:58-90`)
# ---------------------------------------------------------------------------


def _signed_mod(b, m):
    """Rust `signed_mod` (`lambert.rs:58-64`): base>0 -> base % m, else
    m - (-base) % m. Each selected operand is non-negative, where the
    floored and the truncated remainder agree, so `fmod` is exact."""
    return torch.where(b > 0.0, torch.fmod(b, m), m - torch.fmod(-b, m))


def checker(u, v):
    """Hard-coded procedural checker multiplying every Lambert BRDF
    (`lambert.rs:32-35,66-90`). Args are world x / z."""
    lw, li = 2.0, 150.0
    sw, si = 1.0, 30.0
    cw, ci = 150.0, 300.0
    lu, lv = _signed_mod(u, li), _signed_mod(v, li)
    su, sv = _signed_mod(u, si), _signed_mod(v, si)
    cu, cv = _signed_mod(u, ci), _signed_mod(v, ci)
    big_line = (lu < lw) | (lv < lw)
    small_line = (su < sw) | (sv < sw)
    cell = ((cu < cw) | (cv < cw)) & ~((cu < cw) & (cv < cw))
    out = _where(cell, 0.8, 1.0)
    out = _where(small_line, 0.6, out)
    out = _where(big_line, 0.5, out)
    return out


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------


def _pow_clamped(base, e):
    """cos^alpha with negative bases clamped to 0 (the reference's `powf`
    NaN-poisons them; sampled lobes always have cos >= 0)."""
    return _where(base > 0.0, torch.pow(torch.clamp(base, min=1e-30), e), 0.0)


def _sq(x):
    return x * x


def _pow5(x):
    """x**5 as x * (x^2)^2, the JAX package's integer power."""
    x2 = x * x
    return x * (x2 * x2)


def _ggx_alpha(rough):
    return rough * rough


# The floor of x in the gradient of 1 / x (`_ggx_g1`'s x = cos^2,
# `_inv_idn`'s |in . n|): the derivative, -1 / x^2, is finite in float32
# down to x ~ 5.4e-20.
_RECIP_GRAD_FLOOR = 1e-19


def _ggx_g1(v, n, a2):
    """The reference's G1, 1 / max(cos^2, 1e-20) its tan^2 + 1. Its gradient
    takes 1 / max(cos^2, _RECIP_GRAD_FLOOR): between 1e-20 and ~5.4e-20 the
    reference's derivative overflows, and a zero cotangent times it is NaN
    (a direction within ~2.3e-10 of the surface's plane, on any lane that
    evaluates the GGX branch); below the floor G1's gradient is 0, as the
    clamped value is constant there. The value is the reference's, bit for
    bit."""
    cos = vec.dot(v, n)
    cos2 = cos * cos
    inv = 1.0 / torch.clamp(cos2, min=1e-20)
    inv_grad = 1.0 / torch.clamp(cos2, min=_RECIP_GRAD_FLOOR)
    tan2 = inv.detach() + (inv_grad - inv_grad.detach()) - 1.0
    return 2.0 / (1.0 + vec.sqrt(1.0 + a2 * a2 * tan2 * tan2))


def _inv_idn(i_dot_n):
    """The reference's 1 / (in . n) of the ideal refraction, 1 where in . n
    is 0. Its gradient takes 1 / (in . n) with |in . n| floored at
    _RECIP_GRAD_FLOOR: below ~5.4e-20 the reference's derivative overflows,
    and a zero cotangent times it is NaN (a direction within ~5e-20 of the
    surface's plane, on any lane that evaluates the refraction branch);
    below the floor the gradient is 0. The value is the reference's, bit
    for bit."""
    safe = _where(i_dot_n != 0.0, i_dot_n, 1.0)
    inv = 1.0 / safe
    inv_grad = 1.0 / torch.copysign(torch.clamp(torch.abs(safe), min=_RECIP_GRAD_FLOOR), safe)
    return inv.detach() + (inv_grad - inv_grad.detach())


def _ggx_ndf(m, n, a2):
    mdn = vec.dot(m, n)
    x = (a2 * a2 - 1.0) * mdn * mdn + 1.0
    # x == 0 only when a2 == 0 and m == n (lambert-typed lanes running the
    # masked GGX branch): guard the 0/0 so dead branches stay NaN-free.
    x = _where(x != 0.0, x, 1.0)
    return a2 * a2 / (PI * x * x)


def _schlick_f0(ior):
    nnn = 1.0 - ior
    nnp = 1.0 + ior
    return (nnn * nnn) / (nnp * nnp)


def _fresnel_exact(n1, n2, out_, in_, on):
    """Exact (s+p)/2 Fresnel (`ideal_refraction.rs:138-150`)."""
    cos1 = vec.dot(out_, on)
    cos2 = vec.dot(in_, -on)
    rs = _sq((n1 * cos1 - n2 * cos2) / (n1 * cos1 + n2 * cos2))
    rp = _sq((n1 * cos2 - n2 * cos1) / (n1 * cos2 + n2 * cos1))
    return (rs + rp) / 2.0


def _ior_pair(out_, n, ior):
    """(from_ior, to_ior) by side (`ideal_refraction.rs:117-136`)."""
    entering = vec.dot(out_, n) > 0.0
    return _where(entering, 1.0, ior), _where(entering, ior, 1.0)


# ---------------------------------------------------------------------------
# emission / RR weight / coef
# ---------------------------------------------------------------------------


def rr_weight(m: GatheredMaterial):
    """Max color channel (`material/*.rs weight()`)."""
    return torch.amax(m.color, dim=-1)


_ALL_TYPES = (MAT_LAMBERT, MAT_PHONG, MAT_BLINN_PHONG, MAT_GGX,
              MAT_REFRACTION)


def coef(m: GatheredMaterial, out_, n, distance, present=None):
    """Beer-Lambert absorption when exiting a refractive medium
    (`ideal_refraction.rs:106-113`); 1 otherwise."""
    if present is not None and MAT_REFRACTION not in present:
        return torch.ones_like(out_)
    exiting = vec.dot(out_, n) < 0.0
    absorb = torch.exp(-(1.0 - m.color) * (m.absorbtance * distance)[..., None])
    use = exiting & (m.type_id == MAT_REFRACTION)
    return _where(use[..., None], absorb, 1.0)


# ---------------------------------------------------------------------------
# BRDF evaluation
# ---------------------------------------------------------------------------


def eval_brdf(m: GatheredMaterial, out_, in_, n, pos, present=None):
    """f(out, in) per lane -> (N,3). `n` is the raw geometric normal; each
    family computes its own orienting normal."""
    present = _ALL_TYPES if present is None else tuple(present)
    on = vec.orienting_normal(out_, n)
    i_dot_on = vec.dot(in_, on)
    front = (i_dot_on > 0.0)[..., None]
    t = m.type_id[..., None]
    out = torch.zeros_like(out_)
    need_h = MAT_BLINN_PHONG in present or MAT_GGX in present
    h = vec.safe_normalize(in_ + out_) if need_h else None

    if MAT_LAMBERT in present:
        # Lambert: albedo * checker(x, z) / pi (`lambert.rs:32-35`).
        f_lambert = vec.over(m.color * checker(pos[..., 0], pos[..., 2])[..., None], PI)
        out = torch.where(t == MAT_LAMBERT, f_lambert, out)

    if MAT_PHONG in present:
        # Phong: rho (a+2)/(2pi) (r.in)^a (`phong.rs:37-45`).
        r = vec.reflect(out_, on)
        cos_ph = vec.dot(r, in_)
        f_phong = m.color * (
            vec.over(m.alpha + 2.0, 2.0 * PI) * _pow_clamped(cos_ph, m.alpha)
        )[..., None]
        f_phong = _where(front, f_phong, 0.0)
        out = torch.where(t == MAT_PHONG, f_phong, out)

    if MAT_BLINN_PHONG in present:
        # Blinn-Phong (`blinn_phong.rs:37-47`).
        cos_bl = vec.dot(h, on)
        a = m.alpha
        f_blinn = m.color * (
            (a + 2.0) * (a + 4.0)
            / (8.0 * PI * (torch.exp2(-a / 2.0) + a))
            * _pow_clamped(cos_bl, a)
        )[..., None]
        f_blinn = _where(front, f_blinn, 0.0)
        out = torch.where(t == MAT_BLINN_PHONG, f_blinn, out)

    if MAT_GGX in present:
        # GGX Torrance-Sparrow (`ggx.rs:71-85`).
        a2 = _ggx_alpha(m.alpha)
        fr_s = _schlick_f0(m.ior) + (1.0 - _schlick_f0(m.ior)) * _pow5(
            1.0 - vec.dot(in_, h)
        )
        g = _ggx_g1(in_, on, a2) * _ggx_g1(out_, on, a2)
        d_ndf = _ggx_ndf(h, on, a2)
        denom = 4.0 * i_dot_on * vec.dot(out_, on)
        f_ggx = m.color * (
            fr_s * g * d_ndf / _where(denom != 0.0, denom, 1.0)
        )[..., None]
        f_ggx = _where(front, f_ggx, 0.0)
        out = torch.where(t == MAT_GGX, f_ggx, out)

    if MAT_REFRACTION in present:
        # Ideal refraction: delta weights / (in . n) with radiance
        # compression on transmission (`ideal_refraction.rs:39-66`).
        from_ior, to_ior = _ior_pair(out_, n, m.ior)
        eta = from_ior / to_ior
        refr, valid = vec.refract(out_, on, eta)
        fr = _fresnel_exact(from_ior, to_ior, out_, refr, on)
        inv_idn = _inv_idn(vec.dot(in_, n))
        ft = (1.0 - fr) * _sq(to_ior / from_ior)
        w_refl = torch.where(i_dot_on > 0.0, fr, ft)
        f_refr = (
            m.color * _where(valid, w_refl, 1.0)[..., None]
            * inv_idn[..., None]
        )
        out = torch.where(t == MAT_REFRACTION, f_refr, out)
    return out


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


class BsdfSample(NamedTuple):
    direction: torch.Tensor  # (N, 3)
    pdf: torch.Tensor  # (N,)


def sample(m: GatheredMaterial, out_, n, r1u, r2u, r3u,
           present=None) -> BsdfSample:
    """Importance-sample the per-lane BSDF (`material/*.rs sample()`).

    r1u/r2u: lobe uniforms; r3u: refraction reflect/transmit roulette."""
    present = _ALL_TYPES if present is None else tuple(present)
    on = vec.orienting_normal(out_, n)
    t = m.type_id
    t3 = t[..., None]
    d = torch.zeros_like(out_)
    pdf = torch.zeros_like(r1u)

    need_basis = any(
        k in present for k in (MAT_LAMBERT, MAT_BLINN_PHONG, MAT_GGX)
    )
    if need_basis:
        u, v = vec.orthonormal_basis(on)
    if present != (MAT_REFRACTION,):
        phi = 2.0 * PI * r1u
        cp, sp = torch.cos(phi), torch.sin(phi)

    if MAT_LAMBERT in present:
        # Lambert: cosine hemisphere (`util.rs:87-96`, `lambert.rs:37-55`).
        r2s = vec.sqrt(r2u)
        d_lam = (
            u * (cp * r2s)[..., None]
            + v * (sp * r2s)[..., None]
            + on * vec.sqrt(1.0 - r2u)[..., None]
        )
        pdf_lam = vec.over(vec.dot(d_lam, n), PI)  # geometric n (`lambert.rs:47-50`)
        d = torch.where(t3 == MAT_LAMBERT, d_lam, d)
        pdf = torch.where(t == MAT_LAMBERT, pdf_lam, pdf)

    if MAT_PHONG in present:
        # Phong: lobe around the mirror direction (`phong.rs:47-68`).
        a = m.alpha
        r = vec.reflect(out_, on)
        ur, vr = vec.orthonormal_basis(r)
        t_ph = torch.pow(r2u, 1.0 / (a + 2.0))
        ts_ph = vec.sqrt(torch.clamp(1.0 - t_ph * t_ph, min=0.0))
        d_ph = (
            ur * (cp * ts_ph)[..., None]
            + vr * (sp * ts_ph)[..., None]
            + r * t_ph[..., None]
        )
        cos_ph = vec.dot(r, d_ph)
        pdf_ph = vec.over(a + 2.0, 2.0 * PI) * _pow_clamped(cos_ph, a)
        d = torch.where(t3 == MAT_PHONG, d_ph, d)
        pdf = torch.where(t == MAT_PHONG, pdf_ph, pdf)

    if MAT_BLINN_PHONG in present:
        # Blinn-Phong: half-vector around the normal, then reflect; pdf in
        # half-vector measure (quirk #15, `blinn_phong.rs:49-72`).
        a = m.alpha
        t_bl = torch.pow(r2u, 1.0 / (a + 2.0))
        ts_bl = vec.sqrt(torch.clamp(1.0 - t_bl * t_bl, min=0.0))
        h_bl = (
            u * (cp * ts_bl)[..., None]
            + v * (sp * ts_bl)[..., None]
            + on * t_bl[..., None]
        )
        d_bl = h_bl * (2.0 * vec.dot(out_, h_bl))[..., None] - out_
        pdf_bl = vec.over(a + 2.0, 2.0 * PI) * _pow_clamped(vec.dot(on, h_bl), a)
        d = torch.where(t3 == MAT_BLINN_PHONG, d_bl, d)
        pdf = torch.where(t == MAT_BLINN_PHONG, pdf_bl, pdf)

    if MAT_GGX in present:
        # GGX: NDF-sampled half vector (`ggx.rs:87-113`).
        a2 = _ggx_alpha(m.alpha)
        tan = a2 * vec.sqrt(r2u / torch.clamp(1.0 - r2u, min=1e-12))
        x = 1.0 + tan * tan
        cos_g = 1.0 / vec.sqrt(x)
        sin_g = tan / vec.sqrt(x)
        h_g = (
            u * (cp * sin_g)[..., None]
            + v * (sp * sin_g)[..., None]
            + on * cos_g[..., None]
        )
        o_h = vec.dot(out_, h_g)
        d_g = h_g * (2.0 * o_h)[..., None] - out_
        pdf_g = (
            _ggx_ndf(h_g, on, a2) * vec.dot(h_g, on)
            / (4.0 * _where(o_h != 0.0, o_h, 1.0))
        )
        d = torch.where(t3 == MAT_GGX, d_g, d)
        pdf = torch.where(t == MAT_GGX, pdf_g, pdf)

    if MAT_REFRACTION in present:
        # Ideal refraction: Fresnel roulette (`ideal_refraction.rs:68-104`).
        from_ior, to_ior = _ior_pair(out_, n, m.ior)
        refr, valid = vec.refract(out_, on, from_ior / to_ior)
        fr = _fresnel_exact(from_ior, to_ior, out_, refr, on)
        refl_dir = vec.reflect(out_, on)
        choose_refl = r3u < fr
        d_rf = torch.where(
            valid[..., None],
            torch.where(choose_refl[..., None], refl_dir, refr),
            refl_dir,
        )
        pdf_rf = _where(valid, torch.where(choose_refl, fr, 1.0 - fr), 1.0)
        d = torch.where(t3 == MAT_REFRACTION, d_rf, d)
        pdf = torch.where(t == MAT_REFRACTION, pdf_rf, pdf)

    return BsdfSample(direction=d, pdf=pdf)
