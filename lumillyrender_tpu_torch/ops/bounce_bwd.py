"""The closed-form backward pass of one bounce, in plain PyTorch.

`plain_bounce_bwd` is the plain version of the CUDA kernel
csrc/bounce_bwd.cu, and both are the counterpart of the JAX package's
`ops/pallas_bounce.py::_bounce_bwd_kernel`: the VJP of one brute-force
bounce on a Lambert-only scene under a uniform sky
(`cuda_bounce.diff_supported`). From the cotangents of the bounce's outputs
(o', d', throughput', accum') it gives those of its inputs (o, d,
throughput; accum's passes through unchanged, since accum is add-only), the
per-row albedo and emission gradients of the evaluation material table and
the sky colour's gradient. Term by term:

* the primal is recomputed as `plain_bounce_step` computes it, so the
  recomputed alive' is the step's;
* Russian roulette divides by a detached probability: no albedo gradient
  flows through it;
* the throughput weight is exactly w = albedo * checker: cos/pdf cancels,
  grazing lanes included (autodiff of the step evaluates the two cancelling
  terms numerically instead);
* the NEE geometry term g = cos_p * cos_l / |path|^2 and its chain to the
  position, with the normal chain of a sphere that the shadow ray hits;
* emission (the evaluation row's) and the sky on a miss;
* for a sphere winner, the chain from d' through the sampling ONB to the
  normal and from the normal to the position;
* pos = o + d t with t by the plane equation at the winner's normal, plus,
  for a sphere winner, the radial dt/dd term of its formula as written.

The lanes that gather light, and the per-row sums, are formed with masks
and `torch.where`, never by multiplying by a mask: a lane outside a mask may
hold inf or NaN in an intermediate. Divisions by pi are by a 0-d tensor on
the lanes' device (PyTorch on CUDA multiplies by the reciprocal of a host
scalar; the kernel divides).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import EPS, INF, PI
from ..scene.data import MAT_LAMBERT, MaterialTable, RenderSettings, SceneData
from . import bsdf, rng, vec
from .intersect import intersect_shade_brute


class BounceGrads(NamedTuple):
    """The backward pass of one bounce."""

    o: torch.Tensor  # (N, 3) cotangent of the bounce's input o
    d: torch.Tensor  # (N, 3) of its input d
    throughput: torch.Tensor  # (N, 3) of its input throughput
    albedo: torch.Tensor  # (nm, 3) of the evaluation table's colours
    emission: torch.Tensor  # (nm, 3) of its emissions
    sky: torch.Tensor  # (3,) of the uniform sky colour
    alive: torch.Tensor  # (N,) bool: the recomputed primal's alive'


def _norm_vjp(n, g, length):
    """VJP of n = u / max(|u|, 1e-20) at |u| = `length`."""
    inv = 1.0 / torch.clamp(length, min=1e-20)
    return (g - n * vec.dot(n, g)[..., None]) * inv[..., None]


def _where(mask, a, b=None):
    """a on the `mask` lanes, else b (0 by default); mask is (N,)."""
    if b is None:
        b = torch.zeros_like(a)
    return torch.where(mask[..., None] if a.dim() > mask.dim() else mask, a, b)


def _row_sums(rows, vals, nm: int):
    """(nm, 3): for each material row, the sum of `vals` (N, 3) over the
    lanes whose row is it. A loop over rows, so it is deterministic on
    every device."""
    return torch.stack([_where(rows == r, vals).sum(dim=0) for r in range(nm)])


def plain_bounce_bwd(scene: SceneData, settings: RenderSettings, seed, state,
                     g_o, g_d, g_t, g_a,
                     mats_eval: MaterialTable | None = None) -> BounceGrads:
    """The backward pass of `plain_bounce_step(scene, settings, seed, state,
    mats_eval)` for cotangents g_o, g_d, g_t, g_a ((N,3) each) of its o, d,
    throughput and accum. `scene.materials` is the sampling table and
    `mats_eval` (default: the same) the evaluation table; the scene must be
    Lambert-only, brute-force and under a uniform sky."""
    from ..integrator.wavefront import (
        _NEE, _SCATTER, _SLOTS, _only, _russian_roulette, emit_flag,
    )

    geom = scene.geometry
    nt, ns = geom.tri_p0.shape[0], geom.sph_c.shape[0]
    mats_e = scene.materials if mats_eval is None else mats_eval
    nm = mats_e.color.shape[0]
    bounce = state.bounce
    o, d, T0 = state.o, state.d, state.throughput
    alive0 = state.alive
    dev = o.device
    pi = torch.full((), PI, dtype=o.dtype, device=dev)
    lam = (MAT_LAMBERT,)
    ctr = bounce * _SLOTS

    # ---- primal recompute (plain_bounce_step's operations) ----
    hit, sp = intersect_shade_brute(o, d, geom,
                                    t_cap=_only(alive0, torch.full_like(o[:, 0], INF)))
    hitm = sp.hit
    missed = alive0 & ~hitm
    pos, n = sp.position, sp.normal
    is_sph = hitm & (hit.prim >= nt)
    center = (geom.sph_c[torch.clamp(hit.prim.long() - nt, 0, ns - 1)] if ns
              else torch.zeros_like(o))
    m_s = bsdf.gather(scene.materials, sp.mat)
    m_e = bsdf.gather(mats_e, sp.mat)
    out = -d
    u_rr, r1, r2, r3 = rng.uniform4(seed, state.lane, ctr + _SCATTER)
    prob = _russian_roulette(bsdf.rr_weight(m_s), bounce, settings)
    alive2 = hitm & ((prob == 1.0) | (u_rr < prob))
    pc = torch.clamp(prob, min=1e-12)
    T1 = T0 / pc[..., None]
    s = bsdf.sample(m_s, out, n, r1, r2, r3, present=lam)
    f = bsdf.eval_brdf(m_e, out, s.direction, n, pos, present=lam)
    safe_pdf = torch.where(s.pdf != 0.0, s.pdf, torch.ones_like(s.pdf))
    w = f * (vec.dot(s.direction, n) / safe_pdf)[..., None]
    alive3 = alive2 & (w != 0.0).any(dim=-1) & (s.pdf != 0.0)
    ck = bsdf.checker(pos[..., 0], pos[..., 2])
    sigma = torch.where(vec.dot(n, out) < 0.0, -torch.ones_like(ck), torch.ones_like(ck))
    zero3 = torch.zeros_like(o)

    # ---- cotangents ----
    gpos = _where(alive3, g_o)
    go_out = _where(alive3, zero3, g_o)
    gd_out = _where(alive3, zero3, g_d)
    gT0 = _where(alive3, zero3, g_t)
    gT1 = _where(alive3, g_t * (m_e.color * ck[..., None]))
    a_bar = _where(alive3, (g_t * T1) * ck[..., None])
    en_bar = zero3
    gn = zero3
    smat = torch.full_like(sp.mat, -1)

    if settings.integrator == "pt-direct" and settings.has_lights:
        from ..integrator.wavefront import _sample_light_point

        u_pick, u1, u2, _ = rng.uniform4(seed, state.lane, ctr + _NEE)
        lpoint, pdf_l = _sample_light_point(scene, u_pick, u1, u2)
        path = lpoint - pos
        dist = vec.norm(path)
        wi = path / torch.clamp(dist, min=1e-20)[..., None]
        pn = vec.orienting_normal(out, n)
        cos_p = vec.dot(wi, pn)
        ok = alive2 & (cos_p > 0.0) & (vec.sqr_norm(m_s.emission) <= 0.0)
        shadow, ssp = intersect_shade_brute(pos, wi, geom,
                                            t_cap=_only(ok, dist + 2.0 * EPS))
        lcos = vec.dot(-wi, ssp.normal)
        m_nee = ok & ssp.hit & (torch.abs(shadow.t - dist) <= EPS) & (lcos > 0.0)
        smat = torch.where(m_nee, ssp.mat, smat)
        q = vec.dot(path, path)
        qg = torch.clamp(q, min=1e-20)
        g = cos_p * lcos / qg
        f1 = m_e.color * ck[..., None] / pi
        le = bsdf.gather(mats_e, ssp.mat).emission
        gp = g / pdf_l
        gat1 = g_a * T1
        gT1 = gT1 + _where(m_nee, g_a * ((f1 * le) * gp[..., None]))
        a_bar = a_bar + _where(m_nee, (gat1 * le) * (gp * ck / pi)[..., None])
        en_bar = _where(m_nee, (gat1 * f1) * gp[..., None])
        gg = vec.dot(gat1 * f1, le) / pdf_l
        gcos_p = gg * lcos / qg
        glcos = gg * cos_p / qg
        gq = torch.where(q > 1e-20, -gg * cos_p * lcos / (qg * qg), torch.zeros_like(q))
        gpath = path * (2.0 * gq)[..., None]
        gwi = pn * gcos_p[..., None]
        gn = _where(m_nee, wi * (gcos_p * sigma)[..., None])
        gwi = gwi - ssp.normal * glcos[..., None]
        gsn = wi * (-glcos)[..., None]
        if ns:
            s_sph = m_nee & ssp.hit & (shadow.prim >= nt)
            s_c = geom.sph_c[torch.clamp(shadow.prim.long() - nt, 0, ns - 1)]
            gu = _norm_vjp(ssp.normal, gsn, vec.norm(ssp.position - s_c))
            den = vec.dot(ssp.normal, wi)
            big = torch.abs(den) > 1e-12
            inv_den = torch.where(big, 1.0 / torch.where(big, den, torch.ones_like(den)),
                                  torch.zeros_like(den))
            ptgu = gu - ssp.normal * (vec.dot(wi, gu) * inv_den)[..., None]
            gpos = gpos + _where(s_sph, ptgu)
            gwi = gwi + _where(s_sph, ptgu * shadow.t[..., None])
        wdg = vec.dot(wi, gwi)
        inv_d = 1.0 / torch.clamp(dist, min=1e-20)
        gpath = gpath + (gwi - wi * wdg[..., None]) * inv_d[..., None]
        gpos = gpos - _where(m_nee, gpath)

    # Emission (the evaluation row's) and the sky on a miss.
    emit = torch.zeros_like(hitm)
    if emit_flag(settings, bounce):
        emit = hitm & (vec.dot(out, n) > 0.0)
    gT0 = gT0 + _where(emit, g_a * m_e.emission)
    e_bar = _where(emit, g_a * T0)
    sky = scene.sky.color.to(o.dtype)
    gT0 = gT0 + _where(missed, g_a * sky)
    sky_bar = _where(missed, g_a * T0).sum(dim=0)
    gT0 = gT0 + _where(alive2, gT1 / pc[..., None])

    if ns:
        # The sampled direction on the ONB of on = sigma n, for a sphere
        # winner, whose n depends on the position.
        on = vec.orienting_normal(out, n)
        u, v = vec.orthonormal_basis(on)
        phi = 2.0 * PI * r1
        cp, spn = torch.cos(phi), torch.sin(phi)
        r2s = vec.sqrt(r2)
        gl = _where(alive3 & is_sph, g_d)
        gon = gl * vec.sqrt(1.0 - r2)[..., None]
        gu = gl * (cp * r2s)[..., None]
        gv = gl * (spn * r2s)[..., None]
        gon = gon + vec.cross(u, gv)
        gu = gu + vec.cross(gv, on)
        use_y = (torch.abs(on[..., 0]) > EPS)[..., None]
        a = torch.where(use_y, vec.unit(1, on), vec.unit(0, on))
        c = vec.cross(a.expand_as(on), on)
        gon = gon + vec.cross(_norm_vjp(u, gu, vec.norm(c)), a.expand_as(on))
        gn = gn + gon * sigma[..., None]
        # n = normalize(pos - c)
        gpos = gpos + _where(is_sph & alive2, _norm_vjp(n, gn, vec.norm(pos - center)))

    # pos = o + d t, t by the plane equation at the winner's normal.
    t_safe = torch.where(hitm, hit.t, torch.zeros_like(hit.t))
    go_out = go_out + gpos
    gd_out = gd_out + gpos * t_safe[..., None]
    gt = vec.dot(gpos, d)
    dn = vec.dot(d, n)
    safe = hitm & (torch.abs(dn) > 1e-20)
    ginv = torch.where(safe, gt / torch.where(safe, dn, torch.ones_like(dn)),
                       torch.zeros_like(dn))
    go_out = go_out - n * ginv[..., None]
    gd_out = gd_out - n * (ginv * t_safe)[..., None]
    if ns:
        rad = ginv * t_safe * t_safe / torch.clamp(vec.norm(pos - center), min=1e-20)
        gd_out = gd_out + _where(safe & is_sph, d * rad[..., None])

    rows = torch.where(hitm, sp.mat, torch.full_like(sp.mat, -1))
    albedo = _row_sums(rows, a_bar, nm)
    emission = _row_sums(rows, e_bar, nm) + _row_sums(smat, en_bar, nm)
    return BounceGrads(o=go_out, d=gd_out, throughput=gT0, albedo=albedo,
                       emission=emission, sky=sky_bar, alive=alive3)
