"""Visibility (silhouette) gradients (``spath_tpu/ops/warp.py``).

Detached sampling differentiates only the smooth part of the estimator:
whether a sampled ray hits an emitter, and whether a shadow ray reaches
its light, are step functions of the scene, so moving a light or a
blocker has a detached gradient of ~0 although the image changes. Two
terms add the missing boundary gradients, each exactly neutral in the
forward pass:

- ``reparam_emitter_factor``, the warped-area change of variables of an
  emitter hit into the emitter triangle's own barycentric frame (Loubet
  et al. 2019, Bangaru et al. 2020): the hit point moves with the
  triangle, and the factor ``C(θ) = [cosθ_prev · |e1×e2| · |cosθ_l| /
  r²] / stop_grad(same)`` is exactly 1 forward and carries the light's
  silhouette gradient backward;
- ``nee_boundary_term``, edge sampling of the NEE shadow boundary
  (Reynolds transport): one mesh edge projected from the shading point
  onto the sampled light's plane, whose term is exactly 0 forward and
  carries the line integral over the shadow boundary backward.

Both follow the JAX functions op by op, with ``torch.where`` guards in
the "double where" form: the inputs of every guarded operation are
replaced on the masked lanes before it runs, so no inf·0 reaches the
backward pass. Square roots are ``ops/fp.py::sqrt_rn`` (correctly
rounded, as the JAX package's) wherever the value feeds a decision: the
edge sample's shadow ray is swept (``ops/intersect.py``: K5 on the card).
The light choice is the port's upper-bound search over the cdf
(``ops/nee.py::sample_light_points``), the one every quality path takes.
"""

from __future__ import annotations

import numpy as np
import torch

from spath_tpu_torch.config import RenderConfig
from spath_tpu_torch.ops.fp import sqrt_rn
from spath_tpu_torch.ops.gather import gather_rows
from spath_tpu_torch.ops.intersect import nearest_hit_edges
from spath_tpu_torch.ops.nee import INV_PI, Lights, bsdf_pdf
from spath_tpu_torch.ops.sampling import cross3, dot3


def _f32(x: float) -> float:
    return float(np.float32(x))


def reparam_emitter_factor(o, d, v0h, e1h, e2h, nh, prev_n, hit):
    """Per-lane warped-area factor of emitter hits: ``(N,)`` float32,
    exactly 1 forward, the silhouette gradient backward.

    ``o`` ``(N, 3)`` are the ray origins (the previous path vertex,
    differentiable), ``d`` the sampled directions (detached), ``v0h``,
    ``e1h``, ``e2h`` and ``nh`` the hit triangle's vertex, edges and
    normal gathered at the hit (differentiable), ``prev_n`` the axis the
    direction was sampled about at the previous vertex or ``None`` at
    bounce 0 (detached here), ``hit`` the lanes whose factor counts.
    Lanes failing the validity guard (grazing cosθ_l, degenerate r) get
    exactly 1 and no gradient."""
    d = d.detach()
    v0s, e1s, e2s = v0h.detach(), e1h.detach(), e2h.detach()
    s = o.detach() - v0s
    h = cross3(d, e2s)
    a = dot3(e1s, h)
    safe_a = torch.where(torch.abs(a) > 0.0, a, 1.0)
    f = 1.0 / safe_a
    q = cross3(s, e1s)
    u = f * dot3(s, h)
    v = f * dot3(d, q)

    # the hit point in the (differentiable) triangle's frame
    y = v0h + u[:, None] * e1h + v[:, None] * e2h
    delta = y - o
    r2 = dot3(delta, delta)

    valid0 = hit & (r2.detach() > _f32(1e-16)) & (
        torch.abs(a) >= _f32(1e-14))
    r2c = torch.where(valid0, r2, 1.0)
    r = sqrt_rn(r2c)
    omega = torch.where(valid0[:, None], delta, d) / r[:, None]

    cr = cross3(e1h, e2h)
    ta2 = dot3(cr, cr)
    two_area = sqrt_rn(torch.where(ta2.detach() > _f32(1e-20), ta2, 1.0))
    nl2 = dot3(nh, nh)
    nlen = sqrt_rn(torch.where(nl2.detach() > _f32(1e-20), nl2, 1.0))
    cos_l = torch.abs(dot3(nh, omega)) / nlen
    if prev_n is None:
        cos_p = torch.ones_like(cos_l)
    else:
        cos_p = dot3(omega, prev_n.detach())

    num = cos_p * two_area * cos_l / r2c
    den = num.detach()
    valid = valid0 & (den > _f32(1e-12)) & torch.isfinite(den)
    safe_num = torch.where(valid, num, 1.0)
    safe_den = torch.where(valid, den, 1.0)
    return safe_num / safe_den


def _pick(k3, first, second, third):
    return torch.where(k3 == 0, first, torch.where(k3 == 1, second, third))


def nee_boundary_term(verts, lights: Lights, p, n_s, hit_albedo, hit_idx,
                      u_sel, u_edge, u_s, cfg: RenderConfig, hit,
                      table=None):
    """Edge-sampled shadow-boundary gradient of the NEE direct term:
    ``(N, 3)``, exactly 0 forward; add ``throughput * term`` to the
    radiance.

    ``verts`` is ``(v0, v1, v2)``, each ``(T, 3)`` (differentiable),
    ``lights`` the light choice (its cdf and prob detached), ``p`` the
    shading points (differentiable), ``n_s`` their flipped shading normals
    and ``hit_albedo`` their albedo (both detached here), ``hit_idx`` the
    surfaces' triangles, ``u_sel`` the NEE light draw, ``u_edge`` and
    ``u_s`` the edge sample's two draws, ``hit`` the live lanes, ``table``
    the triangles' ``sweep_table`` for the nudged shadow ray's sweep.

    An edge of the 3T mesh edges is picked uniformly, a point x(s) on it
    projected from p onto the sampled light's plane; where the point lies
    on a real, visible shadow boundary (between p and the light plane,
    inside the light, on neither the light nor the surface, the lit side
    seeing the light: a shadow ray nudged 1e-3·r off the edge toward the
    lit side hits the light) the term is ``f_A(y) · [(y(θ) − y) · m̂] ·
    |∂y/∂s| · 3T / prob_light``, all detached but the crossing ``y(θ)``,
    which moves with the edge's vertices, p and the light's plane. With
    MIS it carries the NEE strategy's power-heuristic weight."""
    v0, v1, v2 = verts
    t = v0.shape[0]

    # the light choice: the same draw and search as direct_light
    li = torch.searchsorted(lights.cdf, u_sel, right=True).clamp(0, t - 1)
    lv0, lv1, lv2, lemi, lprob = gather_rows(
        li, v0, v1, v2, lights.emission, lights.prob)
    le1, le2 = lv1 - lv0, lv2 - lv0
    ln = cross3(le1, le2)               # unnormalised, differentiable

    # the edge: uniform over the 3T mesh edges
    n_e = 3 * t
    e_id = (u_edge.detach() * float(n_e)).to(torch.int64).clamp(0, n_e - 1)
    tri_e = e_id // 3
    k3 = (e_id % 3)[:, None]
    ev0, ev1, ev2 = gather_rows(tri_e, v0, v1, v2)
    ea = _pick(k3, ev0, ev1, ev2)
    eb = _pick(k3, ev1, ev2, ev0)
    ec = _pick(k3, ev2, ev0, ev1)

    s_ = u_s.detach()[:, None]
    x = ea + s_ * (eb - ea)
    dirx = x - p
    denom = dot3(dirx, ln)
    plane_d = dot3(lv0 - p, ln)
    ok0 = hit & (torch.abs(denom.detach()) > _f32(1e-12))
    den_s = torch.where(ok0, denom, 1.0)
    tq = plane_d / den_s
    y_e = p + tq[:, None] * dirx        # the differentiable boundary point
    yd = y_e.detach()

    # ---- everything below is detached geometry and validity ----
    with torch.no_grad():
        lv0d, le1d, le2d, lnd = lv0, le1, le2, ln
        pd = p
        nn = torch.clamp_min(dot3(lnd, lnd), _f32(1e-20))
        rel = yd - lv0d
        b1 = dot3(cross3(rel, le2d), lnd) / nn
        b2 = dot3(cross3(le1d, rel), lnd) / nn
        inside = (b1 >= 0.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0)

        # arc-length factor and in-plane normal of the curve s -> y(s)
        ebad = eb - ea
        tqp = -tq * dot3(ebad, lnd) / den_s
        dy_ds = tqp[:, None] * dirx + tq[:, None] * ebad
        arc = sqrt_rn(torch.clamp_min(dot3(dy_ds, dy_ds), _f32(1e-20)))
        t_dir = dy_ds / arc[:, None]
        ln_unit = lnd / sqrt_rn(nn)[:, None]
        m0 = cross3(t_dir, ln_unit)
        m0 = m0 / sqrt_rn(torch.clamp_min(dot3(m0, m0), _f32(1e-20)))[:, None]
        # oriented toward the blocker's projected interior (the shadow)
        dirc = ec - pd
        denc = dot3(dirc, lnd)
        okc = torch.abs(denc) > _f32(1e-12)
        tqc = plane_d / torch.where(okc, denc, 1.0)
        y_c = pd + tqc[:, None] * dirc
        side = dot3(m0, y_c - yd)
        mhat = m0 * torch.sign(side)[:, None]

        # lit-side visibility: nudged off the edge toward the lit side
        delta = yd - pd
        r2 = dot3(delta, delta)
        r = sqrt_rn(torch.clamp_min(r2, _f32(1e-20)))
        eps_off = (_f32(1e-3) * r)[:, None]
        y_test = yd - eps_off * mhat
        om = y_test - pd
        om = om / sqrt_rn(torch.clamp_min(dot3(om, om), _f32(1e-20)))[:, None]
        _, occ = nearest_hit_edges(pd, om, v0, v1 - v0, v2 - v0, hit_idx,
                                   cfg.tri_block, table)

        omega = delta / r[:, None]
        cos_s = dot3(n_s, omega)
        cos_l = torch.abs(dot3(ln_unit, omega))
        valid = (ok0 & okc & inside & hit
                 & (tq > _f32(1.0 + 1e-4)) & (tqc > 0.0)
                 & (occ == li) & (lprob > 0.0) & (cos_s > 0.0)
                 & (tri_e != li) & (tri_e != hit_idx)
                 & (torch.abs(side) > _f32(1e-9)))

        f_scalar = cos_s * cos_l / torch.clamp_min(r2, _f32(1e-12))
        if cfg.mis and cfg.sampler != "angle":
            p_nee = (lprob / torch.clamp_min(0.5 * sqrt_rn(nn), _f32(1e-20))
                     ) * torch.clamp_max(r2, _f32(1e12)) / torch.clamp_min(
                         cos_l, _f32(1e-6))
            p_b = bsdf_pdf(cfg.sampler, cos_s)
            f_scalar = f_scalar * p_nee * p_nee / torch.clamp_min(
                p_nee * p_nee + p_b * p_b, _f32(1e-30))
        w = arc * _f32(n_e) / torch.clamp_min(lprob, _f32(1e-20))
        weight = torch.where(valid, f_scalar * w, 0.0)
        f_rgb = hit_albedo * INV_PI * lemi

    crossing = dot3(y_e - yd, mhat)     # forward exactly 0
    return f_rgb * (weight * crossing)[:, None]
