"""Next-event estimation, direct light sampling (``spath_tpu/ops/nee.py``).

At each path vertex p the quality estimator draws a point y on an
emissive triangle, chosen with probability q ∝ luminance(emission)·area,
by the area-uniform barycentric map::

    b1 = 1 - sqrt(u1); b2 = u2 * sqrt(u1)
    y  = v0 + b1·(v1 - v0) + b2·(v2 - v0)

and adds ``albedo/π · emit · cosθ_s · cosθ_ℓ / r² · (A/q) · V(p, y)``,
with the power-heuristic MIS weight against the BSDF strategy when
``cfg.mis``. y, A, r and both cosines are smooth in the light's vertices
and in p, so gradients reach geometry and camera; the selection
probability q, the MIS weights and the shadow test V are detached.
Lights are double-sided (cosθ_ℓ = |n_ℓ·ω|).

The selection distribution (``light_cdf``) is a discrete choice, so a
last-bit difference in the cdf changes which light a draw picks. It is
computed in the order of operations of the JAX package on the CPU, on the
scene's device: the total in XLA's windows of 32 (the ``reduce-window``
ops in the HLO of ``jnp.sum``), the cdf in XLA's blocks of 16 (its scan),
by ``ops/kernels/light_cdf.py`` (a CUDA kernel for a CUDA scene, numpy on
the host for a CPU scene).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from spath_tpu_torch.config import RenderConfig
from spath_tpu_torch.ops.fp import sqrt_rn
from spath_tpu_torch.ops.gather import gather_rows
from spath_tpu_torch.ops.intersect import nearest_hit_edges
from spath_tpu_torch.ops.kernels.light_cdf import light_cdf_call
from spath_tpu_torch.ops.sampling import cross3, dot3

INV_PI = float(np.float32(1.0 / np.pi))


def areas_from_edges(e1: torch.Tensor, e2: torch.Tensor) -> torch.Tensor:
    """``0.5·|e1 × e2|`` per row, differentiable."""
    c = cross3(e1, e2)
    return 0.5 * sqrt_rn(c[..., 0] * c[..., 0] + c[..., 1] * c[..., 1]
                         + c[..., 2] * c[..., 2])


def triangle_areas(scene) -> torch.Tensor:
    """(T,) triangle areas, differentiable in the vertices."""
    return areas_from_edges(scene.v1 - scene.v0, scene.v2 - scene.v0)


def light_cdf(scene):
    """``(cdf (T,), prob (T,))`` of the scene's light choice, detached:
    prob ∝ luminance·area; an all-dark scene gets a uniform cdf and a prob
    of zeros (callers mask by ``prob > 0``)."""
    return light_cdf_call(scene.emission, triangle_areas(scene))


class Lights(NamedTuple):
    """What light sampling reads: the triangles as ``v0`` and edges, the
    emission, and the detached choice distribution. Built once a frame
    (``make_lights``)."""

    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    emission: torch.Tensor
    cdf: torch.Tensor
    prob: torch.Tensor


def make_lights(v0, e1, e2, emission) -> tuple[Lights, torch.Tensor]:
    """The light choice over triangles given as ``v0`` and edges, and the
    triangles' (differentiable) areas."""
    area = areas_from_edges(e1, e2)
    cdf, prob = light_cdf_call(emission, area)
    return Lights(v0, e1, e2, emission, cdf, prob), area


def light_points(v0, e1, e2, emission, prob, idx, u1, u2) -> dict:
    """Points on the chosen triangles, given as their rows (``v0``, edges,
    emission, prob; ``idx`` the triangles), from ``(N,)`` uniforms: the
    dict ``sample_light_points`` returns."""
    su1 = sqrt_rn(u1)
    b1 = 1.0 - su1
    b2 = u2 * su1
    y = v0 + b1[:, None] * e1 + b2[:, None] * e2
    n = cross3(e1, e2)
    norm = sqrt_rn(n[:, 0] * n[:, 0] + n[:, 1] * n[:, 1]
                   + n[:, 2] * n[:, 2])
    return {
        "y": y,
        "normal": n / torch.clamp_min(norm, 1e-20)[:, None],
        "emission": emission,
        "area": 0.5 * norm,
        "prob": prob,
        "idx": idx,
    }


def sample_light_points(lt: Lights, u_sel, u1, u2) -> dict:
    """Sample N points on emissive triangles from ``(N,)`` uniforms.

    Returns ``y`` (N, 3) light points, ``normal`` unit normals,
    ``emission``, ``area``, ``prob`` (detached) and ``idx``, the chosen
    triangle, as the JAX function's dict. The rows are gathered by
    ``ops/gather.py::gather_rows``, whose backward adds each row's
    duplicates in a fixed order (on the card through K7).
    """
    idx = torch.searchsorted(lt.cdf, u_sel, right=True)
    idx = idx.clamp(0, lt.cdf.shape[0] - 1)
    v0, e1, e2, emission = gather_rows(idx, lt.v0, lt.e1, lt.e2,
                                       lt.emission)
    return light_points(v0, e1, e2, emission, lt.prob.index_select(0, idx),
                        idx, u1, u2)


def direct_from_points(s: dict, p, n_s, hit_idx, cfg: RenderConfig,
                       hit_albedo, occluder):
    """``direct_light`` from the light points ``s`` (``light_points``):
    ``occluder(p, omega)`` gives each shadow ray's nearest triangle
    excluding ``hit_idx`` (called without gradient), which must be the
    chosen light."""
    delta = s["y"] - p
    r2 = dot3(delta, delta)
    r = sqrt_rn(torch.clamp_min(r2, 1e-20))
    omega = delta / r[:, None]
    cos_s = dot3(n_s, omega)
    cos_l = torch.abs(dot3(s["normal"], omega))

    # shadow ray: the nearest hit other than the surface must be the light
    with torch.no_grad():
        occ = occluder(p, omega)
    valid = (occ == s["idx"]) & (s["prob"] > 0) & (cos_s > 0) \
        & (s["idx"] != hit_idx)

    g = cos_s * cos_l / torch.clamp_min(r2, 1e-12)
    weight = s["area"] / torch.clamp_min(s["prob"], 1e-20)
    contrib = hit_albedo * INV_PI * s["emission"] * (g * weight)[:, None]
    if cfg.mis and cfg.sampler != "angle":
        p_nee = (s["prob"] / torch.clamp_min(s["area"], 1e-20)) \
            * torch.clamp_max(r2, 1e12) / torch.clamp_min(cos_l, 1e-6)
        p_bsdf = bsdf_pdf(cfg.sampler, cos_s)
        w = p_nee * p_nee / torch.clamp_min(p_nee * p_nee + p_bsdf * p_bsdf,
                                            1e-30)
        contrib = contrib * w.detach()[:, None]
    return torch.where(valid[:, None], contrib, 0.0)


def direct_light(lt: Lights, p, n_s, hit_idx, u_sel, u1, u2,
                 cfg: RenderConfig, hit_albedo, table=None):
    """Direct radiance ``(N, 3)`` at surface points ``p`` with shading
    normals ``n_s`` (flipped toward the incoming ray): the ``albedo/π ·
    emit · G · A/q · V`` estimator, zero where the chosen triangle is dark,
    below the horizon, occluded or the surface itself. ``hit_idx`` is the
    surface's own triangle, excluded from the shadow ray. With ``cfg.mis``
    (and a sampler other than the reference's angle sampler) the
    contribution carries the detached power-heuristic weight. ``table`` is
    the triangles' ``sweep_table`` for the shadow ray's sweep."""
    def occluder(points, omega):
        return nearest_hit_edges(points, omega, lt.v0, lt.e1, lt.e2,
                                 hit_idx, cfg.tri_block, table)[1]

    return direct_from_points(sample_light_points(lt, u_sel, u1, u2), p,
                              n_s, hit_idx, cfg, hit_albedo, occluder)


def bsdf_pdf(sampler: str, cos_theta: torch.Tensor) -> torch.Tensor:
    """Solid-angle pdf of the hemisphere sampler at cosθ from the shading
    normal (for the MIS weights)."""
    if sampler == "cosine":
        return torch.clamp_min(cos_theta, 0.0) * INV_PI
    if sampler == "uniform":
        return torch.full_like(cos_theta, float(np.float32(0.5 / np.pi)))
    raise ValueError(f"MIS unsupported for sampler {sampler!r}")


def nee_pdf_of_hit(prob, area, dist, cos_l) -> torch.Tensor:
    """Solid-angle pdf the NEE strategy gives a BSDF-sampled emitter hit:
    ``(q/A)·r²/|cosθ_ℓ|``, the distance clamped at 1e6 (a miss's 1e12
    would overflow its square)."""
    d = torch.clamp_max(dist, 1e6)
    return (prob / torch.clamp_min(area, 1e-20)) * d * d \
        / torch.clamp_min(cos_l, 1e-6)
