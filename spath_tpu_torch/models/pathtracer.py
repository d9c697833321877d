"""Wavefront Monte-Carlo path tracer (``spath_tpu/models/pathtracer.py``).

Every pixel's ray is in flight at once, in the forward-throughput form::

    L        = Σ_b  throughput_b · (emitted_b + direct_b)
    thru_0   = 1
    thru_b+1 = thru_b · albedo[hit_b] · w_b

Dead rays are masked lanes, not branches. The camera rays' first hit is
the same for every sample, so it is computed once and shared. Attributes
of the hit triangle are gathered by plain indexing.

Two estimators are ported:

- **conformance** (``rng="lcg"``, ``sampler="angle"``): the reference's
  per-pixel LCG, advanced twice and only where a ray hit, and its
  angle-uniform sampler, ``w_b = 2·cosθ``;
- **quality** (``rng="hash"``): the counter-based hash stream keyed by
  (seed, pixel, sample, bounce, draw), the cosine (``w_b = 1``), uniform
  or angle sampler, and with ``nee`` next-event estimation
  (``ops/nee.py``): camera-ray emitter hits count fully, later
  BSDF-sampled ones carry the MIS partner weight (``mis``) or are dropped;
  ``rr_start`` Russian roulette on the continuation, survival
  q = max throughput component with a 1/q reweight, its draw at the fixed
  index 5 with NEE and 2 without; ``stratify`` spreads the first
  bounce's azimuth over the spp samples.

The walk is written over the scene's geometry ``(v0, e1, e2, normals,
albedo, emission)``, so the fused kernel K1's plain version
(``ops/kernels/megakernel.py::megakernel_plain``) runs the same code on
the columns of its packed table.

Differentiability (detached sampling, as the JAX package): sampled
directions, hit indices, the light choice, the roulette decision and the
MIS weights are constants of the backward pass; a recomputed ``2·cosθ``
weight keeps its gradient through the shading normal. ``render_radiance``
is differentiable with respect to the scene's vertices, albedo and
emission and the camera under ``torch.autograd``;
``render_radiance_fastgrad`` gives the same gradients through the fused
kernels' hand-written backward on a CUDA device. The ``threefry`` and
``table`` streams and visibility gradients (``vis_grad``) are not ported
and raise ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

from spath_tpu_torch.camera import Camera, generate_rays
from spath_tpu_torch.config import RenderConfig
from spath_tpu_torch.ops import nee
from spath_tpu_torch.ops.intersect import check_method, nearest_hit_edges
from spath_tpu_torch.ops.rng import fmix32, hash_keys, key_uniforms, lcg_next
from spath_tpu_torch.ops.sampling import dot3, hemisphere_sample
from spath_tpu_torch.scene import Scene

#: What is not ported, and where the ROADMAP queues it.
_MISSING = {
    "threefry": "the threefry stream (ROADMAP queue 1, item 2)",
    "table": "the vec_dist table stream (ROADMAP queue 1, item 2)",
}


def _conformance_gaps(cfg: RenderConfig) -> list[str]:
    gaps = []
    if cfg.rng != "lcg":
        gaps.append(f"rng={cfg.rng!r}")
    if cfg.sampler != "angle":
        gaps.append(f"sampler={cfg.sampler!r}")
    for flag in ("nee", "rr_start", "stratify", "vis_grad"):
        if getattr(cfg, flag):
            gaps.append(f"{flag}={getattr(cfg, flag)!r}")
    return gaps


def is_conformance(cfg: RenderConfig) -> bool:
    """Is ``cfg`` the conformance estimator, the one K1 and K2 take?"""
    return not _conformance_gaps(cfg)


def require_conformance(cfg: RenderConfig) -> None:
    """Raise ``NotImplementedError`` for any setting outside the
    conformance estimator."""
    gaps = _conformance_gaps(cfg)
    if gaps:
        raise NotImplementedError(
            "this kernel takes the conformance estimator only (rng='lcg', "
            "sampler='angle', no nee/rr_start/stratify/vis_grad); got "
            + ", ".join(gaps))


def unported(cfg: RenderConfig) -> list[str]:
    """What of ``cfg`` the port cannot render, in words."""
    missing = []
    if cfg.rng in _MISSING:
        missing.append(f"rng={cfg.rng!r}: {_MISSING[cfg.rng]}")
    if cfg.vis_grad:
        missing.append("vis_grad=True: visibility gradients (ops/warp.py "
                       "and the hit export K11, ROADMAP queue 1, item 8)")
    return missing


def require_ported(cfg: RenderConfig) -> None:
    """Raise ``NotImplementedError`` naming what is missing when the port
    has no estimator for ``cfg``, and ``ValueError`` for the settings the
    JAX package refuses."""
    missing = unported(cfg)
    if missing:
        raise NotImplementedError("not ported yet: " + "; ".join(missing))
    if cfg.nee and cfg.rng == "lcg":
        raise ValueError("cfg.nee requires rng='threefry' or 'hash'")
    if (cfg.rr_start or cfg.stratify) and cfg.rng == "lcg":
        raise ValueError("rr_start/stratify require rng='threefry'/'hash'")


def scene_geometry(scene: Scene):
    """``(v0, e1, e2, normals, albedo, emission)``, each ``(T, 3)``."""
    v0 = scene.v0
    return (v0, scene.v1 - v0, scene.v2 - v0, scene.normals(),
            scene.albedo, scene.emission)


def geometry_lights(geom) -> tuple[nee.Lights, torch.Tensor]:
    """The light choice over ``geom`` and the triangles' areas."""
    return nee.make_lights(*geom[:3], geom[5])


def n_draws(cfg: RenderConfig) -> int:
    """Uniforms a hash-stream bounce draws: direction (2), light choice
    and point (3) with NEE, roulette (1)."""
    return (5 if cfg.nee else 2) + (1 if cfg.rr_start else 0)


def trace_geometry(geom, origins, directions, rng, cfg: RenderConfig,
                   first_hit=None, lights=None, sample: int = 0):
    """Trace one sample per ray through ``geom`` (``scene_geometry``).

    ``rng`` is the rays' stream: for ``rng="lcg"`` their int64 LCG states,
    for ``rng="hash"`` their first-round hashes ``fmix32(keys)``, the same
    for every sample. ``lights`` (``geometry_lights``) is needed with NEE;
    ``sample`` is the sample's counter. Returns ``(radiance (N, 3),
    rng)``."""
    v0, e1, e2, normals, albedo, emission = geom
    n = origins.shape[0]
    device = origins.device
    use_mis = cfg.nee and cfg.mis and cfg.sampler != "angle"
    if cfg.nee:
        lights, area = lights
        if use_mis:
            hit_tables = (lights.prob, area.detach())
            prev_pdf = torch.zeros(n, dtype=torch.float32, device=device)
    o, d = origins, directions
    throughput = torch.ones((n, 3), dtype=torch.float32, device=device)
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=device)
    alive = torch.ones(n, dtype=torch.bool, device=device)
    src = torch.full((n,), -1, dtype=torch.int64, device=device)

    for bounce in range(cfg.max_bounces):
        if bounce == 0 and first_hit is not None:
            dist, idx = first_hit
        else:
            dist, idx = nearest_hit_edges(o, d, v0, e1, e2, src,
                                          cfg.tri_block)
        hit = alive & (idx >= 0)
        hit3 = hit[:, None]
        safe = idx.clamp_min(0)
        point = o + dist[:, None] * d
        nrm, alb, emi = normals[safe], albedo[safe], emission[safe]
        flip = dot3(nrm, d) > 0.0
        adj_n = torch.where(flip[:, None], -nrm, nrm)

        if cfg.rng == "lcg":
            # two draws; the state advances only where the ray hit
            s1, u1 = lcg_next(rng)
            s2, u2 = lcg_next(s1)
            rng = torch.where(hit, s2, rng)
            us = (u1, u2)
        else:
            us = key_uniforms(rng, sample, bounce, n_draws(cfg))
        u_az = us[0]
        if cfg.stratify and bounce == 0:
            u_az = (float(np.float32(sample)) + u_az) \
                * float(np.float32(1.0 / cfg.spp))
        next_d, weight = hemisphere_sample(cfg.sampler, adj_n, u_az, us[1])
        # Detached sampling: the direction is a constant of the backward
        # pass; a 2·cosθ weight is recomputed against it so that its
        # gradient flows through the normal only.
        next_d = next_d.detach()
        if cfg.sampler in ("angle", "uniform"):
            weight = 2.0 * dot3(next_d, adj_n)

        if cfg.nee:
            # Camera-ray emitter hits count fully; deeper BSDF-sampled
            # ones carry the MIS partner weight or (pure NEE) are dropped.
            if bounce == 0:
                radiance = radiance + torch.where(hit3, throughput * emi, 0.0)
            elif use_mis:
                cos_l = torch.abs(dot3(nrm, d))
                p_here = nee.nee_pdf_of_hit(hit_tables[0][safe],
                                            hit_tables[1][safe], dist, cos_l)
                w_b = (prev_pdf * prev_pdf / torch.clamp_min(
                    prev_pdf * prev_pdf + p_here * p_here, 1e-30)).detach()
                radiance = radiance + torch.where(
                    hit3, throughput * emi * w_b[:, None], 0.0)
            direct = nee.direct_light(lights, point, adj_n, safe, us[2],
                                      us[3], us[4], cfg, hit_albedo=alb)
            radiance = radiance + torch.where(hit3, throughput * direct, 0.0)
        else:
            radiance = radiance + torch.where(hit3, throughput * emi, 0.0)
        throughput = torch.where(hit3, throughput * alb * weight[:, None],
                                 throughput)
        o = torch.where(hit3, point, o)
        d = torch.where(hit3, next_d, d)
        src = torch.where(hit, idx, src)
        alive = hit
        if cfg.rr_start and cfg.rr_start <= bounce < cfg.max_bounces - 1:
            # Russian roulette on the continuation: survive with
            # probability q, reweight by 1/q; the decision is detached.
            q = torch.clamp(throughput.max(dim=-1).values, 0.05, 1.0).detach()
            survive = us[5 if cfg.nee else 2] < q
            throughput = torch.where((hit & survive)[:, None],
                                     throughput / q[:, None], throughput)
            alive = hit & survive
        if use_mis:
            prev_pdf = nee.bsdf_pdf(cfg.sampler,
                                    dot3(next_d, adj_n)).detach()
    return radiance, rng


def mean_radiance_geometry(geom, origins, directions, rng,
                           cfg: RenderConfig, lights=None):
    """Mean of ``cfg.spp`` samples per ray → ``(N, 3)``; ``rng`` and
    ``lights`` as ``trace_geometry`` takes them. The camera rays' nearest
    hit is the same for every sample and is computed once."""
    require_ported(cfg)
    v0, e1, e2 = geom[:3]
    src = torch.full((origins.shape[0],), -1, dtype=torch.int64,
                     device=origins.device)
    first_hit = nearest_hit_edges(origins, directions, v0, e1, e2, src,
                                  cfg.tri_block)
    if cfg.nee and lights is None:
        lights = geometry_lights(geom)
    accum = torch.zeros((origins.shape[0], 3), dtype=torch.float32,
                        device=origins.device)
    for s in range(cfg.spp):
        rad, rng = trace_geometry(geom, origins, directions, rng, cfg,
                                  first_hit, lights, s)
        accum = accum + rad
    return accum * float(np.float32(1.0) / np.float32(cfg.spp))


def _pixel_ids(n: int, pixel_ids, device):
    if pixel_ids is None:
        return torch.arange(n, dtype=torch.int64, device=device)
    return pixel_ids.to(torch.int64)


def trace_radiance(scene: Scene, origins, directions, cfg: RenderConfig,
                   rng_state, pixel_ids=None, sample_idx: int = 0):
    """Trace ONE sample per ray. Returns ``(radiance (N, 3), rng_state)``:
    for ``rng="lcg"`` ``rng_state`` holds the rays' int64 LCG seeds and
    advances; for ``rng="hash"`` it is the frame seed, keyed with the
    rays' global ``pixel_ids`` (default ``arange(N)``) and the counter
    ``sample_idx``."""
    require_ported(cfg)
    check_method(cfg.intersect)
    geom = scene_geometry(scene)
    lights = geometry_lights(geom) if cfg.nee else None
    if cfg.rng == "lcg":
        return trace_geometry(geom, origins, directions, rng_state, cfg,
                              lights=lights)
    ids = _pixel_ids(origins.shape[0], pixel_ids, origins.device)
    h1 = fmix32(hash_keys(int(rng_state), ids))
    rad, _ = trace_geometry(geom, origins, directions, h1, cfg,
                            lights=lights, sample=sample_idx)
    return rad, rng_state


def trace_mean_radiance(scene: Scene, origins, directions,
                        cfg: RenderConfig, seed: int = 0, pixel_ids=None):
    """Average ``cfg.spp`` samples per ray → ``(N, 3)``. LCG streams start
    at each ray's pixel index plus ``seed``; hash streams are keyed by
    ``seed`` and the pixel index."""
    require_ported(cfg)
    check_method(cfg.intersect)
    n, device = origins.shape[0], origins.device
    ids = _pixel_ids(n, pixel_ids, device)
    if cfg.rng == "lcg":
        rng = (ids + seed) & 0xFFFFFFFF
    else:
        rng = fmix32(hash_keys(seed, ids))
    return mean_radiance_geometry(scene_geometry(scene), origins,
                                  directions, rng, cfg)


def _check_devices(scene: Scene, camera: Camera) -> None:
    if scene.device != camera.device:
        raise ValueError(f"scene on {scene.device}, camera on "
                         f"{camera.device}: put both on one device")


def render_radiance(scene: Scene, camera: Camera, cfg: RenderConfig,
                    seed: int = 0) -> torch.Tensor:
    """Unclamped mean radiance ``(H, W, 3)`` through the wavefront."""
    _check_devices(scene, camera)
    origins, directions = generate_rays(camera, cfg.width, cfg.height)
    mean = trace_mean_radiance(scene, origins, directions, cfg, seed)
    return mean.reshape(cfg.height, cfg.width, 3)


def render_pt(scene: Scene, camera: Camera, cfg: RenderConfig,
              seed: int = 0) -> torch.Tensor:
    """Path-traced frame with the reference's final clamp, float32
    ``(H, W, 3)`` in [0, 1]."""
    return torch.clamp(render_radiance(scene, camera, cfg, seed), 0.0, 1.0)


def render_radiance_fastgrad(scene: Scene, camera: Camera,
                             cfg: RenderConfig, seed: int = 0
                             ) -> torch.Tensor:
    """Differentiable unclamped radiance ``(H, W, 3)``: the same value and
    the same detached-sampling gradients as ``render_radiance``, from the
    fastest backend with a gradient path (``models/renderer.py``). On a
    CUDA device the forward is a fused kernel (K1, or K3 for the quality
    estimator) or, on large scenes, a streamed one (K6, K9), and the
    backward its hand-written reverse sweep (K2, K4; K8 or K10 with the
    scatter K7); on the CPU, autograd of the wavefront. A scene or config
    that no ported kernel differentiates raises ``NotImplementedError``."""
    from spath_tpu_torch.models.renderer import grad_renderer

    _check_devices(scene, camera)
    return grad_renderer(scene, cfg).render_radiance_grad(scene, camera,
                                                          cfg, seed)


def render_pt_fast(scene: Scene, camera: Camera, cfg: RenderConfig,
                   seed: int = 0) -> torch.Tensor:
    """The serving path: the clamped frame from the fastest renderer that
    renders ``(scene, cfg)`` exactly (``models/renderer.py``): a fused
    CUDA kernel on a CUDA device (K1 conformance, K3 quality) or, on large
    scenes, a streamed one (K6, K9), the wavefront on the CPU. A scene or config that no ported kernel takes
    raises ``NotImplementedError``."""
    from spath_tpu_torch.models.renderer import forward_renderer

    _check_devices(scene, camera)
    return forward_renderer(scene, cfg).render(scene, camera, cfg, seed)
