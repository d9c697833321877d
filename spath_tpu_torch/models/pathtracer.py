"""Wavefront Monte-Carlo path tracer, conformance estimator.

The PyTorch counterpart of the ``rng="lcg"``, ``sampler="angle"`` branch
of ``spath_tpu/models/pathtracer.py``. Every pixel's ray is in flight at
once, in the forward-throughput form::

    L        = Σ_b  throughput_b · emittance[hit_b]
    thru_0   = 1
    thru_b+1 = thru_b · albedo[hit_b] · 2·cosθ_b

Dead rays are masked lanes, not branches. The camera rays' first hit is
the same for every sample, so it is computed once and shared; the
per-pixel LCG advances (twice) only where a ray hit. Attributes of the
hit triangle are gathered by plain indexing.

The walk is written over the scene's geometry ``(v0, e1, e2, normals,
albedo, emission)``, so the fused kernel's plain version
(``ops/kernels/megakernel.py::megakernel_plain``) runs the same code on
the columns of its packed table.

Differentiability (detached sampling, as the JAX package): sampled
directions and hit indices are constants of the backward pass; the
weight ``2·cosθ`` is recomputed against the detached direction, so its
gradient flows through the shading normal only. ``render_radiance`` is
differentiable with respect to the scene's vertices, albedo and emission
and the camera under ``torch.autograd``; ``render_radiance_fastgrad``
gives the same gradients through the fused kernels' hand-written
backward on a CUDA device. The quality estimator (NEE, MIS, Russian
roulette, stratification, other RNGs and samplers) and visibility
gradients are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

from spath_tpu_torch.camera import Camera, generate_rays
from spath_tpu_torch.config import RenderConfig
from spath_tpu_torch.ops.intersect import check_method, nearest_hit_edges
from spath_tpu_torch.ops.rng import lcg_next, pixel_seeds
from spath_tpu_torch.ops.sampling import angle_sample, dot3
from spath_tpu_torch.scene import Scene


def _unported(cfg: RenderConfig) -> list[str]:
    unported = []
    if cfg.rng != "lcg":
        unported.append(f"rng={cfg.rng!r}")
    if cfg.sampler != "angle":
        unported.append(f"sampler={cfg.sampler!r}")
    for flag in ("nee", "rr_start", "stratify", "vis_grad"):
        if getattr(cfg, flag):
            unported.append(f"{flag}={getattr(cfg, flag)!r}")
    return unported


def is_conformance(cfg: RenderConfig) -> bool:
    """Is ``cfg`` the conformance estimator, the one this port renders?"""
    return not _unported(cfg)


def require_conformance(cfg: RenderConfig) -> None:
    """Raise ``NotImplementedError`` for any setting outside the
    conformance estimator."""
    unported = _unported(cfg)
    if unported:
        raise NotImplementedError(
            "only the conformance estimator (rng='lcg', sampler='angle', "
            "no nee/rr_start/stratify/vis_grad) is ported; got "
            + ", ".join(unported))


def scene_geometry(scene: Scene):
    """``(v0, e1, e2, normals, albedo, emission)``, each ``(T, 3)``."""
    v0 = scene.v0
    return (v0, scene.v1 - v0, scene.v2 - v0, scene.normals(),
            scene.albedo, scene.emission)


def trace_geometry(geom, origins, directions, seeds, cfg: RenderConfig,
                   first_hit=None):
    """Trace one sample per ray through ``geom`` (``scene_geometry``).

    ``seeds`` are the rays' int64 LCG states. Returns ``(radiance (N, 3),
    seeds)``.
    """
    v0, e1, e2, normals, albedo, emission = geom
    n = origins.shape[0]
    device = origins.device
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

        # two LCG draws; the state advances only where the ray hit
        s1, u1 = lcg_next(seeds)
        s2, u2 = lcg_next(s1)
        seeds = torch.where(hit, s2, seeds)
        next_d, _ = angle_sample(adj_n, u1, u2)
        # Detached sampling: the direction is a constant of the backward
        # pass, and the weight is recomputed against it so that its
        # gradient flows through the normal only.
        next_d = next_d.detach()
        weight = 2.0 * dot3(next_d, adj_n)

        radiance = radiance + torch.where(hit3, throughput * emi, 0.0)
        throughput = torch.where(hit3, throughput * alb * weight[:, None],
                                 throughput)
        o = torch.where(hit3, point, o)
        d = torch.where(hit3, next_d, d)
        src = torch.where(hit, idx, src)
        alive = hit
    return radiance, seeds


def mean_radiance_geometry(geom, origins, directions, seeds,
                           cfg: RenderConfig):
    """Mean of ``cfg.spp`` samples per ray → ``(N, 3)``. The camera rays'
    nearest hit is the same for every sample and is computed once."""
    require_conformance(cfg)
    v0, e1, e2 = geom[:3]
    src = torch.full((origins.shape[0],), -1, dtype=torch.int64,
                     device=origins.device)
    first_hit = nearest_hit_edges(origins, directions, v0, e1, e2, src,
                                  cfg.tri_block)
    accum = torch.zeros((origins.shape[0], 3), dtype=torch.float32,
                        device=origins.device)
    for _ in range(cfg.spp):
        rad, seeds = trace_geometry(geom, origins, directions, seeds, cfg,
                                    first_hit)
        accum = accum + rad
    return accum * float(np.float32(1.0) / np.float32(cfg.spp))


def trace_radiance(scene: Scene, origins, directions, cfg: RenderConfig,
                   rng_state):
    """Trace ONE sample per ray. Returns ``(radiance (N, 3), rng_state)``;
    ``rng_state`` holds the rays' int64 LCG seeds."""
    require_conformance(cfg)
    check_method(cfg.intersect)
    return trace_geometry(scene_geometry(scene), origins, directions,
                          rng_state, cfg)


def trace_mean_radiance(scene: Scene, origins, directions,
                        cfg: RenderConfig, seed: int = 0):
    """Average ``cfg.spp`` samples per ray → ``(N, 3)``. Each ray's LCG
    starts at its pixel index plus ``seed``."""
    check_method(cfg.intersect)
    seeds = pixel_seeds(origins.shape[0], seed, device=origins.device)
    return mean_radiance_geometry(scene_geometry(scene), origins,
                                  directions, seeds, cfg)


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
    CUDA device the forward is the fused kernel K1 and the backward its
    hand-written reverse sweep K2; on the CPU, autograd of the wavefront.
    A scene or config that no ported kernel differentiates raises
    ``NotImplementedError``."""
    from spath_tpu_torch.models.renderer import grad_renderer

    _check_devices(scene, camera)
    return grad_renderer(scene, cfg).render_radiance_grad(scene, camera,
                                                          cfg, seed)


def render_pt_fast(scene: Scene, camera: Camera, cfg: RenderConfig,
                   seed: int = 0) -> torch.Tensor:
    """The serving path: the clamped frame from the fastest renderer that
    renders ``(scene, cfg)`` exactly (``models/renderer.py``): the fused
    CUDA kernel on a CUDA device, the wavefront on the CPU. A scene or
    config that no ported kernel takes raises ``NotImplementedError``."""
    from spath_tpu_torch.models.renderer import forward_renderer

    _check_devices(scene, camera)
    return forward_renderer(scene, cfg).render(scene, camera, cfg, seed)
