"""Wavefront Monte-Carlo path tracer (``spath_tpu/models/pathtracer.py``).

Every pixel's ray is in flight at once, in the forward-throughput form::

    L        = Σ_b  throughput_b · (emitted_b + direct_b)
    thru_0   = 1
    thru_b+1 = thru_b · albedo[hit_b] · w_b

Dead rays are masked lanes, not branches. The camera rays' first hit is
the same for every sample, so it is computed once and shared. Attributes
of the hit triangle are gathered by ``ops/gather.py::gather_rows``.

Two estimators, four streams:

- **conformance** (``rng="lcg"``, ``sampler="angle"``): the reference's
  per-pixel LCG, advanced twice and only where a ray hit, and its
  angle-uniform sampler, ``w_b = 2·cosθ``; ``rng="table"`` swaps in the
  reference's ``vec_dist`` table (``ops/rng.py::table_uniforms``: two
  draws a bounce, stateless, the frame seed as the cursor's offset), with
  any sampler;
- **quality** (``rng="hash"`` or ``"threefry"``): a counter-based stream
  keyed by the ray's global pixel id, the hash stream by (seed, pixel,
  sample, bounce, draw), the threefry stream ``jax.random``'s (the frame
  key ``threefry_key(seed)`` folded with the sample and the bounce on the
  host, then with the pixel id on the device, ``csrc/threefry.cu`` on the
  card); the cosine (``w_b = 1``), uniform or angle sampler, and with
  ``nee`` next-event estimation (``ops/nee.py``): camera-ray emitter hits
  count fully, later BSDF-sampled ones carry the MIS partner weight
  (``mis``) or are dropped; ``rr_start`` Russian roulette on the
  continuation, survival q = max throughput component with a 1/q
  reweight, its draw at the fixed index 5 with NEE and 2 without;
  ``stratify`` spreads the first bounce's azimuth over the spp samples.
  ``config.QUALITY`` is the JAX package's preset, threefry with NEE.

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
kernels' hand-written backward on a CUDA device. With ``cfg.vis_grad``
the wavefront adds the visibility terms of ``ops/warp.py`` (exactly
neutral forward), and ``render_vis_residual`` gives them alone, for
``VisGradFusedRenderer``. A config the JAX package refuses (NEE, Russian
roulette or stratification on the LCG or table stream) raises its
``ValueError``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from spath_tpu_torch.camera import Camera, generate_rays
from spath_tpu_torch.config import RenderConfig
from spath_tpu_torch.ops import nee
from spath_tpu_torch.ops.gather import gather_rows
from spath_tpu_torch.ops.intersect import (
    check_method, in_plain_sweep, nearest_hit, nearest_hit_edges, sweep_table,
)
from spath_tpu_torch.ops.rng import (
    fmix32, fold_in, hash_keys, key_uniforms, lcg_next, lcg_seeds,
    per_pixel_uniforms, table_tensor, table_uniforms, threefry_key,
)
from spath_tpu_torch.ops.kernels.threefry import threefry_call
from spath_tpu_torch.ops.sampling import cross3, dot3, hemisphere_sample
from spath_tpu_torch.ops.warp import nee_boundary_term, reparam_emitter_factor
from spath_tpu_torch.scene import Scene


def _conformance_gaps(cfg: RenderConfig) -> list[str]:
    gaps = []
    if cfg.rng != "lcg":
        gaps.append(f"rng={cfg.rng!r}")
    if cfg.sampler != "angle":
        gaps.append(f"sampler={cfg.sampler!r}")
    for flag in ("nee", "rr_start", "stratify"):
        if getattr(cfg, flag):
            gaps.append(f"{flag}={getattr(cfg, flag)!r}")
    return gaps


def is_conformance(cfg: RenderConfig) -> bool:
    """Is ``cfg`` the conformance estimator, the one K1 and K2 take?
    ``vis_grad`` does not count: it changes no frame, only gradients,
    which K2 and K8 refuse (their ``supported_grad``)."""
    return not _conformance_gaps(cfg)


def require_conformance(cfg: RenderConfig) -> None:
    """Raise ``NotImplementedError`` for any setting outside the
    conformance estimator."""
    gaps = _conformance_gaps(cfg)
    if gaps:
        raise NotImplementedError(
            "this kernel takes the conformance estimator only (rng='lcg', "
            "sampler='angle', no nee/rr_start/stratify); got "
            + ", ".join(gaps))


def check_estimator(cfg: RenderConfig) -> None:
    """Raise the JAX package's ``ValueError`` for the settings it refuses:
    NEE, Russian roulette or stratification on a stream with no slot for
    their draws (``lcg``, ``table``)."""
    if cfg.nee and cfg.rng in ("lcg", "table"):
        raise ValueError("cfg.nee requires rng='threefry' or 'hash'")
    if (cfg.rr_start or cfg.stratify) and cfg.rng in ("lcg", "table"):
        raise ValueError("rr_start/stratify require rng='threefry'/'hash'")


class ThreefryRays(NamedTuple):
    """The threefry stream of a set of rays: a key's two words (the
    frame's, or a sample's once ``sample`` has folded it) and the rays'
    int64 global pixel ids, which key each ray's draws."""

    key: tuple[int, int]
    ids: torch.Tensor

    def sample(self, s: int) -> "ThreefryRays":
        return ThreefryRays(fold_in(self.key, s), self.ids)


class TableRays(NamedTuple):
    """The ``table`` stream of a set of rays: the ``vec_dist`` table on
    their device, their int64 global pixel ids and the frame seed, the
    cursors' offset."""

    table: torch.Tensor
    ids: torch.Tensor
    offset: int


def scene_geometry(scene: Scene):
    """``(v0, e1, e2, normals, albedo, emission)``, each ``(T, 3)``."""
    v0 = scene.v0
    return (v0, scene.v1 - v0, scene.v2 - v0, scene.normals(),
            scene.albedo, scene.emission)


def geometry_lights(geom) -> tuple[nee.Lights, torch.Tensor]:
    """The light choice over ``geom`` and the triangles' areas."""
    return nee.make_lights(*geom[:3], geom[5])


def n_draws(cfg: RenderConfig) -> int:
    """Uniforms a bounce of a counter-based stream draws: direction (2),
    light choice and point (3) with NEE, roulette (1), and with
    ``vis_grad`` and NEE the edge sample's two (``ops/warp.py``), after
    the roulette slot; the table stream's 2. Each draw is keyed by its
    index, so the first five or six are the same with or without
    ``vis_grad``."""
    return ((5 if cfg.nee else 2) + (1 if cfg.rr_start else 0)
            + (2 if cfg.vis_grad and cfg.nee else 0))


def _bounce_uniforms(cfg: RenderConfig, rng, sample: int,
                     bounce: int) -> torch.Tensor:
    """The ``(n_draws(cfg), N)`` uniforms of one bounce of a counter-based
    stream (``spath_tpu/models/pathtracer.py::_bounce_uniforms``): the
    hash stream from the rays' first-round hashes, the table stream's
    cursors, or the threefry stream's sample key folded with the bounce,
    drawn by ``csrc/threefry.cu`` on the card (its plain version inside
    ``plain_sweep()``, where the kernels' plain references run)."""
    if cfg.rng == "hash":
        return key_uniforms(rng, sample, bounce, n_draws(cfg))
    if cfg.rng == "table":
        return table_uniforms(rng.table, rng.ids, sample, bounce,
                              n_draws(cfg), cfg.max_bounces, rng.offset)
    key = fold_in(rng.key, bounce)
    if in_plain_sweep():
        return per_pixel_uniforms(key, rng.ids, n_draws(cfg))
    return threefry_call(key, rng.ids, n_draws(cfg))


def _tri_dist(o, d, v0h, e1h, e2h, hit):
    """Differentiable hit distance of the ray ``(o, d)`` against its known
    hit triangle ``(v0h, e1h, e2h)``, O(1) a lane, no sweep:
    Möller–Trumbore ``t = (1 / e1·(d × e2)) · e2·(s × e1)`` with the
    direction detached. Lanes that did not hit, or whose determinant is
    below 1e-12, get 0 and no gradient. (The sweep's backward
    ``_dist_selected`` guards with ``|a| > 0``; each keeps the JAX
    package's guard.)

    The value is the sweep's to the bit (``_sweep`` and K5 multiply by the
    reciprocal in this order), so the residual's position chain and the
    points its edge samples start from equal the walk's. The JAX package
    divides (``e2·q / a``): its chain then drifts from the walk's by an
    ulp, and the edge samples' discrete validity tests (inside the light,
    the nudged shadow ray) flip on a few lanes. At 320x240, 4 spp on its
    test scene that moved the decomposition's vertex and camera gradients
    by 1.8% of their max; with the sweep's order they agree to 3e-5."""
    d = d.detach()
    h = cross3(d, e2h)
    a = dot3(e1h, h)
    valid = hit & (torch.abs(a.detach()) > float(np.float32(1e-12)))
    ac = torch.where(valid, a, 1.0)
    s = o - v0h
    q = cross3(s, e1h)
    t = (1.0 / ac) * dot3(e2h, q)
    return torch.where(valid, t, 0.0)


def trace_geometry(geom, origins, directions, rng, cfg: RenderConfig,
                   first_hit=None, lights=None, sample: int = 0,
                   verts=None, vis_residual: bool = False,
                   hits_replay=None, alive_fractions=None):
    """Trace one sample per ray through ``geom`` (``scene_geometry``).

    ``rng`` is the rays' stream: for ``rng="lcg"`` their int64 LCG states,
    for ``rng="hash"`` their first-round hashes ``fmix32(keys)``, the same
    for every sample, for ``rng="threefry"`` a ``ThreefryRays`` with the
    sample's key, for ``rng="table"`` a ``TableRays``. ``lights``
    (``geometry_lights``) is needed with NEE; ``sample`` is the sample's
    counter. Returns ``(radiance (N, 3), rng)``. ``alive_fractions``, a
    list, gets each bounce's share of rays still alive after it (0-d
    float32 tensors; ``utils/profiling.py::bounce_stats``).

    With ``cfg.vis_grad`` every emitter hit after the camera's carries the
    warped-area factor and, with NEE, every vertex the edge-sampled
    shadow-boundary term (``ops/warp.py``; ``verts``, the scene's ``(v0,
    v1, v2)``, is needed then): neither changes the radiance, both add
    gradient.

    ``vis_residual`` computes only those visibility terms: the walk runs
    detached (the same draws, hits and throughput, no other radiance), and
    a differentiable position chain re-derives each hit point from the
    known hit triangle (``_tri_dist``), so the terms see the gradients the
    whole wavefront would give them. The result is exactly zero, and
    ``grad(interior) + grad(residual) == grad(wavefront with vis_grad)``,
    the decomposition ``VisGradFusedRenderer`` (``models/renderer.py``)
    runs. ``hits_replay``, one ``(dist (N,), idx (N,))`` a bounce (a hit
    export, ``ops/kernels/bigscene_quality.py``), replaces the residual's
    own sweeps; lanes whose path ended hold ``(BIG, -1)``, read only
    through ``alive & idx >= 0``."""
    if hits_replay is not None and not vis_residual:
        raise ValueError("hits_replay is a vis_residual-only replay")
    if vis_residual and not cfg.vis_grad:
        raise ValueError("vis_residual needs cfg.vis_grad")
    if cfg.vis_grad and cfg.nee and verts is None:
        raise ValueError("vis_grad with nee needs the scene's vertices")
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
    sweep_tris = (v0, e1, e2)
    if vis_residual:
        # the detached walk, and the differentiable position chain o_diff
        sweep_tris = (v0.detach(), e1.detach(), e2.detach())
        o_diff = origins
        o, d = o.detach(), d.detach()
        if first_hit is not None:
            first_hit = (first_hit[0].detach(), first_hit[1])
    table = sweep_table(*sweep_tris)   # K5's table, once for every sweep
    throughput = torch.ones((n, 3), dtype=torch.float32, device=device)
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=device)
    alive = torch.ones(n, dtype=torch.bool, device=device)
    src = torch.full((n,), -1, dtype=torch.int64, device=device)
    prev_n = None                      # the axis d was sampled about

    for bounce in range(cfg.max_bounces):
        if hits_replay is not None:
            dist, idx = hits_replay[bounce]
            dist, idx = dist.detach(), idx.to(torch.int64)
        elif bounce == 0 and first_hit is not None:
            dist, idx = first_hit
        else:
            dist, idx = nearest_hit_edges(o, d, *sweep_tris, src,
                                          cfg.tri_block, table)
        hit = alive & (idx >= 0)
        hit3 = hit[:, None]
        safe = idx.clamp_min(0)
        point = o + dist[:, None] * d
        # Row gathers are ops/gather.py's gather_rows: index_select
        # forward; backward the stream scatter K7 on the card, which adds
        # each row's duplicates in a fixed order (index_select's own
        # index_add_ adds them with float atomics, and indexing's
        # index_put_ sorts them, 23 ms a gather of 262,144 rays over 7
        # rows on an H100). With vis_grad one call gathers the hit's
        # geometry too, so its backward is one K7 launch of 18 columns.
        if cfg.vis_grad:
            nrm, alb, emi, v0h, e1h, e2h = gather_rows(
                safe, normals, albedo, emission, v0, e1, e2)
        else:
            nrm, alb, emi = gather_rows(safe, normals, albedo, emission)
        flip = dot3(nrm, d) > 0.0
        adj_n = torch.where(flip[:, None], -nrm, nrm)

        # Warped-area factor of emitter hits: exactly 1 forward. Bounce 0
        # has no sampled direction (camera rays are a fixed pixel grid).
        vis_c = None
        if cfg.vis_grad:
            if bounce >= 1:
                vis_c = reparam_emitter_factor(
                    o_diff if vis_residual else o, d, v0h, e1h, e2h, nrm,
                    prev_n, hit)[:, None]
        if vis_residual:
            dist_diff = _tri_dist(o_diff, d, v0h, e1h, e2h, hit)
            point_diff = o_diff + dist_diff[:, None] * d

        if cfg.rng == "lcg":
            # two draws; the state advances only where the ray hit
            s1, u1 = lcg_next(rng)
            s2, u2 = lcg_next(s1)
            rng = torch.where(hit, s2, rng)
            us = (u1, u2)
        else:
            us = _bounce_uniforms(cfg, rng, sample, bounce)
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
                if not vis_residual:
                    radiance = radiance + torch.where(hit3, throughput * emi,
                                                      0.0)
            elif use_mis:
                cos_l = torch.abs(dot3(nrm, d))
                p_here = nee.nee_pdf_of_hit(
                    hit_tables[0].index_select(0, safe),
                    hit_tables[1].index_select(0, safe), dist, cos_l)
                w_b = (prev_pdf * prev_pdf / torch.clamp_min(
                    prev_pdf * prev_pdf + p_here * p_here, 1e-30)).detach()
                term = throughput * emi * w_b[:, None]
                if vis_residual:
                    # the residual of term·C: sg(term)·(C − 1), exactly 0
                    # forward, term·dC backward
                    term = term.detach() * (vis_c - 1.0)
                elif vis_c is not None:
                    term = term * vis_c
                radiance = radiance + torch.where(hit3, term, 0.0)
            if not vis_residual:
                direct = nee.direct_light(lights, point, adj_n, safe, us[2],
                                          us[3], us[4], cfg, hit_albedo=alb,
                                          table=table)
                radiance = radiance + torch.where(hit3, throughput * direct,
                                                  0.0)
            if cfg.vis_grad:
                # the shadow boundary's edge-sampled term, exactly 0
                # forward; its draws sit after the roulette slot
                ei = 5 + (1 if cfg.rr_start else 0)
                bnd = nee_boundary_term(
                    verts, lights, point_diff if vis_residual else point,
                    adj_n, alb, safe, us[2], us[ei], us[ei + 1], cfg, hit,
                    table)
                thr_b = throughput.detach() if vis_residual else throughput
                radiance = radiance + torch.where(hit3, thr_b * bnd, 0.0)
        elif vis_residual:
            if vis_c is not None:
                term = (throughput * emi).detach() * (vis_c - 1.0)
                radiance = radiance + torch.where(hit3, term, 0.0)
        else:
            term = throughput * emi
            if vis_c is not None:
                term = term * vis_c
            radiance = radiance + torch.where(hit3, term, 0.0)
        throughput = torch.where(hit3, throughput * alb * weight[:, None],
                                 throughput)
        if vis_residual:
            throughput = throughput.detach()
            o_diff = torch.where(hit3, point_diff, o_diff)
        o = torch.where(hit3, point, o)
        d = torch.where(hit3, next_d, d)
        src = torch.where(hit, idx, src)
        alive = hit
        prev_n = adj_n if prev_n is None else torch.where(hit3, adj_n,
                                                          prev_n)
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
        if alive_fractions is not None:
            alive_fractions.append(alive.float().mean())
    return radiance, rng


def mean_radiance_geometry(geom, origins, directions, rng,
                           cfg: RenderConfig, lights=None, verts=None,
                           vis_residual: bool = False, hits_replay=None,
                           first_hit=None):
    """Mean of ``cfg.spp`` samples per ray → ``(N, 3)``; ``rng``,
    ``lights``, ``verts``, ``vis_residual`` as ``trace_geometry`` takes
    them. The camera rays' nearest hit is the same for every sample and is
    computed once, unless the caller gives it (``first_hit``, ``(dist,
    idx)``, as the compacted wavefront does). ``hits_replay`` is ``(dist
    (spp, B, N), idx (spp, B, N))``, replayed for every sweep
    (``vis_residual`` only).

    Under autograd with ``cfg.remat`` and more than 8 samples, each
    sample is checkpointed (``torch.utils.checkpoint``), as the JAX
    package's ``jax.checkpoint`` per sample: the tape holds one sample's
    walk at a time, which is recomputed in the backward pass, its draws
    too (every stream is counter-based or carried, so they are the same
    numbers). A threefry stream's key is folded with each sample's
    counter (``ThreefryRays.sample``)."""
    check_estimator(cfg)
    n, device = origins.shape[0], origins.device
    if hits_replay is not None:
        first_hit = None
    elif first_hit is None:
        src = torch.full((n,), -1, dtype=torch.int64, device=device)
        if vis_residual:
            with torch.no_grad():
                first_hit = nearest_hit_edges(
                    origins.detach(), directions.detach(),
                    *(t.detach() for t in geom[:3]), src, cfg.tri_block)
        else:
            first_hit = nearest_hit_edges(origins, directions, *geom[:3],
                                          src, cfg.tri_block)
    if cfg.nee and lights is None:
        lights = geometry_lights(geom)
    remat = cfg.remat and cfg.spp > 8 and torch.is_grad_enabled()
    accum = torch.zeros((n, 3), dtype=torch.float32, device=device)
    for s in range(cfg.spp):
        replay = None if hits_replay is None else [
            (hits_replay[0][s, b], hits_replay[1][s, b])
            for b in range(cfg.max_bounces)]
        rng_s = rng.sample(s) if cfg.rng == "threefry" else rng
        args = (geom, origins, directions, rng_s, cfg, first_hit, lights, s,
                verts, vis_residual, replay)
        if remat:
            rad, rng_s = checkpoint(trace_geometry, *args,
                                    use_reentrant=False)
        else:
            rad, rng_s = trace_geometry(*args)
        if cfg.rng == "lcg":
            rng = rng_s
        accum = accum + rad
    return accum * float(np.float32(1.0) / np.float32(cfg.spp))


def _pixel_ids(n: int, pixel_ids, device):
    if pixel_ids is None:
        return torch.arange(n, dtype=torch.int64, device=device)
    return pixel_ids.to(torch.int64)


def _scene_verts(scene: Scene):
    return scene.v0, scene.v1, scene.v2


def _stream(cfg: RenderConfig, seed, ids: torch.Tensor):
    """The counter-based stream of rays with global pixel ids ``ids``
    under the frame seed ``seed`` (a threefry key's two words too):
    ``trace_geometry``'s ``rng`` for every sample."""
    if cfg.rng == "hash":
        return fmix32(hash_keys(int(seed), ids))
    if cfg.rng == "threefry":
        return ThreefryRays(threefry_key(seed), ids)
    return TableRays(table_tensor(cfg.table_size, ids.device), ids,
                     int(seed))


def trace_radiance(scene: Scene, origins, directions, cfg: RenderConfig,
                   rng_state, pixel_ids=None, sample_idx: int = 0,
                   vis_residual: bool = False, hits_replay=None,
                   return_aux: bool = False):
    """Trace ONE sample per ray. Returns ``(radiance (N, 3), rng_state)``:
    for ``rng="lcg"`` ``rng_state`` holds the rays' int64 LCG seeds and
    advances; for the counter-based streams it is the frame seed (for
    ``threefry`` a seed or a key's two words, already folded with the
    sample, as the JAX package's per-sample state), keyed with the rays'
    global ``pixel_ids`` (default ``arange(N)``) and the counter
    ``sample_idx``. ``vis_residual`` and ``hits_replay`` (one ``(dist,
    idx)`` a bounce) as ``trace_geometry`` takes them. ``return_aux`` adds
    ``{"alive_fraction": (max_bounces,) float32}``, each bounce's share of
    rays still alive after it."""
    check_estimator(cfg)
    check_method(cfg.intersect)
    geom = scene_geometry(scene)
    lights = geometry_lights(geom) if cfg.nee else None
    fractions = [] if return_aux else None
    kw = dict(lights=lights, verts=_scene_verts(scene),
              vis_residual=vis_residual, hits_replay=hits_replay,
              alive_fractions=fractions)
    if cfg.rng == "lcg":
        rad, rng_state = trace_geometry(geom, origins, directions,
                                        rng_state, cfg, **kw)
    else:
        ids = _pixel_ids(origins.shape[0], pixel_ids, origins.device)
        rad, _ = trace_geometry(geom, origins, directions,
                                _stream(cfg, rng_state, ids), cfg,
                                sample=sample_idx, **kw)
    if return_aux:
        return rad, rng_state, {"alive_fraction": torch.stack(fractions)}
    return rad, rng_state


def trace_mean_radiance(scene: Scene, origins, directions,
                        cfg: RenderConfig, seed=0, pixel_ids=None,
                        vis_residual: bool = False, hits_replay=None,
                        first_hit=None):
    """Average ``cfg.spp`` samples per ray → ``(N, 3)``. LCG streams start
    at each ray's pixel index plus ``seed``; the hash and table streams
    are keyed by ``seed`` and the pixel index, the threefry stream by the
    key ``seed`` makes (or ``seed`` itself, a key's two words), folded
    with each sample, then the pixel index. ``vis_residual``,
    ``hits_replay`` (``(dist (spp, B, N), idx (spp, B, N))``) and
    ``first_hit`` (the rays' nearest hit, ``(dist, idx)``) as
    ``trace_geometry`` and ``mean_radiance_geometry`` take them."""
    check_estimator(cfg)
    check_method(cfg.intersect)
    n, device = origins.shape[0], origins.device
    ids = _pixel_ids(n, pixel_ids, device)
    if cfg.rng == "lcg":
        rng = lcg_seeds(seed, ids)
    else:
        rng = _stream(cfg, seed, ids)
    return mean_radiance_geometry(scene_geometry(scene), origins,
                                  directions, rng, cfg,
                                  verts=_scene_verts(scene),
                                  vis_residual=vis_residual,
                                  hits_replay=hits_replay,
                                  first_hit=first_hit)


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


def render_radiance_compact(scene: Scene, camera: Camera, cfg: RenderConfig,
                            seed: int = 0) -> torch.Tensor:
    """The compacted wavefront: ``render_radiance``'s frame, tracing only
    the pixels whose camera ray hits a triangle
    (``spath_tpu/models/pathtracer.py::render_radiance_compact``).

    A camera ray that misses contributes exactly zero for every sample
    and bounce, and every stream is keyed by the global pixel id, so the
    frame is bit-equal to the whole wavefront's. The first-hit sweep over
    all camera rays (K5 on the card) is the one the wavefront does
    anyway; the live pixels go through ``trace_mean_radiance`` with their
    first hit given, and come back by a gather. One host scalar, the live
    count, crosses a call. Forward only, detached: differentiate
    ``render_radiance``."""
    _check_devices(scene, camera)
    with torch.no_grad():
        origins, directions = generate_rays(camera, cfg.width, cfg.height)
        n = origins.shape[0]
        src = torch.full((n,), -1, dtype=torch.int64, device=origins.device)
        dist0, idx0 = nearest_hit(origins, directions, scene.v0, scene.v1,
                                  scene.v2, src, cfg)
        live = idx0 >= 0
        (sel,) = torch.nonzero(live, as_tuple=True)
        n_live = sel.shape[0]
        if n_live == 0:
            return torch.zeros((cfg.height, cfg.width, 3),
                               dtype=torch.float32, device=origins.device)
        mean = trace_mean_radiance(scene, origins[sel], directions[sel], cfg,
                                   seed, sel,
                                   first_hit=(dist0[sel], idx0[sel]))
        take = torch.where(live, torch.cumsum(live, 0) - 1, n_live)
        ext = torch.cat([mean, mean.new_zeros((1, 3))])
        return ext.index_select(0, take).reshape(cfg.height, cfg.width, 3)


#: Pixels of one slice of the residual's backward pass: its tape holds
#: one slice at a time (the JAX package's ``_VIS_CHUNK``).
VIS_CHUNK = 262144


class _VisResidual(torch.autograd.Function):
    """The visibility residual of ``cfg.spp`` samples per ray, ``(N, 3)``:
    the forward value is exactly zero, so it returns zeros without
    tracing; the backward replays the residual walk
    (``trace_mean_radiance(vis_residual=True)``) slice by slice of
    ``VIS_CHUNK`` rays, keyed by their global pixel ids, and adds each
    slice's gradient. The tape holds one slice, as the JAX package's
    ``jax.checkpoint``-ed ``lax.map`` over slices bounds it (and, above 8
    samples with ``cfg.remat``, one sample of it)."""

    @staticmethod
    def forward(ctx, origins, directions, vertices, albedo, emission, cfg,
                seed, hits, light_idx):
        ctx.save_for_backward(origins, directions, vertices, albedo,
                              emission)
        ctx.cfg, ctx.seed, ctx.hits, ctx.light_idx = cfg, seed, hits, \
            light_idx
        return origins.new_zeros((origins.shape[0], 3))

    @staticmethod
    def backward(ctx, gout):
        origins, directions, vertices, albedo, emission = ctx.saved_tensors
        cfg, hits = ctx.cfg, ctx.hits
        n = origins.shape[0]
        grads = [torch.zeros_like(t) for t in (origins, vertices, albedo,
                                               emission)]
        for c0 in range(0, n, VIS_CHUNK):
            c1 = min(n, c0 + VIS_CHUNK)
            with torch.enable_grad():
                o = origins[c0:c1].detach().requires_grad_()
                leaves = [t.detach().requires_grad_()
                          for t in (vertices, albedo, emission)]
                scene = Scene(*leaves, ctx.light_idx)
                replay = None if hits is None else (
                    hits[0][:, :, c0:c1], hits[1][:, :, c0:c1])
                ids = torch.arange(c0, c1, dtype=torch.int64,
                                   device=origins.device)
                out = trace_mean_radiance(scene, o, directions[c0:c1], cfg,
                                          ctx.seed, ids, vis_residual=True,
                                          hits_replay=replay)
                parts = torch.autograd.grad(out, [o, *leaves],
                                            gout[c0:c1], allow_unused=True)
            grads[0][c0:c1] = 0.0 if parts[0] is None else parts[0]
            for g, part in zip(grads[1:], parts[1:]):
                if part is not None:
                    g += part
        return (grads[0], None, *grads[1:], None, None, None, None)


def render_vis_residual(scene: Scene, camera: Camera, cfg: RenderConfig,
                        seed: int = 0, hits=None) -> torch.Tensor:
    """The visibility-gradient residual image ``(H, W, 3)``: its value is
    exactly zero, and its gradient is that of the warped-area (light
    silhouette) and edge-sampled (shadow boundary) terms of ``vis_grad``,
    the exact complement of the interior gradient the kernels compute, so

        grad(interior + render_vis_residual) == grad(render_radiance)

    with ``cfg.vis_grad`` (``trace_geometry``'s ``vis_residual``;
    ``VisGradFusedRenderer`` routes by it). The walk replays detached,
    only the O(1)-a-lane visibility chains are differentiated, in slices
    of ``VIS_CHUNK`` pixels (``_VisResidual``). ``hits`` is ``(dist (spp,
    B, N), idx (spp, B, N))``, the hits of the interior's own walk
    (``ops/kernels/bigscene_quality.py``: ``render_bigscene_quality_with_hits``):
    then only the NEE shadow-boundary edge rays are swept."""
    if not cfg.vis_grad:
        raise ValueError("render_vis_residual needs cfg.vis_grad")
    check_estimator(cfg)
    check_method(cfg.intersect)
    _check_devices(scene, camera)
    origins, directions = generate_rays(camera, cfg.width, cfg.height)
    out = _VisResidual.apply(origins, directions, scene.vertices,
                             scene.albedo, scene.emission, cfg, seed, hits,
                             scene.light_idx)
    return out.reshape(cfg.height, cfg.width, 3)


def render_pt(scene: Scene, camera: Camera, cfg: RenderConfig,
              seed: int = 0) -> torch.Tensor:
    """Path-traced frame with the reference's final clamp, float32
    ``(H, W, 3)`` in [0, 1]."""
    return torch.clamp(render_radiance(scene, camera, cfg, seed), 0.0, 1.0)


def render_radiance_fastgrad(scene: Scene, camera: Camera,
                             cfg: RenderConfig, seed: int = 0, mesh=None,
                             require_jittable: bool = False
                             ) -> torch.Tensor:
    """Differentiable unclamped radiance ``(H, W, 3)``: the same value and
    the same detached-sampling gradients as ``render_radiance``, from the
    fastest backend with a gradient path (``models/renderer.py``). On a
    CUDA device the forward is a fused kernel (K1, or K3 for the quality
    estimator) or, on large scenes, a streamed one (K6, K9), and the
    backward its hand-written reverse sweep (K2, K4; K8 or K10 with the
    scatter K7); with ``cfg.vis_grad`` that interior plus
    ``render_vis_residual``, whose sweeps are K5 (K11 the interior's
    forward on large quality scenes at up to 8 spp); what no fused kernel
    takes, autograd of the wavefront with its sweeps on K5; on the CPU,
    autograd of the wavefront. Above the streamed kernels' 2^20 triangles
    it raises ``NotImplementedError``. With a ``mesh``
    (``spath_tpu_torch.parallel``) every rank of it traces its block of
    pixels and gets the whole frame, and the gradients are summed over
    the ranks (``parallel/shard_fast.py``). A compacted kernel pair
    takes the call where this camera's plan is cached
    (``CompactFusedRenderer``), as the JAX package's eager calls may;
    ``require_jittable`` keeps it off, as a traced JAX call is kept off
    it: a train step passes it."""
    if mesh is not None:
        from spath_tpu_torch.parallel.shard_fast import (
            render_radiance_fastgrad_sharded,
        )

        return render_radiance_fastgrad_sharded(scene, camera, cfg, seed,
                                                mesh)
    from spath_tpu_torch.models.renderer import grad_renderer

    _check_devices(scene, camera)
    return grad_renderer(
        scene, cfg, require_jittable=require_jittable,
        camera=camera).render_radiance_grad(scene, camera, cfg, seed)


def render_pt_fast(scene: Scene, camera: Camera, cfg: RenderConfig,
                   seed: int = 0, mesh=None) -> torch.Tensor:
    """The serving path: the clamped frame from the fastest renderer that
    renders ``(scene, cfg)`` exactly (``models/renderer.py``): a fused
    CUDA kernel on a CUDA device (K1 conformance, K3 quality) or, on large
    scenes, a streamed one (K6, K9), ``vis_grad`` or not; for other
    estimators the wavefront with its sweeps on K5; on the CPU the
    wavefront. Above the streamed kernels' 2^20 triangles it raises
    ``NotImplementedError``. A compacted kernel takes the call where
    this camera's plan is cached (``CompactFusedRenderer``), as the JAX
    package's eager calls may. With a ``mesh`` every rank of it renders
    its block of pixels on the same route, never compacted, and gets the
    whole frame (``parallel/shard_fast.py``)."""
    if mesh is not None:
        from spath_tpu_torch.parallel.shard_fast import render_pt_fast_sharded

        return render_pt_fast_sharded(scene, camera, cfg, seed, mesh)
    from spath_tpu_torch.models.renderer import forward_renderer

    _check_devices(scene, camera)
    return forward_renderer(scene, cfg, require_jittable=False,
                            camera=camera).render(scene, camera, cfg, seed)
