"""Whole-frame quality path tracer in one CUDA launch (K3).

The port of ``spath_tpu/ops/pallas/megakernel_quality.py::_quality_kernel``:
the quality estimator (hash RNG, cosine sampler, next-event estimation
with MIS, Russian roulette, stratification) fused into one kernel, one
thread per ray; the kernel is ``csrc/megakernel_quality.cu`` and its walk
``csrc/quality_walk.cuh``, which the backward kernel K4 replays.

Layouts, as the wrapper checks them (all contiguous):

- ``origins``, ``directions``: float32 ``(n, 3)``, as ``generate_rays``
  gives them;
- ``keys``: int64 ``(n,)`` holding each ray's uint32 stream key
  ``seed·0x9E3779B9 + pixel`` (``ops/rng.py::hash_keys``);
- ``tri``: float32 ``(T, 21)``, rows v0, e1, e2, normal, albedo,
  emission, prob, area, cdf (``quality_table``; the JAX package's three
  pad columns are dropped), ``1 <= T <= MAX_TRIS``;
- ``light_idx``: int32 ``(L,)``, the ascending rows the light choice
  searches (``Scene.light_idx``); ``None`` searches every row, which picks
  the same light wherever the cdf does not decrease (zero-probability
  rows repeat the cdf value before them);
- output: float32 ``(n, 3)``, the mean radiance.

A lane owns a pixel and walks it one bounce a step, starting the pixel's
next sample as soon as a path ends and taking the next pixel when its
samples are done (``csrc/quality_lanes.cuh``); its warps take their
pixels from a queue on a persistent grid (``k3_grid``; measured against
runs of pixels a warp, PERF.md). ``warp_schedules`` counts the idle
lanes of the lockstep loop this replaced and of each schedule.

``quality_call`` launches the kernel for CUDA tensors and counts each
launch in ``quality_call.launches``; for CPU tensors it computes the same
function with ``quality_plain``, the plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from spath_tpu_torch.camera import Camera, pixel_rays
from spath_tpu_torch.config import RenderConfig
from spath_tpu_torch.models.pathtracer import (
    check_estimator, geometry_lights, n_draws, scene_geometry,
)
from spath_tpu_torch.ops.fp import sqrt_rn
from spath_tpu_torch.ops.intersect import nearest_hit_edges, plain_sweep
from spath_tpu_torch.ops.kernels import bigscene as bs
from spath_tpu_torch.ops.kernels.build import library
from spath_tpu_torch.ops.nee import INV_PI
from spath_tpu_torch.ops.rng import fmix32, hash_keys, key_uniforms
from spath_tpu_torch.ops.sampling import cosine_sample, dot3
from spath_tpu_torch.scene import Scene

#: Largest scene the kernel takes (the JAX kernel's SMEM table cap).
MAX_TRIS = 1024
#: Lanes of a warp, and warps of a K3 block (``kBlock`` / 32).
WARP, K3_WARPS = 32, 4
#: Columns of the quality table.
COLS = 21
COL_PROB, COL_AREA, COL_CDF = 18, 19, 20


def quality_table(scene: Scene) -> torch.Tensor:
    """``(T, 21)`` table: v0, e1, e2, normal, albedo, emission, then the
    light choice's prob, the area and the cdf. Differentiable in the
    vertices (through the edges, the normal and the area), the albedo and
    the emission; prob and cdf are detached and computed on the scene's
    device in the JAX package's CPU order (``light_cdf.light_cdf_call``:
    the total in XLA's windows of 32, the ``reduce-window`` ops of
    ``jnp.sum``'s HLO, the cdf in its scan's blocks of 16), so the table
    equals ``spath_tpu``'s ``quality_table`` on the CPU."""
    geom = scene_geometry(scene)
    lights, area = geometry_lights(geom)
    return torch.cat([*geom, lights.prob[:, None], area[:, None],
                      lights.cdf[:, None]], dim=1).contiguous()


def light_rows(scene: Scene) -> torch.Tensor | None:
    """The scene's emissive rows as the kernels take them, or ``None``.
    Raises ``ValueError`` unless they are ascending rows of the scene."""
    if scene.light_idx is None:
        return None
    return _device_rows(tuple(scene.light_idx), scene.n_tris, scene.device)


@functools.lru_cache(maxsize=64)
def _device_rows(rows: tuple, n_tris: int, device: torch.device
                 ) -> torch.Tensor:
    """``rows`` as an int32 tensor on ``device``, copied there once: a
    copy from the host waits for the device's stream, and a serving call
    or train step would otherwise make one every time."""
    _check_rows(rows, n_tris)
    return torch.tensor(rows, dtype=torch.int32, device=device)


def _check_rows(rows, n_tris: int) -> None:
    rows = list(rows)
    if any(not 0 <= r < n_tris for r in rows) \
            or any(b <= a for a, b in zip(rows, rows[1:])):
        raise ValueError(f"light_idx must be ascending rows of the "
                         f"{n_tris}-triangle table, got {rows}")


def supported(scene: Scene, cfg: RenderConfig) -> bool:
    """Does K3 render ``(scene, cfg)`` exactly?"""
    return (scene.n_tris <= MAX_TRIS and cfg.rng == "hash"
            and cfg.sampler == "cosine")


def pack_rays(camera: Camera, cfg: RenderConfig, seed: int = 0):
    """Camera → ``(origins (n, 3), directions (n, 3), keys (n,))`` on the
    camera's device."""
    o, d, ids = pixel_rays(camera, cfg.width, cfg.height)
    return o, d, hash_keys(seed, ids)


def _rows(light_idx, n_tris: int, device) -> torch.Tensor:
    if light_idx is None:
        return torch.arange(n_tris, dtype=torch.int32, device=device)
    return light_idx


def _select_light(cdf, rows, u):
    """The kernels' light choice (``csrc/quality_walk.cuh``:
    ``search_light``): ``torch.searchsorted`` of ``u`` in the cdf at the
    ascending ``rows`` (the same upper-bound loop), then that row, else
    the last triangle."""
    t, n_rows = cdf.shape[0], rows.shape[0]
    if n_rows == 0:
        return torch.full_like(u, t - 1, dtype=torch.int64)
    rows = rows.to(torch.int64)
    c = torch.searchsorted(cdf[rows].contiguous(), u, right=True)
    return torch.where(c < n_rows, rows[c.clamp(max=n_rows - 1)], t - 1)


def quality_replay(origins, directions, keys, tri, light_idx,
                   cfg: RenderConfig):
    """K3's walk in PyTorch, one sample at a time, vectorised over rays
    with masked lanes: the port of ``_make_ctx``/``_sample_walk`` over the
    table's columns in the kernel's order of operations, ``.detach()``
    where the JAX body has ``_detach``. Yields for each sample
    ``(radiance (n, 3), saved)``; ``saved`` holds per bounce what the
    reverse sweep (``megakernel_quality_grad``) reads. Differentiable in
    ``tri``, ``origins`` and ``directions``. ``vis_grad`` is dropped: it
    changes no frame, and the kernels draw no edge samples."""
    cfg = cfg.replace(vis_grad=False)
    n, device = origins.shape[0], origins.device
    v0, e1, e2 = tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]
    cdf = tri[:, COL_CDF].detach()
    rows = _rows(light_idx, tri.shape[0], device)
    use_mis = cfg.nee and cfg.mis
    src0 = torch.full((n,), -1, dtype=torch.int64, device=device)
    first = nearest_hit_edges(origins, directions, v0, e1, e2, src0,
                              cfg.tri_block)
    h1 = fmix32(keys)
    strat = float(np.float32(1.0 / cfg.spp))
    for s in range(cfg.spp):
        o, d, src = origins, directions, src0
        alive = torch.ones(n, dtype=torch.bool, device=device)
        tr = torch.ones((n, 3), dtype=torch.float32, device=device)
        rad = torch.zeros((n, 3), dtype=torch.float32, device=device)
        prev_pdf = torch.zeros(n, dtype=torch.float32, device=device)
        dist, idx = first
        saved = []
        for b in range(cfg.max_bounces):
            last = b == cfg.max_bounces - 1
            if b > 0 and not cfg.nee:
                dist, idx = nearest_hit_edges(o, d, v0, e1, e2, src,
                                              cfg.tri_block)
            hit = alive & (idx >= 0)
            hit3 = hit[:, None]
            safe = idx.clamp_min(0)
            row = tri[safe]
            nrm, alb, emi = row[:, 9:12], row[:, 12:15], row[:, 15:18]
            p = o + dist[:, None] * d
            flip = dot3(nrm, d) > 0.0
            an = torch.where(flip[:, None], -nrm, nrm)
            us = key_uniforms(h1, s, b, n_draws(cfg))

            # emitter-hit term (BSDF strategy)
            w_b = None
            if cfg.nee:
                if b == 0:
                    w_b = torch.ones_like(dist)
                elif use_mis:
                    cos_l_hit = torch.abs(dot3(nrm, d))
                    dmin = torch.clamp_max(dist, 1e6)
                    p_here = row[:, COL_PROB] / torch.clamp_min(
                        row[:, COL_AREA], 1e-20) * dmin * dmin \
                        / torch.clamp_min(cos_l_hit, 1e-6)
                    w_b = (prev_pdf * prev_pdf / torch.clamp_min(
                        prev_pdf * prev_pdf + p_here * p_here,
                        1e-30)).detach()
                else:
                    w_b = torch.zeros_like(dist)
                rad = rad + torch.where(hit3, tr * emi * w_b[:, None], 0.0)
            else:
                rad = rad + torch.where(hit3, tr * emi, 0.0)

            # cosine-weighted direction, detached
            u0 = us[0]
            if cfg.stratify and b == 0:
                u0 = (float(np.float32(s)) + u0) * strat
            nd, _ = cosine_sample(an, u0, us[1])
            nd = nd.detach()
            o_next = torch.where(hit3, p, o)
            d_next = torch.where(hit3, nd, d)
            src_next = torch.where(hit, idx, src)

            sv = dict(o=o, d=d, dist=dist, idx=safe, hit=hit, tr=tr,
                      flip=flip)
            if cfg.nee:
                li = _select_light(cdf, rows, us[2])
                lrow = tri[li]
                lv0, le1, le2 = lrow[:, 0:3], lrow[:, 3:6], lrow[:, 6:9]
                ln, lem = lrow[:, 9:12], lrow[:, 15:18]
                lprob, larea = lrow[:, COL_PROB], lrow[:, COL_AREA]
                su1 = sqrt_rn(us[3])
                b1 = 1.0 - su1
                b2 = us[4] * su1
                y = lv0 + b1[:, None] * le1 + b2[:, None] * le2
                dl = y - p
                r2 = dot3(dl, dl)
                rl = sqrt_rn(torch.clamp_min(r2, 1e-20))
                om = dl / rl[:, None]
                cos_s = dot3(an, om)
                cos_l = torch.abs(dot3(ln, om))
                with torch.no_grad():
                    _, occ = nearest_hit_edges(o_next, om, v0, e1, e2,
                                               src_next, cfg.tri_block)
                if not last:
                    nxt = nearest_hit_edges(o_next, d_next, v0, e1, e2,
                                            src_next, cfg.tri_block)
                valid = (occ == li) & (lprob > 0.0) & (cos_s > 0.0) \
                    & (li != safe)
                g = cos_s * cos_l / torch.clamp_min(r2, 1e-12)
                wgt = larea / torch.clamp_min(lprob.detach(), 1e-20)
                scale = g * wgt * INV_PI
                if use_mis:
                    p_nee = lprob / torch.clamp_min(larea, 1e-20) \
                        * torch.clamp_max(r2, 1e12) \
                        / torch.clamp_min(cos_l, 1e-6)
                    p_bsdf = torch.clamp_min(cos_s, 0.0) * INV_PI
                    misw = (p_nee * p_nee / torch.clamp_min(
                        p_nee * p_nee + p_bsdf * p_bsdf, 1e-30)).detach()
                else:
                    misw = torch.ones_like(scale)
                scale = scale * misw
                ok = hit & valid
                rad = rad + torch.where(ok[:, None],
                                        tr * alb * lem * scale[:, None], 0.0)
                sv.update(w_b=w_b, ok=ok, li=li, b1=b1, b2=b2, misw=misw)

            # advance (cosine weight 1: the pdf cancels BRDF·cosθ)
            tr = torch.where(hit3, tr * alb, tr)
            o, d, src = o_next, d_next, src_next
            alive = hit
            if cfg.rr_start and b >= cfg.rr_start and not last:
                q = torch.clamp(torch.maximum(torch.maximum(
                    tr[:, 0], tr[:, 1]), tr[:, 2]), 0.05, 1.0).detach()
                rrs = hit & (us[-1] < q)
                tr = torch.where(rrs[:, None], tr / q[:, None], tr)
                alive = rrs
                sv.update(rrs=rrs, rrq=q)
            saved.append(sv)
            if use_mis:
                prev_pdf = (torch.clamp_min(dot3(nd, an), 0.0)
                            * INV_PI).detach()
            if cfg.nee and not last:
                dist, idx = nxt
        yield rad, saved


def quality_plain(origins, directions, keys, tri, light_idx,
                  cfg: RenderConfig) -> torch.Tensor:
    """The plain PyTorch version of K3 (``quality_replay``'s mean over
    samples). Returns ``(n, 3)``. Its sweeps are the plain ``_sweep`` on
    any device (``ops/intersect.py``: ``plain_sweep``)."""
    acc = torch.zeros((origins.shape[0], 3), dtype=torch.float32,
                      device=origins.device)
    with plain_sweep():
        for rad, _ in quality_replay(origins, directions, keys, tri,
                                     light_idx, cfg):
            acc = acc + rad
    return acc * float(np.float32(1.0) / np.float32(cfg.spp))


def k3_grid(n: int, device: torch.device) -> int:
    """CTAs of a K3 launch for ``n`` rays on the CUDA ``device``: a
    persistent grid of K3's own resident CTAs (``bigscene.queue_grid``),
    whose warps take their pixels from one queue
    (``csrc/pixel_source.cuh``: ``PixelSource``)."""
    return bs.queue_grid(n, device, "K3")


def warp_schedules(totals, runs=(2, 4, 8, 16), queue_warps: int = 1
                   ) -> dict:
    """K3's warp steps (one sweep a lane a step) and idle lane share on the
    pixels of ``totals`` (``bigscene.lane_schedules``' layout: the camera
    sweep, then each sample's sweeps, ``bigscene_quality.
    quality_sweep_totals``): ``lockstep``, the loop this kernel replaced
    (a lane a pixel, a warp stepping each sample as often as its longest
    path needs); ``regeneration``, a lane running its pixel's samples back
    to back; ``runs_<k>``, a run of k chunks of 32 pixels a warp; and
    ``queue``, ``queue_warps`` warps sharing one queue."""
    sched = bs.lane_schedules(totals, WARP, queue_warps)
    out = {name: dict(warp_steps=sched[name]["cta_sweeps"],
                      idle_lane_share=sched[name]["idle_lane_share"])
           for name in ("lockstep", "regeneration", "queue")}
    n = np.asarray(totals).shape[0]
    for k in runs:
        out[f"runs_{k}"] = bs.run_schedule(
            totals, k * WARP, -(-n // (k * WARP)), WARP)
    out["useful_lane_steps"] = sched["useful_lane_sweeps"]
    return out


def _flags(cfg: RenderConfig) -> int:
    return (int(cfg.nee) | (int(cfg.nee and cfg.mis) << 1)
            | (int(cfg.stratify) << 2))


def kernel_args(cfg: RenderConfig, n_tris: int, n_rows: int) -> list:
    """The scalar arguments K3 and K4 share after ``n``."""
    return [n_tris, n_rows, cfg.spp, cfg.max_bounces, cfg.rr_start,
            _flags(cfg), ctypes.c_float(float(np.float32(1.0 / cfg.spp)))]


def _check(origins, directions, keys, tri, light_idx, cfg: RenderConfig,
           max_tris: int = MAX_TRIS) -> None:
    check_estimator(cfg)
    if cfg.rng != "hash" or cfg.sampler != "cosine":
        raise NotImplementedError(
            "the quality kernel takes rng='hash', sampler='cosine'; got "
            f"rng={cfg.rng!r}, sampler={cfg.sampler!r}")
    n = origins.shape[0] if origins.dim() == 2 else -1
    for name, rays in (("origins", origins), ("directions", directions)):
        if rays.dtype != torch.float32 or tuple(rays.shape) != (n, 3):
            raise ValueError(f"{name} must be float32 ({n}, 3), got "
                             f"{rays.dtype} {tuple(rays.shape)}")
    if keys.dtype != torch.int64 or tuple(keys.shape) != (n,):
        raise ValueError(f"keys must be int64 ({n},), got {keys.dtype} "
                         f"{tuple(keys.shape)}")
    if tri.dtype != torch.float32 or tri.dim() != 2 or tri.shape[1] != COLS:
        raise ValueError(f"tri must be float32 (T, {COLS}), got {tri.dtype} "
                         f"{tuple(tri.shape)}")
    if not 1 <= tri.shape[0] <= max_tris:
        raise ValueError(f"T={tri.shape[0]} outside [1, {max_tris}]")
    if cfg.spp < 1 or cfg.max_bounces < 0 or cfg.rr_start < 0:
        raise ValueError(f"spp={cfg.spp}, max_bounces={cfg.max_bounces}, "
                         f"rr_start={cfg.rr_start}")
    if 3 * n >= 2**31:
        raise ValueError(f"{n} rays overflow the kernel's int32 indexing")
    tensors = [origins, directions, keys, tri]
    if light_idx is not None:
        if light_idx.dtype != torch.int32 or light_idx.dim() != 1:
            raise ValueError("light_idx must be int32 (L,), got "
                             f"{light_idx.dtype} {tuple(light_idx.shape)}")
        # Reading a CUDA tensor's values back would stall the stream on
        # every launch; ``light_rows`` checks the scene's on the host.
        if light_idx.device.type == "cpu":
            _check_rows(light_idx.tolist(), tri.shape[0])
        tensors.append(light_idx)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("origins, directions, keys, tri and light_idx must "
                         "be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("origins, directions, keys, tri and light_idx must "
                         "be contiguous")


def quality_call(origins, directions, keys, tri, light_idx,
                 cfg: RenderConfig) -> torch.Tensor:
    """Mean radiance ``(n, 3)`` of ``n`` rays (layouts in the module
    docstring). Launches K3 on CUDA tensors, on PyTorch's current stream
    and without synchronising; a failed build or launch raises. CPU
    tensors take ``quality_plain``."""
    _check(origins, directions, keys, tri, light_idx, cfg)
    if origins.device.type == "cpu":
        return quality_plain(origins, directions, keys, tri, light_idx, cfg)
    if origins.device.type != "cuda":
        raise ValueError(f"no quality kernel for device {origins.device}")
    n, n_tris = origins.shape[0], tri.shape[0]
    out = torch.empty((n, 3), dtype=torch.float32, device=origins.device)
    if n == 0:
        return out
    rows = _rows(light_idx, n_tris, origins.device)
    lib = library()
    grid = k3_grid(n, origins.device)
    counter = torch.zeros(1, dtype=torch.int32, device=origins.device)
    with torch.cuda.device(origins.device):
        stream = torch.cuda.current_stream(origins.device).cuda_stream
        err = lib.spath_quality_forward(
            ctypes.c_void_p(origins.data_ptr()),
            ctypes.c_void_p(directions.data_ptr()),
            ctypes.c_void_p(keys.data_ptr()),
            ctypes.c_void_p(tri.data_ptr()),
            ctypes.c_void_p(rows.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(counter.data_ptr()),
            n, *kernel_args(cfg, n_tris, rows.shape[0]), grid,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"quality kernel launch failed: CUDA error {err} "
                           f"({lib.spath_error_string(err).decode()})")
    quality_call.launches += 1
    return out


quality_call.launches = 0


def radiance_block(scene: Scene, origins, directions, pixel_ids,
                   cfg: RenderConfig, seed: int = 0) -> torch.Tensor:
    """Mean radiance ``(n, 3)`` through ``quality_call`` of camera rays
    with their pixel ids in the whole frame, which key the hash streams:
    a block of a frame's rays gets the frame's bits."""
    if not supported(scene, cfg):
        raise ValueError("quality megakernel needs rng='hash', "
                         f"sampler='cosine', T <= {MAX_TRIS}")
    return quality_call(origins, directions, hash_keys(seed, pixel_ids),
                        quality_table(scene), light_rows(scene), cfg)


def render_radiance_quality_megakernel(scene: Scene, camera: Camera,
                                       cfg: RenderConfig, seed: int = 0
                                       ) -> torch.Tensor:
    """Unclamped mean radiance ``(H, W, 3)`` through ``quality_call``."""
    return radiance_block(scene, *pixel_rays(camera, cfg.width, cfg.height),
                          cfg, seed).reshape(cfg.height, cfg.width, 3)
