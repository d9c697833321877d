"""Whole-frame quality path tracer for large scenes in one CUDA launch
(K9).

The port of ``spath_tpu/ops/pallas/megakernel_bigscene_quality.py``
(``_bigq_kernel``, ``bigq_call``, ``render_radiance_bigscene_quality``):
K3's walk (``ops/kernels/megakernel_quality.py``: hash draws, cosine
sampler, NEE with MIS, Russian roulette, stratification) with the
nearest-hit sweeps streamed through shared memory in blocks of 256
triangles (the shadow ray and the next bounce's ray tested against each
block together) and the light chosen by a binary search of the cdf at the
light rows, so the scene may hold up to ``BIGQ_MAX_TRIS`` triangles. The
kernel is ``csrc/bigscene_quality.cu``; its walk, K3's, is in
``csrc/quality_walk.cuh`` and its sweeps in ``csrc/stream_sweep.cuh``.

Layouts, as the wrapper checks them (all contiguous):

- ``origins``, ``directions`` float32 ``(n, 3)`` and ``keys`` int64
  ``(n,)``, as ``megakernel_quality.pack_rays`` gives them;
- ``tri``: the float32 ``(T, 21)`` quality table of
  ``megakernel_quality.quality_table``, ``1 <= T <= BIGQ_MAX_TRIS``;
- ``light_idx``: int32 ``(L,)``, the ascending light rows, at most
  ``LIGHT_MAX`` (``static_light_idx``; ``None`` takes every row); the
  wrapper gathers the table's cdf at those rows on the device;
- output: float32 ``(n, 3)``, the mean radiance.

K9 computes K3's function with the same arithmetic: it equals K3 to the
bit at T <= 1024 and ``megakernel_quality.quality_plain``, its plain
version, at every T, whichever lane runs which pixel: like K6 it runs a
queue of pixels on a persistent grid (``bigscene.queue_grid`` of its own
resident CTAs) and starts a pixel's next sample in a lane as soon as a
path ends, so that its CTA-wide sweeps test live rays
(``quality_sweep_totals`` counts each pixel's sweeps for
``bigscene.lane_schedules``). The JAX kernel's sublane-chunked light table and
its one-hot MXU row fetch are a TPU layout; the port reads the table's rows by
index. Where ``u`` lies at or above the cdf at every light, the light is the
last row, as in the wavefront and K3 (``select_light_plain``).

``bigq_call`` launches the kernel for CUDA tensors and counts each launch
in ``bigq_call.launches``; for CPU tensors it computes the same function
with the plain version.

**K11**, the hit export (``_bigq_hits_kernel``, ``bigq_hits_call`` of the
JAX module): the same launch with an export flag, which also writes the
nearest hit ``(dist, idx)`` of every (sample, bounce) into ``(spp, B,
n)`` buffers, B = ``max_bounces``, for the visibility residual's replay
(``models/pathtracer.py``: ``render_vis_residual(hits=...)``). A bounce
the path did not reach alive, or at which it missed, holds ``(BIG, -1)``.
The radiance is K9's to the bit. ``bigq_hits_call`` counts its launches
in ``bigq_hits_call.launches``; its plain version is
``quality_hits_plain``. As in the JAX package it takes at most
``HITS_MAX_SPP`` samples: the buffers hold 8 bytes a (sample, bounce,
ray), 663 MB at 1920x1080, 5 bounces and 8 spp.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from spath_tpu_torch.camera import Camera, pixel_rays
from spath_tpu_torch.config import RenderConfig
from spath_tpu_torch.ops.intersect import BIG, plain_sweep
from spath_tpu_torch.ops.kernels import bigscene
from spath_tpu_torch.ops.kernels import megakernel_quality as mq
from spath_tpu_torch.ops.kernels.build import library
from spath_tpu_torch.ops.rng import hash_keys
from spath_tpu_torch.scene import Scene

#: Largest scene the streamed quality kernels take (the JAX package's
#: ``BIG_MAX_TRIS``): a (2^20, 21) float32 table is 88 MB.
BIGQ_MAX_TRIS = 1 << 20
#: Most lights the route takes with NEE (the JAX package's ``LIGHT_MAX``,
#: its VMEM light table's cap); the binary search itself has no cap.
LIGHT_MAX = 65536
#: Most samples the hit export takes (the JAX package's gate).
HITS_MAX_SPP = 8


def static_light_idx(scene: Scene) -> tuple[int, ...]:
    """The light set: ``scene.light_idx`` if set, else the rows whose
    emission sums above 0 (read from the scene's device)."""
    if scene.light_idx is not None:
        return tuple(int(i) for i in scene.light_idx)
    lit = scene.emission.detach().sum(-1) > 0
    return tuple(torch.nonzero(lit).flatten().tolist())


def supported(scene: Scene, cfg: RenderConfig) -> bool:
    """Does K9 render ``(scene, cfg)`` exactly? The quality estimator
    (hash + cosine) up to ``BIGQ_MAX_TRIS`` triangles and, with NEE, up to
    ``LIGHT_MAX`` lights, as the JAX package's ``supported``."""
    return (scene.n_tris <= BIGQ_MAX_TRIS and cfg.rng == "hash"
            and cfg.sampler == "cosine"
            and (not cfg.nee or len(static_light_idx(scene)) <= LIGHT_MAX))


def select_light_plain(lcdf: torch.Tensor, rows: torch.Tensor,
                       u: torch.Tensor, n_tris: int) -> torch.Tensor:
    """The kernel's light choice (``csrc/quality_walk.cuh``:
    ``search_light``), vectorised over ``u``: the upper bound of ``u`` in
    ``lcdf``, the cdf at the ascending light ``rows``, by the same binary
    search (PyTorch's loop), then ``rows[count]``, or ``n_tris - 1`` when
    ``u`` is at or above every value. Returns int64 rows."""
    n_rows = lcdf.shape[0]
    last = torch.full(u.shape, n_tris - 1, dtype=torch.int64,
                      device=u.device)
    if n_rows == 0:
        return last
    lo = torch.zeros(u.shape, dtype=torch.int64, device=u.device)
    hi = torch.full_like(lo, n_rows)
    for _ in range(n_rows.bit_length()):
        go = lo < hi
        mid = lo + ((hi - lo) >> 1)
        above = lcdf[mid.clamp(max=n_rows - 1)] > u
        lo = torch.where(go & ~above, mid + 1, lo)
        hi = torch.where(go & above, mid, hi)
    return torch.where(lo < n_rows, rows.long()[lo.clamp(max=n_rows - 1)],
                       last)


def _check(origins, directions, keys, tri, light_idx,
           cfg: RenderConfig) -> None:
    mq._check(origins, directions, keys, tri, light_idx, cfg, BIGQ_MAX_TRIS)
    n_rows = tri.shape[0] if light_idx is None else light_idx.shape[0]
    if n_rows > LIGHT_MAX:
        raise ValueError(f"{n_rows} light rows above the streamed quality "
                         f"kernels' LIGHT_MAX = {LIGHT_MAX}")


def kernel_inputs(tri, light_idx, device):
    """The light rows (every row for ``None``) and the table's cdf at
    them, on the device."""
    rows = mq._rows(light_idx, tri.shape[0], device)
    return rows, tri[:, mq.COL_CDF].detach().index_select(0, rows)


def bigq_call(origins, directions, keys, tri, light_idx,
              cfg: RenderConfig) -> torch.Tensor:
    """Mean radiance ``(n, 3)`` of ``n`` rays (layouts in the module
    docstring). Launches K9 on CUDA tensors, on PyTorch's current stream
    and without synchronising; a failed build or launch raises. CPU
    tensors take ``megakernel_quality.quality_plain``."""
    _check(origins, directions, keys, tri, light_idx, cfg)
    if origins.device.type == "cpu":
        return mq.quality_plain(origins, directions, keys, tri, light_idx,
                                cfg)
    if origins.device.type != "cuda":
        raise ValueError(f"no streamed quality kernel for device "
                         f"{origins.device}")
    n, n_tris = origins.shape[0], tri.shape[0]
    out = torch.empty((n, 3), dtype=torch.float32, device=origins.device)
    if n == 0:
        return out
    rows, lcdf = kernel_inputs(tri, light_idx, origins.device)
    grid = bigscene.queue_grid(n, origins.device, "K9")
    next_pixel = torch.zeros(1, dtype=torch.int32, device=origins.device)
    lib = library()
    with torch.cuda.device(origins.device):
        stream = torch.cuda.current_stream(origins.device).cuda_stream
        err = lib.spath_bigscene_quality_forward(
            *(ctypes.c_void_p(t.data_ptr()) for t in (
                origins, directions, keys, tri, rows, lcdf, out,
                next_pixel)),
            n, *mq.kernel_args(cfg, n_tris, rows.shape[0]), grid,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"streamed quality kernel launch failed: CUDA "
                           f"error {err} "
                           f"({lib.spath_error_string(err).decode()})")
    bigq_call.launches += 1
    return out


bigq_call.launches = 0


def quality_sweep_totals(origins, directions, keys, tri, light_idx,
                         cfg: RenderConfig) -> np.ndarray:
    """The CTA sweeps each pixel takes part in under K9's and K11's queue,
    counted with the plain replay (``quality_replay``), as an ``(n, spp +
    1)`` int64 array for ``bigscene.lane_schedules``: column 0 the camera
    sweep (1), column ``s + 1`` those of sample ``s``. With NEE a sample
    sweeps once at each bounce it enters alive and hits (its shadow ray,
    with the next ray unless the path ends there); without NEE once after
    each bounce that hits and goes on (not the last, not lost to the
    roulette: its next ray)."""
    n = origins.shape[0]
    cols = [torch.ones(n, dtype=torch.int64, device=origins.device)]
    with torch.no_grad(), plain_sweep():
        for _, saved in mq.quality_replay(origins, directions, keys, tri,
                                          light_idx, cfg):
            col = torch.zeros(n, dtype=torch.int64, device=origins.device)
            for sv in (saved if cfg.nee else saved[:-1]):
                col += sv["rrs" if not cfg.nee and "rrs" in sv
                          else "hit"].long()
            cols.append(col)
    return torch.stack(cols, 1).cpu().numpy()


def quality_hits_plain(origins, directions, keys, tri, light_idx,
                       cfg: RenderConfig):
    """The plain version of K11: ``(out (n, 3), dist (spp, B, n) float32,
    idx (spp, B, n) int32)``, ``megakernel_quality.quality_plain``'s
    radiance and the nearest hit of each (sample, bounce) of its walk
    (``quality_replay``), ``(BIG, -1)`` where the path did not enter the
    bounce alive or missed."""
    n, nb = origins.shape[0], cfg.max_bounces
    acc = torch.zeros((n, 3), dtype=torch.float32, device=origins.device)
    dist = torch.empty((cfg.spp, nb, n), dtype=torch.float32,
                       device=origins.device)
    idx = torch.empty((cfg.spp, nb, n), dtype=torch.int32,
                      device=origins.device)
    with torch.no_grad(), plain_sweep():
        for s, (rad, saved) in enumerate(mq.quality_replay(
                origins, directions, keys, tri, light_idx, cfg)):
            acc = acc + rad
            for b, sv in enumerate(saved):
                dist[s, b] = torch.where(sv["hit"], sv["dist"], BIG)
                idx[s, b] = torch.where(sv["hit"], sv["idx"], -1)
    return acc * float(np.float32(1.0) / np.float32(cfg.spp)), dist, idx


def bigq_hits_call(origins, directions, keys, tri, light_idx,
                   cfg: RenderConfig):
    """K11: ``(out (n, 3), dist (spp, B, n), idx (spp, B, n) int32)``, K9's
    mean radiance and its walk's hits (module docstring), for at most
    ``HITS_MAX_SPP`` samples. Launches K11 on CUDA tensors, on PyTorch's
    current stream and without synchronising; a failed build or launch
    raises. CPU tensors take ``quality_hits_plain``."""
    _check(origins, directions, keys, tri, light_idx, cfg)
    if cfg.spp > HITS_MAX_SPP:
        raise ValueError(f"the hit export takes spp <= {HITS_MAX_SPP}, got "
                         f"{cfg.spp}")
    if origins.device.type == "cpu":
        return quality_hits_plain(origins, directions, keys, tri, light_idx,
                                  cfg)
    if origins.device.type != "cuda":
        raise ValueError(f"no streamed quality kernel for device "
                         f"{origins.device}")
    n, n_tris, dev = origins.shape[0], tri.shape[0], origins.device
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    dist = torch.empty((cfg.spp, cfg.max_bounces, n), dtype=torch.float32,
                       device=dev)
    idx = torch.empty((cfg.spp, cfg.max_bounces, n), dtype=torch.int32,
                      device=dev)
    if n == 0:
        return out, dist, idx
    rows, lcdf = kernel_inputs(tri, light_idx, dev)
    grid = bigscene.queue_grid(n, dev, "K11")
    next_pixel = torch.zeros(1, dtype=torch.int32, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.spath_bigscene_quality_forward_hits(
            *(ctypes.c_void_p(t.data_ptr()) for t in (
                origins, directions, keys, tri, rows, lcdf, out, dist, idx,
                next_pixel)),
            n, *mq.kernel_args(cfg, n_tris, rows.shape[0]), grid,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"hit-export kernel launch failed: CUDA error "
                           f"{err} ({lib.spath_error_string(err).decode()})")
    bigq_hits_call.launches += 1
    return out, dist, idx


bigq_hits_call.launches = 0


def light_rows(scene: Scene) -> torch.Tensor:
    """The scene's static light set as the kernels take it, on its
    device (copied there once)."""
    return mq._device_rows(static_light_idx(scene), scene.n_tris,
                           scene.device)


def radiance_block(scene: Scene, origins, directions, pixel_ids,
                   cfg: RenderConfig, seed: int = 0) -> torch.Tensor:
    """Mean radiance ``(n, 3)`` through ``bigq_call`` of camera rays with
    their pixel ids in the whole frame (``megakernel_quality``'s)."""
    if not supported(scene, cfg):
        raise ValueError("the streamed quality kernel needs rng='hash', "
                         f"sampler='cosine', T <= {BIGQ_MAX_TRIS}, at most "
                         f"LIGHT_MAX = {LIGHT_MAX} lights with nee")
    return bigq_call(origins, directions, hash_keys(seed, pixel_ids),
                     mq.quality_table(scene), light_rows(scene), cfg)


def render_radiance_bigscene_quality(scene: Scene, camera: Camera,
                                     cfg: RenderConfig, seed: int = 0
                                     ) -> torch.Tensor:
    """Unclamped mean radiance ``(H, W, 3)`` through ``bigq_call``."""
    return radiance_block(scene, *pixel_rays(camera, cfg.width, cfg.height),
                          cfg, seed).reshape(cfg.height, cfg.width, 3)
