"""Whole-frame conformance path tracer for large scenes in one CUDA
launch (K6).

The port of ``spath_tpu/ops/pallas/megakernel_bigscene.py``
(``_bigscene_kernel``, ``bigscene_call``, ``render_radiance_bigscene``):
K1's walk (``ops/kernels/megakernel.py``) with the nearest-hit sweep
streamed through shared memory in blocks of 256 triangles, so the
scene may hold up to ``BIG_MAX_TRIS`` triangles. The kernel is in
``csrc/bigscene.cu``, its sweep in ``csrc/stream_sweep.cuh`` and its walk,
K1's, in ``csrc/megakernel_common.cuh``.

It takes K1's inputs: the ``(n, 3)`` rays and int64 seeds of
``megakernel.pack_rays`` and the ``(T, 18)`` table of
``megakernel.scene_table``, with ``1 <= T <= BIG_MAX_TRIS``; the output
is the ``(n, 3)`` mean radiance. The JAX kernel's Plücker feature blocks
and attribute rows (``bigscene_tables``) are a TPU layout; the port reads
the one table.

K6 computes the same function as K1 with the same arithmetic: it equals
K1 to the bit at T <= 1024 and ``megakernel.megakernel_plain``, its plain
version, at every T, whichever lane runs which pixel. (The JAX kernel's
Plücker arithmetic differs from the reference Möller–Trumbore in the
last bits, so the JAX suite holds it to its wavefront within a flip
budget.)

The kernel runs a queue of pixels on a persistent grid (``queue_plan``)
and regenerates a lane's path at once when it ends, so that its CTA-wide
sweeps test live rays (``lane_schedules`` counts the schedules).

``bigscene_call`` launches the kernel for CUDA tensors and counts each
launch in ``bigscene_call.launches``; for CPU tensors it computes the
same function with the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import heapq

import numpy as np
import torch

from spath_tpu_torch.camera import Camera, pixel_rays
from spath_tpu_torch.config import RenderConfig
from spath_tpu_torch.models.pathtracer import is_conformance
from spath_tpu_torch.ops.kernels import megakernel
from spath_tpu_torch.ops.kernels.build import library
from spath_tpu_torch.ops.rng import lcg_seeds
from spath_tpu_torch.scene import Scene

#: Largest scene the streamed kernels take (the JAX package's
#: ``BIG_MAX_TRIS``): a (2^20, 18) float32 table is 75 MB.
BIG_MAX_TRIS = 1 << 20
#: Lanes (threads) of a CTA, ``kStreamThreads`` of ``csrc/stream_sweep.cuh``.
CTA_LANES = 128


#: The kernels that run a queue of pixels on a persistent grid, and each
#: one's occupancy query in the library: its entry point and arguments.
QUEUE_KERNELS = {
    "K1": ("spath_megakernel_forward_occupancy", ()),
    "K3": ("spath_quality_forward_occupancy", ()),
    "K6": ("spath_bigscene_forward_occupancy", ()),
    "K8": ("spath_bigscene_backward_occupancy", ()),
    "K9": ("spath_bigscene_quality_forward_occupancy", (0,)),
    "K11": ("spath_bigscene_quality_forward_occupancy", (1,)),
    "K10": ("spath_bigscene_quality_backward_occupancy", ()),
}


def queue_plan(n: int, per_sm: int, sms: int) -> int:
    """CTAs of a queue kernel's persistent grid for ``n`` rays: every CTA
    of that kernel the card holds at once (``per_sm`` on each of ``sms``
    SMs), so that no CTA waits for another to end, and no more than the
    rays fill at one ray a lane. Each CTA takes pixels from the queue
    until it is empty."""
    if n < 1 or per_sm < 1 or sms < 1:
        raise ValueError(f"no grid for n={n}, {per_sm} CTAs an SM, {sms} "
                         "SMs")
    return min(per_sm * sms, -(-n // CTA_LANES))


@functools.cache
def resident_ctas(device_index: int, kernel: str) -> tuple[int, int]:
    """``(per_sm, sms)``: the CTAs of ``kernel`` (a key of
    ``QUEUE_KERNELS``) resident on one SM of the card
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, asked of that
    kernel: registers and stack differ kernel to kernel) and its SMs."""
    entry, args = QUEUE_KERNELS[kernel]
    lib = library()
    with torch.cuda.device(device_index):
        per_sm = getattr(lib, entry)(*args)
    if per_sm <= 0:
        err = lib.spath_error_string(-per_sm).decode()
        raise RuntimeError(f"{kernel} occupancy query failed: CUDA error "
                           f"{-per_sm} ({err})")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return per_sm, sms


def queue_grid(n: int, device: torch.device, kernel: str) -> int:
    """The persistent grid of ``kernel`` for ``n`` rays on the CUDA
    ``device``: ``queue_plan`` of that kernel's own resident CTAs."""
    index = device.index
    return queue_plan(n, *resident_ctas(
        torch.cuda.current_device() if index is None else index, kernel))


def lockstep_sweeps(totals, cta: int = CTA_LANES) -> int:
    """The sweeps of ``cta``-lane CTAs (or warps) of consecutive pixels in
    lockstep, on the pixels of ``totals`` (``lane_schedules``' layout): a
    CTA sweeps the camera rays once, then, sample by sample, as often as
    its longest path needs."""
    totals = np.asarray(totals, dtype=np.int64)
    pad = (-totals.shape[0]) % cta
    return int(np.pad(totals, ((0, pad), (0, 0))).reshape(
        -1, cta, totals.shape[1]).max(axis=1).sum())


def lane_schedules(totals, cta: int = CTA_LANES, ctas: int = 1) -> dict:
    """The idle share of the lanes of a streamed kernel's CTA-wide sweeps
    under three schedules, counted from the sweeps each pixel needs.
    ``totals`` is an ``(n, samples + 1)`` integer array: column 0 the
    camera sweep (1; 0 in a later chunk of K8 or K10, which read the
    camera hit back), column ``s + 1`` the sweeps of sample ``s`` after
    its camera hit (0 for every sample of a pixel whose camera ray
    missed). A lane
    that takes no part in a sweep idles through it, and a pixel with no
    sweep to make takes none.

    - ``lockstep`` (the first port): a lane a pixel, ``cta`` consecutive
      pixels a CTA (``lockstep_sweeps``);
    - ``regeneration``: the same lanes, but a lane starts its pixel's next
      sample as soon as a path ends, so the CTA sweeps as often as its
      busiest lane needs in all;
    - ``queue`` (the shipped design): ``ctas`` CTAs of ``cta`` lanes share
      one queue of the pixels in order; a lane takes the next pixel when
      its own is done (a list schedule, ties to the lowest lane), and a
      CTA sweeps until its last lane is done.

    Returns per schedule the CTA sweeps and the idle lane share,
    ``1 - useful / (cta_sweeps * cta)``, and the useful lane sweeps."""
    totals = np.asarray(totals, dtype=np.int64)
    per_pixel = totals.sum(axis=1)
    n, useful = totals.shape[0], int(per_pixel.sum())
    pad = (-n) % cta
    grid = np.pad(totals, ((0, pad), (0, 0))).reshape(-1, cta,
                                                      totals.shape[1])
    lockstep = lockstep_sweeps(totals, cta)
    regeneration = int(grid.sum(axis=2).max(axis=1).sum())
    lanes = cta * ctas
    free = [(0, lane) for lane in range(lanes)]
    finish = np.zeros(lanes, dtype=np.int64)
    for work in per_pixel.tolist():
        t, lane = heapq.heappop(free)
        finish[lane] = t + work
        heapq.heappush(free, (t + work, lane))
    queue = int(finish.reshape(ctas, cta).max(axis=1).sum())

    def share(cta_sweeps: int) -> dict:
        return dict(cta_sweeps=cta_sweeps, idle_lane_share=(
            1.0 - useful / (cta_sweeps * cta) if cta_sweeps else 0.0))

    return dict(useful_lane_sweeps=useful, lockstep=share(lockstep),
                regeneration=share(regeneration), queue=share(queue))


def run_sequences(n: int, run: int, warps: int) -> list[np.ndarray]:
    """The pixels each of ``warps`` warps takes under a fixed assignment
    of runs (``csrc/pixel_source.cuh``: ``PixelSource``): the ``n``
    pixels cut into runs of ``run`` consecutive pixels, warp ``w`` owning
    runs ``w``, ``w + warps``, ... in that order. Every pixel lies in
    exactly one warp's sequence."""
    if n < 0 or run < 1 or warps < 1:
        raise ValueError(f"no runs for n={n}, run={run}, warps={warps}")
    starts = np.arange(0, n, run)
    return [np.concatenate([np.arange(a, min(a + run, n))
                            for a in starts[w::warps]] or
                           [np.zeros(0, dtype=np.int64)]).astype(np.int64)
            for w in range(warps)]


def list_schedule(work, lanes: int) -> tuple[np.ndarray, np.ndarray]:
    """``lanes`` lanes taking the items of ``work`` in order, each lane the
    next item when its own is done, ties to the lowest lane (a warp's
    lanes taking pixels a step at a time in lane order). Returns each
    item's ``(lane, start)``."""
    free = [(0, lane) for lane in range(lanes)]
    lane_of = np.zeros(len(work), dtype=np.int64)
    start = np.zeros(len(work), dtype=np.int64)
    for i, w in enumerate(np.asarray(work, dtype=np.int64).tolist()):
        t, lane = heapq.heappop(free)
        lane_of[i], start[i] = lane, t
        heapq.heappush(free, (t + w, lane))
    return lane_of, start


def run_schedule(totals, run: int, warps: int, lanes: int = 32) -> dict:
    """A lane-per-pixel kernel's steps (one sweep a lane a step, K3's and
    K4's forward) when ``warps`` warps of ``lanes`` lanes take their pixels
    from a fixed assignment of runs of ``run`` pixels (``run_sequences``),
    a lane the next pixel of its warp's sequence when its own is done
    (``list_schedule``) and a warp stepping until its last lane is done.
    ``totals`` is ``lane_schedules``' layout. Returns the warp steps and
    the idle lane share, ``1 - useful / (steps * lanes)``."""
    totals = np.asarray(totals, dtype=np.int64)
    per_pixel = totals.sum(axis=1)
    steps = 0
    for seq in run_sequences(totals.shape[0], run, warps):
        if seq.size:
            _, start = list_schedule(per_pixel[seq], lanes)
            steps += int((start + per_pixel[seq]).max())
    useful = int(per_pixel.sum())
    return dict(warp_steps=steps, idle_lane_share=(
        1.0 - useful / (steps * lanes) if steps else 0.0))


def chunk_totals(totals, s0: int, count: int) -> np.ndarray:
    """The sweeps each pixel needs in the K8 or K10 launch that replays
    samples ``s0`` to ``s0 + count - 1`` of ``totals`` (``lane_schedules``'
    layout for the whole frame): that launch's samples' columns, after a
    camera column that only the first launch (``s0 == 0``) sweeps."""
    totals = np.asarray(totals, dtype=np.int64)
    camera = totals[:, :1] if s0 == 0 else np.zeros_like(totals[:, :1])
    return np.concatenate([camera, totals[:, 1 + s0:1 + s0 + count]], axis=1)


def supported(scene: Scene, cfg: RenderConfig) -> bool:
    """Does K6 render ``(scene, cfg)`` exactly? The conformance estimator
    (lcg + angle, no nee, ``rr_start == 0``, no stratify) up to
    ``BIG_MAX_TRIS`` triangles, as the JAX package's ``supported``. The
    intersection method is not read: only ``pallas_fast`` differs there,
    and it is an alias of the exact sweep."""
    return scene.n_tris <= BIG_MAX_TRIS and is_conformance(cfg)


def bigscene_call(origins, directions, seeds, tri, cfg: RenderConfig):
    """Mean radiance ``(n, 3)`` of ``n`` rays (K1's layouts, T up to
    ``BIG_MAX_TRIS``). Launches K6 on CUDA tensors, on PyTorch's current
    stream and without synchronising; a failed build or launch raises.
    CPU tensors take ``megakernel.megakernel_plain``."""
    megakernel._check(origins, directions, seeds, tri, cfg, BIG_MAX_TRIS)
    if origins.device.type == "cpu":
        return megakernel.megakernel_plain(origins, directions, seeds, tri,
                                           cfg)
    if origins.device.type != "cuda":
        raise ValueError(f"no streamed kernel for device {origins.device}")
    n = origins.shape[0]
    out = torch.empty((n, 3), dtype=torch.float32, device=origins.device)
    if n == 0:
        return out
    lib = library()
    grid = queue_grid(n, origins.device, "K6")
    next_pixel = torch.zeros(1, dtype=torch.int32, device=origins.device)
    with torch.cuda.device(origins.device):
        stream = torch.cuda.current_stream(origins.device).cuda_stream
        err = lib.spath_bigscene_forward(
            ctypes.c_void_p(origins.data_ptr()),
            ctypes.c_void_p(directions.data_ptr()),
            ctypes.c_void_p(seeds.data_ptr()),
            ctypes.c_void_p(tri.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(next_pixel.data_ptr()),
            n, tri.shape[0], cfg.spp, cfg.max_bounces, grid,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"streamed kernel launch failed: CUDA error {err} "
                           f"({lib.spath_error_string(err).decode()})")
    bigscene_call.launches += 1
    return out


bigscene_call.launches = 0


def radiance_block(scene: Scene, origins, directions, pixel_ids,
                   cfg: RenderConfig, seed: int = 0) -> torch.Tensor:
    """Mean radiance ``(n, 3)`` through ``bigscene_call`` of camera rays
    with their pixel ids in the whole frame (``megakernel``'s)."""
    if not supported(scene, cfg):
        raise ValueError("the streamed kernel supports lcg+angle, "
                         f"T <= {BIG_MAX_TRIS}")
    return bigscene_call(origins, directions, lcg_seeds(seed, pixel_ids),
                         megakernel.scene_table(scene), cfg)


def render_radiance_bigscene(scene: Scene, camera: Camera, cfg: RenderConfig,
                             seed: int = 0) -> torch.Tensor:
    """Unclamped mean radiance ``(H, W, 3)`` through ``bigscene_call``."""
    return radiance_block(scene, *pixel_rays(camera, cfg.width, cfg.height),
                          cfg, seed).reshape(cfg.height, cfg.width, 3)
