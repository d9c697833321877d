"""The streamed kernel's hand-written reverse sweep (K8) and its autograd
Function.

The port of ``spath_tpu/ops/pallas/megakernel_bigscene_grad.py``
(``supported_grad``, ``_bigscene_bwd_kernel``, ``bigscene_bwd_call``, the
custom VJP ``bigscene_rows`` and ``render_radiance_bigscene_grad``): one
launch of ``csrc/bigscene_grad.cu`` per chunk of samples replays K6's walk
(``csrc/megakernel_common.cuh`` through ``csrc/stream_sweep.cuh``) on K6's
schedule, a queue of pixels on a persistent grid (``bigscene.queue_grid``
of K8's own resident CTAs) with regeneration, and runs K2's reverse sweep
of each sample as it ends, writing one adjoint event per (sample,
bounce, ray) to a buffer at a fixed slot; the stream scatter K7
(``ops/kernels/stream_scatter.py``) then adds the chunk's events into the
``(T, 9)`` adjoint of the table's shading columns. ``BigRows`` puts K6
forward and K8 + K7 backward under ``torch.autograd``.

Chunks: a sample's events take ``n × max_bounces × 40`` bytes (415 MB at
1920×1080 and 5 bounces); a launch takes as many samples as fit
``EVENT_BUDGET`` bytes (at least one). The rays' LCG states and their
camera-ray hits carry from one launch to the next in buffers.

Gradient semantics are K2's (``ops/kernels/megakernel_grad.py``): the
table's vertex and edge columns (0-8) and the camera rays get exact
zeros; vertex gradients flow through the table's normals, which
``megakernel.scene_table`` builds differentiably.

``bigscene_bwd_call`` launches K8 and K7 for CUDA tensors and counts each
K8 launch in ``bigscene_bwd_call.launches``; for CPU tensors it computes
the same function with ``megakernel_grad.mega_bwd_plain``, the plain
version of K2, which takes any T.
"""

from __future__ import annotations

import ctypes

import torch

from spath_tpu_torch.camera import Camera, pixel_rays
from spath_tpu_torch.config import RenderConfig
from spath_tpu_torch.ops.kernels import bigscene, megakernel, megakernel_grad
from spath_tpu_torch.ops.kernels.build import library
from spath_tpu_torch.ops.kernels.stream_scatter import stream_scatter_call
from spath_tpu_torch.ops.rng import lcg_seeds
from spath_tpu_torch.scene import Scene

#: Largest scene K8 takes: the forward's cap, as in the JAX package.
GRAD_MAX_TRIS = bigscene.BIG_MAX_TRIS
#: Longest path K8 replays (its saved per-bounce state), K2's cap.
MAX_BOUNCES = megakernel_grad.MAX_BOUNCES
#: Bytes of one event (an int32 index and 9 float32 adjoints), and the
#: most the event buffer of one launch may take.
EVENT_BYTES, EVENT_BUDGET = 40, 2 << 30


def supported_grad(scene: Scene, cfg: RenderConfig) -> bool:
    """Do K6 and K8 differentiate ``(scene, cfg)``? Not with
    ``vis_grad`` (``VisGradFusedRenderer`` adds its residual)."""
    return (bigscene.supported(scene, cfg) and not cfg.vis_grad
            and scene.n_tris <= GRAD_MAX_TRIS
            and cfg.max_bounces <= MAX_BOUNCES)


def chunk_samples(n: int, cfg: RenderConfig) -> int:
    """Samples one K8 launch takes for ``n`` rays: as many as fit
    ``EVENT_BUDGET``, at least one, at most ``cfg.spp``."""
    per_sample = max(1, n * cfg.max_bounces) * EVENT_BYTES
    return max(1, min(cfg.spp, EVENT_BUDGET // per_sample))


def bigscene_bwd_call(origins, directions, seeds, tri, gbar,
                      cfg: RenderConfig) -> torch.Tensor:
    """The ``(T, 18)`` table cotangent of K6's output for the cotangent
    ``gbar`` (K1's layouts; T up to ``GRAD_MAX_TRIS``); columns 0-8 are
    zero. Launches K8 and K7 once a chunk of samples on CUDA tensors, on
    PyTorch's current stream and without synchronising; a failed build or
    launch raises. CPU tensors take ``megakernel_grad.mega_bwd_plain``."""
    gbar = gbar.contiguous()
    megakernel_grad._check(origins, directions, seeds, tri, gbar, cfg,
                           GRAD_MAX_TRIS)
    n = origins.shape[0]
    chunk = chunk_samples(n, cfg)
    n_events = chunk * cfg.max_bounces * n
    if n_events >= 2**31:
        raise ValueError(f"{n_events} events a launch overflow K7's int32 "
                         "ids")
    if origins.device.type == "cpu":
        return megakernel_grad.mega_bwd_plain(origins, directions, seeds,
                                              tri, gbar, cfg)
    if origins.device.type != "cuda":
        raise ValueError(f"no streamed backward for device {origins.device}")
    n_tris, dev = tri.shape[0], origins.device
    out = torch.zeros_like(tri)
    if n == 0 or cfg.max_bounces == 0:
        return out
    adj = torch.zeros((n_tris, 9), dtype=torch.float32, device=dev)
    first_dist = torch.empty(n, dtype=torch.float32, device=dev)
    first_idx = torch.empty(n, dtype=torch.int32, device=dev)
    state = torch.empty(n, dtype=torch.int32, device=dev)
    ev_idx = torch.empty(n_events, dtype=torch.int32, device=dev)
    ev_val = torch.empty((n_events, 9), dtype=torch.float32, device=dev)
    starts = range(0, cfg.spp, chunk)
    # one queue counter a launch, zeroed on the stream before the first
    next_pixel = torch.zeros(len(starts), dtype=torch.int32, device=dev)
    grid = bigscene.queue_grid(n, dev, "K8")
    lib = library()
    for k, s0 in enumerate(starts):
        count = min(chunk, cfg.spp - s0)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.spath_bigscene_backward(
                *(ctypes.c_void_p(t.data_ptr()) for t in (
                    origins, directions, seeds, tri, gbar, first_dist,
                    first_idx, state, ev_idx, ev_val, next_pixel[k])),
                n, n_tris, cfg.spp, cfg.max_bounces, s0, count, grid,
                ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(
                f"streamed backward launch failed: CUDA error {err} "
                f"({lib.spath_error_string(err).decode()})")
        bigscene_bwd_call.launches += 1
        used = count * cfg.max_bounces * n
        stream_scatter_call(adj, ev_idx[:used], ev_val[:used])
    out[:, megakernel_grad.ADJ_COLS] = adj
    return out


bigscene_bwd_call.launches = 0


class BigRows(torch.autograd.Function):
    """K6 forward, K8 + K7 backward: ``BigRows.apply(tri, origins,
    directions, seeds, cfg)`` is the ``(n, 3)`` mean radiance,
    differentiable in the table. The camera rays get zero cotangents, as
    the JAX package's ``_big_bwd`` gives them."""

    @staticmethod
    def forward(ctx, tri, origins, directions, seeds, cfg):
        ctx.save_for_backward(tri, origins, directions, seeds)
        ctx.cfg = cfg
        return bigscene.bigscene_call(origins, directions, seeds, tri, cfg)

    @staticmethod
    def backward(ctx, gbar):
        tri, origins, directions, seeds = ctx.saved_tensors
        gtri = bigscene_bwd_call(origins, directions, seeds, tri, gbar,
                                 ctx.cfg)
        return (gtri, torch.zeros_like(origins),
                torch.zeros_like(directions), None, None)


def radiance_block_grad(scene: Scene, origins, directions, pixel_ids,
                        cfg: RenderConfig, seed: int = 0) -> torch.Tensor:
    """``bigscene.radiance_block``, differentiable (``BigRows``)."""
    if not supported_grad(scene, cfg):
        raise ValueError("the streamed VJP supports lcg+angle, "
                         f"T <= {GRAD_MAX_TRIS}, "
                         f"max_bounces <= {MAX_BOUNCES}")
    return BigRows.apply(megakernel.scene_table(scene), origins, directions,
                         lcg_seeds(seed, pixel_ids), cfg)


def render_radiance_bigscene_grad(scene: Scene, camera: Camera,
                                  cfg: RenderConfig, seed: int = 0
                                  ) -> torch.Tensor:
    """Differentiable streamed render: unclamped mean radiance ``(H, W,
    3)``, the value of ``bigscene.render_radiance_bigscene``, with
    gradients to the scene's vertices (through the table's normals),
    albedo and emission, and zeros to the camera, for scenes up to
    ``GRAD_MAX_TRIS`` triangles. Raises ``ValueError`` outside the
    conformance estimator or the kernels' limits."""
    return radiance_block_grad(
        scene, *pixel_rays(camera, cfg.width, cfg.height), cfg,
        seed).reshape(cfg.height, cfg.width, 3)
