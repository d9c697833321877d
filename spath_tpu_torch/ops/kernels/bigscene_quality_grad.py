"""The streamed quality kernel's hand-written reverse sweep (K10) and its
autograd Function.

The port of ``spath_tpu/ops/pallas/megakernel_bigscene_quality.py``'s
backward (``supported_grad``, ``_bigq_bwd_kernel``, ``bigq_bwd_call``,
the custom VJP ``bigq_rows``): one launch of
``csrc/bigscene_quality_grad.cu`` per chunk of samples replays K9's walk
and runs K4's reverse sweep with the live position chain
(``csrc/quality_reverse.cuh``), writing per (sample, bounce, ray) a
surface event at the hit triangle and a light event at the light whose
NEE term counted; the stream scatter K7 (``ops/kernels/stream_scatter.py``,
at 19 columns) then adds the chunk's events into the ``(T, 19)`` adjoint,
which ``megakernel_quality_grad.grad_table_from_gtab19`` maps onto the
quality table. The camera-ray adjoint ``(n, 6)`` is summed per ray over
samples in K4's order, carried from one launch to the next.
``BigQualityRows`` puts K9 forward and K10 + K7 backward under
``torch.autograd``. K10 runs K9's queue of pixels on a persistent grid of
its own resident CTAs (``bigscene.queue_grid(..., "K10")``, one counter a
launch) and runs a sample's reverse sweep in its lane as its path ends;
each event has a fixed slot, so the gradient is the same bits whichever
lane runs which pixel (``bigscene.lane_schedules`` of each launch's
``bigscene.chunk_totals`` counts its lanes' idle share).

Chunks: a sample's events take ``n × max_bounces × 2 × EVENT_BYTES``
bytes (1.66 GB at 1920×1080 and 5 bounces); a launch takes as many
samples as fit ``EVENT_BUDGET`` bytes, at least one.

``bigq_bwd_call`` launches K10 and K7 for CUDA tensors and counts each
K10 launch in ``bigq_bwd_call.launches``; for CPU tensors it computes the
same function with ``megakernel_quality_grad.quality_bwd_plain``, the
plain version of K4, which takes any T.
"""

from __future__ import annotations

import ctypes

import torch

from spath_tpu_torch.camera import Camera, pixel_rays
from spath_tpu_torch.config import RenderConfig
from spath_tpu_torch.ops.kernels import bigscene as bs
from spath_tpu_torch.ops.kernels import bigscene_quality as bq
from spath_tpu_torch.ops.kernels import megakernel_quality as mq
from spath_tpu_torch.ops.kernels import megakernel_quality_grad as mqg
from spath_tpu_torch.ops.kernels.build import library
from spath_tpu_torch.ops.kernels.stream_scatter import stream_scatter_call
from spath_tpu_torch.ops.rng import hash_keys
from spath_tpu_torch.scene import Scene

#: Largest scene K10 takes: the forward's cap, as in the JAX package.
GRAD_MAX_TRIS = bq.BIGQ_MAX_TRIS
#: Longest path K10 replays (its saved per-bounce state), K4's cap.
MAX_BOUNCES = mqg.MAX_BOUNCES
#: Bytes of one event (an int32 index and 19 float32 adjoints; two a
#: (sample, bounce, ray)), and the most the event buffer of one launch
#: may take.
EVENT_BYTES, EVENT_BUDGET = 80, 2 << 30


def supported_grad(scene: Scene, cfg: RenderConfig) -> bool:
    """Do K9 and K10 differentiate ``(scene, cfg)``? Not with
    ``vis_grad`` (``VisGradFusedRenderer`` adds its residual)."""
    return (bq.supported(scene, cfg) and not cfg.vis_grad
            and scene.n_tris <= GRAD_MAX_TRIS
            and cfg.max_bounces <= MAX_BOUNCES)


def chunk_samples(n: int, cfg: RenderConfig) -> int:
    """Samples one K10 launch takes for ``n`` rays: as many as fit
    ``EVENT_BUDGET``, at least one, at most ``cfg.spp``."""
    per_sample = max(1, n * cfg.max_bounces) * 2 * EVENT_BYTES
    return max(1, min(cfg.spp, EVENT_BUDGET // per_sample))


def _check(origins, directions, keys, tri, light_idx, gbar,
           cfg: RenderConfig) -> None:
    bq._check(origins, directions, keys, tri, light_idx, cfg)
    n = origins.shape[0]
    if gbar.dtype != torch.float32 or tuple(gbar.shape) != (n, 3):
        raise ValueError(f"gbar must be float32 ({n}, 3), got {gbar.dtype} "
                         f"{tuple(gbar.shape)}")
    if gbar.device != origins.device:
        raise ValueError("gbar must be on the rays' device")
    if cfg.max_bounces > MAX_BOUNCES:
        raise ValueError(f"max_bounces={cfg.max_bounces} above K10's "
                         f"{MAX_BOUNCES}")
    n_events = chunk_samples(n, cfg) * cfg.max_bounces * 2 * n
    if n_events >= 2**31:
        raise ValueError(f"{n_events} events a launch overflow K7's int32 "
                         "ids")


def bigq_bwd_call(origins, directions, keys, tri, light_idx, gbar,
                  cfg: RenderConfig):
    """``(gtab19 (T, 19), grays (n, 6))``: the table and ray adjoints of
    K9's output for the cotangent ``gbar`` (K9's layouts). Launches K10
    and K7 once a chunk of samples on CUDA tensors, on PyTorch's current
    stream and without synchronising; a failed build or launch raises.
    CPU tensors take ``megakernel_quality_grad.quality_bwd_plain``."""
    gbar = gbar.contiguous()
    _check(origins, directions, keys, tri, light_idx, gbar, cfg)
    if origins.device.type == "cpu":
        return mqg.quality_bwd_plain(origins, directions, keys, tri,
                                     light_idx, gbar, cfg)
    if origins.device.type != "cuda":
        raise ValueError(f"no streamed quality backward for device "
                         f"{origins.device}")
    n, n_tris, dev = origins.shape[0], tri.shape[0], origins.device
    adj = torch.zeros((n_tris, mqg.ADJ), dtype=torch.float32, device=dev)
    grays = torch.zeros((n, 6), dtype=torch.float32, device=dev)
    if n == 0 or cfg.max_bounces == 0:
        return adj, grays
    rows, lcdf = bq.kernel_inputs(tri, light_idx, dev)
    chunk = chunk_samples(n, cfg)
    n_events = chunk * cfg.max_bounces * 2 * n
    first_dist = torch.empty(n, dtype=torch.float32, device=dev)
    first_idx = torch.empty(n, dtype=torch.int32, device=dev)
    ev_idx = torch.empty(n_events, dtype=torch.int32, device=dev)
    ev_val = torch.empty((n_events, mqg.ADJ), dtype=torch.float32,
                         device=dev)
    grid = bs.queue_grid(n, dev, "K10")
    # one queue counter a launch, all zeroed at once
    next_pixel = torch.zeros(-(-cfg.spp // chunk), dtype=torch.int32,
                             device=dev)
    lib = library()
    for launch, s0 in enumerate(range(0, cfg.spp, chunk)):
        count = min(chunk, cfg.spp - s0)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.spath_bigscene_quality_backward(
                *(ctypes.c_void_p(t.data_ptr()) for t in (
                    origins, directions, keys, tri, rows, lcdf, gbar,
                    first_dist, first_idx, grays, ev_idx, ev_val)),
                ctypes.c_void_p(next_pixel[launch:].data_ptr()),
                n, *mq.kernel_args(cfg, n_tris, rows.shape[0]), s0, count,
                grid, ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(
                f"streamed quality backward launch failed: CUDA error {err} "
                f"({lib.spath_error_string(err).decode()})")
        bigq_bwd_call.launches += 1
        used = count * cfg.max_bounces * 2 * n
        stream_scatter_call(adj, ev_idx[:used], ev_val[:used])
    return adj, grays


bigq_bwd_call.launches = 0


class BigQualityRows(torch.autograd.Function):
    """K9 forward, K10 + K7 backward: ``BigQualityRows.apply(tri, origins,
    directions, keys, light_idx, cfg)`` is the ``(n, 3)`` mean radiance,
    differentiable in the ``(T, 21)`` table and the camera rays."""

    @staticmethod
    def forward(ctx, tri, origins, directions, keys, light_idx, cfg):
        ctx.save_for_backward(tri, origins, directions, keys)
        ctx.light_idx, ctx.cfg = light_idx, cfg
        return bq.bigq_call(origins, directions, keys, tri, light_idx, cfg)

    @staticmethod
    def backward(ctx, gbar):
        tri, origins, directions, keys = ctx.saved_tensors
        gtab, grays = bigq_bwd_call(origins, directions, keys, tri,
                                    ctx.light_idx, gbar, ctx.cfg)
        return (mqg.grad_table_from_gtab19(gtab), grays[:, 0:3],
                grays[:, 3:6], None, None, None)


class BigQualityRowsHits(torch.autograd.Function):
    """K11 forward, K10 + K7 backward: ``BigQualityRowsHits.apply(tri,
    origins, directions, keys, light_idx, cfg)`` is ``(out (n, 3), dist,
    idx)``, ``BigQualityRows``' radiance, differentiable as that, with the
    hit export (``bigscene_quality.bigq_hits_call``), which is detached:
    its cotangent is ignored, as in the JAX package's ``bigq_rows_hits``."""

    @staticmethod
    def forward(ctx, tri, origins, directions, keys, light_idx, cfg):
        ctx.save_for_backward(tri, origins, directions, keys)
        ctx.light_idx, ctx.cfg = light_idx, cfg
        out, dist, idx = bq.bigq_hits_call(origins, directions, keys, tri,
                                           light_idx, cfg)
        ctx.mark_non_differentiable(dist, idx)
        return out, dist, idx

    @staticmethod
    def backward(ctx, gbar, _dist_bar, _idx_bar):
        return BigQualityRows.backward(ctx, gbar)


def render_bigscene_quality_with_hits(scene: Scene, camera: Camera,
                                      cfg: RenderConfig, seed: int = 0):
    """``(img (H, W, 3), (dist (spp, B, n), idx (spp, B, n) int32))``: the
    differentiable streamed quality radiance of
    ``render_radiance_bigscene_quality_grad`` from K11, with the detached
    hit export in pixel order that ``render_vis_residual(hits=...)``
    replays. Takes at most ``bigscene_quality.HITS_MAX_SPP`` samples."""
    if not supported_grad(scene, cfg):
        raise ValueError("the streamed quality VJP needs rng='hash', "
                         f"sampler='cosine', T <= {GRAD_MAX_TRIS}, "
                         f"max_bounces <= {MAX_BOUNCES}, at most "
                         f"LIGHT_MAX = {bq.LIGHT_MAX} lights with nee")
    o, d, keys = mq.pack_rays(camera, cfg, seed)
    out, dist, idx = BigQualityRowsHits.apply(
        mq.quality_table(scene), o, d, keys, bq.light_rows(scene), cfg)
    return out.reshape(cfg.height, cfg.width, 3), (dist, idx)


def radiance_block_grad(scene: Scene, origins, directions, pixel_ids,
                        cfg: RenderConfig, seed: int = 0) -> torch.Tensor:
    """``bigscene_quality.radiance_block``, differentiable
    (``BigQualityRows``), the rays' adjoint included."""
    if not supported_grad(scene, cfg):
        raise ValueError("the streamed quality VJP needs rng='hash', "
                         f"sampler='cosine', T <= {GRAD_MAX_TRIS}, "
                         f"max_bounces <= {MAX_BOUNCES}, at most "
                         f"LIGHT_MAX = {bq.LIGHT_MAX} lights with nee")
    return BigQualityRows.apply(mq.quality_table(scene), origins, directions,
                                hash_keys(seed, pixel_ids),
                                bq.light_rows(scene), cfg)


def render_radiance_bigscene_quality_grad(scene: Scene, camera: Camera,
                                          cfg: RenderConfig, seed: int = 0
                                          ) -> torch.Tensor:
    """Differentiable streamed quality render: unclamped mean radiance
    ``(H, W, 3)``, the value of
    ``bigscene_quality.render_radiance_bigscene_quality``, with gradients
    to the scene's vertices (through the table's edges, normals and
    areas), albedo and emission, and to the camera (through
    ``generate_rays``), for scenes up to ``GRAD_MAX_TRIS`` triangles.
    Raises ``ValueError`` outside the hash+cosine estimator or the
    kernels' limits."""
    return radiance_block_grad(
        scene, *pixel_rays(camera, cfg.width, cfg.height), cfg,
        seed).reshape(cfg.height, cfg.width, 3)
