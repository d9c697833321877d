"""The fused kernel's hand-written reverse sweep (K2) and its autograd
Function.

The port of ``spath_tpu/ops/pallas/megakernel_grad.py``: one launch of
``csrc/megakernel_grad.cu`` replays K1's walk for every sample and runs
the analytic reverse sweep, accumulating the adjoint of the scene table's
shading columns (normal, albedo, emission) without ever materialising a
per-bounce tensor. ``MegaRows`` puts K1 forward and K2 backward under
``torch.autograd``, in place of the JAX package's ``mega_rows`` custom
VJP, and ``render_radiance_mega`` is the differentiable render through
them.

Gradient semantics are those of the wavefront's detached sampling
(``models/pathtracer.py``): hit positions never enter a continuous
quantity of the conformance estimator, so the table's vertex and edge
columns (0-8) and the camera rays get exact zeros, as the JAX kernel's
``position_chain=False`` gives them.

Layouts (all contiguous): the rays, seeds and ``(T, 18)`` table of K1
(``ops/kernels/megakernel.py``), ``gbar`` float32 ``(n, 3)``, the
cotangent of K1's output; the result is the ``(T, 18)`` table cotangent.

``mega_bwd_call`` launches K2 for CUDA tensors and counts each launch in
``mega_bwd_call.launches``; for CPU tensors it computes the same function
with ``mega_bwd_plain``, the plain PyTorch version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from spath_tpu_torch.camera import Camera
from spath_tpu_torch.config import RenderConfig
from spath_tpu_torch.ops.intersect import nearest_hit_edges, plain_sweep
from spath_tpu_torch.ops.kernels import megakernel
from spath_tpu_torch.ops.kernels.build import library
from spath_tpu_torch.ops.rng import lcg_next
from spath_tpu_torch.ops.sampling import angle_sample, dot3
from spath_tpu_torch.scene import Scene

#: The JAX kernel's switch from unrolled masked adds to its MXU scatter.
#: K2 has one accumulation for every T; the tests use this to reach the
#: JAX package's scatter mode.
GRAD_UNROLL_TRIS = 64
#: Largest scene K2 takes: each of a block's 4 warps keeps a (T, 9)
#: float32 slice in shared memory, 144 KiB at T = 1024, inside the 227 KB
#: a Hopper block may use. Equal to K1's ``MAX_TRIS``.
GRAD_MAX_TRIS = 1024
#: Longest path K2 replays: it keeps per-bounce state in fixed arrays of
#: ``MAX_BOUNCES`` (``csrc/megakernel_common.cuh``: ``Saved``,
#: ``kMaxBounces``). Deeper gradients go to the wavefront.
MAX_BOUNCES = 64
#: The adjoint columns of the table: normal, albedo, emission.
ADJ_COLS = slice(9, 18)


def supported_grad(scene: Scene, cfg: RenderConfig) -> bool:
    """Do K1 and K2 differentiate ``(scene, cfg)``? Not with
    ``vis_grad``: its residual is ``VisGradFusedRenderer``'s, as in the
    JAX package's ``supported_grad``.

    Which scenes the router gives K2 and which the streamed backward K8
    is ``models/renderer.py``'s ``GRAD_ROUTE_MAX_TRIS``."""
    return (megakernel.supported(scene, cfg) and not cfg.vis_grad
            and scene.n_tris <= GRAD_MAX_TRIS
            and cfg.max_bounces <= MAX_BOUNCES)


def replay(origins, directions, seeds, tri, cfg: RenderConfig):
    """K1's walk as K2 replays it, one sample at a time: yields for each
    sample the list, bounce by bounce, of ``(hit, idx, fs, om, w, tr)``,
    the hit mask, the triangle hit (0 on a miss), the normal's flip sign,
    the sampled direction and its weight, and the throughput before the
    bounce. The camera rays' nearest hit is swept once for all samples,
    and bounce ``b + 1`` sweeps the rays that hit at bounce ``b``."""
    v0, e1, e2 = tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]
    nrm, alb = tri[:, 9:12], tri[:, 12:15]
    n, device = origins.shape[0], origins.device
    src0 = torch.full((n,), -1, dtype=torch.int64, device=device)
    first = nearest_hit_edges(origins, directions, v0, e1, e2, src0,
                              cfg.tri_block)
    for _ in range(cfg.spp):
        o, d, src = origins, directions, src0
        alive = torch.ones(n, dtype=torch.bool, device=device)
        tr = torch.ones((n, 3), dtype=torch.float32, device=device)
        saved = []
        for bounce in range(cfg.max_bounces):
            dist, idx = first if bounce == 0 else nearest_hit_edges(
                o, d, v0, e1, e2, src, cfg.tri_block)
            hit = alive & (idx >= 0)
            safe = idx.clamp_min(0)
            flip = dot3(nrm[safe], d) > 0.0
            fs = torch.where(flip, -1.0, 1.0)
            adj_n = nrm[safe] * fs[:, None]
            s1, u1 = lcg_next(seeds)
            s2, u2 = lcg_next(s1)
            seeds = torch.where(hit, s2, seeds)
            om, w = angle_sample(adj_n, u1, u2)
            saved.append((hit, safe, fs, om, w, tr))
            hit3 = hit[:, None]
            tr = torch.where(hit3, tr * alb[safe] * w[:, None], tr)
            o = torch.where(hit3, o + dist[:, None] * d, o)
            d = torch.where(hit3, om, d)
            src = torch.where(hit, idx, src)
            alive = hit
        yield saved


def mega_bwd_plain(origins, directions, seeds, tri, gbar,
                   cfg: RenderConfig) -> torch.Tensor:
    """The plain PyTorch version of K2, and of the streamed backward K8
    with its scatter K7 (it takes a table of any size): an explicit
    reverse sweep over the
    table's columns, vectorised over rays, one sample at a time (the
    forward state from ``replay``), with ``index_add_`` into the
    ``(T, 9)`` adjoint per (sample, bounce), in the order of operations of
    the JAX package's ``_bwd_tile``. Returns the ``(T, 18)`` table
    cotangent; columns 0-8 are zero.

    The adjoint accumulates in float64: a float32 running sum of a
    frame's 10⁸-10⁹ terms drops every term below half an ulp of the sum
    (at 1920×1080, 64 spp the largest entry is ~3×10⁵, whose float32 ulp
    is 0.03, while single terms are ~10⁻²)."""
    with torch.no_grad(), plain_sweep():
        alb, emi = tri[:, 12:15], tri[:, 15:18]
        n, device = origins.shape[0], origins.device
        g = gbar * float(np.float32(1.0) / np.float32(cfg.spp))
        adj = torch.zeros((tri.shape[0], 9), dtype=torch.float64,
                          device=device)
        for saved in replay(origins, directions, seeds, tri, cfg):
            # reverse sweep; bb is the adjoint of the throughput after the
            # bounce (the JAX kernel's tb)
            bb = torch.zeros((n, 3), dtype=torch.float32, device=device)
            for hit, safe, fs, om, w, tr in reversed(saved):
                a, e = alb[safe], emi[safe]
                p = bb * tr * a
                wbar = p[:, 0] + p[:, 1] + p[:, 2]
                nbar = (2.0 * wbar * fs)[:, None] * om
                abar = bb * tr * w[:, None]
                ebar = g * tr
                bb = torch.where(hit[:, None], g * e + bb * a * w[:, None],
                                 bb)
                contrib = torch.cat([nbar, abar, ebar], 1)[hit]
                adj.index_add_(0, safe[hit], contrib.double())
        out = torch.zeros_like(tri)
        out[:, ADJ_COLS] = adj.float()
        return out


def _check(origins, directions, seeds, tri, gbar, cfg: RenderConfig,
           max_tris: int = GRAD_MAX_TRIS) -> None:
    """K1's checks with a cap of ``max_tris`` rows, the cotangent's and
    the cap on the path length (the streamed backward K8 shares them)."""
    megakernel._check(origins, directions, seeds, tri, cfg, max_tris)
    n = origins.shape[0]
    if gbar.dtype != torch.float32 or tuple(gbar.shape) != (n, 3):
        raise ValueError(f"gbar must be float32 ({n}, 3), got {gbar.dtype} "
                         f"{tuple(gbar.shape)}")
    if gbar.device != origins.device:
        raise ValueError("gbar must be on the rays' device")
    if cfg.max_bounces > MAX_BOUNCES:
        raise ValueError(f"max_bounces={cfg.max_bounces} above the "
                         f"backward kernels' {MAX_BOUNCES}")


def mega_bwd_call(origins, directions, seeds, tri, gbar,
                  cfg: RenderConfig) -> torch.Tensor:
    """The ``(T, 18)`` table cotangent of K1's output for the cotangent
    ``gbar`` (layouts in the module docstring); columns 0-8 are zero.
    Launches K2 on CUDA tensors, on PyTorch's current stream and without
    synchronising; a failed build or launch raises. CPU tensors take
    ``mega_bwd_plain``."""
    gbar = gbar.contiguous()
    _check(origins, directions, seeds, tri, gbar, cfg)
    if origins.device.type == "cpu":
        return mega_bwd_plain(origins, directions, seeds, tri, gbar, cfg)
    if origins.device.type != "cuda":
        raise ValueError(f"no backward kernel for device {origins.device}")
    n, n_tris = origins.shape[0], tri.shape[0]
    out = torch.zeros_like(tri)
    if n == 0:
        return out
    lib = library()
    grid = lib.spath_megakernel_backward_grid(n)
    partial = torch.empty((grid, n_tris * 9), dtype=torch.float32,
                          device=origins.device)
    with torch.cuda.device(origins.device):
        stream = torch.cuda.current_stream(origins.device).cuda_stream
        err = lib.spath_megakernel_backward(
            ctypes.c_void_p(origins.data_ptr()),
            ctypes.c_void_p(directions.data_ptr()),
            ctypes.c_void_p(seeds.data_ptr()),
            ctypes.c_void_p(tri.data_ptr()),
            ctypes.c_void_p(gbar.data_ptr()),
            ctypes.c_void_p(partial.data_ptr()),
            n, n_tris, cfg.spp, cfg.max_bounces,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"backward megakernel launch failed: CUDA error "
                           f"{err} ({lib.spath_error_string(err).decode()})")
    mega_bwd_call.launches += 1
    out[:, ADJ_COLS] = partial.sum(0).view(n_tris, 9)
    return out


mega_bwd_call.launches = 0


class MegaRows(torch.autograd.Function):
    """K1 forward, K2 backward: ``MegaRows.apply(tri, origins, directions,
    seeds, cfg)`` is the ``(n, 3)`` mean radiance, differentiable in the
    table. The camera rays get zero cotangents, as the JAX package's
    ``_mega_rows_bwd`` gives them."""

    @staticmethod
    def forward(ctx, tri, origins, directions, seeds, cfg):
        ctx.save_for_backward(tri, origins, directions, seeds)
        ctx.cfg = cfg
        return megakernel.mega_call(origins, directions, seeds, tri, cfg)

    @staticmethod
    def backward(ctx, gbar):
        tri, origins, directions, seeds = ctx.saved_tensors
        gtri = mega_bwd_call(origins, directions, seeds, tri, gbar, ctx.cfg)
        return (gtri, torch.zeros_like(origins),
                torch.zeros_like(directions), None, None)


def render_radiance_mega(scene: Scene, camera: Camera, cfg: RenderConfig,
                         seed: int = 0) -> torch.Tensor:
    """Differentiable fused render: unclamped mean radiance ``(H, W, 3)``,
    the value of ``render_radiance_megakernel``, with gradients to the
    scene's vertices (through the table's normals), albedo and emission,
    and zeros to the camera. Raises ``ValueError`` outside the
    conformance estimator or the kernels' limits."""
    if not supported_grad(scene, cfg):
        raise ValueError("megakernel VJP supports lcg+angle, "
                         f"T <= {GRAD_MAX_TRIS}, "
                         f"max_bounces <= {MAX_BOUNCES}")
    o, d, seeds = megakernel.pack_rays(camera, cfg, seed)
    out = MegaRows.apply(megakernel.scene_table(scene), o, d, seeds, cfg)
    return out.reshape(cfg.height, cfg.width, 3)
