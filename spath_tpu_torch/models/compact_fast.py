"""Camera-ray compaction for the fused and streamed kernels
(``spath_tpu/models/compact_fast.py``).

A camera ray that misses every triangle contributes exactly zero for
every sample and bounce, so its pixel needs no kernel time. The plan
classifies the frame's camera rays once, packs the live rays first, and
the kernel (K1, K3, K6, K9 forward; K1+K2, K3+K4, K6+K8+K7, K9+K10+K7
for a gradient) runs on the live rays only; a gather puts the frame back
together.

Exactness. The classifier is the exact first-hit sweep,
``ops/intersect.py::nearest_hit`` (K5 on the card), not the JAX
package's ``_any_hit_relaxed``: that one needs a band of slack because
its XLA classifier and its Mosaic kernels intersect differently. Here
every forward kernel is bit-equal to its plain version on ``_sweep``,
and K5 is bit-equal to ``_sweep`` too, so a camera ray that misses under
the classifier misses under every kernel. The live set is the exact
hits, a subset of the JAX package's relaxed one; each live ray keeps its
pixel id in the whole frame, which keys its random stream, so the
compacted frame is bit-equal to the full launch's.

No lane buckets. The JAX package pads the live count to ``PAD_MULTIPLE``
and to whole kernel tiles, so that Mosaic rarely recompiles; a CUDA
launch takes any lane count, so the kernel runs on exactly ``n_live``
rays. The one host scalar is ``n_live``, read once a plan.

The plan depends on the geometry and the camera only, so it is built
once and reused across seeds (``_cached_plan``); the router takes
compaction on its own only where that plan is already cached
(``has_plan``, ``renderer.CompactFusedRenderer``). The gradient path
regenerates the rays from the camera, so that camera cotangents flow
through the permutation; its two transposes are gathers
(``_TakePrefix``, ``_UnpackRows``), never an ``index_add_``, whose
backward on the card is float atomics.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import torch

from spath_tpu_torch.camera import Camera, generate_rays
from spath_tpu_torch.config import RenderConfig
from spath_tpu_torch.ops.intersect import nearest_hit
from spath_tpu_torch.ops.kernels import (
    bigscene, bigscene_grad, bigscene_quality, bigscene_quality_grad,
    megakernel, megakernel_grad, megakernel_quality, megakernel_quality_grad,
)
from spath_tpu_torch.scene import Scene

#: each kernel route's forward and gradient modules, by the JAX
#: package's names; every module has ``radiance_block(_grad)(scene,
#: origins, directions, pixel_ids, cfg, seed)``
KERNELS = {
    "conformance": (megakernel, megakernel_grad),
    "quality": (megakernel_quality, megakernel_quality_grad),
    "bigscene": (bigscene, bigscene_grad),
    "bigscene_quality": (bigscene_quality, bigscene_quality_grad),
}


class CompactPlan(NamedTuple):
    """A (scene geometry, camera, frame size) launch plan, independent of
    the seed and of the kernel: the same plan serves every kernel route
    and the compacted wavefront.

    ``rays_p`` holds the live rays first, then the misses, each in pixel
    order; ``pix_p`` their pixel ids in the whole frame. ``sel`` maps a
    packed slot to its pixel, ``inv`` a pixel to its packed slot (the two
    are inverse permutations), ``take`` is ``min(inv, n_live)``: the row
    a pixel reads from the live rows with one zero row appended."""

    rays_p: tuple[torch.Tensor, torch.Tensor]   # (N, 3) origins, dirs
    pix_p: torch.Tensor                         # (N,) int64
    sel: torch.Tensor                           # (N,) int64
    inv: torch.Tensor                           # (N,) int64
    take: torch.Tensor                          # (N,) int64
    n_live: int


def classify(scene: Scene, origins, directions,
             cfg: RenderConfig) -> torch.Tensor:
    """``(N,)`` bool: which rays hit a triangle, by the exact first-hit
    sweep (K5 on the card)."""
    src = torch.full((origins.shape[0],), -1, dtype=torch.int64,
                     device=origins.device)
    _, idx = nearest_hit(origins, directions, scene.v0, scene.v1, scene.v2,
                         src, cfg)
    return idx >= 0


def make_compact_plan(scene: Scene, camera: Camera,
                      cfg: RenderConfig) -> CompactPlan:
    """Classify the camera rays and pack the live ones first, in the JAX
    package's cumsum form: live pixels in order, then misses in order."""
    with torch.no_grad():
        o, d = generate_rays(camera, cfg.width, cfg.height)
        live = classify(scene, o, d, cfg)
        livei = live.to(torch.int64)
        ahead = torch.cumsum(livei, 0)
        n_live = int(ahead[-1])                 # the one host scalar
        inv = torch.where(live, ahead - 1,
                          n_live + torch.cumsum(1 - livei, 0) - 1)
        sel = torch.empty_like(inv)
        sel[inv] = torch.arange(inv.shape[0], dtype=torch.int64,
                                device=inv.device)
        # a pixel's id is its index, so the packed pixel ids are ``sel``
        return CompactPlan((o[sel], d[sel]), sel, sel, inv,
                           inv.clamp(max=n_live), n_live)


def _select_kernel(scene: Scene, cfg: RenderConfig) -> str | None:
    """The kernel route (a ``KERNELS`` name) the router gives ``(scene,
    cfg)``'s forward, whatever the device: ``renderer.kernel_route``."""
    from spath_tpu_torch.models.renderer import kernel_route

    return kernel_route(scene, cfg)


def _select_kernel_grad(scene: Scene, cfg: RenderConfig) -> str | None:
    """``_select_kernel`` for a gradient."""
    from spath_tpu_torch.models.renderer import kernel_route

    return kernel_route(scene, cfg, grad=True)


def supported(scene: Scene, cfg: RenderConfig) -> bool:
    """Does a kernel route render ``(scene, cfg)`` compacted?"""
    return _select_kernel(scene, cfg) is not None


def supported_grad(scene: Scene, cfg: RenderConfig) -> bool:
    """Does a kernel route differentiate ``(scene, cfg)`` compacted?"""
    return _select_kernel_grad(scene, cfg) is not None


#: The plan cache: a FIFO of at most ``_PLAN_CACHE_MAX`` plans, each
#: entry ``[fast key, its tensors, value key, plan]``. The fast key is
#: every input tensor's ``(id, data_ptr, _version)``, with the tensors
#: held so that the ids stay theirs: an in-place change (``add_``, an
#: optimiser step) bumps the version and misses. On a miss the value key,
#: a hash of the bytes of the vertices and the camera (a sync and a copy
#: to the host), finds the plan of an equal rebuilt Scene and Camera,
#: whose entry then takes the new fast key. The plan reads no albedo,
#: emission, light list, sampling setting or kernel, so none of them is
#: in a key.
_PLAN_CACHE: list = []
_PLAN_CACHE_MAX = 8


def _inputs(scene: Scene, camera: Camera) -> tuple:
    return scene.vertices, camera.pos, camera.angle, camera.focal


def _fast_key(tensors: tuple, cfg: RenderConfig) -> tuple:
    return (tuple((id(t), t.data_ptr(), t._version) for t in tensors),
            cfg.width, cfg.height, cfg.tri_block)


def _value_key(tensors: tuple, cfg: RenderConfig) -> tuple:
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().to("cpu", torch.float32).numpy().tobytes())
    return (h.hexdigest(), str(tensors[0].device), cfg.width, cfg.height,
            cfg.tri_block)


def has_plan(scene: Scene, camera: Camera, cfg: RenderConfig) -> bool:
    """Is the plan of these very tensors, unchanged, cached? A fast-key
    lookup only: no sync, no hash, no plan build."""
    key = _fast_key(_inputs(scene, camera), cfg)
    return any(e[0] == key for e in _PLAN_CACHE)


def _cached_plan(scene: Scene, camera: Camera,
                 cfg: RenderConfig) -> CompactPlan:
    tensors = _inputs(scene, camera)
    key = _fast_key(tensors, cfg)
    for e in _PLAN_CACHE:
        if e[0] == key:
            return e[3]
    vkey = _value_key(tensors, cfg)
    for e in _PLAN_CACHE:
        if e[2] == vkey:
            e[0], e[1] = key, tensors
            return e[3]
    plan = make_compact_plan(scene, camera, cfg)
    _PLAN_CACHE.append([key, tensors, vkey, plan])
    del _PLAN_CACHE[:-_PLAN_CACHE_MAX]
    return plan


def _zero_frame(scene: Scene, camera: Camera, cfg: RenderConfig):
    """The all-miss frame, with no kernel launch; under autograd it hangs
    off the inputs that need a gradient, which get zeros."""
    out = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                      device=scene.device)
    leaves = [t for t in (scene.vertices, scene.albedo, scene.emission,
                          camera.pos, camera.angle, camera.focal)
              if t.requires_grad]
    if leaves and torch.is_grad_enabled():
        out = out + sum(t.sum() for t in leaves) * 0.0
    return out


def unpack_rows(rows: torch.Tensor, take: torch.Tensor) -> torch.Tensor:
    """The ``(N, C)`` frame of the live rows ``(n_live, C)``: each pixel
    reads row ``take`` of them with one zero row appended."""
    ext = torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])
    return ext.index_select(0, take)


def render_radiance_compact_fused(scene: Scene, camera: Camera,
                                  cfg: RenderConfig, seed: int = 0,
                                  plan: CompactPlan | None = None
                                  ) -> torch.Tensor:
    """Unclamped ``(H, W, 3)`` radiance from the selected forward kernel
    (K1, K3, K6, K9) on the live rays only, bit-equal to the full
    launch's frame. Not for a jitted caller's sense of the word: the
    plan's live count crosses to the host, once a plan. Pass ``plan`` or
    rely on the cache to reuse it across frames."""
    kernel = _select_kernel(scene, cfg)
    if kernel is None:
        raise ValueError("no fused or streamed kernel renders this "
                         "(scene, cfg)")
    if plan is None:
        plan = _cached_plan(scene, camera, cfg)
    n = plan.n_live
    if n == 0:
        return _zero_frame(scene, camera, cfg)
    rows = KERNELS[kernel][0].radiance_block(
        scene, plan.rays_p[0][:n], plan.rays_p[1][:n], plan.pix_p[:n], cfg,
        seed)
    return unpack_rows(rows, plan.take).reshape(cfg.height, cfg.width, 3)


class _TakePrefix(torch.autograd.Function):
    """``x[sel[:n]]``, the live rows of ``x (N, C)``, whose backward is the
    inverse gather: pixel p's cotangent is its slot ``take[p]``'s, or the
    appended zero row's past the live rows."""

    @staticmethod
    def forward(ctx, x, sel, take, n: int):
        ctx.save_for_backward(take)
        return x.index_select(0, sel[:n])

    @staticmethod
    def backward(ctx, g):
        (take,) = ctx.saved_tensors
        return unpack_rows(g, take), None, None, None


class _UnpackRows(torch.autograd.Function):
    """``unpack_rows(rows, take)``, whose backward is a gather too: slot s
    is read by exactly one pixel, ``sel[s]``, so its cotangent is that
    pixel's."""

    @staticmethod
    def forward(ctx, rows, sel, take, n: int):
        ctx.save_for_backward(sel)
        ctx.n = n
        return unpack_rows(rows, take)

    @staticmethod
    def backward(ctx, g):
        (sel,) = ctx.saved_tensors
        return g.index_select(0, sel[:ctx.n]), None, None, None


def render_radiance_compact_grad(scene: Scene, camera: Camera,
                                 cfg: RenderConfig, seed: int = 0,
                                 plan: CompactPlan | None = None
                                 ) -> torch.Tensor:
    """Differentiable compacted render: unclamped ``(H, W, 3)`` radiance
    from the selected kernel pair (K1+K2, K3+K4, K6+K8+K7, K9+K10+K7) on
    the live rays, differentiable in the scene and the camera. The frame
    is the full launch's; the gradients differ from it only in the order
    of the backward kernels' sums. The rays are regenerated from the
    camera so that its cotangents flow through ``_TakePrefix``.

    A plan certifies misses for the geometry and camera it was built
    with: an explicit ``plan`` must be rebuilt when they move."""
    kernel = _select_kernel_grad(scene, cfg)
    if kernel is None:
        raise ValueError("no fused or streamed kernel differentiates this "
                         "(scene, cfg)")
    if plan is None:
        plan = _cached_plan(scene, camera, cfg)
    n = plan.n_live
    if n == 0:
        return _zero_frame(scene, camera, cfg)
    o, d = generate_rays(camera, cfg.width, cfg.height)
    rows = KERNELS[kernel][1].radiance_block_grad(
        scene, _TakePrefix.apply(o, plan.sel, plan.take, n),
        _TakePrefix.apply(d, plan.sel, plan.take, n), plan.pix_p[:n], cfg,
        seed)
    return _UnpackRows.apply(rows, plan.sel, plan.take, n).reshape(
        cfg.height, cfg.width, 3)
