"""Ray-sharded rendering: pixels across the ranks of a mesh
(``spath_tpu/parallel/shard.py``).

The JAX package wraps ``trace_mean_radiance`` in ``shard_map`` with the
scene and camera replicated and the rays split along ``"rays"``. Here
the mesh's ranks run the same program (SPMD): every rank generates the
whole frame's camera rays, pads them to a multiple of the mesh size with
zero-direction rays (which always miss; the padding is dropped before
return), traces its own contiguous block of them, as ``P("rays")``
splits an axis, and all-gathers the blocks, so every rank returns the
whole frame. The streams are keyed by **global** pixel ids, so the frame
is bit-identical to the one-device frame in every stream (lcg, hash,
threefry, table).

Gradients. Every rank computes the same loss from the whole frame, so
the all-gather's backward keeps this rank's block of the incoming
gradient and needs no collective (``_AllGather``). Each replicated input
that carries a gradient (the scene's vertices, albedo and emission, the
camera's position, angles and focal length) passes through ``_RankSum``:
the identity forward; backward, it all-gathers the ranks' partial
gradients and adds them in rank order, so the sum has the same bits on
every rank and from run to run. No ``all_reduce``: NCCL's reduction
order depends on its algorithm and the topology.

``sharded_ray_specs`` (the JAX package's ``NamedSharding`` pair) has no
counterpart: a torch tensor carries no sharding.
"""

from __future__ import annotations

import dataclasses

import torch

from spath_tpu_torch.camera import Camera, pixel_rays
from spath_tpu_torch.config import RenderConfig
from spath_tpu_torch.models.renderer import (
    Renderer, WavefrontRenderer, no_kernel,
)
from spath_tpu_torch.parallel.mesh import Mesh, default_mesh
from spath_tpu_torch.scene import Scene


def pad_to_multiple(x: torch.Tensor, m: int, axis: int = 0):
    """Pad ``axis`` with zeros up to a multiple of ``m``. Returns
    ``(padded, original_len)``."""
    n = x.shape[axis]
    pad = (-n) % m
    if pad == 0:
        return x, n
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis), n


class _AllGather(torch.autograd.Function):
    """``_AllGather.apply(block, mesh, lo, hi)``: the members' blocks
    concatenated in mesh order. Backward: this rank's rows ``lo:hi`` of
    the gradient, which every rank computed alike."""

    @staticmethod
    def forward(ctx, block, mesh, lo, hi):
        ctx.lo, ctx.hi = lo, hi
        return torch.cat(mesh.all_gather(block))

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.lo:ctx.hi], None, None, None


class _RankSum(torch.autograd.Function):
    """``_RankSum.apply(mesh, *tensors)``: the tensors, unchanged.
    Backward: every member's gradient of them, added in rank order, one
    all-gather for all of them."""

    @staticmethod
    def forward(ctx, mesh, *tensors):
        ctx.mesh = mesh
        ctx.shapes = [t.shape for t in tensors]
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([g.reshape(-1) for g in grads])
        parts = ctx.mesh.all_gather(flat)
        total = parts[0].clone()
        for p in parts[1:]:
            total += p
        sizes = [s.numel() for s in ctx.shapes]
        return (None, *(g.view(s) for g, s in
                        zip(total.split(sizes), ctx.shapes)))


def replicated(scene: Scene, camera: Camera, mesh: Mesh):
    """``(scene, camera)`` with every input that requires a gradient
    passed through ``_RankSum``; unchanged without a process group (a
    world of one sums nothing) or without a gradient."""
    leaves = {"vertices": scene.vertices, "albedo": scene.albedo,
              "emission": scene.emission, "pos": camera.pos,
              "angle": camera.angle, "focal": camera.focal}
    diff = [k for k, t in leaves.items() if t.requires_grad]
    if mesh.group is None or not diff or not torch.is_grad_enabled():
        return scene, camera
    leaves.update(zip(diff, _RankSum.apply(mesh,
                                           *(leaves[k] for k in diff))))
    scene = dataclasses.replace(scene, vertices=leaves["vertices"],
                                albedo=leaves["albedo"],
                                emission=leaves["emission"])
    camera = Camera(pos=leaves["pos"], angle=leaves["angle"],
                    focal=leaves["focal"])
    return scene, camera


def sharded_frame(renderer: Renderer, scene: Scene, camera: Camera,
                  cfg: RenderConfig, seed: int, mesh: Mesh,
                  grad: bool = False) -> torch.Tensor:
    """The ``(H, W, 3)`` frame of ``renderer`` over the mesh: this rank's
    block of the padded camera rays through ``renderer.trace_block``, the
    blocks all-gathered. ``grad``: differentiable in the scene and
    camera, their gradients summed over the ranks in rank order."""
    index = mesh.member_index()
    if scene.device != camera.device:
        raise ValueError(f"scene on {scene.device}, camera on "
                         f"{camera.device}: put both on one device")
    if grad:
        scene, camera = replicated(scene, camera, mesh)
    origins, directions, ids = pixel_rays(camera, cfg.width, cfg.height)
    origins, n = pad_to_multiple(origins, mesh.size)
    directions, _ = pad_to_multiple(directions, mesh.size)
    ids, _ = pad_to_multiple(ids, mesh.size)
    per = origins.shape[0] // mesh.size
    lo, hi = index * per, (index + 1) * per
    block = renderer.trace_block(scene, origins[lo:hi], directions[lo:hi],
                                 ids[lo:hi], cfg, seed, grad)
    frame = _AllGather.apply(block, mesh, lo, hi)
    return frame[:n].reshape(cfg.height, cfg.width, 3)


def render_radiance_sharded(scene: Scene, camera: Camera,
                            cfg: RenderConfig, seed: int = 0,
                            mesh: Mesh | None = None) -> torch.Tensor:
    """Sharded ``render_radiance``: the same ``(H, W, 3)`` unclamped frame
    through the wavefront (``trace_mean_radiance`` keyed by global pixel
    ids), each rank tracing its block, differentiable under autograd
    with the gradients summed over the ranks. Above the 2^20 triangles
    that the wavefront on the card keeps it raises
    ``NotImplementedError``, as the one-device routes do."""
    wavefront = WavefrontRenderer()
    if not wavefront.supports(scene, cfg):
        raise NotImplementedError(no_kernel(scene, cfg,
                                            torch.is_grad_enabled()))
    return sharded_frame(wavefront, scene, camera, cfg, seed,
                         mesh or default_mesh(scene.device), grad=True)


def render_pt_sharded(scene: Scene, camera: Camera, cfg: RenderConfig,
                      seed: int = 0, mesh: Mesh | None = None
                      ) -> torch.Tensor:
    """Sharded full frame with the reference clamp."""
    return torch.clamp(render_radiance_sharded(scene, camera, cfg, seed,
                                               mesh), 0.0, 1.0)
