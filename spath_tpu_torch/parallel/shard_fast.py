"""Sharded kernels: the fast path over the ``rays`` axis
(``spath_tpu/parallel/shard_fast.py``).

Each rank renders its own block of rays (``parallel/shard.py::
sharded_frame``) through the backend that the one-device router picks
(``models/renderer.py``), with the scene's table replicated: K1 (K1 and
K2 for a gradient) and the streamed K6 (K6, K8 and K7) for the
conformance estimator, K3 (K3, K4) and the streamed K9 (K9, K10 and K7)
for the quality estimator, and the wavefront (on the card its sweeps on
K5) for the rest: the other streams, the ``vis_grad`` gradient (as the
JAX package's sharded paths send it), and scenes of more than
``LIGHT_MAX`` lights with NEE. So the crossovers are the port's,
measured on the H100 (``SMEM_ROUTE_MAX_TRIS``, ``GRAD_ROUTE_MAX_TRIS``,
``QUALITY_*_ROUTE_MAX_TRIS``), not the JAX package's, measured on a TPU,
and above 2^20 triangles every route raises, as on one device.

A backend traces a block through ``Renderer.trace_block``, which keys
the streams (seeds, keys) by the rays' global pixel ids, the same code
its one-device frame runs; every kernel traces each lane on its own, so
the frame is bit-identical to the one-device frame. A gradient is each
rank's kernel gradient of its block, summed over the ranks in rank order
on the scene's and the camera's tensors (``shard._RankSum``); the JAX
package sums the table adjoint with ``psum`` instead, the same sum one
step earlier in the chain. The JAX package's lane multiples
(``megakernel.shard_lane_multiple``) are TPU tile padding: a block here
is padded only to the mesh size.
"""

from __future__ import annotations

import torch

from spath_tpu_torch.camera import Camera
from spath_tpu_torch.config import RenderConfig
from spath_tpu_torch.models.renderer import forward_renderer, grad_renderer
from spath_tpu_torch.parallel.mesh import Mesh, default_mesh
from spath_tpu_torch.parallel.shard import sharded_frame
from spath_tpu_torch.scene import Scene


def fused_available(device=None) -> bool:
    """Can the kernels run on ``device`` (default: this process's)? Only
    on a CUDA device; elsewhere the wavefront renders."""
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


def _render(scene: Scene, camera: Camera, cfg: RenderConfig, seed: int,
            mesh: Mesh | None, grad: bool) -> torch.Tensor:
    renderer = (grad_renderer if grad else forward_renderer)(
        scene, cfg, require_jittable=True)
    return sharded_frame(renderer, scene, camera, cfg, seed,
                         mesh or default_mesh(scene.device), grad=grad)


def render_radiance_fast_sharded(scene: Scene, camera: Camera,
                                 cfg: RenderConfig, seed: int = 0,
                                 mesh: Mesh | None = None) -> torch.Tensor:
    """Sharded forward-only fast render (the serving path): the unclamped
    ``(H, W, 3)`` frame of ``render_pt_fast``'s route, each rank
    launching its kernel on its block, bit-identical to one device."""
    return _render(scene, camera, cfg, seed, mesh, grad=False)


def render_pt_fast_sharded(scene: Scene, camera: Camera, cfg: RenderConfig,
                           seed: int = 0, mesh: Mesh | None = None
                           ) -> torch.Tensor:
    """Sharded fast frame with the reference clamp."""
    return torch.clamp(render_radiance_fast_sharded(scene, camera, cfg,
                                                    seed, mesh), 0.0, 1.0)


def render_radiance_fastgrad_sharded(scene: Scene, camera: Camera,
                                     cfg: RenderConfig, seed: int = 0,
                                     mesh: Mesh | None = None
                                     ) -> torch.Tensor:
    """Sharded differentiable radiance: the value and detached-sampling
    gradients of ``render_radiance_fastgrad``, the backward kernel (K2,
    K4, K8+K7, K10+K7) run on each rank's block and the gradients to the
    scene's vertices, albedo and emission and to the camera summed over
    the ranks in rank order; the sharded wavefront where no kernel
    differentiates the config."""
    return _render(scene, camera, cfg, seed, mesh, grad=True)
