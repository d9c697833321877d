"""One renderer interface over the backends, and the rule that picks one
(``spath_tpu/models/renderer.py``).

``REGISTRY`` lists the backends fastest first; ``forward_renderer`` takes
the first that renders ``(scene, cfg)`` exactly and ``grad_renderer`` the
first that differentiates it, so every entry point agrees on which
kernel a config runs on. So far the port has two: the fused CUDA kernels
for the conformance estimator (K1 forward, K2 backward), and the plain
wavefront, with autograd, for CPU tensors. On a CUDA device a frame or a
gradient goes through a kernel or raises: a scene or config no ported
kernel takes is not handed to the plain version. The compacted, quality
and streamed renderers are not registered yet.
"""

from __future__ import annotations

import torch

from spath_tpu_torch.camera import Camera
from spath_tpu_torch.config import RenderConfig
from spath_tpu_torch.models import pathtracer
from spath_tpu_torch.ops.kernels import megakernel, megakernel_grad
from spath_tpu_torch.scene import Scene


class Renderer:
    """Abstract renderer; ``render`` applies the reference's final
    clamp."""

    #: short stable identifier
    name: str = "abstract"

    def available(self, scene: Scene) -> bool:
        """Can this backend run on the scene's device at all?"""
        return True

    def supports(self, scene: Scene, cfg: RenderConfig) -> bool:
        """Can this backend render this (scene, config) exactly?"""
        raise NotImplementedError

    def supports_grad(self, scene: Scene, cfg: RenderConfig) -> bool:
        """Can this backend differentiate this (scene, config)?"""
        return False

    def render_radiance(self, scene: Scene, camera: Camera,
                        cfg: RenderConfig, seed: int = 0) -> torch.Tensor:
        """Unclamped mean radiance ``(H, W, 3)``."""
        raise NotImplementedError

    def render_radiance_grad(self, scene: Scene, camera: Camera,
                             cfg: RenderConfig, seed: int = 0
                             ) -> torch.Tensor:
        """``render_radiance``, differentiable under ``torch.autograd``."""
        raise NotImplementedError(f"{self.name} has no gradient path")

    def render(self, scene: Scene, camera: Camera, cfg: RenderConfig,
               seed: int = 0) -> torch.Tensor:
        return torch.clamp(self.render_radiance(scene, camera, cfg, seed),
                           0.0, 1.0)


class WavefrontRenderer(Renderer):
    """Plain PyTorch wavefront, for CPU tensors."""

    name = "wavefront"

    def available(self, scene) -> bool:
        return scene.device.type == "cpu"

    def supports(self, scene, cfg) -> bool:
        return self.available(scene)

    supports_grad = supports

    def render_radiance(self, scene, camera, cfg, seed=0):
        return pathtracer.render_radiance(scene, camera, cfg, seed)

    render_radiance_grad = render_radiance


class MegakernelRenderer(Renderer):
    """The fused CUDA kernels, conformance estimator, T <= MAX_TRIS: K1
    forward, and K1 with its reverse sweep K2 for gradients.

    The JAX package hands scenes above 128 triangles to its streamed
    kernel (K6), and above 64 to its streamed backward (K8), crossovers
    measured on a TPU v5e; until those are ported these kernels take
    every scene they can hold."""

    name = "megakernel"

    def available(self, scene) -> bool:
        return scene.device.type == "cuda"

    def supports(self, scene, cfg) -> bool:
        return self.available(scene) and megakernel.supported(scene, cfg)

    def supports_grad(self, scene, cfg) -> bool:
        return self.available(scene) and megakernel_grad.supported_grad(
            scene, cfg)

    def render_radiance(self, scene, camera, cfg, seed=0):
        return megakernel.render_radiance_megakernel(scene, camera, cfg,
                                                     seed)

    def render_radiance_grad(self, scene, camera, cfg, seed=0):
        return megakernel_grad.render_radiance_mega(scene, camera, cfg, seed)


#: All backends, fastest first: selection takes the first match.
REGISTRY: tuple[Renderer, ...] = (
    MegakernelRenderer(),
    WavefrontRenderer(),
)


def forward_renderer(scene: Scene, cfg: RenderConfig) -> Renderer:
    """The fastest backend that renders ``(scene, cfg)`` exactly; raises
    ``NotImplementedError`` when no ported backend does."""
    for r in REGISTRY:
        if r.supports(scene, cfg):
            return r
    pathtracer.require_conformance(cfg)
    raise NotImplementedError(
        f"no ported kernel renders {scene.n_tris} triangles on "
        f"{scene.device}: the fused kernel takes T <= {megakernel.MAX_TRIS}; "
        "larger scenes need the streamed kernel K6 "
        "(spath_tpu/ops/pallas/megakernel_bigscene.py), not ported yet")


def grad_renderer(scene: Scene, cfg: RenderConfig) -> Renderer:
    """The fastest backend that differentiates ``(scene, cfg)``; raises
    ``NotImplementedError`` when no ported backend does."""
    for r in REGISTRY:
        if r.supports_grad(scene, cfg):
            return r
    pathtracer.require_conformance(cfg)
    raise NotImplementedError(
        f"no ported kernel differentiates {scene.n_tris} triangles and "
        f"{cfg.max_bounces} bounces on {scene.device}: the fused backward "
        f"K2 takes T <= {megakernel_grad.GRAD_MAX_TRIS} and max_bounces <= "
        f"{megakernel_grad.MAX_BOUNCES}; larger scenes need the streamed "
        "backward K8 (spath_tpu/ops/pallas/megakernel_bigscene_grad.py), "
        "not ported yet")
