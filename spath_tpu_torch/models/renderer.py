"""One renderer interface over the backends, and the rule that picks one
(``spath_tpu/models/renderer.py``).

``REGISTRY`` lists the backends fastest first; ``forward_renderer`` takes
the first that renders ``(scene, cfg)`` exactly, so every entry point
agrees on which kernel a config runs on. So far the port has two: the
fused CUDA kernel for the conformance estimator, and the plain wavefront
for CPU tensors. On a CUDA device a frame goes through a kernel or
raises: a scene or config no ported kernel takes is not handed to the
plain version. The compacted, quality and streamed renderers are not
registered yet.
"""

from __future__ import annotations

import torch

from spath_tpu_torch.camera import Camera
from spath_tpu_torch.config import RenderConfig
from spath_tpu_torch.models import pathtracer
from spath_tpu_torch.ops.kernels import megakernel
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

    def render_radiance(self, scene: Scene, camera: Camera,
                        cfg: RenderConfig, seed: int = 0) -> torch.Tensor:
        """Unclamped mean radiance ``(H, W, 3)``."""
        raise NotImplementedError

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

    def render_radiance(self, scene, camera, cfg, seed=0):
        return pathtracer.render_radiance(scene, camera, cfg, seed)


class MegakernelRenderer(Renderer):
    """The fused CUDA kernel, conformance estimator, T <= MAX_TRIS.

    The JAX package hands scenes above 128 triangles to its streamed
    kernel (K6), a crossover measured on a TPU v5e; until K6 is ported
    this kernel takes every scene it can hold."""

    name = "megakernel"

    def available(self, scene) -> bool:
        return scene.device.type == "cuda"

    def supports(self, scene, cfg) -> bool:
        return self.available(scene) and megakernel.supported(scene, cfg)

    def render_radiance(self, scene, camera, cfg, seed=0):
        return megakernel.render_radiance_megakernel(scene, camera, cfg,
                                                     seed)


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
