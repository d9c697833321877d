"""Flat-shaded debug view (``spath_tpu/models/flat.py``): each pixel is
the raw albedo of its nearest triangle, black on a miss. Deterministic
and free of random numbers, it checks camera and intersection before any
path tracing."""

from __future__ import annotations

import torch

from spath_tpu_torch.camera import Camera, generate_rays
from spath_tpu_torch.config import RenderConfig
from spath_tpu_torch.ops.intersect import nearest_hit
from spath_tpu_torch.scene import Scene


def render_flat(scene: Scene, camera: Camera, cfg: RenderConfig
                ) -> torch.Tensor:
    """Flat view as float32 ``(H, W, 3)`` on the scene's device."""
    o, d = generate_rays(camera, cfg.width, cfg.height)
    src = torch.full((o.shape[0],), -1, dtype=torch.int64, device=o.device)
    _, idx = nearest_hit(o, d, scene.v0, scene.v1, scene.v2, src, cfg)
    color = torch.where((idx >= 0)[:, None],
                        scene.albedo[idx.clamp_min(0)],
                        torch.zeros((), dtype=torch.float32, device=o.device))
    return color.reshape(cfg.height, cfg.width, 3)
