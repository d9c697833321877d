"""Pinhole camera and ray generation.

The PyTorch counterpart of ``spath_tpu/camera.py``, with the reference's
viewport semantics: image plane of height 1 and width ``W/H``, x falling
with the column and y with the row (row 0 at the top), direction
``unit(plane + (0, 0, focal))``, then the rotation ``rY(rX(·))`` applied
to both the plane position and the direction, and the camera position
added to the origin. All arithmetic is float32 in the JAX package's op
order, so both packages generate the same rays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spath_tpu_torch.ops.fp import sqrt_rn


@dataclasses.dataclass(frozen=True)
class Camera:
    """Camera parameters.

    Attributes:
      pos: ``(3,)`` world-space position.
      angle: ``(3,)`` Euler angles; only x (pitch) and y (yaw) are used.
      focal: 0-d focal length.
    """

    pos: torch.Tensor
    angle: torch.Tensor
    focal: torch.Tensor

    @classmethod
    def default(cls, device) -> "Camera":
        """Position (0, 0, -3), no rotation, focal 2."""
        return cls(
            pos=torch.tensor([0.0, 0.0, -3.0], dtype=torch.float32,
                             device=device),
            angle=torch.zeros(3, dtype=torch.float32, device=device),
            focal=torch.tensor(2.0, dtype=torch.float32, device=device),
        )

    @property
    def device(self) -> torch.device:
        return self.pos.device

    def rotate(self, v: torch.Tensor) -> torch.Tensor:
        """Apply ``rY(rX(v))`` to ``(..., 3)`` vectors: pitch about x
        first, then yaw about y."""
        cx, sx = torch.cos(self.angle[0]), torch.sin(self.angle[0])
        cy, sy = torch.cos(self.angle[1]), torch.sin(self.angle[1])
        x, y, z = v[..., 0], v[..., 1], v[..., 2]
        y, z = y * cx - z * sx, y * sx + z * cx          # rX
        x, z = x * cy + z * sy, -x * sy + z * cy         # rY
        return torch.stack([x, y, z], dim=-1)


def pixel_rays(camera: Camera, width: int, height: int):
    """``generate_rays`` and each ray's pixel id: ``(origins, directions,
    ids)``, ``ids`` int64 ``0 .. height*width - 1``."""
    o, d = generate_rays(camera, width, height)
    return o, d, torch.arange(o.shape[0], dtype=torch.int64, device=o.device)


def generate_rays(camera: Camera, width: int, height: int):
    """Per-pixel camera rays.

    Returns ``(origins, directions)``, each ``(height*width, 3)`` float32
    on the camera's device, in row-major pixel order ``i + j*width``.
    """
    device = camera.device
    f32 = np.float32
    x_size = f32(width / height)
    x_max = x_size / f32(2)
    x_step = x_size / f32(width)
    h_x_step = x_step / f32(2)
    y_max = f32(0.5)
    y_step = f32(1.0) / f32(height)
    h_y_step = y_step / f32(2)

    i = torch.arange(width, dtype=torch.float32, device=device)
    j = torch.arange(height, dtype=torch.float32, device=device)
    px = (float(x_max) - float(x_step) * i) - float(h_x_step)   # (W,)
    py = (float(y_max) - float(y_step) * j) - float(h_y_step)   # (H,)
    px = px[None, :].expand(height, width)
    py = py[:, None].expand(height, width)
    plane = torch.stack([px, py, torch.zeros_like(px)], dim=-1)  # (H, W, 3)

    dz = plane[..., 2] + camera.focal
    dx, dy = plane[..., 0], plane[..., 1]
    norm = sqrt_rn(dx * dx + dy * dy + dz * dz)
    d = torch.stack([dx / norm, dy / norm, dz / norm], dim=-1)

    origins = camera.rotate(plane) + camera.pos
    directions = camera.rotate(d)
    return origins.reshape(-1, 3), directions.reshape(-1, 3)
