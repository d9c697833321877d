"""The reference's angle-uniform hemisphere sampler
(``spath_tpu/ops/sampling.py::angle_sample``).

azimuth = u1·2π, elevation = u2·π/2, direction = (cos(az)·cos(el),
sin(el), sin(az)·cos(el)), flipped into the normal's hemisphere. It is
neither cosine-weighted nor solid-angle-uniform, and the reference pairs
it with p = 1/(2π); the conformance estimator reproduces both quirks, so
the per-bounce weight without albedo is ``2·cosθ``. The cosine and
uniform samplers of the quality estimator are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

TWO_PI = float(np.float32(2.0 * np.pi))
HALF_PI = float(np.float32(0.5 * np.pi))


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a·b`` over the last axis of ``(..., 3)`` tensors, summed left to
    right as the JAX package and the CUDA kernel do."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def angle_sample(normal: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor):
    """Sample directions about ``(N, 3)`` normals (already flipped against
    the incoming ray) from ``(N,)`` uniforms u1 (azimuth), u2 (elevation).

    Returns ``(dirs (N, 3), weight (N,))`` with weight ``2·cosθ``.
    """
    rv_xz = u1 * TWO_PI
    rv_y = u2 * HALF_PI
    f_x = torch.cos(rv_y)
    f_y = torch.sin(rv_y)
    out = torch.stack([torch.cos(rv_xz) * f_x, f_y, torch.sin(rv_xz) * f_x],
                      dim=-1)
    aligned = dot3(normal, out) >= 0.0
    dirs = torch.where(aligned[:, None], out, -out)
    return dirs, 2.0 * dot3(dirs, normal)
