"""Hemisphere direction sampling (``spath_tpu/ops/sampling.py``).

- **angle**, the reference's sampler: azimuth = u1·2π, elevation =
  u2·π/2, direction = (cos(az)·cos(el), sin(el), sin(az)·cos(el)),
  flipped into the normal's hemisphere. It is neither cosine-weighted nor
  solid-angle-uniform, and the reference pairs it with p = 1/(2π); the
  conformance estimator reproduces both quirks, so the per-bounce weight
  without albedo is ``2·cosθ``.
- **cosine**, the quality estimator's: cosine-weighted about the normal
  in the branchless tangent frame of Duff et al. (2017); its pdf cosθ/π
  cancels the Lambertian BRDF·cosθ, so the weight is 1.
- **uniform**: solid-angle-uniform, pdf 1/(2π), weight ``2·cosθ``.

All are float32 functions of two uniforms in the JAX package's op order;
callers detach the sampled direction (detached sampling).
"""

from __future__ import annotations

import numpy as np
import torch

from spath_tpu_torch.ops.fp import sqrt_rn

TWO_PI = float(np.float32(2.0 * np.pi))
HALF_PI = float(np.float32(0.5 * np.pi))


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a·b`` over the last axis of ``(..., 3)`` tensors, summed left to
    right as the JAX package and the CUDA kernel do."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a × b`` over the last axis, component by component as
    ``jnp.cross`` and the kernels compute it."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


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


def orthonormal_basis(n: torch.Tensor):
    """Branchless tangent frame ``(t, bt)`` around unit normals
    ``(..., 3)`` (Duff et al. 2017)."""
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + s * n[..., 0] * n[..., 0] * a, s * b,
                     -s * n[..., 0]], dim=-1)
    bt = torch.stack([b, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return t, bt


def _frame_sample(normal, phi, r, z):
    t, bt = orthonormal_basis(normal)
    return (t * (torch.cos(phi) * r)[..., None]
            + bt * (torch.sin(phi) * r)[..., None]
            + normal * z[..., None])


def cosine_sample(normal: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor):
    """Cosine-weighted hemisphere sample about ``normal``: ``(dirs,
    weight)`` with weight 1."""
    phi = u1 * TWO_PI
    r = sqrt_rn(torch.clamp_min(1.0 - u2, 0.0))
    z = sqrt_rn(u2)
    return _frame_sample(normal, phi, r, z), torch.ones_like(u1)


def uniform_sample(normal: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor):
    """Solid-angle-uniform hemisphere sample: ``(dirs, weight)`` with
    weight ``2·cosθ``."""
    phi = u1 * TWO_PI
    z = u2
    r = sqrt_rn(torch.clamp_min(1.0 - z * z, 0.0))
    dirs = _frame_sample(normal, phi, r, z)
    return dirs, 2.0 * dot3(dirs, normal)


def hemisphere_sample(mode: str, normal, u1, u2):
    """Dispatch on the sampler (``"angle"``, ``"cosine"``, ``"uniform"``)."""
    if mode == "angle":
        return angle_sample(normal, u1, u2)
    if mode == "cosine":
        return cosine_sample(normal, u1, u2)
    if mode == "uniform":
        return uniform_sample(normal, u1, u2)
    raise ValueError(f"unknown sampler mode: {mode}")
