"""Brute-force rays × triangles nearest hit, the reference Möller–Trumbore
sweep of ``spath_tpu/ops/intersect.py``.

ε bounds on the determinant and the distance, exclusion of each ray's
source triangle by index, and ties to the lowest triangle index (the
reference's strict ``<`` scan). Triangles are swept in blocks of
``tri_block`` so no ``(N, T)`` buffer is ever built whole; each block is
a component-wise ``(N, B)`` computation in the JAX package's float32 op
order.

``intersect="pluecker"`` runs this same sweep: the Plücker form exists
on the TPU to put the sweep on its matrix unit, and Hopper's float32
tensor-core path is TF32, which is not exact. ``"pallas"`` and
``"pallas_fast"`` name the standalone Pallas kernel (K5), which is not
ported yet, and raise.

Gradients: ``nearest_hit_edges`` is a ``torch.autograd.Function``, the
port of the JAX package's custom VJP (``spath_tpu/ops/intersect.py``,
``_nearest_hit_vjp``). The argmin is a detached selector; the backward
is the O(N) derivative of the selected triangle's distance
(``_dist_selected``). Autograd through the sweep itself would keep
``(N, B)`` block tensors for every sweep of every sample and bounce.
"""

from __future__ import annotations

import numpy as np
import torch

from spath_tpu_torch.config import EPSILON, MAX_DIST, RenderConfig

EPS = float(np.float32(EPSILON))
INV_EPS = float(np.float32(1.0 / EPSILON))
BIG = float(np.float32(MAX_DIST))

METHODS = ("reference", "pluecker")


def _mt_block(o, d, v0, e1, e2, src_idx, tri_base: int):
    """Möller–Trumbore of ``(N, 3)`` rays against one ``(B, 3)`` block of
    triangles given by ``v0`` and its edges. Returns ``(N, B)`` distances,
    ``BIG`` where there is no valid hit."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]          # (N, 1)
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    e1x, e1y, e1z = e1[None, :, 0], e1[None, :, 1], e1[None, :, 2]  # (1, B)
    e2x, e2y, e2z = e2[None, :, 0], e2[None, :, 1], e2[None, :, 2]

    hx = dy * e2z - dz * e2y                              # h = d × e2
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    nondeg = torch.abs(a) >= EPS
    f = 1.0 / torch.where(nondeg, a, torch.ones_like(a))

    sx = ox - v0[None, :, 0]
    sy = oy - v0[None, :, 1]
    sz = oz - v0[None, :, 2]
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y                              # q = s × e1
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    dist = f * (e2x * qx + e2y * qy + e2z * qz)

    tri_ids = tri_base + torch.arange(v0.shape[0], device=o.device)
    valid = (
        nondeg
        & (u >= 0.0) & (u <= 1.0)
        & (v >= 0.0) & (u + v <= 1.0)
        & (dist > EPS) & (dist < INV_EPS)
        & (tri_ids[None, :] != src_idx[:, None])
    )
    return torch.where(valid, dist, torch.full_like(dist, BIG))


def _sweep(o, d, v0, e1, e2, src_idx, tri_block: int):
    """The blocked sweep: ``(dist (N,), idx (N,) int64)``."""
    best = torch.full((o.shape[0],), BIG, dtype=torch.float32,
                      device=o.device)
    best_i = torch.full((o.shape[0],), -1, dtype=torch.int64,
                        device=o.device)
    for base in range(0, v0.shape[0], tri_block):
        sl = slice(base, base + tri_block)
        dist = _mt_block(o, d, v0[sl], e1[sl], e2[sl], src_idx, base)
        blk_best, blk_idx = torch.min(dist, dim=1)        # first min wins
        better = blk_best < best                          # earlier block wins
        best = torch.where(better, blk_best, best)
        best_i = torch.where(better, blk_idx + base, best_i)
    best_i = torch.where(best >= BIG, torch.full_like(best_i, -1), best_i)
    return best, best_i


def _dist_selected(o, d, v0, e1, e2, idx):
    """Differentiable Möller–Trumbore distance of each ray to its selected
    triangle, ``BIG`` on a miss: the O(N) backward path. The guard is
    ``|a| > 0``, as in the JAX package, not the sweep's ε."""
    safe = idx.clamp_min(0)
    a0, e1s, e2s = v0[safe], e1[safe], e2[safe]
    h = torch.linalg.cross(d, e2s)
    a = (e1s * h).sum(-1)
    f = 1.0 / torch.where(a.abs() > 0.0, a, torch.ones_like(a))
    q = torch.linalg.cross(o - a0, e1s)
    dist = f * (e2s * q).sum(-1)
    return torch.where(idx >= 0, dist, torch.full_like(dist, BIG))


class _NearestHit(torch.autograd.Function):
    """The sweep forward; the selected triangle's distance backward. Saves
    only the O(N) residuals ``(o, d, v0, e1, e2, idx)``."""

    @staticmethod
    def forward(ctx, o, d, v0, e1, e2, src_idx, tri_block):
        dist, idx = _sweep(o, d, v0, e1, e2, src_idx, tri_block)
        ctx.save_for_backward(o, d, v0, e1, e2, idx)
        ctx.mark_non_differentiable(idx)
        return dist, idx

    @staticmethod
    def backward(ctx, dist_bar, _idx_bar):
        o, d, v0, e1, e2, idx = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (o, d, v0, e1, e2)]
            grads = torch.autograd.grad(_dist_selected(*leaves, idx), leaves,
                                        dist_bar)
        return (*grads, None, None)


def nearest_hit_edges(o, d, v0, e1, e2, src_idx, tri_block: int = 512):
    """Nearest hit against triangles given as ``v0`` and edges
    ``e1 = v1 - v0``, ``e2 = v2 - v0`` (each ``(T, 3)``).

    Returns ``(dist (N,), idx (N,) int64)``: ``idx`` is -1 on a miss.
    ``dist`` is differentiable in ``o``, ``d`` and the triangles through
    the selected triangle only.
    """
    return _NearestHit.apply(o, d, v0, e1, e2, src_idx, tri_block)


def check_method(method: str) -> None:
    """Raise for an ``intersect`` method this sweep does not stand for."""
    if method in ("pallas", "pallas_fast"):
        raise NotImplementedError(
            f"intersect={method!r} is the Pallas kernel K5 "
            "(spath_tpu/ops/pallas/intersect_pallas.py), not ported yet; "
            "use 'reference'")
    if method not in METHODS:
        raise ValueError(f"unknown intersect method {method!r}")


def nearest_hit(o, d, v0, v1, v2, src_idx, cfg: RenderConfig | None = None,
                method: str | None = None, tri_block: int | None = None):
    """Nearest hit of ``(N, 3)`` rays ``o + t·d`` against ``(T, 3)``
    triangle vertices, excluding each ray's ``src_idx`` (-1 = none).

    Returns ``(dist, idx)`` as ``nearest_hit_edges`` does.
    """
    check_method(method or (cfg.intersect if cfg else "reference"))
    block = tri_block or (cfg.tri_block if cfg else 512)
    return nearest_hit_edges(o, d, v0, v1 - v0, v2 - v0, src_idx, block)
