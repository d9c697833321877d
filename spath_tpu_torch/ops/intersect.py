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
ported yet, and raise. Forward only: the custom backward comes with the
gradient port.
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


def nearest_hit_edges(o, d, v0, e1, e2, src_idx, tri_block: int = 512):
    """Nearest hit against triangles given as ``v0`` and edges
    ``e1 = v1 - v0``, ``e2 = v2 - v0`` (each ``(T, 3)``).

    Returns ``(dist (N,), idx (N,) int64)``: ``idx`` is -1 on a miss.
    """
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
