"""Brute-force rays × triangles nearest hit, the reference Möller–Trumbore
sweep of ``spath_tpu/ops/intersect.py``.

ε bounds on the determinant and the distance, exclusion of each ray's
source triangle by index, and ties to the lowest triangle index (the
reference's strict ``<`` scan). Triangles are swept in blocks of
``tri_block`` so no ``(N, T)`` buffer is ever built whole; each block is
a component-wise ``(N, B)`` computation in the JAX package's float32 op
order.

Every ``intersect`` method runs this sweep. ``"pluecker"``: the Plücker
form exists on the TPU to put the sweep on its matrix unit, and Hopper's
float32 tensor-core path is TF32, which is not exact. ``"pallas"`` names
the standalone kernel K5, ``"pallas_fast"`` its TPU variant on bf16 split
features, an alias of it here. On CPU tensors the sweep is ``_sweep``,
the plain PyTorch version; on CUDA tensors it is K5
(``ops/kernels/intersect.py``), bit-identical to ``_sweep``, for every
method. Inside ``plain_sweep()`` CUDA tensors take ``_sweep`` too: the
kernels' plain versions run there, so that they stay plain PyTorch.

Gradients: ``nearest_hit_edges`` is a ``torch.autograd.Function``, the
port of the JAX package's custom VJP (``spath_tpu/ops/intersect.py``,
``_nearest_hit_vjp``). The argmin is a detached selector; the backward
is the O(N) derivative of the selected triangle's distance
(``_dist_selected``). Autograd through the sweep itself would keep
``(N, B)`` block tensors for every sweep of every sample and bounce.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from spath_tpu_torch.config import EPSILON, MAX_DIST, RenderConfig

EPS = float(np.float32(EPSILON))
INV_EPS = float(np.float32(1.0 / EPSILON))
BIG = float(np.float32(MAX_DIST))

METHODS = ("reference", "pluecker", "pallas", "pallas_fast")

#: Depth of ``plain_sweep`` blocks: above 0, CUDA tensors take ``_sweep``.
_plain_depth = 0


@contextlib.contextmanager
def plain_sweep():
    """Inside the block every sweep is the plain ``_sweep`` and every row
    gather of ``ops/gather.py`` is ``index_select`` with its own backward,
    on CUDA tensors too: for the kernels' plain versions and for
    comparisons with K5 and K7, never on a path a user calls."""
    global _plain_depth
    _plain_depth += 1
    try:
        yield
    finally:
        _plain_depth -= 1


def in_plain_sweep() -> bool:
    """Is a ``plain_sweep`` block open?"""
    return _plain_depth > 0


def sweep_table(v0, e1, e2):
    """The detached ``(T, 9)`` table K5 reads, packed once for the sweeps
    of a trace that share these triangles (``table`` of ``sweep`` and
    ``nearest_hit_edges``); ``None`` where the sweep is ``_sweep`` (CPU
    tensors, inside ``plain_sweep()``)."""
    if v0.device.type != "cuda" or _plain_depth:
        return None
    from spath_tpu_torch.ops.kernels.intersect import pack_triangles

    with torch.no_grad():
        return pack_triangles(v0, e1, e2)


def sweep(o, d, v0, e1, e2, src_idx, tri_block: int, table=None):
    """``(dist, idx)``: K5 on CUDA tensors, ``_sweep`` on CPU tensors or
    inside ``plain_sweep()``. ``table`` (``sweep_table`` of the same
    triangles) saves K5 packing them again."""
    if o.device.type == "cuda" and not _plain_depth:
        from spath_tpu_torch.ops.kernels.intersect import (
            nearest_hit_call, pack_triangles,
        )

        if table is None:
            table = pack_triangles(v0, e1, e2)
        return nearest_hit_call(o.contiguous(), d.contiguous(), table,
                                src_idx.to(torch.int64).contiguous())
    return _sweep(o, d, v0, e1, e2, src_idx, tri_block)


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
    ``|a| > 0``, as in the JAX package, not the sweep's ε. The rows are
    gathered by ``ops/gather.py::gather_rows``, whose backward adds each
    row's duplicates in a fixed order (on the card through K7)."""
    from spath_tpu_torch.ops.gather import gather_rows

    a0, e1s, e2s = gather_rows(idx.clamp_min(0), v0, e1, e2)
    h = torch.linalg.cross(d, e2s)
    a = (e1s * h).sum(-1)
    f = 1.0 / torch.where(a.abs() > 0.0, a, torch.ones_like(a))
    q = torch.linalg.cross(o - a0, e1s)
    dist = f * (e2s * q).sum(-1)
    return torch.where(idx >= 0, dist, torch.full_like(dist, BIG))


class _NearestHit(torch.autograd.Function):
    """The sweep forward (``sweep``: K5 on CUDA tensors); the selected
    triangle's distance backward. Saves only the O(N) residuals ``(o, d,
    v0, e1, e2, idx)``."""

    @staticmethod
    def forward(ctx, o, d, v0, e1, e2, src_idx, tri_block, table):
        dist, idx = sweep(o, d, v0, e1, e2, src_idx, tri_block, table)
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
        return (*grads, None, None, None)


def nearest_hit_edges(o, d, v0, e1, e2, src_idx, tri_block: int = 512,
                      table=None):
    """Nearest hit against triangles given as ``v0`` and edges
    ``e1 = v1 - v0``, ``e2 = v2 - v0`` (each ``(T, 3)``); ``table``, their
    ``sweep_table``, where a trace sweeps them more than once.

    Returns ``(dist (N,), idx (N,) int64)``: ``idx`` is -1 on a miss.
    ``dist`` is differentiable in ``o``, ``d`` and the triangles through
    the selected triangle only.
    """
    return _NearestHit.apply(o, d, v0, e1, e2, src_idx, tri_block, table)


def check_method(method: str) -> None:
    """Raise for an unknown ``intersect`` method; every known one runs
    ``sweep``."""
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
