"""The triangle ring: rays and triangles sharded over the ranks of a mesh
(``spath_tpu/parallel/ring.py``).

A brute-force sweep is a rays x triangles reduction, as attention is
queries x keys, so the ring decomposition applies exactly: every rank keeps
its block of rays, the triangle table is cut into one shard a rank, and the
shards move one place around the ring a step (``Mesh.shift``, the JAX
package's ``lax.ppermute``) while each rank carries a running (least
distance, lowest index) for its rays. After ``S`` steps every rank has the
whole scene's nearest hit for its rays and never held more than ``T/S``
triangles. Every shard is swept by ``ops/intersect.py::sweep``: K5 on CUDA
tensors (the resident shard packed once a step), ``_sweep`` on CPU ones.
The carry, the take mask and the light choice stay elementwise PyTorch, as
they are XLA in the JAX package.

The owner arithmetic is the JAX package's: at step ``t`` rank ``me`` holds
the shard of owner ``(me - t) % S``, whose global rows start at
``owner * size``. Each rank runs the same program (SPMD over
``torch.distributed``), as ``parallel/shard.py`` does: it passes the same
scene, camera, config and seed, builds the whole ring table, cuts its own
shard, traces its block of rays and all-gathers the frame.

Gradients. The primitives are ``torch.autograd.Function`` s whose residuals
are O(N) (the carried winner rows and indices, never the rotated shards):
the distance's adjoint is the selected triangle's Möller–Trumbore chain on
the carried row (``_dist_from_rows``, the expressions of
``ops/intersect.py::_dist_selected``), and the row cotangents go back to
the sharded table through ``ring_scatter_rows``, one accumulator a rank
that rides the ring once, each step's local scatter through the stream
scatter K7 (``ops/kernels/stream_scatter.py``, float64 sums in a fixed
order; its plain version on CPU tensors). ``shard_map``'s transpose
assembles the whole table adjoint; here the backward of the cut of a rank's
shard (``_Shard``) all-gathers the shards' adjoints in mesh order, so every
rank backpropagates the same adjoint through ``_ring_table`` and gets the
same scene gradient bits. The camera's gradient, a part from each rank's
block of rays, is summed over the ranks in rank order
(``shard._RankSum``).

The JAX package's mode switches (``SPATH_RING_UNFUSED``,
``SPATH_RING_PAIRWISE``, ``SPATH_RING_MERGE``, ``SPATH_RING_SPP_BATCH``)
are not read: the port always runs the JAX package's one-device default,
the fused sweep and light choice on the counter-based streams with NEE
(``nearest_and_select_ring``), ``nearest_hit_ring_rows`` otherwise, the
shadow ray's own sweep (``nearest_hit_ring``, detached) and one sample at
a time; with ``cfg.remat`` and more than 8 samples under autograd each
sample is checkpointed, as ``models/pathtracer.py`` does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from spath_tpu_torch.camera import Camera, pixel_rays
from spath_tpu_torch.config import RenderConfig
from spath_tpu_torch.models.pathtracer import (
    _bounce_uniforms, _check_devices, _stream, check_estimator,
)
from spath_tpu_torch.models.renderer import within_caps
from spath_tpu_torch.ops import nee
from spath_tpu_torch.ops.fp import sqrt_rn
from spath_tpu_torch.ops.gather import k7_width
from spath_tpu_torch.ops.intersect import BIG, check_method, sweep
from spath_tpu_torch.ops.kernels.stream_scatter import stream_scatter_call
from spath_tpu_torch.ops.rng import lcg_next, lcg_seeds
from spath_tpu_torch.ops.sampling import cross3, dot3, hemisphere_sample
from spath_tpu_torch.parallel.mesh import Mesh
from spath_tpu_torch.parallel.shard import (
    _AllGather, _RankSum, pad_to_multiple,
)
from spath_tpu_torch.scene import Scene

#: Columns of the ring table: v0, v1, v2, albedo, emission, and with NEE
#: the light choice's prob and cdf.
VERTS, ALBEDO, EMISSION = slice(0, 9), slice(9, 12), slice(12, 15)
PROB_COL, CDF_COL = 15, 16
#: The cdf of the padding rows: above every uniform, never chosen.
PAD_CDF = 2.0


def _dist_from_rows(o, d, rows9, idx):
    """Differentiable Möller–Trumbore distance of each ray to its winner,
    from the carried ``[v0, v1, v2]`` columns instead of a table gather:
    ``ops/intersect.py::_dist_selected``'s expressions, ``BIG`` on a
    miss."""
    a0, b0, c0 = rows9[:, 0:3], rows9[:, 3:6], rows9[:, 6:9]
    e1 = b0 - a0
    e2 = c0 - a0
    h = torch.linalg.cross(d, e2)
    a = (e1 * h).sum(-1)
    f = 1.0 / torch.where(a.abs() > 0.0, a, torch.ones_like(a))
    q = torch.linalg.cross(o - a0, e1)
    dist = f * (e2 * q).sum(-1)
    return torch.where(idx >= 0, dist, torch.full_like(dist, BIG))


def _owner(mesh: Mesh, step: int) -> int:
    """The owner of the shard rank ``mesh.member_index()`` holds after
    ``step`` rotations."""
    return (mesh.member_index() - step) % mesh.size


def ring_scatter_rows(pairs, size: int, mesh: Mesh) -> torch.Tensor:
    """Transpose of the ring's row gathers: the ``(size, k)`` adjoint of
    this rank's table shard from ``pairs``, a list of ``(g (N, k),
    global_idx (N,))`` row cotangents and the global rows they touch.

    One accumulator a rank rides the ring once: at step ``t`` the one
    resident here belongs to owner ``(me - t - 1) % S``, and every rank adds
    its events on that owner's rows (the others at index -1, which add
    nowhere) with one K7 call, the pairs' events in order, so the sum has a
    fixed order on the card; after ``S - 1`` rotations each accumulator is
    back on its owner with every rank's part. The accumulator is ``k``
    columns zero padded to K7's width (``ops/gather.py::k7_width``)."""
    k = pairs[0][0].shape[1]
    width = k7_width(k)
    g = torch.cat([p[0] for p in pairs])
    if width > k:
        g = torch.cat([g, g.new_zeros((g.shape[0], width - k))], dim=1)
    g = g.contiguous()
    gi = torch.cat([p[1] for p in pairs]).to(torch.int64)
    acc = g.new_zeros((size, width))
    for step in range(mesh.size):
        base = ((mesh.member_index() - step - 1) % mesh.size) * size
        local = gi - base
        mine = (local >= 0) & (local < size)
        local = torch.where(mine, local, torch.full_like(local, -1))
        stream_scatter_call(acc, local.to(torch.int32).contiguous(), g)
        if step + 1 < mesh.size:
            acc = mesh.shift(acc)
    return acc[:, :k]


def _take_mask(best_d, best_i, new_d, new_i):
    """Associative (least distance, lowest index) take mask."""
    return (new_d < best_d) | (
        (new_d == best_d) & (new_i >= 0) & ((new_i < best_i) | (best_i < 0)))


def _combine(best_d, best_i, new_d, new_i):
    """Associative (least distance, lowest index) combine."""
    take = _take_mask(best_d, best_i, new_d, new_i)
    return torch.where(take, new_d, best_d), torch.where(take, new_i, best_i)


def _local_src(src_idx, base: int, size: int):
    """The rays' source triangles in the resident shard's rows, -2 (no
    row) outside it: the sweep excludes the row ``!= src``."""
    inside = (src_idx >= base) & (src_idx < base + size)
    return torch.where(inside, src_idx - base, torch.full_like(src_idx, -2))


def _sweep_shard(o, d, blk, src_idx, base: int, cfg: RenderConfig | None):
    """Nearest hit of the rays against the resident shard (its
    ``[v0, v1, v2]`` in columns 0-8), K5 on CUDA tensors: ``(dist,
    local idx)``."""
    v0 = blk[:, 0:3]
    tri_block = cfg.tri_block if cfg else 512
    return sweep(o, d, v0, blk[:, 3:6] - v0, blk[:, 6:9] - v0,
                 _local_src(src_idx, base, blk.shape[0]), tri_block)


def _nearest_ring(o, d, blk, src_idx, cfg, mesh: Mesh):
    """``nearest_hit_ring`` on this rank's shard ``blk``, its ``[v0, v1,
    v2]`` in columns 0-8."""
    size = blk.shape[0]
    best_d = torch.full((o.shape[0],), BIG, dtype=torch.float32,
                        device=o.device)
    best_i = torch.full((o.shape[0],), -1, dtype=torch.int64,
                        device=o.device)
    with torch.no_grad():
        for step in range(mesh.size):
            base = _owner(mesh, step) * size
            d_blk, i_blk = _sweep_shard(o, d, blk, src_idx, base, cfg)
            i_blk = torch.where(i_blk >= 0, i_blk + base, i_blk)
            best_d, best_i = _combine(best_d, best_i, d_blk, i_blk)
            if step + 1 < mesh.size:
                blk = mesh.shift(blk)
    return best_d, best_i


def nearest_hit_ring(o, d, v0, v1, v2, src_idx, cfg: RenderConfig | None,
                     mesh: Mesh):
    """Nearest hit with the triangle shards rotated around the ring.

    ``o, d, src_idx``: this rank's rays and their source triangles (global
    indices, -1 for none); ``v0, v1, v2``: this rank's ``(T/S, 3)`` shard,
    of equal size on every rank (padded with degenerate triangles, which
    no ray hits). Returns ``(dist, global idx)`` as the one-device sweep
    does, ties to the lowest global index, so source exclusion works as
    on one device. Not differentiable: the shadow rays' sweep, whose
    gradient is zero (``nearest_hit_ring_rows`` is the differentiable
    sweep)."""
    if cfg is not None:
        check_method(cfg.intersect)
    return _nearest_ring(o, d, torch.cat([v0, v1, v2], dim=1).detach(),
                         src_idx, cfg, mesh)


def _sweep_step(blk, owner: int, base: int, o, d, src_idx, cfg, carry):
    """One ring step of the sweep with the winner's row carried, the
    shared body of ``nearest_hit_ring_rows`` and
    ``nearest_and_select_ring``. ``carry`` = (best_d, best_i, best_rows,
    row0); ``row0`` captures global row 0, the miss lanes' row, as its
    owner passes."""
    best_d, best_i, best_rows, row0 = carry
    size = blk.shape[0]
    d_blk, i_blk = _sweep_shard(o, d, blk, src_idx, base, cfg)
    rows_blk = blk.index_select(0, i_blk.clamp(0, size - 1))
    gi_blk = torch.where(i_blk >= 0, i_blk + base, i_blk)
    take = _take_mask(best_d, best_i, d_blk, gi_blk)
    best_d = torch.where(take, d_blk, best_d)
    best_i = torch.where(take, gi_blk, best_i)
    best_rows = torch.where(take[:, None], rows_blk, best_rows)
    if owner == 0:
        row0 = blk[0]
    return best_d, best_i, best_rows, row0


def _select_step(blk, owner: int, base: int, u_sel, n_tris: int,
                 prob_col: int, cdf_col: int, last_owner: int,
                 last_local: int, carry):
    """One ring step of the categorical light choice with the chosen row
    carried, the shared body of ``ring_light_select_rows`` and
    ``nearest_and_select_ring``. The stored cdf is the global one, so the
    crossing lies in one shard and is found there: the shard's own
    ``searchsorted`` gives ``j``, and at ``j == 0`` the cdf just before the
    shard is ``cdf[0] - prob[0]``, the JAX package's float32 subtraction.
    ``carry`` = (found, g, rows, fb_row); ``fb_row`` captures global row
    ``n_tris - 1``, the choice when no real row crosses, as its owner
    passes."""
    found, g, rows, fb_row = carry
    size = blk.shape[0]
    cdf = blk[:, cdf_col].contiguous()
    j = torch.searchsorted(cdf, u_sel, right=True)
    prev0 = cdf[0] - blk[0, prob_col]
    jc = j.clamp(0, size - 1)
    gidx = base + jc
    in_shard = (j < size) & ((j > 0) | (u_sel >= prev0)) & (gidx < n_tris)
    newly = in_shard & ~found
    g = torch.where(newly, gidx, g)
    rows = torch.where(newly[:, None], blk.index_select(0, jc), rows)
    found = found | in_shard
    if owner == last_owner:
        fb_row = blk[last_local]
    return found, g, rows, fb_row


def _sweep_carry(o, k: int):
    n = o.shape[0]
    return (torch.full((n,), BIG, dtype=torch.float32, device=o.device),
            torch.full((n,), -1, dtype=torch.int64, device=o.device),
            o.new_zeros((n, k)), o.new_zeros((k,)))


def _select_carry(u_sel, k: int):
    n = u_sel.shape[0]
    return (torch.zeros(n, dtype=torch.bool, device=u_sel.device),
            torch.zeros(n, dtype=torch.int64, device=u_sel.device),
            u_sel.new_zeros((n, k)), u_sel.new_zeros((k,)))


def _sweep_result(carry):
    best_d, best_i, best_rows, row0 = carry
    rows = torch.where((best_i < 0)[:, None], row0[None, :], best_rows)
    return best_d, best_i, rows


def _select_result(carry, n_tris: int):
    found, g, rows, fb_row = carry
    li = torch.where(found, g, torch.full_like(g, n_tris - 1))
    return li, torch.where(found[:, None], rows, fb_row[None, :])


def _last_row(n_tris: int, size: int) -> tuple[int, int]:
    """``(owner, local row)`` of global row ``n_tris - 1``."""
    return (n_tris - 1) // size, (n_tris - 1) % size


def _rows_impl(o, d, table, src_idx, cfg, mesh):
    carry = _sweep_carry(o, table.shape[1])
    blk = table
    for step in range(mesh.size):
        owner = _owner(mesh, step)
        carry = _sweep_step(blk, owner, owner * table.shape[0], o, d,
                            src_idx, cfg, carry)
        if step + 1 < mesh.size:
            blk = mesh.shift(blk)
    return _sweep_result(carry)


def _select_impl(table, u_sel, n_tris, mesh, prob_col, cdf_col):
    size = table.shape[0]
    last_owner, last_local = _last_row(n_tris, size)
    carry = _select_carry(u_sel, table.shape[1])
    blk = table
    for step in range(mesh.size):
        owner = _owner(mesh, step)
        carry = _select_step(blk, owner, owner * size, u_sel, n_tris,
                             prob_col, cdf_col, last_owner, last_local,
                             carry)
        if step + 1 < mesh.size:
            blk = mesh.shift(blk)
    return _select_result(carry, n_tris)


def _sweepsel_impl(o, d, table, src_idx, u_sel, n_tris, cfg, mesh,
                   prob_col, cdf_col):
    size, k = table.shape
    last_owner, last_local = _last_row(n_tris, size)
    sweep_carry = _sweep_carry(o, k)
    sel_carry = _select_carry(u_sel, k)
    blk = table
    for step in range(mesh.size):
        owner = _owner(mesh, step)
        sweep_carry = _sweep_step(blk, owner, owner * size, o, d, src_idx,
                                  cfg, sweep_carry)
        sel_carry = _select_step(blk, owner, owner * size, u_sel, n_tris,
                                 prob_col, cdf_col, last_owner, last_local,
                                 sel_carry)
        if step + 1 < mesh.size:
            blk = mesh.shift(blk)
    return (*_sweep_result(sweep_carry), *_select_result(sel_carry, n_tris))


def _dist_vjp(o, d, rows, idx, g_dist, g_rows):
    """``(go, gd, g_rows)``: the distance's adjoint through the carried
    row's vertex columns (``_dist_from_rows``) added to the rows' own."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (o, d, rows[:, 0:9])]
        go, gd, gr9 = torch.autograd.grad(_dist_from_rows(*leaves, idx),
                                          leaves, g_dist)
    g_rows = g_rows.clone()
    g_rows[:, 0:9] += gr9
    return go, gd, g_rows


class _RingRows(torch.autograd.Function):
    """``nearest_hit_ring_rows``; residuals ``(o, d, idx, rows)``."""

    @staticmethod
    def forward(ctx, o, d, table, src_idx, cfg, mesh):
        dist, idx, rows = _rows_impl(o, d, table, src_idx, cfg, mesh)
        ctx.save_for_backward(o, d, idx, rows)
        ctx.mesh, ctx.size = mesh, table.shape[0]
        ctx.mark_non_differentiable(idx)
        return dist, idx, rows

    @staticmethod
    def backward(ctx, g_dist, _g_idx, g_rows):
        o, d, idx, rows = ctx.saved_tensors
        go, gd, g_rows = _dist_vjp(o, d, rows, idx, g_dist, g_rows)
        g_table = ring_scatter_rows([(g_rows, idx.clamp_min(0))], ctx.size,
                                    ctx.mesh)
        return go, gd, g_table, None, None, None


def nearest_hit_ring_rows(o, d, tri_table, src_idx,
                          cfg: RenderConfig | None, mesh: Mesh):
    """The ring sweep with the winner's table row carried: one rotation of
    the ``(T/S, k)`` table serves the nearest hit and the hit's attributes.
    Equal to ``nearest_hit_ring`` followed by ``ring_gather_rows(tri_table,
    max(idx, 0))``, bit for bit: the row rides the same take mask as the
    (distance, index) carry, and a miss lane gets global row 0. Vertex
    columns are ``tri_table[:, 0:9]``. Returns ``(dist, global idx,
    rows)``, differentiable in ``o``, ``d`` and the table with O(N)
    residuals (module docstring)."""
    if cfg is not None:
        check_method(cfg.intersect)
    return _RingRows.apply(o, d, tri_table, src_idx, cfg, mesh)


class _RingSelect(torch.autograd.Function):
    """``ring_light_select_rows``; residual: the chosen rows' indices."""

    @staticmethod
    def forward(ctx, table, u_sel, n_tris, mesh, prob_col, cdf_col):
        li, rows = _select_impl(table, u_sel, n_tris, mesh, prob_col,
                                cdf_col)
        ctx.save_for_backward(li)
        ctx.mesh, ctx.size = mesh, table.shape[0]
        ctx.mark_non_differentiable(li)
        return li, rows

    @staticmethod
    def backward(ctx, _g_li, g_rows):
        (li,) = ctx.saved_tensors
        return (ring_scatter_rows([(g_rows, li)], ctx.size, ctx.mesh),
                None, None, None, None, None)


def ring_light_select_rows(tri_table, u_sel, n_tris: int, mesh: Mesh,
                           prob_col: int = PROB_COL, cdf_col: int = CDF_COL):
    """The categorical light choice with the chosen row carried, in one
    rotation: ``ops/nee.py::sample_light_points``' global
    ``searchsorted(cdf, u, right=True)`` clipped to ``n_tris - 1``, decided
    shard by shard (``_select_step``). Returns ``(light idx, rows)``; the
    choice is detached, the rows differentiable in the table."""
    return _RingSelect.apply(tri_table, u_sel, n_tris, mesh, prob_col,
                             cdf_col)


class _RingSweepSelect(torch.autograd.Function):
    """``nearest_and_select_ring``; residuals ``(o, d, idx, rows, li)``."""

    @staticmethod
    def forward(ctx, o, d, table, src_idx, u_sel, n_tris, cfg, mesh,
                prob_col, cdf_col):
        dist, idx, rows, li, lrows = _sweepsel_impl(
            o, d, table, src_idx, u_sel, n_tris, cfg, mesh, prob_col,
            cdf_col)
        ctx.save_for_backward(o, d, idx, rows, li)
        ctx.mesh, ctx.size = mesh, table.shape[0]
        ctx.mark_non_differentiable(idx, li)
        return dist, idx, rows, li, lrows

    @staticmethod
    def backward(ctx, g_dist, _g_idx, g_rows, _g_li, g_lrows):
        o, d, idx, rows, li = ctx.saved_tensors
        go, gd, g_rows = _dist_vjp(o, d, rows, idx, g_dist, g_rows)
        g_table = ring_scatter_rows(
            [(g_rows, idx.clamp_min(0)), (g_lrows, li)], ctx.size, ctx.mesh)
        return (go, gd, g_table) + (None,) * 7


def nearest_and_select_ring(o, d, tri_table, src_idx, u_sel, n_tris: int,
                            cfg: RenderConfig | None, mesh: Mesh,
                            prob_col: int = PROB_COL,
                            cdf_col: int = CDF_COL):
    """The ring sweep and the light choice in one rotation: equal to
    ``nearest_hit_ring_rows`` followed by ``ring_light_select_rows``, bit
    for bit (their step bodies are shared), for draws that exist before
    the sweep (the counter-based streams, which NEE requires). Returns
    ``(dist, global idx, winner rows, light idx, light rows)``; both row
    cotangents share one adjoint ring cycle."""
    if cfg is not None:
        check_method(cfg.intersect)
    return _RingSweepSelect.apply(o, d, tri_table, src_idx, u_sel, n_tris,
                                  cfg, mesh, prob_col, cdf_col)


class _RingGather(torch.autograd.Function):
    """``ring_gather_rows``; residual: the indices."""

    @staticmethod
    def forward(ctx, table, global_idx, mesh):
        size = table.shape[0]
        out = table.new_zeros((global_idx.shape[0], table.shape[1]))
        blk = table
        for step in range(mesh.size):
            base = _owner(mesh, step) * size
            rows = blk.index_select(0, (global_idx - base).clamp(0, size - 1))
            mine = (global_idx >= base) & (global_idx < base + size)
            out = torch.where(mine[:, None], rows, out)
            if step + 1 < mesh.size:
                blk = mesh.shift(blk)
        ctx.save_for_backward(global_idx)
        ctx.mesh, ctx.size = mesh, size
        return out

    @staticmethod
    def backward(ctx, g):
        (global_idx,) = ctx.saved_tensors
        # a negative index lies in no shard's window: no contribution, as
        # the forward's zero row
        return (ring_scatter_rows([(g, global_idx)], ctx.size, ctx.mesh),
                None, None)


def ring_gather_rows(table_shard, global_idx, mesh: Mesh):
    """Rows by global index from a table sharded around the ring (a
    negative index gives a zero row): the shard rotates ``S - 1`` times and
    each ray takes its row as the owner passes. Differentiable in the
    table, its adjoint by ``ring_scatter_rows``."""
    return _RingGather.apply(table_shard, global_idx.to(torch.int64), mesh)


def ring_light_select(cdf_shard, u_sel, n_tris: int, mesh: Mesh):
    """The light choice with the cdf column sharded around the ring: the
    global ``searchsorted(side='right')`` count is the sum of the shards'
    counts (padding rows hold cdf 2.0 and count nowhere), clipped to
    ``n_tris - 1``. Detached."""
    cnt = torch.zeros(u_sel.shape, dtype=torch.int64, device=u_sel.device)
    blk = cdf_shard.detach().contiguous()
    for step in range(mesh.size):
        cnt = cnt + torch.searchsorted(blk, u_sel.detach(), right=True)
        if step + 1 < mesh.size:
            blk = mesh.shift(blk)
    return cnt.clamp(0, n_tris - 1)


def _ring_sample(table, o, d, rng, cfg: RenderConfig, sample: int,
                 mesh: Mesh, n_tris: int):
    """One sample of this rank's rays through the ring-sharded table:
    ``models/pathtracer.py::trace_geometry``'s bounce loop, its arithmetic
    op for op, with the ring's primitives for the sweeps and the light
    choice and the hit's normal and area from its carried vertices
    (``unit((v1-v0) x (v2-v0))`` with the 1e-20 guard, ``0.5·|...|``).
    Returns ``(radiance (N, 3), rng)``."""
    n, device = o.shape[0], o.device
    use_mis = cfg.nee and cfg.mis and cfg.sampler != "angle"
    if use_mis:
        prev_pdf = torch.zeros(n, dtype=torch.float32, device=device)
    verts = table[:, VERTS].detach()
    throughput = torch.ones((n, 3), dtype=torch.float32, device=device)
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=device)
    alive = torch.ones(n, dtype=torch.bool, device=device)
    src = torch.full((n,), -1, dtype=torch.int64, device=device)
    for bounce in range(cfg.max_bounces):
        if cfg.rng != "lcg":
            us = _bounce_uniforms(cfg, rng, sample, bounce)
        if cfg.nee:
            dist, idx, rows, li, lrows = nearest_and_select_ring(
                o, d, table, src, us[2], n_tris, cfg, mesh)
        else:
            dist, idx, rows = nearest_hit_ring_rows(o, d, table, src, cfg,
                                                    mesh)
        hit = alive & (idx >= 0)
        hit3 = hit[:, None]
        safe = idx.clamp_min(0)
        point = o + dist[:, None] * d
        gv0 = rows[:, 0:3]
        e1, e2 = rows[:, 3:6] - gv0, rows[:, 6:9] - gv0
        nrm = cross3(e1, e2)
        norm = sqrt_rn(nrm[:, 0] * nrm[:, 0] + nrm[:, 1] * nrm[:, 1]
                       + nrm[:, 2] * nrm[:, 2])
        nrm = nrm / torch.clamp_min(norm, 1e-20)[:, None]
        alb, emi = rows[:, ALBEDO], rows[:, EMISSION]
        flip = dot3(nrm, d) > 0.0
        adj_n = torch.where(flip[:, None], -nrm, nrm)
        if cfg.rng == "lcg":
            s1, u1 = lcg_next(rng)
            s2, u2 = lcg_next(s1)
            rng = torch.where(hit, s2, rng)
            us = (u1, u2)
        u_az = us[0]
        if cfg.stratify and bounce == 0:
            u_az = (float(np.float32(sample)) + u_az) \
                * float(np.float32(1.0 / cfg.spp))
        next_d, weight = hemisphere_sample(cfg.sampler, adj_n, u_az, us[1])
        next_d = next_d.detach()
        if cfg.sampler in ("angle", "uniform"):
            weight = 2.0 * dot3(next_d, adj_n)

        if cfg.nee:
            if bounce == 0:
                radiance = radiance + torch.where(hit3, throughput * emi, 0.0)
            elif use_mis:
                cos_l = torch.abs(dot3(nrm, d))
                p_here = nee.nee_pdf_of_hit(
                    rows[:, PROB_COL], nee.areas_from_edges(e1, e2).detach(),
                    dist, cos_l)
                w_b = (prev_pdf * prev_pdf / torch.clamp_min(
                    prev_pdf * prev_pdf + p_here * p_here, 1e-30)).detach()
                term = throughput * emi * w_b[:, None]
                radiance = radiance + torch.where(hit3, term, 0.0)
            direct = _direct_light(lrows, li, point, adj_n, safe, us, alb,
                                   cfg, verts, mesh)
            radiance = radiance + torch.where(hit3, throughput * direct, 0.0)
        else:
            radiance = radiance + torch.where(hit3, throughput * emi, 0.0)
        throughput = torch.where(hit3, throughput * alb * weight[:, None],
                                 throughput)
        o = torch.where(hit3, point, o)
        d = torch.where(hit3, next_d, d)
        src = torch.where(hit, idx, src)
        alive = hit
        if cfg.rr_start and cfg.rr_start <= bounce < cfg.max_bounces - 1:
            q = torch.clamp(throughput.max(dim=-1).values, 0.05, 1.0).detach()
            survive = us[5 if cfg.nee else 2] < q
            throughput = torch.where((hit & survive)[:, None],
                                     throughput / q[:, None], throughput)
            alive = hit & survive
        if use_mis:
            prev_pdf = nee.bsdf_pdf(cfg.sampler,
                                    dot3(next_d, adj_n)).detach()
    return radiance, rng


def _direct_light(lrows, li, point, adj_n, safe, us, alb, cfg, verts,
                  mesh):
    """``ops/nee.py::direct_light`` on the chosen light's carried row
    ``lrows`` (light ``li``), its shadow ray swept around the ring
    (``_nearest_ring`` on the resident vertices, the occlusion index
    alone)."""
    lv0 = lrows[:, 0:3]
    points = nee.light_points(lv0, lrows[:, 3:6] - lv0, lrows[:, 6:9] - lv0,
                              lrows[:, EMISSION], lrows[:, PROB_COL], li,
                              us[3], us[4])

    def occluder(p, omega):
        return _nearest_ring(p, omega, verts, safe, cfg, mesh)[1]

    return nee.direct_from_points(points, point, adj_n, safe, cfg, alb,
                                  occluder)


def _trace_ring(table, o, d, pixel_ids, cfg: RenderConfig, seed,
                mesh: Mesh, n_tris: int):
    """Mean radiance ``(N, 3)`` of this rank's rays, their streams keyed by
    their global pixel ids (the LCG's ``pixel id + seed``, the hash, table
    and threefry streams as ``models/pathtracer.py::_stream`` keys them),
    against the ring-sharded ``table`` (this rank's ``(T/S, 15|17)``
    shard). Under autograd with ``cfg.remat`` and more than 8 samples each
    sample is checkpointed; its recomputation in the backward pass rotates
    the shards again, in the same order on every rank."""
    if cfg.rng == "lcg":
        rng = lcg_seeds(seed, pixel_ids)
    else:
        rng = _stream(cfg, seed, pixel_ids)
    remat = cfg.remat and cfg.spp > 8 and torch.is_grad_enabled()
    accum = torch.zeros((o.shape[0], 3), dtype=torch.float32,
                        device=o.device)
    for s in range(cfg.spp):
        rng_s = rng.sample(s) if cfg.rng == "threefry" else rng
        args = (table, o, d, rng_s, cfg, s, mesh, n_tris)
        if remat:
            rad, rng_s = checkpoint(_ring_sample, *args, use_reentrant=False)
        else:
            rad, rng_s = _ring_sample(*args)
        if cfg.rng == "lcg":
            rng = rng_s
        accum = accum + rad
    return accum * float(np.float32(1.0) / np.float32(cfg.spp))


def _ring_table(scene: Scene, cfg: RenderConfig, n_shards: int):
    """The ring table ``(Tp, 15|17)``: v0, v1, v2, albedo, emission and,
    with NEE, the light choice's prob and cdf (``ops/nee.py::light_cdf``,
    detached), padded with zero rows to a multiple of ``n_shards``, the
    padding's cdf ``PAD_CDF``. Differentiable in the scene."""
    cols = [scene.v0, scene.v1, scene.v2, scene.albedo, scene.emission]
    if cfg.nee:
        cdf, prob = nee.light_cdf(scene)
        cols += [prob[:, None], cdf[:, None]]
    table = torch.cat(cols, dim=1)
    pad = (-table.shape[0]) % n_shards
    if pad:
        fill = table.new_zeros((pad, table.shape[1]))
        if cfg.nee:
            fill[:, CDF_COL] = PAD_CDF
        table = torch.cat([table, fill])
    return table


class _Shard(torch.autograd.Function):
    """``_Shard.apply(table, mesh)``: this rank's rows of the replicated
    ring table. Backward: every member's shard adjoint, concatenated in
    mesh order (one all-gather), the whole table's adjoint on every
    rank."""

    @staticmethod
    def forward(ctx, table, mesh):
        ctx.mesh = mesh
        size = table.shape[0] // mesh.size
        lo = mesh.member_index() * size
        return table[lo:lo + size].clone()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(ctx.mesh.all_gather(g.contiguous())), None


def _check_ring(scene: Scene, cfg: RenderConfig) -> None:
    check_estimator(cfg)
    check_method(cfg.intersect)
    if scene.device.type == "cuda" and not within_caps(scene):
        raise NotImplementedError(
            f"the triangle ring on the card takes T <= 2^20 triangles (the "
            f"streamed kernels' cap, which every route on the card keeps); "
            f"got {scene.n_tris}")


def ring_radiance_from_rays(scene: Scene, o, d, pixel_ids, seed,
                            cfg: RenderConfig, mesh: Mesh,
                            n_tris: int | None = None):
    """Ring-sharded mean radiance of explicit rays, ``(N, 3)`` on every
    rank: the rays-level core. Every rank passes the same inputs; the rays
    and their global pixel ids are padded with zeros to a multiple of the
    mesh size (a zero direction never hits; the padding is dropped), each
    rank traces its contiguous block against its contiguous block of the
    table's rows, and the blocks are all-gathered in mesh order.
    Differentiable in the scene (every rank gets the whole gradient) and
    in ``o`` and ``d`` (this rank's block)."""
    _check_ring(scene, cfg)
    n_tris = scene.n_tris if n_tris is None else n_tris
    size = mesh.size
    index = mesh.member_index()
    n = o.shape[0]
    o, _ = pad_to_multiple(o, size)
    d, _ = pad_to_multiple(d, size)
    ids, _ = pad_to_multiple(pixel_ids.to(torch.int64), size)
    per = o.shape[0] // size
    lo, hi = index * per, (index + 1) * per
    shard = _Shard.apply(_ring_table(scene, cfg, size), mesh)
    block = _trace_ring(shard, o[lo:hi], d[lo:hi], ids[lo:hi], cfg, seed,
                        mesh, n_tris)
    return _AllGather.apply(block, mesh, lo, hi)[:n]


def _ranked_camera(camera: Camera, mesh: Mesh) -> Camera:
    """The camera with its leaves that carry a gradient passed through
    ``_RankSum``: each rank's block of rays gives a part of its gradient,
    summed over the ranks in rank order. The scene needs no sum: its
    gradient comes whole from ``_Shard``."""
    leaves = [camera.pos, camera.angle, camera.focal]
    diff = [i for i, t in enumerate(leaves) if t.requires_grad]
    if mesh.group is None or not diff or not torch.is_grad_enabled():
        return camera
    for i, t in zip(diff, _RankSum.apply(mesh, *(leaves[i] for i in diff))):
        leaves[i] = t
    return Camera(*leaves)


def render_radiance_ring(scene: Scene, camera: Camera, cfg: RenderConfig,
                         mesh: Mesh, seed: int = 0) -> torch.Tensor:
    """Unclamped ring-sharded radiance ``(H, W, 3)`` on every rank, the
    differentiable entry: ``torch.autograd`` reaches the scene's vertices,
    albedo and emission and the camera while the triangle data exist only
    as ring shards, forward and backward. The frame is the one-device
    wavefront's (``render_radiance``) bit for bit; the gradients agree with
    its to float32 summation order. NEE on the LCG or table stream raises
    the JAX package's ``ValueError``."""
    _check_devices(scene, camera)
    _check_ring(scene, cfg)
    camera = _ranked_camera(camera, mesh)
    o, d, ids = pixel_rays(camera, cfg.width, cfg.height)
    rad = ring_radiance_from_rays(scene, o, d, ids, seed, cfg, mesh)
    return rad.reshape(cfg.height, cfg.width, 3)


def render_pt_ring(scene: Scene, camera: Camera, cfg: RenderConfig,
                   mesh: Mesh, seed: int = 0) -> torch.Tensor:
    """Path-traced frame with rays and triangle data sharded over the
    mesh, with the reference's clamp: every estimator of the wavefront
    (NEE and MIS with the prob and cdf columns riding the ring, Russian
    roulette, stratification), the one-device frame bit for bit."""
    return torch.clamp(render_radiance_ring(scene, camera, cfg, mesh, seed),
                       0.0, 1.0)


def render_flat_ring(scene: Scene, camera: Camera, cfg: RenderConfig,
                     mesh: Mesh) -> torch.Tensor:
    """Flat view with rays and triangles sharded over the mesh:
    ``models/flat.py::render_flat`` bit for bit, each rank sweeping its
    block of rays around the ring (``nearest_hit_ring``)."""
    _check_devices(scene, camera)
    _check_ring(scene, cfg)
    size, index = mesh.size, mesh.member_index()
    o, d, _ = pixel_rays(camera, cfg.width, cfg.height)
    o, n = pad_to_multiple(o, size)
    d, _ = pad_to_multiple(d, size)
    per = o.shape[0] // size
    lo, hi = index * per, (index + 1) * per
    verts, _ = pad_to_multiple(scene.vertices.reshape(-1, 9), size)
    rows = verts.shape[0] // size
    v = verts[index * rows:(index + 1) * rows]
    src = torch.full((hi - lo,), -1, dtype=torch.int64, device=o.device)
    _, idx = nearest_hit_ring(o[lo:hi], d[lo:hi], v[:, 0:3], v[:, 3:6],
                              v[:, 6:9], src, cfg, mesh)
    color = torch.where((idx >= 0)[:, None],
                        scene.albedo[idx.clamp_min(0)],
                        torch.zeros((), dtype=torch.float32, device=o.device))
    frame = torch.cat(mesh.all_gather(color))[:n]
    return frame.reshape(cfg.height, cfg.width, 3)


def ring_train_step(scene: Scene, camera: Camera, cfg: RenderConfig,
                    mesh: Mesh, target, seed: int = 0, lr: float = 1e-2):
    """One SGD step on ``mean((render_radiance_ring - target)^2)`` over the
    scene's vertices, albedo and emission, the triangle data resident only
    as ring shards. Every rank gets the same loss and the same new scene.
    Returns ``(loss, new_scene)``."""
    leaves = [t.detach().requires_grad_() for t in (
        scene.vertices, scene.albedo, scene.emission)]
    s = Scene(*leaves, scene.light_idx)
    img = render_radiance_ring(s, camera, cfg, mesh, seed)
    loss = torch.mean((img - target) ** 2)
    grads = torch.autograd.grad(loss, leaves)
    new = [(p - lr * g).detach() for p, g in zip(leaves, grads)]
    return loss.detach(), dataclasses.replace(scene, vertices=new[0],
                                              albedo=new[1],
                                              emission=new[2])
