"""The quality kernel's hand-written reverse sweep (K4) and its autograd
Function.

The port of ``spath_tpu/ops/pallas/megakernel_quality_grad.py``: one
launch of ``csrc/megakernel_quality_grad.cu`` replays K3's walk for
every sample and runs the analytic reverse sweep ``_reverse_bounce``.
Unlike the conformance estimator's, the position chain is live: the NEE
term depends on the hit point through ω = (y − p)/r, r² and both cosines,
so gradients reach the light's vertices (through y = v0 + b1·e1 + b2·e2),
the hit triangle's geometry (through the Möller–Trumbore distance), the
light's normal and area, and the camera rays. ``QualityRows`` puts K3
forward and K4 backward under ``torch.autograd``, in place of the JAX
package's ``quality_rows`` custom VJP; ``render_radiance_quality_grad``
is the differentiable render through them, whose camera gradient flows
from K4's ray adjoint through ``generate_rays``.

Adjoint layout per triangle (19 columns): v0, e1, e2, normal, albedo,
emission, area, scattered at the hit triangle (columns 0-17) and at the
light whose NEE term counted (columns 0-11 and 15-18);
``grad_table_from_gtab19`` maps it onto the (T, 21) table, where prob and
cdf get zero (they are detached). The ray adjoint is ``(n, 6)``: origin,
direction.

K4's lanes alternate two warp-wide epochs
(``csrc/megakernel_quality_grad.cu``): ``EPOCH`` forward steps of
K3's walk (``csrc/quality_lanes.cuh``, regenerating across samples and
pixels), each bounce's record appended to the lane's ring of ``ring_size``
records, then one reverse epoch over every lane's finished samples, in
sample order and last bounce first (``reverse_order``). Its warps take
their pixels from a fixed assignment of runs on a persistent grid of K4's
resident CTAs (``k4_grid``), so the table adjoint sums in an order fixed
by the sizes and the data: each warp adds its float32 shared-memory slice
into its own float64 row after every reverse epoch, and the rows are
summed in float64 and rounded once. ``epoch_schedule`` and
``lockstep_cost`` count the schedules.

``quality_bwd_call`` launches K4 for CUDA tensors and counts each launch
in ``quality_bwd_call.launches``; for CPU tensors it computes the same
function with ``quality_bwd_plain``, the plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from spath_tpu_torch.camera import Camera, pixel_rays
from spath_tpu_torch.config import RenderConfig
from spath_tpu_torch.ops.fp import sqrt_rn
from spath_tpu_torch.ops.intersect import plain_sweep
from spath_tpu_torch.ops.kernels import bigscene as bs
from spath_tpu_torch.ops.kernels import megakernel_quality as mq
from spath_tpu_torch.ops.kernels.build import library
from spath_tpu_torch.ops.nee import INV_PI
from spath_tpu_torch.ops.rng import hash_keys
from spath_tpu_torch.ops.sampling import cross3, dot3
from spath_tpu_torch.scene import Scene

#: Largest scene K4 takes: two warp slices of (T, 19) float32 fit a
#: Hopper block's shared memory up to T = 1468 (``csrc`` header comment);
#: equal to K3's ``MAX_TRIS``.
GRAD_MAX_TRIS = 1024
#: Longest path K4 replays: it keeps per-bounce state in fixed arrays of
#: ``MAX_BOUNCES`` (``csrc/megakernel_common.cuh``: ``kMaxBounces``);
#: deeper gradients go to the wavefront.
MAX_BOUNCES = 64
#: Adjoint columns per triangle.
ADJ = 19
#: Forward steps of K4's epoch (the kernel's ``kEpoch``: ``MAX_BOUNCES``,
#: so any path fits), and its pixels a run (chunks of 32), counted
#: (``epoch_schedule``) and timed on an H100 (PERF.md).
EPOCH, RUN_CHUNKS = MAX_BOUNCES, 1
#: Floats of a ring slot of a K4 lane: a record (16) and a tag (4).
RING_FLOATS = 20
#: A reverse bounce's cost in forward steps in the counts: K4's time
#: beyond K3's over K3's, 37.517 and 17.438 ms before the epochs (PERF.md).
REVERSE_COST = 1.15


def _epoch(epoch: int, max_bounces: int) -> int:
    if epoch < max_bounces:
        raise ValueError(f"an epoch of {epoch} steps is shorter than "
                         f"{max_bounces} bounces")
    return epoch


def ring_size(max_bounces: int, epoch: int = EPOCH) -> int:
    """Records a K4 lane's ring holds: an epoch's, and those of a sample
    still in flight (at most ``max_bounces - 1``); the kernel starts a
    sample only where the ring has room for all its bounces."""
    return _epoch(epoch, max_bounces) + max_bounces - 1


def reverse_order(pixels, epoch: int, max_bounces: int) -> list:
    """The reverse epochs of one lane (NEE: one record a sweep), as a list
    of ``(forward_steps, [(pixel, sample, bounce), ...])``: the lane takes
    the ``(pixel, [bounces of each sample])`` of ``pixels`` in order,
    sweeps each camera ray in a step of its own and each bounce's rays in
    one step, recording the bounce, and after every ``epoch`` forward
    steps (at least ``max_bounces``; the kernel's is ``EPOCH``) or its
    last reverses the samples finished so far, in sample order, last
    bounce first."""
    e = _epoch(epoch, max_bounces)
    steps = []  # per forward step: the samples finishing there
    for pix, lengths in pixels:
        steps.append([])
        for s, n in enumerate(lengths):
            if n:
                steps.extend([[]] * (n - 1))
                steps.append([(pix, s, n)])
    out = []
    for k in range(0, len(steps), e):
        done = [(pix, s, b) for step in steps[k:k + e]
                for pix, s, n in step for b in reversed(range(n))]
        out.append((min(e, len(steps) - k), done))
    return out


def epoch_schedule(totals, epoch: int, max_bounces: int, run: int,
                   warps: int, lanes: int = 32,
                   reverse_cost: float = REVERSE_COST) -> dict:
    """K4's epochs of ``epoch`` forward steps (at least ``max_bounces``;
    the kernel's is ``EPOCH``) counted on the pixels of ``totals``
    (``bigscene.lane_schedules``' layout, NEE: a sample's sweeps are its
    records): ``warps`` warps of ``lanes`` lanes take their pixels from
    runs of ``run`` (``bigscene.run_sequences``, ``list_schedule``); a
    warp's forward steps are its lanes' last step, and each epoch's
    reverse steps the most records any lane finished in it. Returns the
    forward and reverse warp steps, their cost in forward steps and the
    useful cost over ``lanes``."""
    totals = np.asarray(totals, dtype=np.int64)
    e = _epoch(epoch, max_bounces)
    per_pixel = totals.sum(axis=1)
    fwd = rev = 0
    for seq in bs.run_sequences(totals.shape[0], run, warps):
        if not seq.size:
            continue
        lane, start = bs.list_schedule(per_pixel[seq], lanes)
        fwd += int((start + per_pixel[seq]).max())
        lengths = totals[seq, 1:]
        ends = start[:, None] + np.cumsum(lengths, axis=1)
        has = lengths > 0
        when = ends[has] // e
        per = np.zeros((lanes, int(when.max()) + 1 if when.size else 1),
                       dtype=np.int64)
        np.add.at(per, (np.broadcast_to(lane[:, None], lengths.shape)[has],
                        when), lengths[has])
        rev += int(per.max(axis=0).sum())
    useful = (per_pixel.sum() + reverse_cost * totals[:, 1:].sum()) / lanes
    return dict(forward_steps=fwd, reverse_steps=rev,
                cost=fwd + reverse_cost * rev, useful_cost=float(useful))


def lockstep_cost(totals, lanes: int = 32,
                  reverse_cost: float = REVERSE_COST) -> dict:
    """The loop K4's epochs replaced, counted as ``epoch_schedule``: a lane
    a pixel, ``lanes`` consecutive pixels a warp, which sweeps the camera
    rays once, then for each sample replays as many forward steps and
    reverses as many steps as its longest path has."""
    totals = np.asarray(totals, dtype=np.int64)
    pad = (-totals.shape[0]) % lanes
    warp = np.pad(totals, ((0, pad), (0, 0))).reshape(-1, lanes,
                                                      totals.shape[1])
    longest = warp.max(axis=1)
    fwd = int(longest.sum())
    rev = int(longest[:, 1:].sum())
    return dict(forward_steps=fwd, reverse_steps=rev,
                cost=fwd + reverse_cost * rev)


@functools.cache
def k4_resident(device_index: int, n_tris: int) -> tuple[int, int, int]:
    """``(per_sm, sms, threads)``: K4's resident CTAs on one SM at ``T``
    triangles (its shared memory grows with T), the card's SMs and the
    block's threads."""
    lib = library()
    with torch.cuda.device(device_index):
        per_sm = lib.spath_quality_backward_occupancy(n_tris)
        threads = lib.spath_quality_backward_threads(n_tris)
    if per_sm <= 0:
        err = lib.spath_error_string(-per_sm).decode()
        raise RuntimeError(f"K4 occupancy query failed: CUDA error "
                           f"{-per_sm} ({err})")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return per_sm, sms, threads


def lane_grid(n: int, run: int, warps: int, cap: int | None = None) -> int:
    """CTAs of ``warps`` warps for ``n`` pixels in runs of ``run`` pixels
    a warp (``bigscene.run_sequences``): one run a warp, at most ``cap``
    CTAs (a persistent grid, whose warps then own several runs each)."""
    if n < 1 or run < 1 or warps < 1:
        raise ValueError(f"no grid for n={n}, run={run}, warps={warps}")
    grid = -(-(-(-n // run)) // warps)
    return grid if cap is None else max(1, min(grid, cap))


def k4_grid(n: int, n_tris: int, device: torch.device) -> tuple:
    """``(grid, run, threads)`` of a K4 launch: runs of ``RUN_CHUNKS``
    chunks of 32 pixels on a persistent grid of K4's resident CTAs
    (``lane_grid``)."""
    index = device.index
    per_sm, sms, threads = k4_resident(
        torch.cuda.current_device() if index is None else index, n_tris)
    run = RUN_CHUNKS * mq.WARP
    return lane_grid(n, run, threads // mq.WARP, per_sm * sms), run, \
        threads


def supported_grad(scene: Scene, cfg: RenderConfig) -> bool:
    """Do K3 and K4 differentiate ``(scene, cfg)``? Not with
    ``vis_grad`` (``VisGradFusedRenderer`` adds its residual)."""
    return (mq.supported(scene, cfg) and not cfg.vis_grad
            and scene.n_tris <= GRAD_MAX_TRIS
            and cfg.max_bounces <= MAX_BOUNCES)


def _reverse_bounce(sv, tb, ob, g3, tri, cfg: RenderConfig):
    """One bounce of the reverse sweep (``_reverse_bounce``) over masked
    lanes, in the JAX kernel's order of operations. ``tb``/``ob`` are the
    throughput and origin adjoints of the bounce after. Returns ``(tb,
    onew, gry_d, surf (n, 18), light (n, 19) or None)``."""
    hit = sv["hit"]
    hit3 = hit[:, None]
    dist, o, d, tr = sv["dist"], sv["o"], sv["d"], sv["tr"]
    row = tri[sv["idx"]]
    nrm, alb, emi = row[:, 9:12], row[:, 12:15], row[:, 15:18]
    flip3 = sv["flip"][:, None]
    fs = torch.where(sv["flip"], -1.0, 1.0)
    an = torch.where(flip3, -nrm, nrm)
    zeros = torch.zeros_like(tr)

    # Russian roulette: the continuation's detached 1/q reweight
    if "rrq" in sv:
        tb = torch.where(sv["rrs"][:, None], tb / sv["rrq"][:, None], tb)
    ew = sv["w_b"][:, None] if cfg.nee else torch.ones_like(tr)
    ebar = torch.where(hit3, g3 * tr * ew, 0.0)
    tb_new = torch.where(hit3, tb * alb, tb) \
        + torch.where(hit3, g3 * emi * ew, 0.0)
    albbar = torch.where(hit3, tb * tr, 0.0)
    nrawbar = zeros
    pbar = torch.where(hit3, ob, 0.0)

    light = None
    if cfg.nee:
        ok3 = sv["ok"][:, None]
        lrow = tri[sv["li"]]
        lv0, le1, le2 = lrow[:, 0:3], lrow[:, 3:6], lrow[:, 6:9]
        ln, lem = lrow[:, 9:12], lrow[:, 15:18]
        lprob, larea = lrow[:, mq.COL_PROB], lrow[:, mq.COL_AREA]
        b1, b2, misw = sv["b1"], sv["b2"], sv["misw"]
        # the NEE geometry again (no O(T) sweep)
        p = o + dist[:, None] * d
        y = lv0 + b1[:, None] * le1 + b2[:, None] * le2
        dl = y - p
        r2 = dot3(dl, dl)
        rl = sqrt_rn(torch.clamp_min(r2, 1e-20))
        om = dl / rl[:, None]
        cos_s = dot3(an, om)
        q = dot3(ln, om)
        cos_l = torch.abs(q)
        r2m = torch.clamp_min(r2, 1e-12)
        g = cos_s * cos_l / r2m
        wden = torch.clamp_min(lprob, 1e-20)
        wgt = larea / wden
        scale = (g * wgt * INV_PI * misw)[:, None]

        # rad_c += ok · tr_c·alb_c·lem_c·scale
        tb_new = tb_new + torch.where(ok3, g3 * alb * lem * scale, 0.0)
        albbar = albbar + torch.where(ok3, g3 * tr * lem * scale, 0.0)
        lembar = torch.where(ok3, g3 * tr * alb * scale, 0.0)
        t = torch.where(ok3, g3, 0.0) * tr * alb * lem
        sbar = ((0.0 + t[:, 0]) + t[:, 1]) + t[:, 2]
        gbar_g = sbar * wgt * INV_PI * misw
        wgtbar = sbar * g * INV_PI * misw
        areabar = wgtbar / wden
        cosbar_s = gbar_g * cos_l / r2m
        cosbar_l = gbar_g * cos_s / r2m
        r2bar = torch.where(r2 >= 1e-12,
                            -gbar_g * cos_s * cos_l / (r2m * r2m), 0.0)
        qbar = torch.sign(q) * cosbar_l
        lnbar = qbar[:, None] * om
        nrawbar = nrawbar + fs[:, None] * (cosbar_s[:, None] * om)
        ombar = cosbar_s[:, None] * an + qbar[:, None] * ln
        dlbar = ombar / rl[:, None]
        rlbar = -dot3(ombar, dl) / (rl * rl)
        r2bar = r2bar + torch.where(r2 >= 1e-20, rlbar / (rl + rl), 0.0)
        dlbar = dlbar + 2.0 * r2bar[:, None] * dl
        pbar = pbar - dlbar
        light = torch.cat([dlbar, b1[:, None] * dlbar, b2[:, None] * dlbar,
                           lnbar, zeros, lembar, areabar[:, None]], dim=1)

    # Möller–Trumbore distance chain (live when pbar != 0)
    distbar = dot3(pbar, d)
    v0, e1, e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    s_ = o - v0
    h = cross3(d, e2)
    fa = 1.0 / torch.where(hit, dot3(e1, h), 1.0)
    g1 = torch.where(hit, distbar * fa, 0.0)[:, None]
    tn = cross3(e1, e2)
    dist3 = dist[:, None]
    surf = torch.cat([-g1 * tn, g1 * (cross3(e2, s_) - dist3 * h),
                      g1 * (cross3(s_, e1) - dist3 * cross3(e1, d)),
                      nrawbar, albbar, ebar], dim=1)
    onew = torch.where(hit3, 0.0, ob) + pbar + g1 * tn
    gry_d = torch.where(hit3, dist3 * pbar + g1 * dist3 * tn, 0.0)
    return tb_new, onew, gry_d, surf, light


def quality_bwd_plain(origins, directions, keys, tri, light_idx, gbar,
                      cfg: RenderConfig):
    """The plain PyTorch version of K4: for each sample the forward state
    of ``megakernel_quality.quality_replay``, then the reverse sweep over
    the table's columns, vectorised over rays, with ``index_add_`` of the
    surface terms at the hit triangle and of the NEE terms at the light.
    Returns ``(gtab19 (T, 19), grays (n, 6))``.

    The table adjoint accumulates in float64, as ``mega_bwd_plain``'s: a
    float32 running sum of a frame's ~10⁹ terms drops the small ones. The
    ray adjoint is a per-ray float32 sum over samples, as K4's."""
    with torch.no_grad(), plain_sweep():
        n = origins.shape[0]
        g3 = gbar * float(np.float32(1.0 / cfg.spp))
        adj = torch.zeros((tri.shape[0], ADJ), dtype=torch.float64,
                          device=origins.device)
        grays = torch.zeros((n, 6), dtype=torch.float32,
                            device=origins.device)
        pad = torch.zeros((n, 1), dtype=torch.float32, device=origins.device)
        for _, saved in mq.quality_replay(origins, directions, keys, tri,
                                          light_idx, cfg):
            tb = torch.zeros((n, 3), dtype=torch.float32,
                             device=origins.device)
            ob = torch.zeros_like(tb)
            for b in reversed(range(len(saved))):
                sv = saved[b]
                tb_new, onew, gry_d, surf, light = _reverse_bounce(
                    sv, tb, ob, g3, tri, cfg)
                hit = sv["hit"]
                adj.index_add_(0, sv["idx"][hit],
                               torch.cat([surf, pad], 1)[hit].double())
                if light is not None:
                    ok = sv["ok"]
                    adj.index_add_(0, sv["li"][ok], light[ok].double())
                if b == 0:
                    grays = grays + torch.cat([onew, gry_d], 1)
                else:
                    ob = onew
                tb = tb_new
        return adj.float(), grays


def grad_table_from_gtab19(gtab19: torch.Tensor) -> torch.Tensor:
    """``(T, 19)`` adjoint → ``(T, 21)`` quality-table cotangent: columns
    0-17 as they are, area (18) to column 19; prob (18) and cdf (20) get
    zero (detached by construction)."""
    zero = torch.zeros_like(gtab19[:, :1])
    return torch.cat([gtab19[:, :18], zero, gtab19[:, 18:19], zero], dim=1)


def _check(origins, directions, keys, tri, light_idx, gbar,
           cfg: RenderConfig) -> None:
    mq._check(origins, directions, keys, tri, light_idx, cfg)
    n = origins.shape[0]
    if gbar.dtype != torch.float32 or tuple(gbar.shape) != (n, 3):
        raise ValueError(f"gbar must be float32 ({n}, 3), got {gbar.dtype} "
                         f"{tuple(gbar.shape)}")
    if gbar.device != origins.device:
        raise ValueError("gbar must be on the rays' device")
    if tri.shape[0] > GRAD_MAX_TRIS:
        raise ValueError(f"T={tri.shape[0]} above K4's {GRAD_MAX_TRIS}")
    if cfg.max_bounces > MAX_BOUNCES:
        raise ValueError(f"max_bounces={cfg.max_bounces} above K4's "
                         f"{MAX_BOUNCES}")


def quality_bwd_call(origins, directions, keys, tri, light_idx, gbar,
                     cfg: RenderConfig):
    """``(gtab19 (T, 19), grays (n, 6))``: the table and ray adjoints of
    K3's output for the cotangent ``gbar`` (layouts in the module
    docstrings). Launches K4 on CUDA tensors, on PyTorch's current stream
    and without synchronising; a failed build or launch raises. CPU
    tensors take ``quality_bwd_plain``."""
    gbar = gbar.contiguous()
    _check(origins, directions, keys, tri, light_idx, gbar, cfg)
    if origins.device.type == "cpu":
        return quality_bwd_plain(origins, directions, keys, tri, light_idx,
                                 gbar, cfg)
    if origins.device.type != "cuda":
        raise ValueError(f"no backward kernel for device {origins.device}")
    n, n_tris = origins.shape[0], tri.shape[0]
    grays = torch.zeros((n, 6), dtype=torch.float32, device=origins.device)
    if n == 0:
        return torch.zeros((n_tris, ADJ), device=origins.device), grays
    rows = mq._rows(light_idx, n_tris, origins.device)
    lib = library()
    grid, run, threads = k4_grid(n, n_tris, origins.device)
    partial = torch.empty((grid * (threads // mq.WARP), n_tris * ADJ),
                          dtype=torch.float64, device=origins.device)
    rings = torch.empty(grid * threads * ring_size(cfg.max_bounces)
                        * RING_FLOATS, dtype=torch.float32,
                        device=origins.device)
    with torch.cuda.device(origins.device):
        stream = torch.cuda.current_stream(origins.device).cuda_stream
        err = lib.spath_quality_backward(
            ctypes.c_void_p(origins.data_ptr()),
            ctypes.c_void_p(directions.data_ptr()),
            ctypes.c_void_p(keys.data_ptr()),
            ctypes.c_void_p(tri.data_ptr()),
            ctypes.c_void_p(rows.data_ptr()),
            ctypes.c_void_p(gbar.data_ptr()),
            ctypes.c_void_p(partial.data_ptr()),
            ctypes.c_void_p(grays.data_ptr()),
            ctypes.c_void_p(rings.data_ptr()),
            n, *mq.kernel_args(cfg, n_tris, rows.shape[0]), run, grid,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"quality backward launch failed: CUDA error "
                           f"{err} ({lib.spath_error_string(err).decode()})")
    quality_bwd_call.launches += 1
    return partial.sum(0).float().view(n_tris, ADJ), grays


quality_bwd_call.launches = 0


class QualityRows(torch.autograd.Function):
    """K3 forward, K4 backward: ``QualityRows.apply(tri, origins,
    directions, keys, light_idx, cfg)`` is the ``(n, 3)`` mean radiance,
    differentiable in the ``(T, 21)`` table and the camera rays."""

    @staticmethod
    def forward(ctx, tri, origins, directions, keys, light_idx, cfg):
        ctx.save_for_backward(tri, origins, directions, keys)
        ctx.light_idx, ctx.cfg = light_idx, cfg
        return mq.quality_call(origins, directions, keys, tri, light_idx,
                               cfg)

    @staticmethod
    def backward(ctx, gbar):
        tri, origins, directions, keys = ctx.saved_tensors
        gtab, grays = quality_bwd_call(origins, directions, keys, tri,
                                       ctx.light_idx, gbar, ctx.cfg)
        return (grad_table_from_gtab19(gtab), grays[:, 0:3], grays[:, 3:6],
                None, None, None)


def radiance_block_grad(scene: Scene, origins, directions, pixel_ids,
                        cfg: RenderConfig, seed: int = 0) -> torch.Tensor:
    """``megakernel_quality.radiance_block``, differentiable
    (``QualityRows``), the rays' adjoint included."""
    if not supported_grad(scene, cfg):
        raise ValueError("quality megakernel VJP needs rng='hash', "
                         f"sampler='cosine', T <= {GRAD_MAX_TRIS}, "
                         f"max_bounces <= {MAX_BOUNCES}")
    return QualityRows.apply(mq.quality_table(scene), origins, directions,
                             hash_keys(seed, pixel_ids), mq.light_rows(scene),
                             cfg)


def render_radiance_quality_grad(scene: Scene, camera: Camera,
                                 cfg: RenderConfig, seed: int = 0
                                 ) -> torch.Tensor:
    """Differentiable fused quality render: unclamped mean radiance
    ``(H, W, 3)``, the value of ``render_radiance_quality_megakernel``,
    with gradients to the scene's vertices (through the table's edges,
    normals and areas), albedo and emission, and to the camera (through
    ``generate_rays``). Raises ``ValueError`` outside the hash+cosine
    estimator or the kernels' limits."""
    return radiance_block_grad(
        scene, *pixel_rays(camera, cfg.width, cfg.height), cfg,
        seed).reshape(cfg.height, cfg.width, 3)
