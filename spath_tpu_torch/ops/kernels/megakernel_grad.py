"""The fused kernel's hand-written reverse sweep (K2) and its autograd
Function.

The port of ``spath_tpu/ops/pallas/megakernel_grad.py``: one launch of
``csrc/megakernel_grad.cu`` replays K1's walk for every sample on K1's
lane loop and runs the analytic reverse sweep, accumulating the adjoint
of the scene table's shading columns (normal, albedo, emission) without
ever materialising a per-bounce tensor. Its warps take runs of pixels
from a queue (run ``r`` of ``R``: pixels ``r``, ``r + R``, ...; ``R`` is
``RUNS_PER_WARP`` times the grid's warps) and alternate epochs of
``EPOCH`` forward steps, recording each bounce in a lane's ring, with a
reverse epoch over the samples they finished (``reverse_order`` models
one lane; ``reverse_counts`` counts the warps' steps); each run adds its
adjoint into its own float64 row (``run_rows_model``), so the sum has a
fixed order whichever warp takes which run. ``MegaRows`` puts K1 forward
and K2 backward under ``torch.autograd``, in place of the JAX package's
``mega_rows`` custom VJP, and ``render_radiance_mega`` is the
differentiable render through them.

Gradient semantics are those of the wavefront's detached sampling
(``models/pathtracer.py``): hit positions never enter a continuous
quantity of the conformance estimator, so the table's vertex and edge
columns (0-8) and the camera rays get exact zeros, as the JAX kernel's
``position_chain=False`` gives them.

Layouts (all contiguous): the rays, seeds and ``(T, 18)`` table of K1
(``ops/kernels/megakernel.py``), ``gbar`` float32 ``(n, 3)``, the
cotangent of K1's output; the result is the ``(T, 18)`` table cotangent.

``mega_bwd_call`` launches K2 for CUDA tensors and counts each launch in
``mega_bwd_call.launches``; for CPU tensors it computes the same function
with ``mega_bwd_plain``, the plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from spath_tpu_torch.camera import Camera, pixel_rays
from spath_tpu_torch.config import RenderConfig
from spath_tpu_torch.ops.intersect import nearest_hit_edges, plain_sweep
from spath_tpu_torch.ops.kernels import megakernel
from spath_tpu_torch.ops.kernels.build import library
from spath_tpu_torch.ops.rng import lcg_next, lcg_seeds
from spath_tpu_torch.ops.sampling import angle_sample, dot3
from spath_tpu_torch.scene import Scene

#: The JAX kernel's switch from unrolled masked adds to its MXU scatter.
#: K2 has one accumulation for every T; the tests use this to reach the
#: JAX package's scatter mode.
GRAD_UNROLL_TRIS = 64
#: Largest scene K2 takes: each of a block's 4 warps keeps a (T, 9)
#: float32 slice in shared memory, 144 KiB at T = 1024, inside the 227 KB
#: a Hopper block may use. Equal to K1's ``MAX_TRIS``.
GRAD_MAX_TRIS = 1024
#: Longest path K2 replays: its epoch, and so its ring, holds any path of
#: up to ``MAX_BOUNCES`` (``csrc/megakernel_common.cuh``: ``kMaxBounces``).
#: Deeper gradients go to the wavefront.
MAX_BOUNCES = 64
#: Forward steps of K2's epoch (the kernel's ``kEpoch``), and its runs a
#: warp of its persistent grid (timed on an H100, PERF.md).
EPOCH, RUNS_PER_WARP, WARP = 4, 2, 32
#: The adjoint columns of the table: normal, albedo, emission.
ADJ_COLS = slice(9, 18)


def supported_grad(scene: Scene, cfg: RenderConfig) -> bool:
    """Do K1 and K2 differentiate ``(scene, cfg)``? Not with
    ``vis_grad``: its residual is ``VisGradFusedRenderer``'s, as in the
    JAX package's ``supported_grad``.

    Which scenes the router gives K2 and which the streamed backward K8
    is ``models/renderer.py``'s ``GRAD_ROUTE_MAX_TRIS``."""
    return (megakernel.supported(scene, cfg) and not cfg.vis_grad
            and scene.n_tris <= GRAD_MAX_TRIS
            and cfg.max_bounces <= MAX_BOUNCES)


def replay(origins, directions, seeds, tri, cfg: RenderConfig):
    """K1's walk as K2 replays it, one sample at a time: yields for each
    sample the list, bounce by bounce, of ``(hit, idx, fs, om, w, tr, o,
    d)``, the hit mask, the triangle hit (0 on a miss), the normal's flip
    sign, the sampled direction and its weight, the throughput before
    the bounce, and the ray the bounce swept (for the lanes alive
    there). The camera rays' nearest hit is swept once for all samples,
    and bounce ``b + 1`` sweeps the rays that hit at bounce ``b``."""
    v0, e1, e2 = tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]
    nrm, alb = tri[:, 9:12], tri[:, 12:15]
    n, device = origins.shape[0], origins.device
    src0 = torch.full((n,), -1, dtype=torch.int64, device=device)
    first = nearest_hit_edges(origins, directions, v0, e1, e2, src0,
                              cfg.tri_block)
    for _ in range(cfg.spp):
        o, d, src = origins, directions, src0
        alive = torch.ones(n, dtype=torch.bool, device=device)
        tr = torch.ones((n, 3), dtype=torch.float32, device=device)
        saved = []
        for bounce in range(cfg.max_bounces):
            dist, idx = first if bounce == 0 else nearest_hit_edges(
                o, d, v0, e1, e2, src, cfg.tri_block)
            hit = alive & (idx >= 0)
            safe = idx.clamp_min(0)
            flip = dot3(nrm[safe], d) > 0.0
            fs = torch.where(flip, -1.0, 1.0)
            adj_n = nrm[safe] * fs[:, None]
            s1, u1 = lcg_next(seeds)
            s2, u2 = lcg_next(s1)
            seeds = torch.where(hit, s2, seeds)
            om, w = angle_sample(adj_n, u1, u2)
            saved.append((hit, safe, fs, om, w, tr, o, d))
            hit3 = hit[:, None]
            tr = torch.where(hit3, tr * alb[safe] * w[:, None], tr)
            o = torch.where(hit3, o + dist[:, None] * d, o)
            d = torch.where(hit3, om, d)
            src = torch.where(hit, idx, src)
            alive = hit
        yield saved


def walk_totals(origins, directions, seeds, tri, cfg: RenderConfig):
    """``(sweeps, hits)``, two ``(n, spp + 1)`` int64 arrays from the plain
    replay: ``sweeps`` in ``bigscene.lane_schedules``' layout (column 0 the
    camera sweep, 1; column ``s + 1`` the sweeps of sample ``s`` after its
    camera hit, one after each hit but the last bounce's), ``hits`` the
    records K2 keeps of each sample (column 0 zero)."""
    n = origins.shape[0]
    sweeps = [torch.ones(n, dtype=torch.int64, device=origins.device)]
    hits = [torch.zeros_like(sweeps[0])]
    with torch.no_grad(), plain_sweep():
        for saved in replay(origins, directions, seeds, tri, cfg):
            masks = [hit.long() for hit, *_ in saved]
            sweeps.append(sum(masks[:-1], torch.zeros_like(hits[0])))
            hits.append(sum(masks, torch.zeros_like(hits[0])))
    return (torch.stack(sweeps, 1).cpu().numpy(),
            torch.stack(hits, 1).cpu().numpy())


def reverse_counts(sweeps, hits, run: int, warps: int, epochs=(EPOCH,),
                   lanes: int = WARP) -> dict:
    """K2's warp steps counted on the pixels of ``walk_totals``: ``warps``
    warps of ``lanes`` lanes take their pixels from runs of ``run``
    (``bigscene.run_sequences``, ``list_schedule``), a warp's forward steps
    its lanes' last; its reverse steps, a record a hit, either in the lane
    as each sample ends (``in_lane``: at each step the most records a lane
    finished there) or in epochs of E forward steps for each E of
    ``epochs`` (``epochs[E]``: each epoch the most records a lane finished
    in it). ``records`` is every lane's records, the reverse steps if no
    lane idled times ``lanes``; ``lockstep`` the loop K2 replaced (a lane a
    pixel, ``lanes`` consecutive pixels a warp, each sample replayed and
    reversed as long as the warp's longest path)."""
    from spath_tpu_torch.ops.kernels import bigscene as bs

    sweeps = np.asarray(sweeps, dtype=np.int64)
    hits = np.asarray(hits, dtype=np.int64)
    per_pixel = sweeps.sum(axis=1)
    fwd = in_lane = 0
    rev = dict.fromkeys(epochs, 0)
    for seq in bs.run_sequences(sweeps.shape[0], run, warps):
        if not seq.size:
            continue
        lane, start = bs.list_schedule(per_pixel[seq], lanes)
        steps = int((start + per_pixel[seq]).max())
        fwd += steps
        ends = start[:, None] + np.cumsum(sweeps[seq, 1:], axis=1)
        records = hits[seq, 1:]
        has = records > 0
        who = np.broadcast_to(lane[:, None], records.shape)[has]
        when, count = ends[has], records[has]
        per = np.zeros((lanes, steps + 1), dtype=np.int64)
        np.add.at(per, (who, when), count)
        in_lane += int(per.max(axis=0).sum())
        for e in epochs:
            per = np.zeros((lanes, steps // e + 1), dtype=np.int64)
            np.add.at(per, (who, when // e), count)
            rev[e] += int(per.max(axis=0).sum())
    return dict(forward_steps=fwd, in_lane=in_lane, epochs=rev,
                records=int(hits.sum()),
                lockstep=dict(
                    forward_steps=bs.lockstep_sweeps(sweeps, lanes),
                    reverse_steps=bs.lockstep_sweeps(hits, lanes)))


def reverse_order(pixels, epoch: int, max_bounces: int) -> list:
    """One K2 lane (``csrc/megakernel_grad.cu``) on ``pixels``, a list of
    ``(pixel, [hits of each sample])``: its epochs, as a list of
    ``(forward_steps, [(pixel, sample, bounce), ...])``, the records each
    reverse epoch runs, in order. As the kernel's lane loop
    (``csrc/megakernel_lanes.cuh``) does, the lane sweeps a pixel's camera
    ray in a step of its own, runs each sample's bounce 0 on the camera
    hit without a sweep and sweeps before each later bounce, and once more
    where the path misses before ``max_bounces``; a sample starts in the
    step its predecessor ends, unless the ring (``epoch + max_bounces -
    1`` records) could not hold it beside the finished ones: then the lane
    waits for the next reverse epoch. Every ``epoch`` forward steps, and
    after its last, the lane reverses the samples finished so far, in
    sample order, last bounce first."""
    if epoch < 1:
        raise ValueError(f"an epoch of {epoch} steps")
    size = epoch + max_bounces - 1
    pending = list(pixels)[::-1]
    out, done = [], []
    st = dict(mode="idle", pix=0, hits=[], s=0, left=0, fin=0)

    def sample_sweeps(n_hits):
        return min(n_hits, max_bounces - 1) if n_hits else 0

    def walk_on():
        # from the start of sample st["s"]: its sweeps, or its end and the
        # next sample's start
        while True:
            n_hits = st["hits"][st["s"]]
            if sample_sweeps(n_hits):
                st["left"] = sample_sweeps(n_hits)
                return "bounce"
            end_sample()
            if st["s"] == len(st["hits"]):
                return "idle"
            if st["fin"] + max_bounces > size:
                return "sample"

    def end_sample():
        n_hits = st["hits"][st["s"]]
        if n_hits:
            done.append((st["pix"], st["s"], n_hits))
            st["fin"] += n_hits
        st["s"] = len(st["hits"]) if not n_hits else st["s"] + 1

    def step():
        if st["mode"] == "idle":
            if not pending:
                return False
            st["pix"], st["hits"] = pending.pop()
            st["s"], st["mode"] = 0, "camera"
        if st["mode"] == "sample" and st["fin"] + max_bounces <= size:
            st["mode"] = walk_on()
        if st["mode"] == "camera":
            st["mode"] = ("sample" if st["fin"] + max_bounces > size
                          else walk_on())
        elif st["mode"] == "bounce":
            st["left"] -= 1
            if not st["left"]:
                end_sample()
                st["mode"] = ("idle" if st["s"] == len(st["hits"]) else
                              "sample" if st["fin"] + max_bounces > size
                              else walk_on())
        return True

    forward = True
    while forward:
        steps = 0
        while steps < epoch:
            if not step():
                forward = False
                break
            steps += 1
        out.append((steps, [(pix, s, b) for pix, s, n_hits in done
                            for b in reversed(range(n_hits))]))
        done.clear()
        st["fin"] = 0
    return out


def run_rows_model(run_epochs, n_tris: int, order) -> np.ndarray:
    """K2's table adjoint as its runs add it (``csrc/megakernel_grad.cu``),
    on the CPU: ``run_epochs[r]`` is run ``r``'s reverse epochs, each a
    list of ``(triangle, 9 float32 adjoints)`` in the order the kernel adds
    them; the warps take the runs in ``order``. Each epoch is summed in a
    float32 slice, then added to the run's own float64 row; the rows are
    summed in run order. Returns the ``(T, 9)`` float64 sum, whatever
    ``order`` is."""
    rows = np.zeros((len(run_epochs), n_tris, 9), dtype=np.float64)
    for r in order:
        for epoch in run_epochs[r]:
            acc = np.zeros((n_tris, 9), dtype=np.float32)
            for tri, vals in epoch:
                acc[tri] = acc[tri] + np.asarray(vals, dtype=np.float32)
            rows[r] = rows[r] + acc.astype(np.float64)
    total = np.zeros((n_tris, 9), dtype=np.float64)
    for row in rows:
        total = total + row
    return total


def mega_bwd_plain(origins, directions, seeds, tri, gbar,
                   cfg: RenderConfig) -> torch.Tensor:
    """The plain PyTorch version of K2, and of the streamed backward K8
    with its scatter K7 (it takes a table of any size): an explicit
    reverse sweep over the
    table's columns, vectorised over rays, one sample at a time (the
    forward state from ``replay``), with ``index_add_`` into the
    ``(T, 9)`` adjoint per (sample, bounce), in the order of operations of
    the JAX package's ``_bwd_tile``. Returns the ``(T, 18)`` table
    cotangent; columns 0-8 are zero.

    The adjoint accumulates in float64: a float32 running sum of a
    frame's 10⁸-10⁹ terms drops every term below half an ulp of the sum
    (at 1920×1080, 64 spp the largest entry is ~3×10⁵, whose float32 ulp
    is 0.03, while single terms are ~10⁻²)."""
    with torch.no_grad(), plain_sweep():
        alb, emi = tri[:, 12:15], tri[:, 15:18]
        n, device = origins.shape[0], origins.device
        g = gbar * float(np.float32(1.0) / np.float32(cfg.spp))
        adj = torch.zeros((tri.shape[0], 9), dtype=torch.float64,
                          device=device)
        for saved in replay(origins, directions, seeds, tri, cfg):
            # reverse sweep; bb is the adjoint of the throughput after the
            # bounce (the JAX kernel's tb)
            bb = torch.zeros((n, 3), dtype=torch.float32, device=device)
            for hit, safe, fs, om, w, tr, *_ in reversed(saved):
                a, e = alb[safe], emi[safe]
                p = bb * tr * a
                wbar = p[:, 0] + p[:, 1] + p[:, 2]
                nbar = (2.0 * wbar * fs)[:, None] * om
                abar = bb * tr * w[:, None]
                ebar = g * tr
                bb = torch.where(hit[:, None], g * e + bb * a * w[:, None],
                                 bb)
                contrib = torch.cat([nbar, abar, ebar], 1)[hit]
                adj.index_add_(0, safe[hit], contrib.double())
        out = torch.zeros_like(tri)
        out[:, ADJ_COLS] = adj.float()
        return out


def _check(origins, directions, seeds, tri, gbar, cfg: RenderConfig,
           max_tris: int = GRAD_MAX_TRIS) -> None:
    """K1's checks with a cap of ``max_tris`` rows, the cotangent's and
    the cap on the path length (the streamed backward K8 shares them)."""
    megakernel._check(origins, directions, seeds, tri, cfg, max_tris)
    n = origins.shape[0]
    if gbar.dtype != torch.float32 or tuple(gbar.shape) != (n, 3):
        raise ValueError(f"gbar must be float32 ({n}, 3), got {gbar.dtype} "
                         f"{tuple(gbar.shape)}")
    if gbar.device != origins.device:
        raise ValueError("gbar must be on the rays' device")
    if cfg.max_bounces > MAX_BOUNCES:
        raise ValueError(f"max_bounces={cfg.max_bounces} above the "
                         f"backward kernels' {MAX_BOUNCES}")


@functools.cache
def k2_resident(device_index: int, n_tris: int) -> tuple[int, int]:
    """``(per_sm, sms)``: K2's resident CTAs on one SM at ``T`` triangles
    (its shared memory grows with T) and the card's SMs."""
    lib = library()
    with torch.cuda.device(device_index):
        per_sm = lib.spath_megakernel_backward_occupancy(n_tris)
    if per_sm <= 0:
        err = lib.spath_error_string(-per_sm).decode()
        raise RuntimeError(f"K2 occupancy query failed: CUDA error "
                           f"{-per_sm} ({err})")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return per_sm, sms


def k2_plan(n: int, per_sm: int, sms: int) -> tuple[int, int]:
    """``(grid, n_runs)`` of a K2 launch for ``n`` pixels: a persistent
    grid of ``per_sm`` CTAs of 4 warps on each of ``sms`` SMs, whose warps
    take ``RUNS_PER_WARP`` runs each from the queue, but no more runs than
    give a run 32 pixels (a lane each), nor CTAs than the runs fill at
    one a warp."""
    if n < 1 or per_sm < 1 or sms < 1:
        raise ValueError(f"no grid for n={n}, {per_sm} CTAs an SM, {sms} "
                         "SMs")
    n_runs = max(1, min(RUNS_PER_WARP * 4 * per_sm * sms, n // WARP))
    return min(per_sm * sms, -(-n_runs // 4)), n_runs


def k2_grid(n: int, n_tris: int, device: torch.device) -> tuple[int, int]:
    """``(grid, n_runs)`` of a K2 launch on the CUDA ``device``:
    ``k2_plan`` of K2's own resident CTAs at ``n_tris`` triangles."""
    index = device.index
    return k2_plan(n, *k2_resident(
        torch.cuda.current_device() if index is None else index, n_tris))


def mega_bwd_call(origins, directions, seeds, tri, gbar,
                  cfg: RenderConfig) -> torch.Tensor:
    """The ``(T, 18)`` table cotangent of K1's output for the cotangent
    ``gbar`` (layouts in the module docstring); columns 0-8 are zero.
    Launches K2 on CUDA tensors, on PyTorch's current stream and without
    synchronising; a failed build or launch raises. CPU tensors take
    ``mega_bwd_plain``."""
    gbar = gbar.contiguous()
    _check(origins, directions, seeds, tri, gbar, cfg)
    if origins.device.type == "cpu":
        return mega_bwd_plain(origins, directions, seeds, tri, gbar, cfg)
    if origins.device.type != "cuda":
        raise ValueError(f"no backward kernel for device {origins.device}")
    n, n_tris = origins.shape[0], tri.shape[0]
    out = torch.zeros_like(tri)
    if n == 0:
        return out
    lib = library()
    grid, n_runs = k2_grid(n, n_tris, origins.device)
    partial = torch.zeros((n_runs, n_tris * 9), dtype=torch.float64,
                          device=origins.device)
    rings = torch.empty(grid * 128 * lib.spath_megakernel_backward_ring(
        cfg.max_bounces), dtype=torch.float32, device=origins.device)
    counter = torch.zeros(1, dtype=torch.int32, device=origins.device)
    with torch.cuda.device(origins.device):
        stream = torch.cuda.current_stream(origins.device).cuda_stream
        err = lib.spath_megakernel_backward(
            ctypes.c_void_p(origins.data_ptr()),
            ctypes.c_void_p(directions.data_ptr()),
            ctypes.c_void_p(seeds.data_ptr()),
            ctypes.c_void_p(tri.data_ptr()),
            ctypes.c_void_p(gbar.data_ptr()),
            ctypes.c_void_p(partial.data_ptr()),
            ctypes.c_void_p(rings.data_ptr()),
            ctypes.c_void_p(counter.data_ptr()),
            n, n_tris, cfg.spp, cfg.max_bounces, n_runs, grid,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"backward megakernel launch failed: CUDA error "
                           f"{err} ({lib.spath_error_string(err).decode()})")
    mega_bwd_call.launches += 1
    out[:, ADJ_COLS] = partial.sum(0).float().view(n_tris, 9)
    return out


mega_bwd_call.launches = 0


class MegaRows(torch.autograd.Function):
    """K1 forward, K2 backward: ``MegaRows.apply(tri, origins, directions,
    seeds, cfg)`` is the ``(n, 3)`` mean radiance, differentiable in the
    table. The camera rays get zero cotangents, as the JAX package's
    ``_mega_rows_bwd`` gives them."""

    @staticmethod
    def forward(ctx, tri, origins, directions, seeds, cfg):
        ctx.save_for_backward(tri, origins, directions, seeds)
        ctx.cfg = cfg
        return megakernel.mega_call(origins, directions, seeds, tri, cfg)

    @staticmethod
    def backward(ctx, gbar):
        tri, origins, directions, seeds = ctx.saved_tensors
        gtri = mega_bwd_call(origins, directions, seeds, tri, gbar, ctx.cfg)
        return (gtri, torch.zeros_like(origins),
                torch.zeros_like(directions), None, None)


def radiance_block_grad(scene: Scene, origins, directions, pixel_ids,
                        cfg: RenderConfig, seed: int = 0) -> torch.Tensor:
    """``megakernel.radiance_block``, differentiable (``MegaRows``)."""
    if not supported_grad(scene, cfg):
        raise ValueError("megakernel VJP supports lcg+angle, "
                         f"T <= {GRAD_MAX_TRIS}, "
                         f"max_bounces <= {MAX_BOUNCES}")
    return MegaRows.apply(megakernel.scene_table(scene), origins,
                          directions, lcg_seeds(seed, pixel_ids), cfg)


def render_radiance_mega(scene: Scene, camera: Camera, cfg: RenderConfig,
                         seed: int = 0) -> torch.Tensor:
    """Differentiable fused render: unclamped mean radiance ``(H, W, 3)``,
    the value of ``render_radiance_megakernel``, with gradients to the
    scene's vertices (through the table's normals), albedo and emission,
    and zeros to the camera. Raises ``ValueError`` outside the
    conformance estimator or the kernels' limits."""
    return radiance_block_grad(
        scene, *pixel_rays(camera, cfg.width, cfg.height), cfg,
        seed).reshape(cfg.height, cfg.width, 3)
