#!/usr/bin/env python3
"""Time the port's kernels at their main paths' shapes, for comparing
two checkouts on one CUDA card.

    python3 tools/kernel_ab.py [--root DIR] [--label NAME] [--check]
                               [--outputs DIR] [--kernels K1,K2,...]
                               [--k5-splits 1,2,...]
                               [--vis-steps N]

Imports ``spath_tpu_torch`` from ``--root`` (default: this checkout),
builds its kernels there, and prints one JSON line: the card as
``nvidia-smi`` names it with its power limit, the build's seconds and
``ptxas -v`` lines, and CUDA-event ms of each kernel at the shape its
main path runs it at, after a warm-up launch:

- K1, K2 (conformance) and K3, K4 (quality, the CLI's ``--mode
  quality``) on the default scene at 1920x1080, 64 spp, 5 bounces;
- K5 on a residual slice, 512x512 rays against procedural_scene(10_000,
  seed=0): the camera rays (``K5``) and bounce rays from their hits in
  random directions, the hit triangle excluded (``K5_bounce``; its first
  238,592, the last slice of a 1080p frame, ``K5_last_slice``), all by
  ``chip_smoke.py``'s ``k5_ray_sets``; on 1080p camera rays against the
  default scene (``K5_1080p_7``), on 640x360 camera rays against
  procedural_scene(65536) (the sweep microbenchmark's shape,
  ``K5_microbench``) and on 64x64 camera rays against
  procedural_scene(2^20) (``K5_2e20``); and (``K5_splits``) each of
  these with its rows cut into each count of ``--k5-splits`` (default 1)
  in place of ``sweep_plan``'s, in turns with the plan;
- T1 at the sweep microbenchmark's shape, 640x360 camera rays against
  procedural_scene(65536) (``T1_K128``, ``T1_K64``), each beside the
  tool's cuBLAS + ``amin`` yardstick (``T1_cublas_K128``,
  ``T1_cublas_K64``);
- on procedural_scene(10_000, seed=0) at 1920x1080, 5 bounces: K6 on the
  serving frame (64 spp) and on the train step's (8 spp); K8 in a train
  step's backward call (8 spp, the call less its K7 calls, as
  ``chip_smoke.py`` phase 25); K9 on the quality serving frame (16 spp),
  K10 in a quality train step's backward call (4 spp, less K7) and K11
  at 4 spp;
- K7 on the first chunk of events of each of those backward calls (9
  and 19 columns), in turns with ``index_add_`` (K7, index_add_,
  index_add_, K7), and each of its launches' device ms from
  ``torch.profiler``; the resident CTAs an SM of each kernel that runs a
  queue of pixels (K6, K8, K9, K11, K10; K6's alone where the package
  sizes every grid by K6's);
- the light distribution (``LIGHT``) on the default scene and on
  ``chip_smoke.py``'s ``light_inputs`` at each of ``LIGHT_T``: device ms
  a call, 20 calls queued behind a sleeping kernel (``queued_ms``), its
  kernels' busy time and the kernels a call (``device_calls``, a
  ``torch.profiler`` trace of 20 calls), and CUDA-event ms a call over 20
  calls back to back (its bits are held by ``chip_smoke.py``'s phases 11
  and 26);
- with ``--vis-steps N``, the host seconds of N quality train steps with
  ``vis_grad`` (``vis_step_s``) on the default scene at 1920x1080,
  ``chip_smoke.py``'s VIS_TRAIN_SPP, and on procedural_scene(10_000) at
  1920x1080, 4 spp.

To compare two commits, unpack the other with ``git archive`` into a
directory that ``.gitignore`` lists (``build/``) and run both in one
call, in turns: parent, change, change, parent. ``--check`` also holds
the streamed kernels to their plain versions and exits non-zero on a
failure, by ``chip_smoke.py``'s bounds and, for K2, K4, K5, K8 and K10,
its check functions (this checkout's ``chip_smoke.py``, run on
``--root``'s package), each for the kernels of ``--kernels``: K1
bit-equal to ``megakernel_plain`` at 320x240, 8 spp, on the default and
25-triangle scenes and at 1024 triangles, 64x48, 2 spp; K2 within phase
6's bounds of ``mega_bwd_plain`` there, two launches bitwise equal; K3
bit-equal to
``quality_plain`` at 320x240, 8 spp, for each estimator of
``QUALITY_GRID``, on the default scene and at 1024 triangles; K4 within
phase 13's bounds of ``quality_bwd_plain`` there, two launches bitwise
equal; K6 bit-equal to K1 and to ``megakernel_plain``, two whole frames
bitwise equal; K7 within 1e-5 of each column's max on synthetic
hot-triangle events and on both event sets, two launches bitwise equal;
K8+K7 within 1e-5 of each column group's max of ``mega_bwd_plain`` (its
float64 sums), in one launch and in chunks of one sample, two calls
bitwise equal; K9 bit-equal to K3 and to ``quality_plain``, two whole
frames bitwise equal; K11's radiance bit-equal to K9's and its hits
equal to ``quality_hits_plain``'s; K10+K7 within ``chip_smoke.py``'s
phase 13 bounds of ``quality_bwd_plain`` on the 10k scene for three
estimator settings, in one launch and in chunks of one sample, two calls
bitwise equal, and on the default scene also within 1e-5 of each group's
max of K4; K5 bit-equal to ``_sweep`` at each timed shape and at 1, 127,
129 and 262,143 rays, two launches bitwise equal; T1 at both depths
within ``TIGHT_SHARE`` of its bound against ``sweep_mm_plain`` on the
whole microbenchmark shape (the ``drop_lo`` control beyond it) and on
``chip_smoke.py``'s ragged and small shapes, two launches bitwise
equal. ``--outputs DIR``
saves K1's headline frame and K2's table gradient there, K3's headline
frame, K4's ray adjoint and table gradient at the headline, K9's frame
and K11's radiance and hits (the timed calls), K10's table gradient and
ray adjoint (the timed training call) and K5's ``dist``/``idx`` (the
slice's bounce rays) to ``DIR/<label>.pt`` and requires them bitwise
equal to those of every other run saved there, but K2's and K4's table
gradients, whose order of sums may change, within phase 6's and phase
13's bounds of each column group's max: run parent, change, change,
parent with one ``DIR`` to hold two checkouts to the same bits. Without a card
it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

# The shapes, bounds and checks are chip_smoke.py's, of this checkout
# (its run is behind __main__); the package is --root's.
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

HEADLINE, QUALITY, BIG_T = cs.HEADLINE, cs.QUALITY, cs.BIG_T
BIG_TRAIN_SPP, BIGQ_SERVE_SPP = cs.BIG_TRAIN_SPP, cs.BIGQ_SERVE_SPP
BIGQ_TRAIN_SPP, QUALITY_GRID = cs.BIGQ_TRAIN_SPP, cs.QUALITY_GRID
#: CUDA-event launches of a K5 timing, more for the short launch.
K5_REPS = {"K5_1080p_7": 200}
#: The last, partial slice of the visibility residual of a 1080p frame:
#: its rays are the first of K5_bounce's.
K5_LAST_SLICE = 1920 * 1080 % (512 * 512)
KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9", "K10",
           "K11", "T1", "LIGHT")
#: The light distribution's sizes: chip_smoke.py's phase 11 and 26 sizes.
LIGHT_T = tuple(sorted({*cs.LIGHT_SMALL_T, *cs.LIGHT_BIG_T, cs.BIG_T,
                        cs.HUGE_T, 1 << 20}))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def event_ms(torch, fn, reps: int = 1) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def timed(torch, fn, reps: int = 1) -> float:
    """A warm-up launch, then CUDA-event ms a launch over ``reps``."""
    fn()
    torch.cuda.synchronize()
    return event_ms(torch, fn, reps)


def split_call(torch, call, *args):
    """``(ms of the call less its K7 calls, ms of its K7 calls, the first
    K7 call's events)`` of one streamed backward call."""
    from spath_tpu_torch.ops.kernels import stream_scatter as ss

    module = sys.modules[call.__module__]
    marks, first = [], []

    def scatter(adj, idx, val):
        if not first:
            first.append((idx.clone(), val.clone()))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = ss.stream_scatter_call(adj, idx, val)
        b.record()
        marks.append((a, b))
        return out

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    module.stream_scatter_call = scatter
    try:
        call(*args)
        torch.cuda.synchronize()
        marks.clear()
        start.record()
        call(*args)
        end.record()
        torch.cuda.synchronize()
    finally:
        module.stream_scatter_call = ss.stream_scatter_call
    k7 = sum(a.elapsed_time(b) for a, b in marks)
    return start.elapsed_time(end) - k7, k7, first[0]


def scatter_ms(torch, idx, val, n_tris: int) -> dict:
    """K7 and ``index_add_`` in turns on one chunk's events, and K7's
    launches by name (device ms a call, ``torch.profiler``, 3 calls)."""
    from torch.profiler import ProfilerActivity, profile

    from spath_tpu_torch.ops.kernels import stream_scatter as ss

    adj = torch.zeros((n_tris, val.shape[1]), device=idx.device)
    valid = idx >= 0
    lidx, lval = idx[valid].long(), val[valid]

    def kernel():
        ss.stream_scatter_call(adj, idx, val)

    def library():
        adj.index_add_(0, lidx, lval)

    kernel(), library()
    t = [event_ms(torch, f, 3) for f in (kernel, library, library, kernel)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            kernel()
        torch.cuda.synchronize()
    launches = {}
    for e in prof.key_averages():
        if "scatter_" in e.key:
            name = e.key.split("::")[-1].split("(")[0]
            us = getattr(e, "device_time_total",
                         getattr(e, "cuda_time_total", 0.0))
            launches[name] = launches.get(name, 0.0) + us / 1e3 / 3
    return dict(slots=idx.shape[0], events=int(valid.sum()),
                ms=[t[0], t[3]], index_add_ms=t[1:3], ms_by_launch=launches)


def window_runs(torch, idx, n_tris: int, window: int) -> dict:
    """How K7's accumulation windows fill on these events: each block's
    valid events in event order cut into windows of ``window`` events;
    per window the longest run of one triangle (its (row, column) tasks
    add that many values one after another). Returns the windows, the
    mean and largest longest run, and the sum of the longest runs over
    the events (1/``window`` if every row of every window held one
    event)."""
    valid = idx >= 0
    tri = idx[valid].long()
    blk = tri // 256
    order = torch.sort(blk, stable=True).indices
    tri, blk = tri[order], blk[order]
    first = torch.searchsorted(blk, blk, right=False)
    win = (torch.arange(tri.numel(), device=tri.device) - first) // window
    key = (blk * (1 << 24) + win) * 256 + (tri % 256)
    _, counts = torch.unique_consecutive(torch.sort(key).values,
                                         return_counts=True)
    wkey = torch.unique_consecutive(torch.sort(key).values) // 256
    longest = torch.zeros(int(wkey.max()) + 1, dtype=torch.int64,
                          device=tri.device).scatter_reduce(
        0, wkey, counts, reduce="amax")
    longest = longest[longest > 0]
    return dict(windows=longest.numel(),
                mean_longest=longest.float().mean().item(),
                max_longest=int(longest.max()),
                longest_share=longest.sum().item() / tri.numel())


def light_ms(torch, dev, small) -> dict:
    """The light distribution's timings at the default scene's and each
    LIGHT_T's inputs, by size."""
    from spath_tpu_torch.ops import nee
    from spath_tpu_torch.ops.kernels import light_cdf as lc

    cases = {"default": (small.emission, nee.triangle_areas(small))}
    cases.update({n: cs.light_inputs(torch, dev, n, n) for n in LIGHT_T})
    out = {}
    for name, (emission, area) in cases.items():
        def call():
            lc.light_cdf_call(emission, area)

        out[name] = dict(cs.device_calls(torch, call, 20),
                         ms=cs.queued_ms(torch, call, 20),
                         call_ms=timed(torch, call, 20))
    return out


def ptxas_lines(log: Path) -> list[str]:
    """Each kernel's ``ptxas -v`` line in the build log, after the name of
    the function it reports (mangled)."""
    import re

    out, name = [], "?"
    for ln in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m[1]
        elif "registers" in ln:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}")
    return out


def fail(msg: str) -> None:
    raise SystemExit(f"kernel_ab: check failed: {msg}")


def scatter_check(torch, idx, val, n_tris: int, name: str) -> dict:
    from spath_tpu_torch.ops.kernels import stream_scatter as ss

    def zeros():
        return torch.zeros((n_tris, val.shape[1]), device=idx.device)

    got = ss.stream_scatter_call(zeros(), idx, val)
    again = ss.stream_scatter_call(zeros(), idx, val)
    want = ss.stream_scatter_plain(zeros(), idx, val)
    scale = want.abs().amax(0)
    err = (got - want).abs().amax(0)
    if not bool((err <= cs.SCATTER_RTOL * scale).all()):
        fail(f"K7 {name}: errors {err.tolist()} of max {scale.tolist()}")
    if not torch.equal(got, again):
        fail(f"K7 {name}: two launches differ")
    return dict(max_abs_err=err.max().item(),
                rel_err=(err / scale.clamp_min(1e-30)).max().item())


def synthetic_events(torch, dev, n_tris: int, n_events: int, cols: int):
    """``chip_smoke.py``'s phase 18 events: half on 4 hot triangles, a
    tenth -1."""
    import numpy as np

    rng = np.random.default_rng(n_tris)
    idx = rng.integers(0, n_tris, size=n_events).astype(np.int32)
    hot = rng.integers(0, n_tris, size=4)
    on_hot = rng.random(n_events) < 0.5
    idx[on_hot] = hot[rng.integers(0, 4, size=int(on_hot.sum()))]
    idx[rng.random(n_events) < 0.1] = -1
    val = rng.normal(size=(n_events, cols)).astype(np.float32)
    return torch.from_numpy(idx).to(dev), torch.from_numpy(val).to(dev)


def k6_checks(torch, dev, cam, big_scene) -> dict:
    from spath_tpu_torch.config import RenderConfig
    from spath_tpu_torch.ops.kernels import bigscene as bs
    from spath_tpu_torch.ops.kernels import megakernel as mk
    from spath_tpu_torch.scene import default_scene, procedural_scene

    out = {}
    small = RenderConfig(width=320, height=240, spp=8, max_bounces=5)
    for name, scene in (("default", default_scene(dev)),
                        ("1024", procedural_scene(1024, seed=1, device=dev))):
        o, d, s = mk.pack_rays(cam, small, 0)
        tri = mk.scene_table(scene)
        got = bs.bigscene_call(o, d, s, tri, small)
        if not torch.equal(got, mk.mega_call(o, d, s, tri, small)):
            fail(f"K6 differs from K1 on {name}")
        out[f"k6_vs_k1_{name}"] = True
    tri = mk.scene_table(big_scene)
    for cfg in (RenderConfig(width=64, height=48, spp=2, max_bounces=5),
                RenderConfig(width=32, height=16, spp=3, max_bounces=1),
                RenderConfig(width=32, height=16, spp=1, max_bounces=0)):
        o, d, s = mk.pack_rays(cam, cfg, 0)
        got = bs.bigscene_call(o, d, s, tri, cfg)
        want = mk.megakernel_plain(o, d, s, tri, cfg.replace(tri_block=2048))
        if not torch.equal(got, want):
            fail(f"K6 differs from its plain version at {cfg}")
    out["k6_vs_plain_10k"] = True
    frame = RenderConfig(width=1920, height=1080, spp=2, max_bounces=5)
    o, d, s = mk.pack_rays(cam, frame, 0)
    if not torch.equal(bs.bigscene_call(o, d, s, tri, frame),
                       bs.bigscene_call(o, d, s, tri, frame)):
        fail("K6: two whole frames differ")
    out["k6_two_frames_equal"] = True
    return out


def k8_checks(torch, dev, cam, big_scene) -> dict:
    """K8+K7 against ``mega_bwd_plain`` on the 10k scene by
    ``chip_smoke.py``'s ``backward_vs_plain``, in one launch and in
    chunks of one sample (the later chunks read the camera hits and LCG
    states back), with the camera missing in part of the frame."""
    from spath_tpu_torch.config import RenderConfig
    from spath_tpu_torch.ops.kernels import bigscene_grad as bg
    from spath_tpu_torch.ops.kernels import megakernel as mk

    tri = mk.scene_table(big_scene)
    out = {}
    budget = bg.EVENT_BUDGET
    for name, cfg, chunked in (
            ("64x48 spp3", RenderConfig(width=64, height=48, spp=3,
                                        max_bounces=5), False),
            ("64x48 spp3 chunks of 1", RenderConfig(
                width=64, height=48, spp=3, max_bounces=5), True),
            ("32x16 spp2 1 bounce", RenderConfig(width=32, height=16, spp=2,
                                                 max_bounces=1), True)):
        o, d, s = mk.pack_rays(cam, cfg, 0)
        if chunked:
            bg.EVENT_BUDGET = o.shape[0] * cfg.max_bounces * bg.EVENT_BYTES
        try:
            c, _ = cs.backward_vs_plain(torch, o, d, s, tri, cfg,
                                        f"K8 {name}", streamed=True,
                                        tri_block=2048)
        finally:
            bg.EVENT_BUDGET = budget
        out[f"k8_vs_plain_{name}"] = c["max_abs_err"]
    return out


def k9_k11_checks(torch, dev, cam, big_scene) -> dict:
    """K9 bit-equal to K3 at T <= 1024 and to ``quality_plain`` on the
    10k scene, two whole frames bitwise equal; K11's radiance bit-equal to
    K9's and its hits to ``quality_hits_plain``'s."""
    from spath_tpu_torch.config import RenderConfig
    from spath_tpu_torch.ops.kernels import bigscene_quality as bq
    from spath_tpu_torch.ops.kernels import megakernel_quality as mq
    from spath_tpu_torch.scene import default_scene, procedural_scene

    out = {}
    small = RenderConfig(width=320, height=240, spp=8, max_bounces=5)
    for name, scene in (("default", default_scene(dev)),
                        ("1024", procedural_scene(1024, seed=1,
                                                  emissive_fraction=0.05,
                                                  device=dev))):
        tri, rows = mq.quality_table(scene), bq.light_rows(scene)
        for label, est in QUALITY_GRID:
            cfg = small.replace(**est)
            o, d, k = mq.pack_rays(cam, cfg, 0)
            if not torch.equal(bq.bigq_call(o, d, k, tri, rows, cfg),
                               mq.quality_call(o, d, k, tri, rows, cfg)):
                fail(f"K9 differs from K3 on {name}, {label}")
    out["k9_vs_k3"] = True
    tri, rows = mq.quality_table(big_scene), bq.light_rows(big_scene)
    for label, est in QUALITY_GRID:
        for cfg in (RenderConfig(width=64, height=48, spp=2, max_bounces=5,
                                 **est),
                    RenderConfig(width=32, height=16, spp=3, max_bounces=1,
                                 **est),
                    RenderConfig(width=32, height=16, spp=1, max_bounces=0,
                                 **est)):
            o, d, k = mq.pack_rays(cam, cfg, 0)
            plain = cfg.replace(tri_block=2048)
            got = bq.bigq_call(o, d, k, tri, rows, cfg)
            if not torch.equal(got, mq.quality_plain(o, d, k, tri, rows,
                                                     plain)):
                fail(f"K9 differs from its plain version at {cfg}")
            if cfg.max_bounces == 0:
                continue  # no hits to export
            h_out, h_dist, h_idx = bq.bigq_hits_call(o, d, k, tri, rows, cfg)
            w_out, w_dist, w_idx = bq.quality_hits_plain(o, d, k, tri, rows,
                                                         plain)
            if not torch.equal(h_out, got):
                fail(f"K11's radiance differs from K9's at {cfg}")
            if not (torch.equal(h_out, w_out) and torch.equal(h_dist, w_dist)
                    and torch.equal(h_idx, w_idx)):
                fail(f"K11 differs from quality_hits_plain at {cfg}")
    out["k9_vs_plain_10k"] = out["k11_vs_k9_and_plain_10k"] = True
    frame = RenderConfig(width=1920, height=1080, spp=2, max_bounces=5,
                         **QUALITY)
    o, d, k = mq.pack_rays(cam, frame, 0)
    if not torch.equal(bq.bigq_call(o, d, k, tri, rows, frame),
                       bq.bigq_call(o, d, k, tri, rows, frame)):
        fail("K9: two whole frames differ")
    out["k9_two_frames_equal"] = True
    return out


def k10_checks(torch, dev, cam, big_scene) -> dict:
    """K10+K7 against ``quality_bwd_plain`` by ``chip_smoke.py``'s
    ``quality_backward_vs_plain``: on the 10k scene at 64x48, 3 spp, for
    each estimator of QUALITY_GRID, in one launch and in chunks of one
    sample (the later launches read the camera hits and the ray adjoint
    back); on the default scene at 320x240x8, where it also holds K10 to
    K4."""
    from spath_tpu_torch.config import RenderConfig
    from spath_tpu_torch.ops.kernels import bigscene_quality as bq
    from spath_tpu_torch.ops.kernels import bigscene_quality_grad as bqg
    from spath_tpu_torch.ops.kernels import megakernel_quality as mq
    from spath_tpu_torch.scene import default_scene

    out = {}
    budget = bqg.EVENT_BUDGET
    tri, rows = mq.quality_table(big_scene), bq.light_rows(big_scene)
    for label, est in QUALITY_GRID:
        cfg = RenderConfig(width=64, height=48, spp=3, max_bounces=5, **est)
        o, d, k = mq.pack_rays(cam, cfg, 0)
        for chunked in (False, True):
            name = f"{label}{' chunks of 1' if chunked else ''}"
            if chunked:
                bqg.EVENT_BUDGET = (o.shape[0] * cfg.max_bounces * 2
                                    * bqg.EVENT_BYTES)
            try:
                c, _ = cs.quality_backward_vs_plain(
                    torch, o, d, k, tri, rows, cfg, f"K10 {name}",
                    streamed=True, tri_block=2048)
            finally:
                bqg.EVENT_BUDGET = budget
            out[f"k10_vs_plain_{name}"] = c["max_abs_err"]
    scene = default_scene(dev)
    tri, rows = mq.quality_table(scene), bq.light_rows(scene)
    small = RenderConfig(width=320, height=240, spp=8, max_bounces=5)
    for label, est in QUALITY_GRID:
        cfg = small.replace(**est)
        o, d, k = mq.pack_rays(cam, cfg, 0)
        c, _ = cs.quality_backward_vs_plain(
            torch, o, d, k, tri, rows, cfg, f"K10 default {label}",
            streamed=True)
        out[f"k10_vs_plain_and_k4_{label}"] = c["rel_err_by_group"]
    return out


def k5_inputs(torch, dev, cam, big_scene) -> dict:
    """K5's timed shapes: ``{name: (origins, directions, table, src)}``,
    the slice's camera and bounce rays by ``chip_smoke.py``'s
    ``k5_ray_sets``."""
    from spath_tpu_torch.camera import generate_rays
    from spath_tpu_torch.scene import default_scene, procedural_scene

    def camera(scene, width, height):
        o, d = generate_rays(cam, width, height)
        return (o.contiguous(), d.contiguous(), cs.k5_table(scene),
                torch.full((o.shape[0],), -1, dtype=torch.int64,
                           device=dev))

    tri = cs.k5_table(big_scene)
    sets = cs.k5_ray_sets(torch, big_scene, *generate_rays(cam, 512, 512),
                          seed=5)
    bounce = tuple(t.contiguous() for t in sets["bounce"])
    out = {"K5": (*(t.contiguous() for t in sets["camera"][:2]), tri,
                  sets["camera"][2]),
           "K5_bounce": (*bounce[:2], tri, bounce[2]),
           "K5_last_slice": (*(t[:K5_LAST_SLICE].contiguous()
                               for t in bounce[:2]), tri,
                             bounce[2][:K5_LAST_SLICE].contiguous())}
    out["K5_1080p_7"] = camera(default_scene(dev), 1920, 1080)
    out["K5_microbench"] = camera(procedural_scene(65536, seed=0,
                                                   device=dev), 640, 360)
    out["K5_2e20"] = camera(procedural_scene(1 << 20, seed=0, device=dev),
                            64, 64)
    return out


def k5_split_ms(torch, k5, inputs: dict, splits: list[int]) -> dict:
    """K5 timed at each row split of ``splits`` (``sweep_plan``'s choice
    replaced; counts above a shape's row blocks skipped) beside the
    plan's own, in turns (plan, each split, each split again, plan):
    lever (a), the split, alone."""
    out = {}
    plan = k5.sweep_plan
    for name, (o, d, tri, src) in inputs.items():
        blocks = -(-tri.shape[0] // k5.TILE_ROWS)
        chosen = plan(o.shape[0], tri.shape[0],
                      *k5.resident_ctas(o.device.index))[1]

        def at(s):
            if s is not None:
                k5.sweep_plan = lambda n, t, tile, *_: (-(-n // tile), s)
            try:
                return timed(torch, lambda: k5.nearest_hit_call(
                    o, d, tri, src), K5_REPS.get(name, 3))
            finally:
                k5.sweep_plan = plan

        order = [None] + [s for s in splits if s <= blocks]
        times = {}
        for s in order + order[::-1]:
            times.setdefault("plan" if s is None else s, []).append(at(s))
        out[name] = {"plan_splits": chosen, "ms": times}
    return out


def k5_checks(torch, inputs: dict) -> dict:
    """K5 bit-equal to its plain version by ``chip_smoke.py``'s
    ``k5_vs_plain`` (two launches bitwise equal) on every timed shape,
    and on the slice's first 1, 127, 129 and 262,143 bounce rays at 10k
    and 7 triangles."""
    cases = dict(inputs)
    bo, bd, btri, bsrc = inputs["K5_bounce"]
    small_tri = inputs["K5_1080p_7"][2]
    for m in cs.K5_RAY_COUNTS:
        cases[f"bounce_{m}"] = (bo[:m], bd[:m], btri, bsrc[:m])
        cases[f"bounce_{m}_7"] = (bo[:m], bd[:m], small_tri,
                                  bsrc[:m].clamp(max=small_tri.shape[0] - 1))
    for name, (o, d, tri, src) in cases.items():
        cs.k5_vs_plain(torch, tri, (o, d, src), f"K5 {name}")
    return {"k5_vs_plain": sorted(cases)}


def t1_ms(torch, dev) -> tuple:
    """T1 at the sweep microbenchmark's shape (``chip_smoke.py``'s
    ``T1_SHAPE``: 640x360 camera rays against procedural_scene(65536)),
    from its tool's operands: ``({"T1_K128", "T1_K64": ms a launch,
    "T1_cublas_K128", "T1_cublas_K64": ms of the tool's cuBLAS + amin
    yardstick}, the operands)``."""
    from spath_tpu_torch.ops.kernels import sweep_mm as sm
    from spath_tpu_torch.tools import sweep_microbench as tool

    w, h, n_tris = cs.T1_SHAPE
    ops = tool.operands(w, h, n_tris, dev)
    out = {}
    for k in (128, 64):
        g, r = ops["t1"][k]
        out[f"T1_K{k}"] = timed(torch, lambda: sm.sweep_mm_call(g, r),
                                cs.T1_REPS)
        out[f"T1_cublas_K{k}"] = timed(torch, lambda: tool.yardstick(g, r),
                                       2)
    return out, ops


def t1_checks(torch, ops: dict) -> dict:
    """T1 at both depths against ``sweep_mm_plain`` by ``chip_smoke.py``'s
    checks: on the whole shape (every ray within ``TIGHT_SHARE`` of the
    bound, the ``drop_lo`` control beyond it, two launches bitwise equal)
    and at its ragged and small shapes."""
    out = {}
    for k in (128, 64):
        out[f"t1_check_K{k}"] = cs.t1_vs_plain(torch, ops, k)
        out[f"t1_ragged_K{k}"] = cs.t1_ragged(torch, ops, k)
    return out


def k1_k2_checks(torch, dev, cam, want: set) -> dict:
    """K1 bit-equal to ``megakernel_plain`` and K2 within ``chip_smoke.py``'s
    phase 6 bounds of ``mega_bwd_plain`` (``backward_vs_plain``, two
    launches bitwise equal) at 320x240, 8 spp, on the default and
    25-triangle scenes, and at 1024 triangles, 64x48, 2 spp."""
    from spath_tpu_torch.config import RenderConfig
    from spath_tpu_torch.ops.kernels import megakernel as mk
    from spath_tpu_torch.scene import default_scene, procedural_scene

    out = {}
    small = RenderConfig(width=320, height=240, spp=8, max_bounces=5)
    cases = [("default", default_scene(dev), small),
             ("25", cs.scene_25(dev), small),
             ("1024", procedural_scene(1024, seed=1, device=dev),
              RenderConfig(width=64, height=48, spp=2, max_bounces=5))]
    for name, scene, cfg in cases:
        o, d, s = mk.pack_rays(cam, cfg, 0)
        tri = mk.scene_table(scene)
        if "K1" in want:
            if not torch.equal(mk.mega_call(o, d, s, tri, cfg),
                               mk.megakernel_plain(o, d, s, tri, cfg)):
                fail(f"K1 differs from megakernel_plain on {name}")
            out[f"k1_vs_plain_{name}"] = True
        if "K2" in want:
            c, _ = cs.backward_vs_plain(torch, o, d, s, tri, cfg,
                                        f"K2 {name}")
            out[f"k2_vs_plain_{name}"] = c["rel_err_by_group"]
    return out


def k3_k4_checks(torch, dev, cam, want: set) -> dict:
    """K3 bit-equal to ``quality_plain`` and K4 within ``chip_smoke.py``'s
    phase 13 bounds of ``quality_bwd_plain`` (``quality_backward_vs_plain``,
    two launches bitwise equal) at 320x240, 8 spp, for each estimator of
    QUALITY_GRID on the default scene, and at 1024 triangles, 64x48, 2
    spp."""
    from spath_tpu_torch.config import RenderConfig
    from spath_tpu_torch.ops.kernels import megakernel_quality as mq
    from spath_tpu_torch.scene import default_scene, procedural_scene

    out = {}
    small = RenderConfig(width=320, height=240, spp=8, max_bounces=5)
    cases = [(f"default {label}", default_scene(dev), small.replace(**est))
             for label, est in QUALITY_GRID]
    cases.append(("1024", procedural_scene(1024, seed=1, device=dev),
                  RenderConfig(width=64, height=48, spp=2, max_bounces=5,
                               **QUALITY)))
    for name, scene, cfg in cases:
        o, d, k = mq.pack_rays(cam, cfg, 0)
        tri, rows = mq.quality_table(scene), mq.light_rows(scene)
        if "K3" in want:
            got = mq.quality_call(o, d, k, tri, rows, cfg)
            if not torch.equal(got, mq.quality_plain(o, d, k, tri, rows,
                                                     cfg)):
                fail(f"K3 differs from quality_plain on {name}")
            out[f"k3_vs_plain_{name}"] = True
        if "K4" in want:
            c, _ = cs.quality_backward_vs_plain(torch, o, d, k, tri, rows,
                                                cfg, f"K4 {name}")
            out[f"k4_vs_plain_{name}"] = c["rel_err_by_group"]
    return out


def vis_step_s(torch, dev, cam, scene, cfg, steps: int) -> list[float]:
    """Host seconds of ``steps`` quality train steps with ``vis_grad``,
    each ending in a synchronise, after a warm-up step: ``chip_smoke.py``'s
    ``vis_training`` set-up (the albedo perturbed as the CLI does, the pose
    group at rate 0), without its launch checks, which differ between
    checkouts."""
    import numpy as np

    from spath_tpu_torch.models.inverse import (
        InverseParams, init_state, make_train_step, param_group_optimizer,
    )
    from spath_tpu_torch.models.renderer import forward_renderer

    target = forward_renderer(scene, cfg).render_radiance(scene, cam, cfg, 0)
    rng = np.random.default_rng(1)
    albedo = scene.albedo.cpu().numpy()
    bad = np.clip(albedo + rng.uniform(-0.4, 0.4, albedo.shape)
                  .astype(np.float32), 0.05, 1.0)
    state = init_state(param_group_optimizer(
        freeze_pose=False, pose_lr=cs.QUALITY_POSE_LR, albedo_lr=2e-2),
        InverseParams(cam_pos=cam.pos, cam_angle=cam.angle,
                      cam_focal=cam.focal,
                      albedo=torch.from_numpy(bad).to(dev)))
    step = make_train_step(scene, cfg, fixed_seed=0)
    out = []
    for _ in range(steps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, aux = step(state, target)
        float(aux["loss"])
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out[1:]


def same_outputs(torch, outputs: Path, label: str, mine: dict,
                 close: dict | None = None) -> dict:
    """Save ``mine`` as ``outputs/<label>.pt`` and require it bitwise
    equal to every other run's there; the keys of ``close`` (``{key:
    {group: (columns, bound)}}``) within each group's bound of its max
    instead."""
    close = close or {}
    outputs.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.cpu() for k, v in mine.items()}, outputs / f"{label}.pt")
    seen = []
    for other in sorted(outputs.glob("*.pt")):
        if other.stem == label:
            continue
        theirs = torch.load(other)
        for key, value in mine.items():
            if key not in theirs:
                continue  # a run of a checkout without that kernel's
            value = value.cpu()
            if key in close:
                for group, (cols, bound_) in close[key].items():
                    scale = theirs[key][:, cols].abs().max().item()
                    err = (value[:, cols]
                           - theirs[key][:, cols]).abs().max().item()
                    if err > bound_ * scale:
                        fail(f"{key} {group} off run {other.stem}'s by "
                             f"{err:.6g}, max {scale:.6g}")
            elif not torch.equal(value, theirs[key]):
                fail(f"{key} differs from run {other.stem}'s")
        seen.append(other.stem)
    return {"bitwise_equal_to": seen, "compared": sorted(mine)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    ap.add_argument("--kernels", default=",".join(KERNELS))
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--outputs", default="")
    ap.add_argument("--k5-splits", default="1")
    ap.add_argument("--vis-steps", type=int, default=0)
    args = ap.parse_args()
    want = set(args.kernels.split(","))
    if not want <= set(KERNELS):
        raise SystemExit(f"--kernels: unknown {want - set(KERNELS)}")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import spath_tpu_torch

    if Path(spath_tpu_torch.__file__).resolve().parents[1] != root:
        raise SystemExit(f"kernel_ab: imported {spath_tpu_torch.__file__}, "
                         f"not the package under {root}")
    from spath_tpu_torch.camera import Camera
    from spath_tpu_torch.config import RenderConfig
    from spath_tpu_torch.ops.kernels import bigscene as bs
    from spath_tpu_torch.ops.kernels import bigscene_grad as bg
    from spath_tpu_torch.ops.kernels import bigscene_quality as bq
    from spath_tpu_torch.ops.kernels import bigscene_quality_grad as bqg
    from spath_tpu_torch.ops.kernels import build
    from spath_tpu_torch.ops.kernels import intersect as k5
    from spath_tpu_torch.ops.kernels import megakernel as mk
    from spath_tpu_torch.ops.kernels import megakernel_grad as mg
    from spath_tpu_torch.ops.kernels import megakernel_quality as mq
    from spath_tpu_torch.ops.kernels import megakernel_quality_grad as mqg
    from spath_tpu_torch.scene import default_scene, procedural_scene

    dev = torch.device("cuda", 0)
    result = dict(label=args.label, root=str(root), card=card())
    t0 = time.perf_counter()
    build.library()
    result["build_s"] = time.perf_counter() - t0
    result["ptxas"] = ptxas_lines(build.BUILD_DIR / "build.log")
    if hasattr(bs, "QUEUE_KERNELS"):
        result["resident_per_sm"] = {
            k: bs.resident_ctas(0, k)[0] for k in bs.QUEUE_KERNELS}
        result["sms"] = bs.resident_ctas(0, "K6")[1]
    elif hasattr(bs, "resident_ctas"):
        result["k6_resident_per_sm"], result["sms"] = bs.resident_ctas(0)
    cam = Camera.default(dev)
    head = RenderConfig(**HEADLINE)
    qhead = head.replace(**QUALITY)
    gen = torch.Generator().manual_seed(3)
    ms, saved = {}, {}

    small = default_scene(dev)
    o, d, s = mk.pack_rays(cam, head, 0)
    tri = mk.scene_table(small)
    g = torch.rand((o.shape[0], 3), generator=gen).to(dev)
    if "K1" in want:
        ms["K1"] = timed(torch, lambda: mk.mega_call(o, d, s, tri, head), 5)
        saved["k1_frame"] = mk.mega_call(o, d, s, tri, head)
    if "K2" in want:
        ms["K2"] = timed(torch, lambda: mg.mega_bwd_call(o, d, s, tri, g,
                                                         head), 3)
        saved["k2_gtab"] = mg.mega_bwd_call(o, d, s, tri, g, head)
    qo, qd, qk = mq.pack_rays(cam, qhead, 0)
    qtri, qrows = mq.quality_table(small), mq.light_rows(small)
    if "K3" in want:
        ms["K3"] = timed(torch, lambda: mq.quality_call(qo, qd, qk, qtri,
                                                        qrows, qhead), 3)
        saved["k3_frame"] = mq.quality_call(qo, qd, qk, qtri, qrows, qhead)
    if "K4" in want:
        ms["K4"] = timed(torch, lambda: mqg.quality_bwd_call(
            qo, qd, qk, qtri, qrows, g, qhead), 2)
        saved["k4_gtab"], saved["k4_grays"] = mqg.quality_bwd_call(
            qo, qd, qk, qtri, qrows, g, qhead)
    del o, d, s, g, qo, qd, qk
    if "LIGHT" in want:
        ms["LIGHT"] = light_ms(torch, dev, small)

    big = procedural_scene(BIG_T, seed=0, device=dev)
    if "K5" in want:
        k5_in = k5_inputs(torch, dev, cam, big)
        for name, (o5, d5, t5, s5) in k5_in.items():
            ms[name] = timed(torch, lambda: k5.nearest_hit_call(
                o5, d5, t5, s5), K5_REPS.get(name, 3))
        if args.k5_splits and hasattr(k5, "sweep_plan"):
            ms["K5_splits"] = k5_split_ms(torch, k5, k5_in, [
                int(x) for x in args.k5_splits.split(",")])
        if args.check:
            result.update(k5_checks(torch, k5_in))
        saved["k5_dist"], saved["k5_idx"] = k5.nearest_hit_call(
            *k5_in["K5_bounce"])
        del k5_in
    if "T1" in want:
        t1, t1_ops = t1_ms(torch, dev)
        ms.update(t1)
        if args.check:
            result.update(t1_checks(torch, t1_ops))
        del t1_ops
    btri = mk.scene_table(big)
    train = head.replace(spp=BIG_TRAIN_SPP)
    o, d, s = mk.pack_rays(cam, head, 0)
    if "K6" in want:
        ms["K6"] = event_ms(torch, lambda: bs.bigscene_call(o, d, s, btri,
                                                            head))
        ms["K6_train"] = timed(torch, lambda: bs.bigscene_call(
            o, d, s, btri, train))
    if {"K7", "K8"} & want:
        g = (torch.rand((o.shape[0], 3), generator=gen) * 0.9 + 0.1).to(dev)
        k8, k7_call, (cidx, cval) = split_call(
            torch, bg.bigscene_bwd_call, o, d, s, btri, g, train)
        ms["K8"], ms["K7_in_train_step"] = k8, k7_call
        if "K7" in want:
            ms["K7_9"] = scatter_ms(torch, cidx, cval, BIG_T)
            ms["K7_9"]["windows"] = window_runs(torch, cidx, BIG_T, 1024)
            if args.check:
                result["k7_check_9"] = scatter_check(torch, cidx, cval,
                                                     BIG_T, "9 columns")
        del cidx, cval, g
    del o, d, s
    bqcfg = qhead.replace(spp=BIGQ_SERVE_SPP)
    qtrain = qhead.replace(spp=BIGQ_TRAIN_SPP)
    qo, qd, qk = mq.pack_rays(cam, qhead, 0)
    qbtri, qbrows = mq.quality_table(big), bq.light_rows(big)
    if "K9" in want:
        ms["K9"] = event_ms(torch, lambda: bq.bigq_call(qo, qd, qk, qbtri,
                                                        qbrows, bqcfg))
        if args.outputs:
            saved["k9_frame"] = bq.bigq_call(qo, qd, qk, qbtri, qbrows,
                                             bqcfg)
    if "K11" in want:
        ms["K11"] = timed(torch, lambda: bq.bigq_hits_call(
            qo, qd, qk, qbtri, qbrows, qtrain))
        if args.outputs:
            saved["k11_out"], saved["k11_dist"], saved["k11_idx"] = \
                bq.bigq_hits_call(qo, qd, qk, qbtri, qbrows, qtrain)
    if {"K7", "K10"} & want:
        g = (torch.rand((qo.shape[0], 3), generator=gen) * 0.9
             + 0.1).to(dev)
        k10, k7q_call, (qidx, qval) = split_call(
            torch, bqg.bigq_bwd_call, qo, qd, qk, qbtri, qbrows, g, qtrain)
        ms["K10"], ms["K7_in_quality_train_step"] = k10, k7q_call
        if "K10" in want:
            saved["k10_gtab"], saved["k10_grays"] = bqg.bigq_bwd_call(
                qo, qd, qk, qbtri, qbrows, g, qtrain)
        if "K7" in want:
            ms["K7_19"] = scatter_ms(torch, qidx, qval, BIG_T)
            ms["K7_19"]["windows"] = window_runs(torch, qidx, BIG_T, 512)
            if args.check:
                result["k7_check_19"] = scatter_check(torch, qidx, qval,
                                                      BIG_T, "19 columns")
        del qidx, qval, g
    result["ms"] = ms
    if args.vis_steps:
        vis = RenderConfig(**HEADLINE, vis_grad=True, **QUALITY)
        result["vis_step_s"] = {
            "default": vis_step_s(torch, dev, cam, small,
                                  vis.replace(spp=cs.VIS_TRAIN_SPP),
                                  args.vis_steps),
            "10k": vis_step_s(torch, dev, cam, big,
                              vis.replace(spp=BIGQ_TRAIN_SPP),
                              args.vis_steps)}
    if args.check:
        for n_tris, n_events in (((1 << 20, 1 << 20), (1000, 1 << 16))
                                 if "K7" in want else ()):
            for cols in (9, 19):
                i, v = synthetic_events(torch, dev, n_tris, n_events, cols)
                result[f"k7_check_{n_tris}_{cols}"] = scatter_check(
                    torch, i, v, n_tris, f"synthetic T={n_tris}, {cols}")
        result.update(k1_k2_checks(torch, dev, cam, want))
        result.update(k3_k4_checks(torch, dev, cam, want))
        if "K6" in want:
            result.update(k6_checks(torch, dev, cam, big))
        if "K8" in want:
            result.update(k8_checks(torch, dev, cam, big))
        if {"K9", "K11"} & want:
            result.update(k9_k11_checks(torch, dev, cam, big))
        if "K10" in want:
            result.update(k10_checks(torch, dev, cam, big))
    if args.outputs and saved:
        result["outputs"] = same_outputs(
            torch, Path(args.outputs), args.label or "run", saved,
            {"k4_gtab": cs.QGRAD_GROUPS,
             "k2_gtab": {group: (cols, cs.GRAD_RTOL)
                         for group, cols in cs.GRAD_GROUPS.items()}})
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
