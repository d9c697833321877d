#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``spath_tpu_torch/csrc`` and drives the
port's serving and training paths, conformance estimator (phases 1-10:
K1, K2), quality estimator (phases 11-17: K3, K4), conformance estimator
on large scenes (phases 18-25: K6, K8 and K7) and quality estimator on
large scenes (phases 26-33: the light distribution beyond one block, K9,
K10 and K7 at 19 columns) and visibility gradients with the wavefront on
the card (phases 34-41: K5, K11, the backward kernels beyond 16
bounces), the matmul-only sweep microbenchmark (phase 42: T1), and the
threefry and table streams (phases 43-46: the threefry kernel,
``config.QUALITY``'s frame and training, the table stream),
ray-sharded rendering and training over ``torch.distributed`` (phases
47-48: one rank on NCCL, two ranks sharing the card) and the triangle
ring (phases 49-50: K5, K7, the light distribution and the threefry
kernel, a world of one on NCCL and two ranks sharing the card) and
camera-ray compaction (phase 51: K1-K4, K6, K8+K7, K9, K10+K7 on the live
rays, the plan's K5 sweep, the compacted wavefront), through
the entry points a user calls; any failure exits
non-zero before a result is printed. Every plain wavefront the kernels
are held to runs its sweeps on the plain ``_sweep`` (``plain_sweep``).

1. Device: the card's name and power limit, and the kernel build.
2. Kernel against its plain PyTorch version on the same rays, to the
   bit: the default scene and a 25-triangle scene at 320x240, 8 spp.
3. The slice at full width: ``render_pt_fast`` on the default scene at
   1920x1080, 64 spp, 5 bounces, through the CUDA kernel, against the
   plain wavefront ``render_pt`` at the same config, to the bit.
4. The CLI: a path-traced and a flat 640x480 frame written as PNG.
5. At 1080p64: kernel against its plain version on the same rays, to
   the bit; then both timed, CUDA events around launches after warm-up,
   in turns (plain, kernel, kernel, plain).
6. The backward kernel K2 against its plain version ``mega_bwd_plain`` on
   the same rays and cotangent: the default and 25-triangle scenes at
   320x240, 8 spp, a scene of K2's largest size (1024 triangles, its
   shared memory above the default 48 KB) at 64x48, 2 spp, then the
   default scene at 1080p64; the normal, albedo and emission adjoints
   each within 1e-5 of their own max, columns 0-8 exactly zero, two
   launches bitwise equal.
7. The gradient entry point ``render_radiance_fastgrad`` at 320x240, 8
   spp: vertex, albedo and emission gradients against autograd of the
   plain wavefront ``render_radiance``, and the emission-linearity check
   through K1 twice.
8. The training slice at full width: 3 steps of ``make_train_step`` at
   1920x1080, 64 spp, 5 bounces with the CLI's perturbation and
   optimizer; each step launches K1 once and K2 once, and the loss falls.
9. The CLI: ``invert`` at 640x480, 16 spp, 5 steps lowers the albedo
   error.
10. At 1080p64: K2 and its plain version timed in turns, and the walk's
    sweeps and hits counted by the plain replay for the kernels' bounds;
    on COUNT_ROWS, K1's warp steps and K2's forward and reverse warp
    steps under the lockstep loops they replaced and under the candidate
    schedules (``conformance_lane_counts``), with the idle lane shares,
    grids and resident CTAs, and how often a whole warp of K1's lane loop
    would reject a triangle before the division (``warp_cull_counts``).
11. The light distribution kernel (the quality table's prob and cdf)
    against its plain version, bit for bit, on the default, 25-triangle,
    1024-triangle, all-dark and wall-and-light scenes. K3 against its
    plain version ``quality_plain`` on the same rays and keys: the
    default and 25-triangle scenes at 320x240, 8 spp, for (nee, mis,
    rr_start, stratify) = (T, T, 0, F), (F, F, 0, F), (T, T, 2, T), and a
    1024-triangle procedural scene at 64x48, 2 spp; the bounds of phase 2.
12. The quality serving slice at full width: ``render_pt_fast`` in the
    CLI's quality config (hash, cosine, NEE, MIS) at 1920x1080, 64 spp,
    5 bounces through the light distribution kernel and K3, against the
    plain wavefront ``render_pt``.
13. K4 against ``quality_bwd_plain`` on the same rays and cotangent at the
    shapes of phase 11 and at 1080p64: normal, albedo, emission and area
    within 1e-5 of their own max, v0/e1/e2 within 1e-4, the camera-ray
    adjoint within 1e-5 of its max, prob and cdf exactly zero, two
    launches bitwise equal; K3's 1080p64 frame bit-equal to
    ``quality_plain``'s.
14. The gradient entry point ``render_radiance_fastgrad`` at 320x240, 8
    spp, quality config: vertex, albedo, emission and camera-position
    gradients against autograd of the plain wavefront.
15. The quality training slice at full width: 3 steps of
    ``make_train_step`` at 1080p64 with the albedo perturbed and the pose
    group enabled at rate 0 (see QUALITY_POSE_LR); each step launches the
    light distribution kernel, K3 and K4 once each, the loss falls, the
    camera gradient is finite and non-zero. Why rate 0, without K4: K3's
    frames at the true camera and at the camera moved EDGE_MOVE along x
    differ in some pixels, and the plain wavefront's moved frame equals
    K3's. Then pose recovery at 1080p64: on a scene with no silhouette in
    view, the camera 0.4 behind the truth, 3 steps with only the pose
    group free (rate POSE_RECOVERY_LR) launch K3 and K4 once each, lower
    the loss and move the camera toward the truth.
16. The CLI: ``render --mode quality`` and ``invert --mode quality`` at
    640x480.
17. At 1080p64: K3 and K4 and their plain versions timed in turns, and
    the quality walk's sweeps, hits and light-choice steps counted by the
    plain replay for the kernels' bounds; the light distribution kernel
    and its plain version timed on the default scene; on COUNT_ROWS,
    K3's warp steps and K4's cost under the lockstep loops they replaced
    and under their schedules (``lane_counts``), with the idle lane
    shares, grids and resident CTAs.
18. The stream scatter K7 against its float64 plain version on synthetic
    events (T = 2^20 and 1000; half the events on 4 hot triangles, a
    tenth -1): each column within 1e-5 of its max, two launches bitwise
    equal.
19. K6 against K1, to the bit, on the default, 25-triangle and
    1024-triangle scenes at phase 2's and phase 6's shapes; against its
    plain version, to the bit, on the 1150-triangle combined scene at
    320x240x8, procedural_scene(10_000) at 64x48x2 and
    procedural_scene(2^20) at 32x16x1, 3 bounces.
20. K8 with K7 against ``mega_bwd_plain`` (phase 6's bounds, columns 0-8
    zero, two launches bitwise equal) at phase 19's shapes, and within
    1e-5 of K2 at T <= 1024.
21. The large-scene serving slice at full width: ``render_pt_fast`` on
    procedural_scene(10_000, seed=0) at 1920x1080, 64 spp, 5 bounces
    through one K6 launch and no other kernel; the frame's rows 536-543
    against the plain version on the same rays and seeds, to the bit, and
    against K6 launched on those rows alone; then procedural_scene(100_000)
    at 2 spp.
22. The gradient entry point on the 1150-triangle scene at 320x240x8
    through K6, K8 and K7, against autograd of the plain wavefront, and
    emission linearity.
23. The large-scene training slice: 3 steps of ``make_train_step`` on
    procedural_scene(10_000) at 1920x1080, 8 spp, 5 bounces; each step
    launches K6 once and K8 and K7 once a chunk of samples; the loss falls.
24. The CLI: ``render --scene procedural:10000`` and ``invert --scene
    procedural:2000`` at 640x480.
25. The routing crossover table (K1 vs K6, K1+K2 vs K6+K8+K7 at T = 64 to
    1024, 320x240x8, in turns); K6 timed at phase 21's shape: two whole
    frames bitwise equal (K6's queue hands pixels out in another order
    every launch), equal to the served frame, and its rows COUNT_ROWS
    bit-equal to the plain version; K8 and K7 at phase 23's (CUDA events;
    K8's time is the backward call's less its K7 calls), the plain
    versions on rows 536-543 in turns with the kernel on the same rows;
    K7 on that call's first chunk of events held to its plain version
    (each column within 1e-5 of its max, two launches bitwise equal),
    timed in turns with ``index_add_`` (its launches one by one:
    ``tools/kernel_ab.py``);
    the walk counted on COUNT_ROWS for the bounds, with the idle lane
    share of the lockstep, regeneration and queue schedules
    (``bigscene.lane_schedules``) and K6's resident CTAs; K8's two calls'
    table gradients bitwise equal (its queue hands pixels out in another
    order every launch), the schedules of each of its launches
    (``bigscene.chunk_totals``) and its resident CTAs.

26. The light distribution kernel against its plain version, bit for
    bit, at 8193, 10k, 100k and 2^20 triangles (1% emissive), timed
    beside its bound (24 bytes a triangle) and ``torch.cumsum`` of its
    prob column (which does not give the cdf's bits); and K7 at K10's 19
    columns against its float64 plain version on phase 18's synthetic
    events.
27. K9 against K3, to the bit, at phase 11's shapes and estimator
    settings; against ``quality_plain`` (phase 2's bounds) on the
    1150-triangle combined scene at 320x240x8, procedural_scene(10_000,
    emissive_fraction=0.01) at 64x48x2, procedural_scene(2^20) at
    32x16x1, 3 bounces (~10.5k lights), and an all-dark 1150-triangle
    scene, whose frame is black and finite.
28. K10 with K7 against ``quality_bwd_plain`` at phase 27's shapes with
    phase 13's bounds, and within 1e-5 of each group's max of K4 at
    T <= 1024.
29. The quality serving slice on a large scene: ``render_pt_fast`` in the
    CLI's quality config on procedural_scene(10_000) at 1920x1080, 16
    spp (cut from 64 for time), 5 bounces, through one light distribution launch
    and one K9 launch and no other kernel; rows 536-543 held to the plain
    version and to K9 on those rows alone; then procedural_scene(100_000)
    at 1 spp.
30. The gradient entry point in the quality config on the 1150-triangle
    scene at 320x240x8 through K9, K10 and K7: vertex, albedo, emission
    and camera-position gradients against autograd of the plain
    wavefront, and emission linearity.
31. Quality training on the large scene: 3 steps of ``make_train_step``
    at 1920x1080, 4 spp, 5 bounces, the albedo perturbed and the pose
    group at rate 0; each step launches the light distribution and K9
    once and K10 and K7 once a chunk; the loss falls.
32. The CLI: ``render --mode quality --scene procedural:10000`` and
    ``invert --mode quality --scene procedural:2000`` at 640x480.
33. The quality crossover table (K3 vs K9, K3+K4 vs K9+K10+K7 at T = 64
    to 1024, 320x240x8, NEE+MIS); K9 timed at phase 29's shape, K10 and
    K7 at 19 columns at phase 31's (CUDA events; K10's time is the
    backward call's less its K7 calls), the plain versions on rows
    536-543 in turns with the kernel on the same rows; K7 held to its
    plain version on that call's first events as in phase 25, timed in
    turns with ``index_add_``; the walk counted for the
    bounds and the CTAs' idle lanes; two whole K9 frames bitwise equal,
    equal to the served frame, and their rows COUNT_ROWS bit-equal to
    ``quality_plain``; two whole K10+K7 backward calls at phase 31's
    shape bitwise equal (table gradient and ray adjoint); each pixel's
    sweeps on COUNT_ROWS (``bigscene_quality.quality_sweep_totals``)
    under the three schedules for K9 at 16 spp and for K11 at 4 spp, and
    K10's launch by launch (``bigscene.chunk_totals``), with K9's, K11's
    and K10's resident CTAs.

34. K5 against the plain sweep ``_sweep``, both outputs to the bit, on
    one residual slice of rays (512x512 camera rays; bounce-shaped rays
    from their hits in random directions, excluding the hit triangle;
    edge-shaped rays toward points on mesh edges; lanes whose camera ray
    missed keep it, as ended paths do) at 7, 1150 and 10k triangles, and
    at 2^20 triangles on 64x64 rays, and on the slice's first 1, 127, 129
    and 262,143 bounce rays (counts that end inside a CTA's ray tile), two
    launches bitwise equal each time; K5 and the plain sweep timed in
    turns on the slice's bounce rays at 10k triangles and on 1080p camera
    rays at 7, with K5's grid (ray tiles, row splits, resident CTAs); the
    bound counts 22 operations of a pair that the cull rejects, 46 of the
    rest (``k5_ops``).
35. K11 against K9 and ``quality_hits_plain``: the radiance and the hits
    to the bit, on the default scene at 320x240x8, the 1150-triangle scene
    at 320x240x4 (and with rr_start=2, stratify) and 10k at 64x48x2; K11
    and K9 timed in turns on the 10k training cell (1080p, 4 spp), K11
    and its plain version on rows 536-543; there K11's radiance bit-equal
    to K9's on the whole frame, and on rows 536-543 its radiance and hits,
    from the rows' own launch and from the frame's export, bit-equal to
    ``quality_hits_plain``'s.
36. The backward kernels at 17 and 32 bounces (their saved state holds
    64): K2, K8+K7, K4 and K10+K7 against their plain versions at 64x48x2
    with phase 6's and phase 13's bounds; K2 and K4 timed at 320x240x8 at
    5, 16, 17 and 32 bounces.
37. The wavefront on the card for hash with the uniform sampler at
    320x240x4: it launches K5 and the light distribution only, and its
    frame equals the plain sweep's to the bit; hash+angle renders; the
    gradients of hash+uniform and of 65 bounces (conformance, and quality
    with roulette) through the wavefront launch K5 and are within 1e-5 of
    each max of the plain sweep's.
38. ``render_radiance_fastgrad`` with ``vis_grad`` through
    ``VisGradFusedRenderer`` against autograd of the plain wavefront with
    ``vis_grad``, vertex, albedo, emission and camera gradients within
    ENTRY_RTOL of each max: the blocker scene (conformance: K1, K2, K5;
    quality: the light distribution, K3, K4, K5) at 320x240x4, and the
    1150-triangle scene at 320x240x2 through K11, K10, K7 and K5, no
    other kernel (the residual's row gathers add their gradients through
    K7 on every scene); the residual's radiance exactly 0; the vis_grad
    frame equal to the frame without it; two gradients on the same seed
    bitwise equal in every group.
39. Visibility-gradient training at full width: 3 quality train steps
    with vis_grad on the default scene at 1920x1080, VIS_TRAIN_SPP (cut
    from 64 for time) samples, 5 bounces, through the light distribution,
    K3, K4, K5 and K7; the loss falls; two gradients on the same seed at
    that shape bitwise equal in every group.
40. 2 such steps on procedural_scene(10_000) at 1920x1080, 4 spp, through
    the light distribution, K11, K10, K7 and K5 (K9 does not launch); two
    gradients on the same seed at that shape bitwise equal in every
    group.
41. The pose step from the true camera, recorded: 3 steps at pose rate
    1e-3 with and without vis_grad, and how many of the pixels that
    change when the camera moves 1e-6 change their primary triangle.

42. T1, the matmul-only sweep: its ``ptxas -v`` line; its SASS
    (``cuobjdump``), which must hold ``HGMMA`` (wgmma) and ``UTMALDG``
    (TMA) and no ``HMMA`` (mma.sync); its launch plan at the tool's shape
    logged (rays a CTA, CTAs, cluster, waves on the card's SMs, stages,
    shared bytes, and the GB of G through L2 counted from the launch),
    ``launch_plan`` held to the compiled one, which the kernels' record
    carries with the card's SM count; the microbenchmark
    ``spath_tpu_torch/tools/sweep_microbench.py`` at its own shape
    (640x360 camera rays against procedural_scene(65536, seed=0), 230,400
    x 65,536), which times K5, T1 at K = 128 and K = 64 and the cuBLAS
    yardstick in turns and launches no other kernel; then, on the
    tensors the tool timed, K5 bit-equal to ``_sweep`` and T1 at both
    depths against ``sweep_mm_plain`` on the whole shape, every ray
    within TIGHT_SHARE of 2^-16 (sweep_mm_scale + |plain|) while the
    control without the split's lo terms lands beyond it, two launches
    bitwise equal, the plain version timed, and single launches timed
    after an L2 flush; and T1 at both depths on 1, 255, 257, 447, 449 and
    1349 rays (the 448-ray CTA tile each side) against 256, 1024 and 4352
    triangles (1, 4, 17 blocks), each within TIGHT_SHARE, two launches
    bitwise equal.

43. The threefry kernel (``csrc/threefry.cu``, the threefry stream's
    draws; XLA in the JAX package, no Pallas kernel): its ``ptxas -v``
    line; bit-equal to ``per_pixel_uniforms`` over the 1080p frame's pixel
    ids and 131,072 ids near 2^32 at 2, 5 and 7 draws and three (seed,
    sample, bounce) steps; two launches bitwise equal; timed in turns with
    its plain version at 1080p, 5 draws, beside its bound (integer
    operations at the SMs' issue rate, 128 a clock an SM).
44. ``render_pt_fast`` on ``config.QUALITY`` (threefry, cosine, NEE with
    MIS) at 1920x1080, 64 spp, 5 bounces: the wavefront, launching K5, the
    light distribution and the threefry kernel (320 launches) only; its
    first call and two frames through ``utils/profiling.py``'s
    ``FrameTimer`` (rays/s), a profiled frame for the kernels' device
    time and the threefry kernel's share; at 320x240x4 bit-equal to the
    frame of the plain sweep and plain draws; ``bounce_stats``.
45. The table stream (the reference's ``vec_dist``, angle sampler) at
    1920x1080x64x5 through ``render_pt_fast``: the wavefront on K5 and
    nothing else, timed; at 320x240x4 bit-equal to the plain sweep's
    frame, and its gradient (K5, its gathers' backward on K7) within
    GRAD_RTOL of each max of the plain sweep's.
46. 3 ``recover`` steps on ``config.QUALITY`` at 1920x1080, 8 spp (cut
    from 64 for time), 5 bounces, albedo perturbed as the CLI does, pose
    frozen: K5, K7, the light distribution and the threefry kernel launch,
    none of K1-K4, K6, K8-K11; the loss falls; two gradients on one seed
    bitwise equal; peak device memory.

47. One rank on NCCL: ``init_multihost`` with a world of one (a second
    call a no-op), ``make_mesh(1)``; ``render_pt_fast(mesh=)`` bit-equal
    to ``render_pt_fast`` on the headline frame (default scene,
    1920x1080, 64 spp, 5 bounces: K1; the light distribution and K3), on
    procedural_scene(10_000) at 320x240, 4 spp (cut for time: K6; the
    light distribution and K9) and through the wavefront on
    ``config.QUALITY`` at 1920x1080, 8 spp (K5, the light distribution and
    the threefry kernel), each call launching its route's kernels only;
    the six gradients of a weighted frame sum (vertices, albedo,
    emission, camera position, angles, focal length) through
    ``render_radiance_fastgrad(mesh=)`` (K1, K2; K3, K4; K6, K8, K7; K9,
    K10, K7; K5, K7, light, threefry) and one ``make_train_step(mesh=)``
    step bitwise equal to one device's (a world of one sums nothing); a
    scene above K9's ``LIGHT_MAX`` lights with NEE (procedural, 100k
    triangles, about 70k lights, 64x48, 1 spp) routed to the wavefront:
    its frame (K5, light) bit-equal to the plain sweep's and to one
    rank's, its gradient (K5, K7, light) within GRAD_RTOL of the plain
    sweep's; the sharded serving call's overhead at the headline (CUDA
    events, eight pairs in alternating order) and the collectives alone.
48. Two ranks sharing the card, spawned here (``torch.multiprocessing``):
    NCCL refuses two ranks on one GPU, so they run on gloo and the mesh
    stages each collective's tensors through host memory. At 1920x1080, 8
    spp (the default scene: conformance, quality, and the wavefront on
    ``config.QUALITY``) and at phase 47's 10k frame: both ranks' frames
    bit-equal to one device's; the six
    gradients, sums of the two ranks' parts in rank order, within
    GRAD_RTOL of each group's max of one device's, bitwise equal on both
    ranks and over two runs; each call launching its route's kernels
    only. 3 ``recover(mesh=)`` steps at 1920x1080, 8 spp lower the loss
    with both ranks' parameters bitwise equal; ``scaling_efficiency(2)``
    and the collectives' ms logged (on one card: machinery, not a scaling
    result).

49. The triangle ring with a world of one on NCCL (``make_mesh(1,
    axis="shard")``), on procedural_scene(65_536) (the JAX README's ring
    point, T1's scene) at 1920x1080, 5 bounces: ``render_pt_ring`` at 2
    spp in the conformance estimator (K5), the quality estimator with
    roulette from bounce 2 (K5, light) and ``config.QUALITY`` (K5, light,
    threefry), each bit-equal to the one-device wavefront ``render_pt``
    (its sweeps on K5 too) and launching its kernels only; the
    conformance frame timed in turns with the wavefront;
    ``render_flat_ring`` bit-equal to ``render_flat``; the six gradients
    of a weighted frame sum through ``render_radiance_ring`` at 1 spp,
    conformance (K5, K7) and ``config.QUALITY`` (K5, K7, light,
    threefry), within GRAD_RTOL of each group's max of the one-device
    wavefront's and bitwise equal over two runs; one ``ring_train_step``;
    at 16x8, 9 spp the gradients with ``cfg.remat`` (each sample
    checkpointed) bitwise equal to those without; peak device memory.
50. Two ranks sharing the card on gloo, spawned as phase 48's
    (``ring_two_rank_worker``), each holding half the table's rows: phase
    49's frames bit-equal to one device's on both ranks, its gradients
    within GRAD_RTOL of one device's and bitwise equal across the ranks
    and over two runs, each call launching its kernels only; three
    ``ring_train_step`` steps on the wall-and-light scene at 1920x1080, 2
    spp from a perturbed albedo lower the loss, the same on both ranks;
    logged by rank: the resident rows, a rotation's ms through host
    memory, the peak device memory.

51. Camera-ray compaction (``models/compact_fast.py``) on each kernel
    route: the default scene at 1920x1080, 64 spp, 5 bounces, conformance
    (K1; K1+K2) and quality (the light distribution and K3; and K4), and
    procedural_scene(10_000) at 1920x1080, 5 bounces, conformance at 8
    spp (K6; K6+K8+K7) and quality at 4 spp (K9; K9+K10+K7), cut for time
    as PERF.md section 4 cuts them: the plan's live count and share, its
    build timed alone (CUDA events) and the first call with it (its K5
    sweep), then the compacted frame bit-equal to the full launch's and
    to the plain version's (the whole frame on the default scene, rows
    536-543 at 10k), launching its route's kernels only; the six
    gradients of a weighted frame sum within GRAD_RTOL of each group's
    max of the full launch's and bitwise equal over two calls; forward
    and forward+backward timed in turns with the full launch (full,
    compacted, compacted, full, the plan cached); the routing rule takes
    ``compact_fused`` on this camera, whose plan is cached, exactly on the
    routes in ``COMPACT_ROUTES`` and ``COMPACT_GRAD_ROUTES``, and the full
    launch on an equal camera built anew, and ``render_pt_fast`` on the
    cached plan launches the route's kernels only (no K5), its frame the
    full launch's. The plan cache's fast and value keys timed on the host
    at 10k and 2^20 triangles. ``config.QUALITY`` at 1920x1080, 8 spp
    through the compacted wavefront: its frame bit-equal to the
    wavefront's, K5, the light distribution and the threefry kernel
    launched, timed in turns.
    An all-miss view: zeros, forward and gradient, and no kernel past the
    plan's K5 sweep. ``render_any(backend="compact_fused")`` and
    ``get_renderer("compact_fused")``'s gradient at 320x240x8 reach K1
    and K1+K2; ``render_any(backend="compact")`` K5 only.

The last three lines of standard output are the kernels' JSON record,
the card as ``nvidia-smi`` names it, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

#: kernel vs plain version: share of pixels off by more than FLIP_ATOL
#: in any channel (chaotic paths flipped by a last-bit difference), and
#: the relative tolerance of the frame mean (tests/test_pallas.py)
FLIP_ATOL, FLIP_MAX, MEAN_RTOL = 1e-4, 0.01, 5e-2
#: the full-width frame against the plain wavefront: mean within 2% (and
#: the flip share under FLIP_MAX)
SLICE_MEAN_RTOL = 2e-2
HEADLINE = dict(width=1920, height=1080, spp=64, max_bounces=5)
CLI_SIZE = (640, 480)
#: K2 against its plain version, which sums in float64: K2's float32
#: sums within GRAD_RTOL of max|plain| in each column group, so that the
#: normal adjoint is held on its own scale, not the emission's
GRAD_RTOL = 1e-5
GRAD_GROUPS = {"normal": slice(9, 12), "albedo": slice(12, 15),
               "emission": slice(15, 18)}
#: the gradient entry point against autograd of the plain wavefront,
#: which sums in float32 in another order, relative to max|plain|
ENTRY_RTOL = 1e-3
#: the emission-linearity check, relative (tests/test_megakernel_grad.py)
LINEARITY_RTOL = 1e-4
#: K7 as the row gathers' backward against a float64 index_add_ of the
#: same rows: K7 sums in float64 and rounds once, so each table's
#: gradient within GATHER_RTOL of its max
GATHER_RTOL = 1e-6
#: Operations counted from the kernels' source (compares, selects, loads
#: and integer work not counted): one Moller-Trumbore test is 18
#: multiplies, 15 adds or subtracts, 12 more in u, v and u + v, and one
#: divide; a hit costs K1 ~44 more (flip, two LCG divides, the sampler
#: with its 4 trig calls counted as one each, weight, radiance,
#: throughput, next origin); K2 replays the hit without the radiance (38)
#: and adds the reverse sweep and its 9 accumulating adds (43).
MT_OPS, K1_HIT_OPS, K2_HIT_OPS = 46, 44, 81
#: Of MT_OPS, the terms that decide K5's cull (csrc/intersect.cu:
#: may_pass): s = o - v0 (3), h = d x e2 (9), a = e1 . h and s . h (5
#: each). Where they reject a pair (``may_pass_plain``), its test needs no
#: more.
MT_CULL_OPS = 22
#: Peak rates of an H100 SXM (NVIDIA's data sheet): float32 outside the
#: tensor cores 67e12 FLOP/s, memory 3.35e12 bytes/s. The bound uses
#: them. The kernels are built with -fmad=false, so no multiply and add
#: fuse: they cannot do float32 work faster than half the peak,
#: NOFMA_OPS, reported beside the bound as a second ceiling.
PEAK_OPS, PEAK_BYTES, NOFMA_OPS = 67e12, 3.35e12, 67e12 / 2
#: The quality estimator as the CLI's --mode quality builds it.
QUALITY = dict(rng="hash", sampler="cosine", nee=True, mis=True)
#: The pose group's rate in the headline quality train steps: the group is
#: enabled, so its gradient (K4's camera-ray adjoint through
#: generate_rays) is computed, at rate 0. The camera starts at the truth,
#: where the paths of some pixels run exactly along edges that two
#: triangles of the symmetric default scene share; a move of the camera by
#: any amount sends them onto the other triangle, a jump the gradient
#: without vis_grad does not see, so at any rate the loss rises after the
#: first pose step (tests/test_torch_quality.py holds the port's wavefront
#: to the JAX package there). EDGE_MOVE is the move of the witness. Pose
#: recovery runs on a scene without silhouettes (tests/test_inverse.py's
#: test_pose_recovery) at POSE_RECOVERY_LR, from the true camera moved
#: POSE_OFFSET along z.
QUALITY_POSE_LR, POSE_RECOVERY_LR, POSE_OFFSET = 0.0, 1e-2, -0.4
EDGE_MOVE = 1e-6
#: The light distribution's work per triangle (csrc/light_cdf.cu): the
#: weight (2 adds, 1 multiply), the total, the divide, the scan's adds in
#: and across blocks of 16; emission and area read, cdf and prob written.
LIGHT_OPS, LIGHT_BYTES = 7, 24
#: The light distribution's sizes held to its plain version on
#: light_inputs: phase 11 up to the one-block route's SHARED_TRIS, phase
#: 26 above it (with procedural_scene at BIG_T, HUGE_T and 2^20, and an
#: all-dark table at HUGE_T); LIGHT_CROSSOVER_T the sizes at which both
#: routes are timed in turns to place SHARED_TRIS.
LIGHT_SMALL_T = (33, 1025, 8192)
LIGHT_BIG_T = (8193, 32769, (1 << 20) - 1)
LIGHT_CROSSOVER_T = (4608, 6144, 7168, 8192, 10240)
#: (label, estimator) of the K3/K4 comparisons
QUALITY_GRID = [
    ("nee+mis", dict(QUALITY)),
    ("bsdf only", dict(QUALITY, nee=False, mis=False)),
    ("nee+mis rr2 strat", dict(QUALITY, rr_start=2, stratify=True)),
]
#: K4 against its plain version (float64 sums): each column group of the
#: (T, 19) adjoint within its bound of its own max|plain|; the vertex and
#: edge groups sum terms of both signs, hence the looser bound
QGRAD_GROUPS = {"v0": (slice(0, 3), 1e-4), "e1": (slice(3, 6), 1e-4),
                "e2": (slice(6, 9), 1e-4), "normal": (slice(9, 12), 1e-5),
                "albedo": (slice(12, 15), 1e-5),
                "emission": (slice(15, 18), 1e-5),
                "area": (slice(18, 19), 1e-5)}
#: Operations of the quality walk, counted from csrc/quality_walk.cuh
#: (compares, selects, loads and integer hash work not counted): a
#: shadow-ray test that shares its origin terms with the next bounce's
#: sweep (nearest2) skips 17 of MT_OPS; a hit costs K3 ~160 more (hit
#: point, flip, emitter term with its MIS weight, the cosine frame and
#: direction with 2 square roots and 2 trig calls, the light point, r²,
#: ω, both cosines, G, A/q, the MIS weight, radiance, throughput and the
#: next pdf), and the light choice 1 compare per emissive row. K4 replays
#: the walk and adds ~155 per hit (emitter, albedo and Moller-Trumbore
#: adjoints, the origin chain, 18 accumulating adds) and ~206 per lane
#: whose NEE term counted (its geometry again and its adjoint, 16 adds).
SHARED_MT_OPS, K3_HIT_OPS, K4_HIT_OPS, K4_NEE_OPS = MT_OPS - 17, 160, 315, 206
#: The large-scene cells (BASELINE config 4, bench.py:292-310): serving on
#: procedural_scene(BIG_T, seed=0) at the headline shape, and on
#: procedural_scene(HUGE_T, seed=0) at HUGE_SPP samples (cut from 64 for
#: time, as bench.py cuts it); training on the first at BIG_TRAIN_SPP
#: samples (cut from 64 for time).
BIG_T, HUGE_T, HUGE_SPP, BIG_TRAIN_SPP = 10_000, 100_000, 2, 8
#: The scene of the streamed kernels' checks: the default scene and
#: procedural_scene(COMBINED_EXTRA, seed=0, emissive_fraction=0.05),
#: 1150 triangles (tests/test_bigscene.py).
COMBINED_EXTRA = 1143
#: Rows of the full-width frames held to the plain version (rays are
#: independent, so a band of rows is the same rays and seeds), and rows
#: spread over the frame whose walk the plain replay counts for the
#: bounds, scaled to the frame.
BAND_ROWS, COUNT_ROWS = range(536, 544), range(67, 1080, 135)
#: K7 against its plain version (float64 sums) on synthetic events
#: (T, E): within SCATTER_RTOL of each column's max|plain|.
SCATTER_CASES, SCATTER_RTOL = ((1 << 20, 1 << 20), (1000, 1 << 16)), 1e-5
#: The routing crossover table: procedural scenes of these sizes at
#: 320x240, 8 spp.
CROSSOVER_T = (64, 128, 256, 512, 1024)
#: A launch longer than this (ms) is timed once, else twice.
LONG_LAUNCH_MS = 20e3
#: Per hit, K8 does K2's work but the 9 accumulating adds, which K7 does
#: per event.
K8_HIT_OPS = K2_HIT_OPS - 9
#: The quality estimator's large-scene cells: serving on
#: procedural_scene(BIG_T, seed=0) at the headline shape but BIGQ_SERVE_SPP
#: samples (cut from 64 to keep the script near 420 s: a 64-sample frame
#: took 28.4 s on an H100, and with its plain band and timings ~140 s of
#: the run), and on procedural_scene(HUGE_T, seed=0) at BIGQ_HUGE_SPP (cut
#: from 64 for time); training on the first at BIGQ_TRAIN_SPP (cut from 64
#: for time).
BIGQ_SERVE_SPP, BIGQ_HUGE_SPP, BIGQ_TRAIN_SPP = 16, 1, 4
#: The visibility-gradient training cell: the quality headline's frame
#: (1920x1080, 5 bounces) with vis_grad, VIS_TRAIN_SPP samples (cut from
#: 64 for time: the residual's backward is bound by the host's launches,
#: ~1,500 small kernels and ~0.09 s a slice of 262,144 pixels and sample
#: on an H100, so a step at 16 spp took 24-29 s). The pose measurement
#: steps at POSE_STEP_LR, the JAX package's default pose rate.
VIS_TRAIN_SPP, POSE_STEP_LR = 8, 1e-3
#: Ray counts of phase 34's K5 checks that end inside a CTA's ray tile, and
#: the launches of each timing of K5 on 1080p rays against 7 triangles.
K5_RAY_COUNTS, K5_FRAME_REPS = (1, 127, 129, 262_143), 100
#: The microbenchmark's shape (tools/sweep_microbench.py: 640x360 rays,
#: procedural_scene(65536, seed=0)) and the CUDA-event calls of each of
#: its timed lines, twice, after one warm-up call.
T1_SHAPE, T1_REPS = (640, 360, 65536), 5
#: T1's ragged and small shapes: rays (one, 256 each side, the 448-ray
#: CTA tile each side, three tiles and 5) and triangles (1, 4 and 17
#: blocks of 256), all pairs, on the tool's operands.
T1_RAY_COUNTS = (1, 255, 257, 447, 449, 3 * 448 + 5)
T1_TRI_COUNTS = (256, 1024, 4352)
#: The threefry kernel's work (csrc/threefry.cu), counted as the integer
#: instructions it needs at the least: a Threefry-2x32 block 73 (its 20
#: rounds of add, funnel shift and xor 60, its five key injections a
#: three-input add and an add each, the first key addition 2, the third
#: key word one three-input xor), a draw 3 more (xor, shift, or); bytes:
#: the pixel id read (8) and each draw written (4). The rate: an SM issues
#: at most 4 warp instructions a clock (one a scheduler), 128 thread
#: operations, on each of the H100 SXM's 132 SMs at its 1.98 GHz boost
#: clock, 33.4e12 /s. The int32 pipes' own 64 a clock (16.7e12 /s) is no
#: bound: nvcc issues integer adds as IMAD on the FP32 pipes too, and the
#: kernel ran faster than 16.7e12 /s allows (an H100 at 700 W, PERF.md).
THREEFRY_BLOCK_OPS, THREEFRY_DRAW_OPS = 73, 3
PEAK_INT32_OPS = 132 * 128 * 1.98e9
#: The (seed, sample, bounce) steps at which phase 43 holds the threefry
#: kernel to its plain version, and the draws a pixel it checks.
THREEFRY_STEPS = ((0, 0, 0), (3, 17, 4), (2**31 - 1, 63, 1))
THREEFRY_DRAWS = (2, 5, 7)
#: The frame of phases 44 and 45's bit-equality with the plain sweep and
#: plain draws; the QUALITY preset's training cell at 1080p, 5 bounces,
#: PRESET_TRAIN_SPP samples (cut from 64 for time: the autograd wavefront's
#: tape holds every sample, ~1.8 KB a pixel and sample counted on the CPU).
STREAM_CHECK = dict(width=320, height=240, spp=4, max_bounces=5)
PRESET_TRAIN_SPP = 8


class SmokeFailure(Exception):
    pass


def plain_sweep():
    """Every sweep the plain ``_sweep`` inside the block, on the card too:
    the plain wavefront the kernels are held to stays plain PyTorch."""
    from spath_tpu_torch.ops.intersect import plain_sweep as block

    return block()


def serving_route(scene, cam, cfg) -> str:
    """The renderer ``render_pt_fast`` takes for ``(scene, cam, cfg)``: a
    timing of it times that route."""
    from spath_tpu_torch.models.renderer import forward_renderer

    return forward_renderer(scene, cfg, require_jittable=False,
                            camera=cam).name


def grad_route(scene, cam, cfg) -> str:
    """The renderer ``render_radiance_fastgrad`` takes for ``(scene, cam,
    cfg)``: a timing of it times that route."""
    from spath_tpu_torch.models.renderer import grad_renderer

    return grad_renderer(scene, cfg, camera=cam).name


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def compare(torch, got, want) -> dict:
    """Flip share, mean agreement and max |error| of two (n, 3) outputs."""
    diff = (got - want).abs()
    flipped = (diff > FLIP_ATOL).any(dim=1).float().mean().item()
    g, w = got.mean().item(), want.mean().item()
    return dict(flipped=flipped, mean=g, plain_mean=w,
                max_abs_err=diff.max().item(),
                bit_exact=bool(torch.equal(got, want)))


def check_against_plain(torch, got, want, name: str) -> dict:
    """Hold a kernel output to its plain version with the bounds of
    tests/test_pallas.py."""
    c = compare(torch, got, want)
    check(torch.isfinite(got).all().item(), f"{name}: kernel output not "
          "finite")
    check(c["flipped"] < FLIP_MAX, f"{name}: {c['flipped']:.4f} of pixels "
          "disagree")
    check(abs(c["mean"] - c["plain_mean"]) <= MEAN_RTOL * abs(c["plain_mean"]),
          f"{name}: means differ")
    check(c["plain_mean"] > 0.0, f"{name}: black frame")
    return c


def scene_25(device):
    """The default scene and 18 random triangles: 25 triangles with the
    default scene's light in view. (``procedural_scene(25, seed=2)`` alone
    has no emissive triangle, so every pixel of it would be 0.)"""
    import numpy as np

    from spath_tpu_torch.convert import scene_to_numpy
    from spath_tpu_torch.scene import default_scene, make_scene, \
        procedural_scene

    parts = [scene_to_numpy(default_scene("cpu")),
             scene_to_numpy(procedural_scene(18, seed=2, device="cpu"))]
    return make_scene(*(np.concatenate([p[k] for p in parts])
                        for k in range(3)), device)


def wall_and_light_scene(device):
    """tests/test_nee.py's silhouette-free scene: a wall far wider than the
    view and a large area light behind the camera, so the frame is a
    smooth function of the camera pose."""
    import numpy as np

    from spath_tpu_torch.scene import make_scene

    verts = np.array([[[-500.0, -500.0, 1.0], [500.0, -500.0, 1.0],
                       [0.0, 800.0, 1.0]],
                      [[-3.0, -3.0, -8.0], [3.0, -3.0, -8.0],
                       [0.0, 4.0, -8.0]]], np.float32)
    albedo = np.array([[0.6, 0.5, 0.4], [0.0, 0.0, 0.0]], np.float32)
    emission = np.array([[0.0, 0.0, 0.0], [5.0, 5.0, 5.0]], np.float32)
    return make_scene(verts, albedo, emission, device)


def event_ms(torch, fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def traced_kernels(torch, fn, reps: int, enough) -> list:
    """``(name, device ms)`` of each kernel in a ``torch.profiler`` trace
    of ``reps`` calls of ``fn``. On an H100 a trace of a few short calls
    has come back with no kernel at all, and one with a launch short of
    50, and one with fewer than half of 60, so a trace that ``enough``
    refuses is taken again, up to three times; where none is enough, the
    one that holds the most kernels is returned."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
        kernels = [(e["name"], e["dur"] / 1e3) for e in events
                   if e.get("cat") == "kernel" and "dur" in e]
        if enough(kernels):
            return kernels
        best = max(best, kernels, key=len)
    return best


def kernel_device_ms(torch, fn, reps: int, kernel: str) -> float:
    """Device ms of one launch of the kernel whose name holds ``kernel``,
    from a ``torch.profiler`` trace of ``reps`` calls of ``fn``: CUDA
    events around back-to-back launches of a few microseconds time the
    host's launch rate, not the kernel. The mean of the launches traced
    (``traced_kernels``: taken again while any is missing); where three
    traces hold none, the device ms a call from CUDA events
    (``queued_ms``), logged as such."""
    def mine(kernels):
        return [ms for name, ms in kernels if kernel in name]

    durs = mine(traced_kernels(torch, fn, reps,
                               lambda ks: len(mine(ks)) == reps))
    if durs:
        return sum(durs) / len(durs)
    log(f"no {kernel} kernel in three traces of {reps} calls: its device "
        f"ms a call from CUDA events instead")
    return queued_ms(torch, fn, reps)


def bound(ops: float, nbytes: float):
    """The least time the card could take, ms, and what bounds it."""
    t_ops, t_bytes = ops / PEAK_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def backward_vs_plain(torch, o, d, seeds, tri, cfg, name: str,
                      streamed: bool = False, tri_block: int = 512):
    """K2 (or, ``streamed``, K8 with K7) against ``mega_bwd_plain`` on the
    same rays and a cotangent drawn uniform in [0.1, 1) from seed 3: each
    column group within GRAD_RTOL of its own max|plain| (exactly equal
    where the plain group is zero), columns 0-8 exactly zero, two
    launches bitwise equal; K8 also within GRAD_RTOL of K2 where K2 takes
    the scene. Returns the comparison and the cotangent."""
    from spath_tpu_torch.ops.kernels import bigscene_grad as bg
    from spath_tpu_torch.ops.kernels import megakernel_grad as mg

    call = bg.bigscene_bwd_call if streamed else mg.mega_bwd_call
    gen = torch.Generator().manual_seed(3)
    gbar = (torch.rand((o.shape[0], 3), generator=gen) * 0.9
            + 0.1).to(o.device)
    got = call(o, d, seeds, tri, gbar, cfg)
    again = call(o, d, seeds, tri, gbar, cfg)
    torch.cuda.synchronize()
    want = mg.mega_bwd_plain(o, d, seeds, tri, gbar,
                             cfg.replace(tri_block=tri_block))
    check(torch.isfinite(got).all().item(), f"{name}: kernel not finite")
    check(want.abs().max().item() > 0.0, f"{name}: the plain adjoint is "
          "zero")
    rel = {}
    for group, cols in GRAD_GROUPS.items():
        scale = want[:, cols].abs().max().item()
        err = (got[:, cols] - want[:, cols]).abs().max().item()
        check(err <= GRAD_RTOL * scale, f"{name}: the {group} adjoint off "
              f"its plain version by {err:.6g}, max|plain| {scale:.6g}")
        rel[group] = err / scale if scale else 0.0
    check(bool((got[:, :9] == 0).all()), f"{name}: columns 0-8 not zero")
    check(torch.equal(got, again), f"{name}: two launches differ")
    if streamed and tri.shape[0] <= mg.GRAD_MAX_TRIS:
        k2 = mg.mega_bwd_call(o, d, seeds, tri, gbar, cfg)
        for group, cols in GRAD_GROUPS.items():
            scale = k2[:, cols].abs().max().item()
            err = (got[:, cols] - k2[:, cols]).abs().max().item()
            check(err <= GRAD_RTOL * scale, f"{name}: K8's {group} adjoint "
                  f"off K2's by {err:.6g}, max|K2| {scale:.6g}")
            rel[f"{group} vs K2"] = err / scale if scale else 0.0
    return dict(max_abs_err=(got - want).abs().max().item(),
                rel_err_by_group=rel, deterministic=True), gbar


def counts(kernels: dict) -> dict:
    """The launch counts of ``{name: wrapper}``."""
    return {name: fn.launches for name, fn in kernels.items()}


def zero_counts(kernels: dict) -> None:
    for fn in kernels.values():
        fn.launches = 0


def conformance_kernels(big: bool) -> dict:
    """The wrappers of the conformance path: the fused K1/K2 or the
    streamed K6/K8/K7."""
    from spath_tpu_torch.ops.kernels import bigscene as bs
    from spath_tpu_torch.ops.kernels import bigscene_grad as bg
    from spath_tpu_torch.ops.kernels import megakernel as mk
    from spath_tpu_torch.ops.kernels import megakernel_grad as mg
    from spath_tpu_torch.ops.kernels import stream_scatter as ss

    if big:
        return {"K6": bs.bigscene_call, "K8": bg.bigscene_bwd_call,
                "K7": ss.stream_scatter_call}
    return {"K1": mk.mega_call, "K2": mg.mega_bwd_call}


def gradient_entry(torch, dev, cam, scene, big: bool = False) -> str:
    """Phase 7 (and 22 with ``big``): ``render_radiance_fastgrad`` on the
    card against autograd of the plain wavefront, then emission linearity
    through the forward kernel twice. Every kernel of the path launches,
    the other path's kernels do not."""
    from spath_tpu_torch.config import RenderConfig
    from spath_tpu_torch.models.pathtracer import (
        render_radiance, render_radiance_fastgrad,
    )
    from spath_tpu_torch.scene import Scene

    cfg = RenderConfig(width=320, height=240, spp=8, max_bounces=5)
    gen = torch.Generator().manual_seed(7)
    wts = (torch.rand((cfg.height, cfg.width, 3), generator=gen) * 0.9
           + 0.1).to(dev)

    def grads(render):
        leaves = [t.detach().clone().requires_grad_()
                  for t in (scene.vertices, scene.albedo, scene.emission)]
        loss = (render(Scene(*leaves), cam, cfg, 0) * wts).sum()
        return torch.autograd.grad(loss, leaves)

    path, other = conformance_kernels(big), conformance_kernels(not big)
    zero_counts({**path, **other})
    got = grads(render_radiance_fastgrad)
    torch.cuda.synchronize()
    launched = counts({**path, **other})
    check(all(launched[k] > 0 for k in path)
          and not any(launched[k] for k in other),
          f"render_radiance_fastgrad launched {launched}")
    with plain_sweep():
        want = grads(render_radiance)
    errs = {}
    for name, g, w in zip(("vertices", "albedo", "emission"), got, want):
        scale = w.abs().max().item()
        errs[name] = (g - w).abs().max().item() / scale
        check(scale > 0.0, f"{name}: zero gradient")
        check(errs[name] <= ENTRY_RTOL, f"{name} gradient off the "
              f"wavefront's by {errs[name]:.3g} of its max")

    e = scene.emission.detach().clone().requires_grad_()
    loss = render_radiance_fastgrad(Scene(scene.vertices, scene.albedo, e),
                                    cam, cfg, 0).mean()
    (g,) = torch.autograd.grad(loss, [e])
    direction = torch.randn(e.shape, generator=gen).to(dev)
    with torch.no_grad():
        f1 = render_radiance_fastgrad(
            Scene(scene.vertices, scene.albedo, e + direction), cam, cfg,
            0).mean().item()
    want_d, got_d = f1 - loss.item(), (g * direction).sum().item()
    check(abs(got_d - want_d) <= LINEARITY_RTOL * max(abs(want_d), 1e-6),
          f"emission linearity: <g, dir> {got_d} against {want_d}")
    return (f"launches {launched}; gradient error / max: "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f"; emission <g, dir> {got_d:.7g} vs L(e+dir) - L(e) "
            f"{want_d:.7g}")


def training(torch, dev, cam, scene, cfg, per_step=None) -> dict:
    """Phase 8 (and 23): three train steps at full width through K1 and
    K2, or, given ``per_step`` ({kernel: launches a step}), through the
    streamed K6, K8 and K7; the other path's kernels do not launch."""
    import numpy as np

    from spath_tpu_torch.models.inverse import (
        InverseParams, init_state, make_train_step, param_group_optimizer,
    )
    from spath_tpu_torch.models.pathtracer import render_radiance_fastgrad
    from spath_tpu_torch.models.renderer import forward_renderer

    target = forward_renderer(scene, cfg).render_radiance(scene, cam, cfg, 0)
    true_albedo = scene.albedo.cpu().numpy()
    rng = np.random.default_rng(1)
    bad = np.clip(true_albedo + rng.uniform(-0.4, 0.4, true_albedo.shape)
                  .astype(np.float32), 0.05, 1.0)
    params = InverseParams(cam_pos=cam.pos, cam_angle=cam.angle,
                           cam_focal=cam.focal,
                           albedo=torch.from_numpy(bad).to(dev))
    state = init_state(param_group_optimizer(freeze_pose=True,
                                             albedo_lr=2e-2), params)
    step = make_train_step(scene, cfg, fixed_seed=0)
    torch.cuda.synchronize()

    big = per_step is not None
    per_step = per_step or {"K1": 1, "K2": 1}
    path, other = conformance_kernels(big), conformance_kernels(not big)
    zero_counts({**path, **other})
    losses, step_s = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        state, aux = step(state, target)
        losses.append(float(aux["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launched = counts({**path, **other})
    check(launched == {**{k: 0 for k in other},
                       **{k: 3 * per_step[k] for k in path}},
          f"3 train steps launched {launched}")
    check(all(np.isfinite(losses)), f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")

    albedo = state.params.albedo.detach().clone().requires_grad_()

    def fwd_bwd():
        img = render_radiance_fastgrad(
            dataclasses.replace(scene, albedo=albedo), cam, cfg, 0)
        torch.autograd.grad(((img - target) ** 2).mean(), [albedo])

    fwd_bwd()
    ms = event_ms(torch, fwd_bwd, 1 if big else 3)
    route = grad_route(dataclasses.replace(scene, albedo=albedo), cam, cfg)
    return dict(launches=launched, losses=losses, step_s=step_s,
                fwd_bwd_ms=ms, fwd_bwd_route=route,
                **{k.lower(): v for k, v in launched.items()})


def cli_invert(cli) -> str:
    """Phase 9: ``invert`` returns 0 and lowers the albedo error."""
    import contextlib
    import io
    import re

    w, h = CLI_SIZE
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["invert", "--size", f"{w}x{h}", "--spp", "16",
                       "--steps", "5"])
    text = out.getvalue()
    m = re.search(r"albedo error ([0-9.]+) -> ([0-9.]+)", text)
    check(rc == 0 and m is not None, f"cli invert: rc {rc}, {text!r}")
    check(float(m[2]) < float(m[1]), f"albedo error did not fall: {text!r}")
    return text.strip()


def light_cdf_vs_plain(torch, scene, name: str) -> dict:
    """Phases 11 and 26: ``light_vs_plain`` on the scene's emission and
    areas."""
    from spath_tpu_torch.ops import nee

    return light_vs_plain(torch, scene.emission, nee.triangle_areas(scene),
                          name)


def light_inputs(torch, dev, n_tris: int, seed: int, lit: bool = True):
    """``(emission (T, 3), area (T,))`` on ``dev`` from numpy's Philox at
    ``seed``: emission over twelve decades, a third of the rows dark (all
    of them unless ``lit``), areas over six decades."""
    import numpy as np

    g = np.random.Generator(np.random.Philox(seed))
    emission = (np.exp(g.uniform(-14.0, 14.0, size=(n_tris, 3)))
                * (g.uniform(size=(n_tris, 1)) < 2 / 3) * lit)
    area = np.exp(g.uniform(-7.0, 7.0, size=n_tris))
    return (torch.from_numpy(emission.astype(np.float32)).to(dev),
            torch.from_numpy(area.astype(np.float32)).to(dev))


def light_vs_plain(torch, emission, area, name: str) -> dict:
    """The light distribution kernel against its plain version on these
    emissions and areas, to the bit (a discrete choice reads the cdf), two
    calls bitwise equal, and the kernels a call launched by the library's
    count (phase 26 counts them in a trace too): one up to SHARED_TRIS
    triangles, at most three above."""
    from spath_tpu_torch.ops.kernels import light_cdf as lc

    n_tris = emission.shape[0]
    before = lc.kernel_launches()
    cdf, prob = lc.light_cdf_call(emission, area)
    launches = lc.kernel_launches() - before
    again = lc.light_cdf_call(emission, area)
    torch.cuda.synchronize()
    want_cdf, want_prob = lc.light_cdf_plain(emission, area)
    err = max((cdf - want_cdf).abs().max().item(),
              (prob - want_prob).abs().max().item())
    check(torch.equal(cdf, want_cdf) and torch.equal(prob, want_prob),
          f"{name}: the light distribution kernel is off its plain version "
          f"by {err:.6g}")
    check(torch.equal(again[0], cdf) and torch.equal(again[1], prob),
          f"{name}: two light distribution calls differ")
    check(launches == 1 if n_tris <= lc.SHARED_TRIS else 1 <= launches <= 3,
          f"{name}: {launches} kernels launched in one call at T={n_tris}")
    return dict(n_tris=n_tris, max_abs_err=err, bit_exact=True,
                two_calls_bitwise_equal=True, launches_per_call=launches,
                lit=bool(want_prob.any().item()))


def device_calls(torch, fn, reps: int, launches: int = 0) -> dict:
    """The kernels of a call of ``fn`` from a ``torch.profiler`` trace of
    ``reps`` calls (``traced_kernels``, taken again while it holds no
    kernel or, where ``launches`` a call are given, not ``reps`` times
    that many):
    ``by_kernel``, each kernel's device ms a call by name (its mean
    duration times its launches a call), ``busy_ms``, their sum, and
    ``kernels_per_call``. A kernel's launches a call are its traced count
    over ``reps``, rounded: the profiler can lose a launch (on an H100,
    53 of 60 in one trace and fewer than half in another). Where three
    traces hold no kernel, or the fullest holds fewer than ``reps`` times
    ``launches`` and too few for its counts a call to add up to
    ``launches``, ``traced`` is False, ``busy_ms`` the device ms a call
    from CUDA events (``queued_ms``), ``traced_kernels`` the kernels that
    trace held and the rest None. A trace that holds ``reps`` times
    ``launches`` or more is kept whatever its counts: a kernel the
    library does not count shows there."""
    kernels = traced_kernels(
        torch, fn, reps, lambda ks: ks and (not launches
                                            or len(ks) == reps * launches))
    durs = {}
    for name, ms in kernels:
        name = name.replace("(anonymous namespace)::", "")
        name = name.split("(")[0].split("<")[0].split("::")[-1].strip()
        durs.setdefault(name, []).append(ms)
    per_call = {name: round(len(d) / reps) for name, d in durs.items()}
    short = len(kernels) < reps * launches
    if short:
        log(f"{len(kernels)} kernels in the fullest of three traces of "
            f"{reps} calls, {reps * launches} launched")
    if not kernels or (short and sum(per_call.values()) != launches):
        log(f"no trace of {reps} calls gives the kernels a call: device ms "
            f"a call from CUDA events instead")
        return dict(busy_ms=queued_ms(torch, fn, reps), by_kernel=None,
                    kernels_per_call=None, traced=False,
                    traced_kernels=len(kernels))
    by_kernel = {name: sum(d) / len(d) * per_call[name]
                 for name, d in durs.items()}
    return dict(busy_ms=sum(by_kernel.values()), by_kernel=by_kernel,
                kernels_per_call=sum(per_call.values()), traced=True)


def queued_ms(torch, fn, reps: int) -> float:
    """Device ms a call of ``fn``, the gaps between its launches included
    but not the host's launch rate: CUDA events around ``reps`` calls
    enqueued while the card runs a sleeping kernel, which must outlast
    the enqueueing (else the sleep is doubled, up to three times)."""
    fn()
    torch.cuda.synchronize()
    cycles = int(4e6 * max(1, reps // 5))
    for _ in range(4):
        slept, start, end = (torch.cuda.Event(enable_timing=True)
                             for _ in range(3))
        slept.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if slept.elapsed_time(start) > host_ms:
            return start.elapsed_time(end) / reps
        cycles *= 2
    raise SmokeFailure(f"the host took {host_ms:.3f} ms to enqueue {reps} "
                       f"calls, longer than the sleep before them")


def light_timing(torch, emission, area, reps: int = 20) -> dict:
    """Phase 26: the light distribution at these inputs, timed: device ms
    a call (``queued_ms``), its kernels' busy time and the kernels a call
    (``device_calls``; the count equal to the library's where the trace
    held the kernels, ``traced``), CUDA-event ms a call over ``reps``
    calls back to back (the host's launch rate included), the plain
    version's ms a call
    (CUDA events over two calls), the bound (LIGHT_BYTES a
    triangle at the memory's rate), and ``torch.cumsum`` of the prob
    column, the library call beside it (the cdf alone, not in the plain
    version's order), timed the same ways."""
    from spath_tpu_torch.ops.kernels import light_cdf as lc

    n_tris = emission.shape[0]
    before = lc.kernel_launches()
    cdf, prob = lc.light_cdf_call(emission, area)
    launches = lc.kernel_launches() - before

    def call():
        lc.light_cdf_call(emission, area)

    def cumsum():
        torch.cumsum(prob, 0)

    kernel, library = device_calls(torch, call, reps, launches), device_calls(
        torch, cumsum, reps)
    out = dict(
        ms=queued_ms(torch, call, reps), busy_ms=kernel["busy_ms"],
        busy_by_kernel_ms=kernel["by_kernel"],
        kernels_per_call=kernel["kernels_per_call"], traced=kernel["traced"],
        call_ms=event_ms(torch, call, reps),
        plain_ms=event_ms(torch, lambda: lc.light_cdf_plain(emission, area),
                          2),
        bound_ms=bound(LIGHT_OPS * n_tris, LIGHT_BYTES * n_tris)[0],
        cumsum_ms=queued_ms(torch, cumsum, reps),
        cumsum_busy_ms=library["busy_ms"],
        cumsum_call_ms=event_ms(torch, cumsum, reps),
        cumsum_bit_equal=torch.equal(torch.cumsum(prob, 0), cdf))
    check(out["ms"] > 0 and out["cumsum_ms"] > 0, "timing failed")
    check(not kernel["traced"] or out["kernels_per_call"] == launches,
          f"{out['kernels_per_call']} kernels a call in the trace, "
          f"{launches} by the library's count")
    return out


def light_crossover(torch, dev) -> dict:
    """Phase 26: the light distribution's one-block route and its grid's
    three launches (``light_cdf.launch``) at each LIGHT_CROSSOVER_T, both
    bit-equal to the plain version, then timed in turns (block, grid,
    grid, block), device ms a call (``queued_ms``), to place
    SHARED_TRIS."""
    from spath_tpu_torch.ops.kernels import light_cdf as lc

    out = {}
    for n_tris in LIGHT_CROSSOVER_T:
        emission, area = light_inputs(torch, dev, n_tris, n_tris)
        want = lc.light_cdf_plain(emission, area)
        for grid in (False, True):
            got = lc.launch(emission, area, grid)
            check(torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                               want[1]),
                  f"light distribution at T={n_tris}, "
                  f"{'grid' if grid else 'one block'}: off the plain version")
        ms = [queued_ms(torch, lambda g=grid: lc.launch(emission, area, g),
                        20) for grid in (False, True, True, False)]
        out[n_tris] = dict(block_ms=(ms[0] + ms[3]) / 2,
                           grid_ms=(ms[1] + ms[2]) / 2, turns_ms=ms)
    return out


def quality_vs_plain(torch, cam, scene, cfg, name: str) -> dict:
    """Phase 11: K3 against ``quality_plain`` on the same rays and keys."""
    from spath_tpu_torch.ops.kernels import megakernel_quality as mq

    o, d, keys = mq.pack_rays(cam, cfg, 0)
    tri, rows = mq.quality_table(scene), mq.light_rows(scene)
    got = mq.quality_call(o, d, keys, tri, rows, cfg)
    torch.cuda.synchronize()
    want = mq.quality_plain(o, d, keys, tri, rows, cfg)
    return check_against_plain(torch, got, want, name)


def quality_backward_vs_plain(torch, o, d, keys, tri, rows, cfg, name: str,
                           streamed: bool = False, tri_block: int = 512):
    """Phase 13's checks of K4, or (``streamed``) phase 28's of K10 with
    K7: against ``quality_bwd_plain`` on the same rays and a cotangent
    uniform in [0.1, 1) from seed 3, each column group within its
    QGRAD_GROUPS bound of its own max|plain|, the camera-ray adjoint
    within 1e-5 of its max, prob and cdf zero, two launches bitwise
    equal; K10 also within 1e-5 of each group's max of K4 where K4 takes
    the scene."""
    from spath_tpu_torch.ops.kernels import bigscene_quality_grad as bqg
    from spath_tpu_torch.ops.kernels import megakernel_quality as mq
    from spath_tpu_torch.ops.kernels import megakernel_quality_grad as mqg

    call = bqg.bigq_bwd_call if streamed else mqg.quality_bwd_call
    kernel = "K10" if streamed else "K4"
    gen = torch.Generator().manual_seed(3)
    gbar = (torch.rand((o.shape[0], 3), generator=gen) * 0.9
            + 0.1).to(o.device)
    got, gray = call(o, d, keys, tri, rows, gbar, cfg)
    again, gray_again = call(o, d, keys, tri, rows, gbar, cfg)
    torch.cuda.synchronize()
    want, want_gray = mqg.quality_bwd_plain(o, d, keys, tri, rows, gbar,
                                            cfg.replace(tri_block=tri_block))
    check(torch.isfinite(got).all().item()
          and torch.isfinite(gray).all().item(), f"{name}: {kernel} not "
          "finite")
    check(want.abs().max().item() > 0.0, f"{name}: the plain adjoint is "
          "zero")
    rel = {}
    for group, (cols, bound_) in QGRAD_GROUPS.items():
        scale = want[:, cols].abs().max().item()
        err = (got[:, cols] - want[:, cols]).abs().max().item()
        check(err <= bound_ * scale, f"{name}: {kernel}'s {group} adjoint "
              f"off its plain version by {err:.6g}, max|plain| {scale:.6g}")
        rel[group] = err / scale if scale else 0.0
    rscale = want_gray.abs().max().item()
    rerr = (gray - want_gray).abs().max().item()
    check(rerr <= GRAD_RTOL * rscale, f"{name}: {kernel}'s ray adjoint off "
          f"by {rerr:.6g}, max|plain| {rscale:.6g}")
    rel["rays"] = rerr / rscale if rscale else 0.0
    table = mqg.grad_table_from_gtab19(got)
    check(not table[:, [mq.COL_PROB, mq.COL_CDF]].any().item(),
          f"{name}: prob/cdf cotangent not zero")
    check(torch.equal(got, again) and torch.equal(gray, gray_again),
          f"{name}: two launches differ")
    if streamed and tri.shape[0] <= mqg.GRAD_MAX_TRIS:
        k4, _ = mqg.quality_bwd_call(o, d, keys, tri, rows, gbar, cfg)
        for group, (cols, _) in QGRAD_GROUPS.items():
            scale = k4[:, cols].abs().max().item()
            err = (got[:, cols] - k4[:, cols]).abs().max().item()
            check(err <= GRAD_RTOL * scale, f"{name}: K10's {group} adjoint "
                  f"off K4's by {err:.6g}, max|K4| {scale:.6g}")
            rel[f"{group} vs K4"] = err / scale if scale else 0.0
    return dict(max_abs_err=(got - want).abs().max().item(),
                rel_err_by_group=rel,
                rays_bit_exact=bool(torch.equal(gray, want_gray)),
                deterministic=True), gbar


def quality_gradient_entry(torch, dev, cam, scene, big: bool = False
                           ) -> str:
    """Phase 14 (and 30 with ``big``): ``render_radiance_fastgrad`` in the
    quality config on the card against autograd of the plain wavefront,
    camera position included, through K3 and K4 (or the light
    distribution, K9, K10 and K7 and no other kernel); with ``big`` also
    emission linearity through K9 twice, along a direction that keeps the
    light distribution (see below)."""
    from spath_tpu_torch.camera import Camera
    from spath_tpu_torch.config import RenderConfig
    from spath_tpu_torch.models.pathtracer import (
        render_radiance, render_radiance_fastgrad,
    )
    from spath_tpu_torch.ops.kernels import megakernel_quality as mq
    from spath_tpu_torch.ops.kernels import megakernel_quality_grad as mqg
    from spath_tpu_torch.scene import Scene

    cfg = RenderConfig(width=320, height=240, spp=8, max_bounces=5,
                       **QUALITY)
    gen = torch.Generator().manual_seed(7)
    wts = (torch.rand((cfg.height, cfg.width, 3), generator=gen) * 0.9
           + 0.1).to(dev)

    def grads(render):
        leaves = [t.detach().clone().requires_grad_()
                  for t in (scene.vertices, scene.albedo, scene.emission,
                            cam.pos)]
        img = render(Scene(*leaves[:3], scene.light_idx),
                     Camera(leaves[3], cam.angle, cam.focal), cfg, 0)
        return torch.autograd.grad((img * wts).sum(), leaves)

    zero_counts(every_kernel())
    got = grads(render_radiance_fastgrad)
    torch.cuda.synchronize()
    k3, k4 = mq.quality_call.launches, mqg.quality_bwd_call.launches
    if big:
        path = launched_only({"light": 1, "K9": 1, "K10": 1, "K7": 1},
                             "render_radiance_fastgrad quality")
    else:
        check(k3 > 0 and k4 > 0, f"render_radiance_fastgrad launched K3 "
              f"{k3} and K4 {k4} times")
    with plain_sweep():
        want = grads(render_radiance)
    errs = {}
    for name, g, w in zip(("vertices", "albedo", "emission", "camera"), got,
                          want):
        scale = w.abs().max().item()
        errs[name] = (g - w).abs().max().item() / scale
        check(scale > 0.0, f"{name}: zero gradient")
        check(errs[name] <= ENTRY_RTOL, f"{name} gradient off the "
              f"wavefront's by {errs[name]:.3g} of its max")
    if not big:
        return (f"K3 {k3} and K4 {k4} launches; gradient error / max: "
                + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    # Along the emission itself, L(2e) - L(e) against <g, e>: doubling
    # every emission doubles every weight and the total exactly, so the
    # light distribution stays bit for bit. The estimator is linear in
    # emission only while its light choice is fixed (prob and cdf are
    # detached): along a random direction the frame moved 0.33% off the
    # first-order change.
    e = scene.emission.detach().clone().requires_grad_()
    escene = Scene(scene.vertices, scene.albedo, e, scene.light_idx)
    loss = render_radiance_fastgrad(escene, cam, cfg, 0).mean()
    (g,) = torch.autograd.grad(loss, [e])
    direction = e.detach()
    with torch.no_grad():
        f1 = render_radiance_fastgrad(
            Scene(scene.vertices, scene.albedo, 2.0 * direction,
                  scene.light_idx), cam, cfg, 0).mean().item()
    want_d, got_d = f1 - loss.item(), (g * direction).sum().item()
    check(abs(got_d - want_d) <= LINEARITY_RTOL * max(abs(want_d), 1e-6),
          f"emission linearity: <g, dir> {got_d} against {want_d}")
    return (f"launches {path}; gradient error / max: "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f"; emission <g, dir> {got_d:.7g} vs L(e+dir) - L(e) "
            f"{want_d:.7g}")


def quality_training(torch, dev, cam, scene, cfg, per_step=None) -> dict:
    """Phase 15: three train steps at full width through the light
    distribution kernel, K3 and K4, the albedo perturbed and the pose
    group enabled at rate 0; or (phase 31), given ``per_step`` ({kernel:
    launches a step}), through exactly those kernels (the light
    distribution, K9, K10 and K7)."""
    import numpy as np

    from spath_tpu_torch.models.inverse import (
        InverseParams, apply_params, init_state, make_train_step,
        param_group_optimizer, render_loss,
    )
    from spath_tpu_torch.models.renderer import forward_renderer
    from spath_tpu_torch.ops.kernels import light_cdf as lc
    from spath_tpu_torch.ops.kernels import megakernel_quality as mq
    from spath_tpu_torch.ops.kernels import megakernel_quality_grad as mqg

    target = forward_renderer(scene, cfg).render_radiance(scene, cam, cfg, 0)
    true_albedo = scene.albedo.cpu().numpy()
    rng = np.random.default_rng(1)
    bad = np.clip(true_albedo + rng.uniform(-0.4, 0.4, true_albedo.shape)
                  .astype(np.float32), 0.05, 1.0)
    params = InverseParams(cam_pos=cam.pos, cam_angle=cam.angle,
                           cam_focal=cam.focal,
                           albedo=torch.from_numpy(bad).to(dev))
    state = init_state(param_group_optimizer(
        freeze_pose=False, pose_lr=QUALITY_POSE_LR, albedo_lr=2e-2), params)
    step = make_train_step(scene, cfg, fixed_seed=0)
    torch.cuda.synchronize()

    zero_counts(every_kernel())
    losses, step_s = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        state, aux = step(state, target)
        losses.append(float(aux["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    k3, k4 = mq.quality_call.launches, mqg.quality_bwd_call.launches
    light = lc.light_cdf_call.launches
    if per_step is None:
        check(k3 == 3 and k4 == 3 and light == 3, f"3 train steps launched "
              f"the light distribution kernel {light}, K3 {k3} and K4 {k4} "
              "times")
        launched = dict(light=light, K3=k3, K4=k4)
    else:
        launched = launched_only({k: 3 * v for k, v in per_step.items()},
                                 "3 quality train steps")
    check(all(np.isfinite(losses)), f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")

    leaves = state.params.leaves()

    def fwd_bwd():
        loss = render_loss(leaves, scene, target, cfg, 0)
        return torch.autograd.grad(loss, [leaves.cam_pos, leaves.albedo])

    g_pos, _ = fwd_bwd()
    check(torch.isfinite(g_pos).all().item() and g_pos.abs().max() > 0,
          f"camera gradient {g_pos.tolist()}")
    ms = event_ms(torch, fwd_bwd, 3)
    out = {k.lower(): v for k, v in launched.items()}
    out.update(losses=losses, step_s=step_s, fwd_bwd_ms=ms,
               fwd_bwd_route=grad_route(*apply_params(leaves, scene), cfg),
               cam_grad=g_pos.tolist(), launches=launched)
    return out


def edge_witness(torch, cam, scene, cfg) -> dict:
    """Phase 15, why the pose rate is 0, with no gradient involved: K3's
    frame at the camera moved EDGE_MOVE along x differs from the frame at
    the true camera in some pixels by more than 1e-3, and the plain
    wavefront's moved frame equals K3's within the flip budget."""
    from spath_tpu_torch.camera import Camera
    from spath_tpu_torch.models.pathtracer import render_radiance
    from spath_tpu_torch.models.renderer import forward_renderer

    serve = forward_renderer(scene, cfg).render_radiance
    true = serve(scene, cam, cfg, 0)
    pos = cam.pos.clone()
    pos[0] += EDGE_MOVE
    moved_cam = Camera(pos, cam.angle, cam.focal)
    moved = serve(scene, moved_cam, cfg, 0)
    with plain_sweep():
        plain = render_radiance(scene, moved_cam, cfg, 0)
    changed = ((moved - true).abs() > 1e-3).any(-1)
    check(changed.any().item(), f"no pixel changed when the camera moved "
          f"{EDGE_MOVE}")
    c = check_against_plain(torch, moved.reshape(-1, 3), plain.reshape(-1, 3),
                            "moved camera")
    return dict(pixels_changed=int(changed.sum().item()),
                mse=((moved - true) ** 2).mean().item(),
                vs_plain_bit_exact=c["bit_exact"],
                vs_plain_flipped=c["flipped"])


def pose_recovery(torch, dev, cam, cfg) -> dict:
    """Phase 15, pose: 3 train steps through K3 and K4 with only the pose
    group free, from the true camera moved POSE_OFFSET along z, on the
    silhouette-free scene: the loss falls and every step moves the camera
    toward the truth."""
    import numpy as np

    from spath_tpu_torch.models.inverse import (
        InverseParams, init_state, make_train_step, param_group_optimizer,
    )
    from spath_tpu_torch.models.renderer import forward_renderer
    from spath_tpu_torch.ops.kernels import megakernel_quality as mq
    from spath_tpu_torch.ops.kernels import megakernel_quality_grad as mqg

    scene = wall_and_light_scene(dev)
    target = forward_renderer(scene, cfg).render_radiance(scene, cam, cfg, 0)
    true_z = cam.pos[2].item()
    start = cam.pos.clone()
    start[2] += POSE_OFFSET
    params = InverseParams(cam_pos=start, cam_angle=cam.angle,
                           cam_focal=cam.focal, albedo=scene.albedo)
    state = init_state(param_group_optimizer(
        freeze_pose=False, freeze_albedo=True, pose_lr=POSE_RECOVERY_LR),
        params)
    step = make_train_step(scene, cfg, fixed_seed=0)
    torch.cuda.synchronize()

    mq.quality_call.launches = mqg.quality_bwd_call.launches = 0
    losses, z_err = [], [abs(POSE_OFFSET)]
    for _ in range(3):
        state, aux = step(state, target)
        losses.append(float(aux["loss"]))
        z_err.append(abs(state.params.cam_pos[2].item() - true_z))
    k3, k4 = mq.quality_call.launches, mqg.quality_bwd_call.launches
    check(k3 == 3 and k4 == 3, f"3 pose steps launched K3 {k3} and K4 "
          f"{k4} times")
    check(all(np.isfinite(losses)), f"pose losses {losses}")
    check(losses[-1] < losses[0], f"pose loss did not fall: {losses}")
    check(all(b < a for a, b in zip(z_err, z_err[1:])),
          f"the camera did not move toward the truth: |z error| {z_err}")
    return dict(k3=k3, k4=k4, losses=losses, z_err=z_err)


def quality_cli(cli) -> str:
    """Phase 16: ``render --mode quality`` writes a lit PNG; ``invert
    --mode quality`` returns 0 and lowers the albedo error."""
    import contextlib
    import io
    import re

    from spath_tpu_torch.utils.image import read_png

    w, h = CLI_SIZE
    with tempfile.TemporaryDirectory() as tmp:
        png = Path(tmp) / "quality.png"
        check(cli.main(["render", "--mode", "quality", "--size", f"{w}x{h}",
                        "--spp", "16", "--out", str(png)]) == 0,
              "cli render --mode quality failed")
        img = read_png(str(png))
        check(img.shape == (h, w, 3) and img.max() > 200,
              "quality PNG is wrong")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["invert", "--mode", "quality", "--size", f"{w}x{h}",
                       "--spp", "16", "--steps", "5"])
    text = out.getvalue()
    m = re.search(r"albedo error ([0-9.]+) -> ([0-9.]+)", text)
    check(rc == 0 and m is not None, f"cli invert: rc {rc}, {text!r}")
    check(float(m[2]) < float(m[1]), f"albedo error did not fall: {text!r}")
    return f"render wrote {w}x{h} PNG; invert: {text.strip()}"


def quality_walk_counts(torch, o, d, keys, tri, rows, cfg) -> dict:
    """The quality walk's work at these inputs, counted with the plain
    replay: MT tests of the camera and next-bounce sweeps, of the shadow
    sweeps (fused with the next bounce's, or alone at the last bounce),
    hits, light-choice steps (a binary search over the light rows) and
    the lanes whose NEE term counted."""
    from spath_tpu_torch.ops.kernels import megakernel_quality as mq

    n, n_tris = o.shape[0], tri.shape[0]
    n_rows = n_tris if rows is None else rows.shape[0]
    hits_before_last = hits_last = oks = 0
    with torch.no_grad():
        for _, saved in mq.quality_replay(o, d, keys, tri, rows, cfg):
            per_bounce = torch.stack([sv["hit"].sum() for sv in saved])
            hits_before_last += int(per_bounce[:-1].sum())
            hits_last += int(per_bounce[-1])
            oks += int(sum(sv["ok"].sum() for sv in saved if "ok" in sv))
    hits = hits_before_last + hits_last
    sweeps = n + hits_before_last
    shadow = n_tris if cfg.nee else 0
    return dict(sweep_tests=sweeps * n_tris,
                fused_shadow_tests=hits_before_last * shadow,
                last_shadow_tests=hits_last * shadow, hits=hits,
                select_steps=hits * n_rows.bit_length() if cfg.nee else 0,
                nee_lanes=oks)


def lane_counts(torch, o, d, keys, tri, rows, cfg) -> dict:
    """Phase 17: K3's warp steps and K4's cost (forward steps plus
    ``REVERSE_COST`` a reverse step) on COUNT_ROWS of the frame, counted
    from each pixel's sweeps (``bigscene_quality.quality_sweep_totals``):
    the lockstep loops the kernels replaced and each shipped schedule on
    the launch's grid (its warps scaled to the rows), with the idle lane
    shares; each kernel's grid, pixels a run and resident CTAs."""
    from spath_tpu_torch.ops.kernels import bigscene as bs
    from spath_tpu_torch.ops.kernels import bigscene_quality as bq
    from spath_tpu_torch.ops.kernels import megakernel_quality as mq
    from spath_tpu_torch.ops.kernels import megakernel_quality_grad as mqg

    n = o.shape[0]
    totals = bq.quality_sweep_totals(*rows_of(torch, cfg.width, COUNT_ROWS,
                                              o, d, keys), tri, rows, cfg)
    m = totals.shape[0]

    def warps(grid, per_cta):
        return max(1, round(grid * per_cta * m / n))

    k3_grid = mq.k3_grid(n, o.device)
    k3_per_sm, sms = bs.resident_ctas(o.device.index or 0, "K3")
    k3_warps = warps(k3_grid, mq.K3_WARPS)
    sched = mq.warp_schedules(totals, queue_warps=k3_warps)
    k4_grid, k4_run, k4_threads = mqg.k4_grid(n, tri.shape[0], o.device)
    k4_per_sm = mqg.k4_resident(o.device.index or 0, tri.shape[0])[0]
    epochs = mqg.epoch_schedule(totals, mqg.EPOCH, cfg.max_bounces, k4_run,
                                warps(k4_grid, k4_threads // mq.WARP))
    lock = mqg.lockstep_cost(totals)
    # the lockstep loop on the camera hits alone, as compaction would run
    compacted = mqg.lockstep_cost(totals[totals[:, 1:].sum(axis=1) > 0])
    useful = epochs["useful_cost"]
    return dict(
        pixels=m, k3=dict(
            sched, shipped=dict(sched["queue"], warps=k3_warps),
            grid=dict(ctas=k3_grid, resident_per_sm=k3_per_sm, sms=sms)),
        k4=dict(
            lockstep=dict(lock, idle_lane_share=1.0 - useful / lock["cost"]),
            lockstep_compacted=compacted,
            epochs=dict(epochs, epoch=mqg.EPOCH,
                        ring=mqg.ring_size(cfg.max_bounces),
                        idle_lane_share=1.0 - useful / epochs["cost"]),
            grid=dict(ctas=k4_grid, run=k4_run, threads=k4_threads,
                      resident_per_sm=k4_per_sm, sms=sms)))


def conformance_lane_counts(torch, o, d, seeds, tri, cfg) -> dict:
    """Phase 10: K1's warp steps and K2's forward and reverse warp steps on
    COUNT_ROWS of the frame, counted from each pixel's sweeps and hits
    (``megakernel_grad.walk_totals``): the lockstep loops the kernels
    replaced and the candidate schedules, with the idle lane shares; K1's
    shipped queue on its grid's warps scaled to the rows, K2's epochs of
    ``EPOCH`` steps on its strided runs (one a warp) scaled to the rows,
    beside the reverse in the lane as each
    sample ends (K8's way) and K4's cost units (a reverse step
    ``REVERSE_COST`` forward ones; ``lockstep_cost``, sweeps as records);
    each kernel's grid and resident CTAs."""
    from spath_tpu_torch.ops.kernels import bigscene as bs
    from spath_tpu_torch.ops.kernels import megakernel_grad as mg
    from spath_tpu_torch.ops.kernels import megakernel_quality as mq
    from spath_tpu_torch.ops.kernels import megakernel_quality_grad as mqg

    n = o.shape[0]
    sweeps, hits = mg.walk_totals(*rows_of(torch, cfg.width, COUNT_ROWS,
                                           o, d, seeds), tri, cfg)
    m = sweeps.shape[0]
    k1_grid = bs.queue_grid(n, o.device, "K1")
    k1_per_sm, sms = bs.resident_ctas(o.device.index or 0, "K1")
    k1_warps = max(1, round(k1_grid * 4 * m / n))
    sched = mq.warp_schedules(sweeps, runs=(8, 16), queue_warps=k1_warps)
    k2_grid, k2_runs = mg.k2_grid(n, tri.shape[0], o.device)
    runs = max(1, round(k2_runs * m / n))
    rev = mg.reverse_counts(sweeps, hits, 1, runs,
                            epochs=sorted({mg.EPOCH, 8, 16, 64}))
    lock = rev["lockstep"]
    ideal = rev["records"] / mg.WARP

    def idle(steps):
        return 1.0 - ideal / steps

    k2_per_sm = mg.k2_resident(o.device.index or 0, tri.shape[0])[0]
    return dict(
        pixels=m, k1=dict(
            sched, shipped=dict(sched["queue"], warps=k1_warps),
            grid=dict(ctas=k1_grid, resident_per_sm=k1_per_sm, sms=sms)),
        k2=dict(
            lockstep=dict(lock, reverse_idle_lane_share=idle(
                lock["reverse_steps"])),
            in_lane=dict(reverse_steps=rev["in_lane"],
                         reverse_idle_lane_share=idle(rev["in_lane"])),
            epochs={e: dict(reverse_steps=r, reverse_idle_lane_share=idle(r))
                    for e, r in rev["epochs"].items()},
            shipped=dict(forward_steps=rev["forward_steps"],
                         reverse_steps=rev["epochs"][mg.EPOCH],
                         epoch=mg.EPOCH, runs=runs),
            records=rev["records"],
            k4_units=dict(
                lockstep=mqg.lockstep_cost(sweeps)["cost"],
                epochs=rev["forward_steps"] + mqg.REVERSE_COST
                * rev["epochs"][mg.EPOCH]),
            grid=dict(ctas=k2_grid, runs=k2_runs, resident_per_sm=k2_per_sm,
                      sms=sms)))


def warp_cull_counts(torch, o, d, seeds, tri, cfg) -> dict:
    """Phase 10: how often a whole warp of K1's lane loop would reject a
    triangle before the division (K5's cull, ``intersect.may_pass_plain``),
    on these rays: every sweep's ray of the walk (each camera ray once,
    then each bounce's ray that the path enters alive) against every
    triangle, the rays dealt into warps of 32 at random (a lane loop's
    warp sweeps 32 pixels at their own samples and bounces; generator
    seed 0), beside warps of 32 consecutive camera rays (the lockstep
    loop's first sweep)."""
    from spath_tpu_torch.ops.kernels import megakernel_grad as mg
    from spath_tpu_torch.ops.kernels.intersect import may_pass_plain

    v0, e1, e2 = (tri[:, k:k + 3] for k in (0, 3, 6))
    n = o.shape[0]
    rays = [(o, d)]
    with torch.no_grad(), plain_sweep():
        for saved in mg.replay(o, d, seeds, tri, cfg):
            # bounce b + 1 sweeps from the lanes that hit at bounce b
            for (alive, *_), later in zip(saved, saved[1:]):
                rays.append((later[6][alive], later[7][alive]))
        ro = torch.cat([r[0] for r in rays])
        rd = torch.cat([r[1] for r in rays])
        passes = torch.stack([may_pass_plain(
            (e1[t] * torch.cross(rd, e2[t].expand_as(rd), dim=1)).sum(1),
            ((ro - v0[t]) * torch.cross(rd, e2[t].expand_as(rd), dim=1))
            .sum(1)) for t in range(tri.shape[0])], 1)
    gen = torch.Generator().manual_seed(0)
    deal = torch.randperm(passes.shape[0], generator=gen).to(o.device)
    m = passes.shape[0] // 32 * 32
    lanes = passes[deal[:m]].view(-1, 32, tri.shape[0])
    cams = passes[:n // 32 * 32].view(-1, 32, tri.shape[0])
    return dict(rays=passes.shape[0],
                pair_pass_share=passes.float().mean().item(),
                warp_reject_share=(~lanes.any(1)).float().mean().item(),
                camera_warp_reject_share=(~cams.any(1)).float().mean().item())


def combined_scene(device):
    """The default scene and procedural_scene(COMBINED_EXTRA, seed=0,
    emissive_fraction=0.05): real multi-bounce light on 1150 triangles."""
    import numpy as np

    from spath_tpu_torch.convert import scene_to_numpy
    from spath_tpu_torch.scene import default_scene, make_scene, \
        procedural_scene

    parts = [scene_to_numpy(default_scene("cpu")),
             scene_to_numpy(procedural_scene(COMBINED_EXTRA, seed=0,
                                             emissive_fraction=0.05,
                                             device="cpu"))]
    return make_scene(*(np.concatenate([p[k] for p in parts])
                        for k in range(3)), device)


def rows_of(torch, width: int, rows, *tensors):
    """The rays of the given frame rows, contiguous."""
    idx = torch.cat([torch.arange(r * width, (r + 1) * width)
                     for r in rows]).to(tensors[0].device)
    return tuple(t[idx].contiguous() for t in tensors)


def walk_counts(torch, o, d, seeds, tri, cfg, cta: int = 128,
                queue_ctas: int | None = None,
                chunk: int | None = None) -> dict:
    """The conformance walk's work on these rays, from the plain replay:
    ray sweeps (the camera sweep and one after every hit but the last
    bounce's), hits, and the sweeps of the first port's 128-ray CTAs in
    lockstep (a CTA sweeps while any of its rays still hits), so the
    share of their lanes that idle through a sweep. With ``queue_ctas``,
    also the idle lane shares of the lockstep, regeneration and queue
    schedules (``bigscene.lane_schedules``, ``queue_ctas`` CTAs sharing
    the queue) under ``schedules``; with ``chunk`` as well, K8's: the
    schedules of each launch of ``chunk`` samples (``bigscene.
    chunk_totals``: the first sweeps the camera rays, the later ones read
    their hits back) under ``chunk_schedules``."""
    from spath_tpu_torch.ops.kernels import bigscene as bs
    from spath_tpu_torch.ops.kernels import megakernel_grad as mg

    totals, hits = mg.walk_totals(o, d, seeds, tri, cfg)
    sweeps = int(totals.sum())
    cta_sweeps = bs.lockstep_sweeps(totals, cta)
    out = dict(rays=o.shape[0], sweeps=sweeps, hits=int(hits.sum()),
               cta_sweeps=cta_sweeps,
               idle_lane_share=1.0 - sweeps / (cta_sweeps * cta))
    if queue_ctas is not None:
        out["schedules"] = bs.lane_schedules(totals, cta, queue_ctas)
        if chunk is not None:
            out["chunk_schedules"] = [
                bs.lane_schedules(bs.chunk_totals(
                    totals, s0, min(chunk, cfg.spp - s0)), cta, queue_ctas)
                for s0 in range(0, cfg.spp, chunk)]
    return out


def scaled(walk: dict, factor: float) -> dict:
    return {k: (v * factor if k not in ("idle_lane_share", "schedules",
                                        "chunk_schedules")
                else v) for k, v in walk.items()}


def queue_ctas(n_frame: int, n_rows: int, per_sm: int, sms: int) -> int:
    """CTAs sharing the queue in the count of ``n_rows`` rays, so that each
    lane takes as many pixels as on the whole frame of ``n_frame`` rays
    (a queue kernel's grid, ``bigscene.queue_plan`` of its own resident
    CTAs ``per_sm``)."""
    from spath_tpu_torch.ops.kernels import bigscene as bs

    grid = bs.queue_plan(n_frame, per_sm, sms)
    return max(1, round(grid * n_rows / n_frame))


def scatter_vs_plain(torch, dev, n_tris: int, n_events: int,
                     cols: int = 9) -> dict:
    """Phase 18 (and 26 at 19 columns): K7 against its float64 plain
    version on synthetic events from numpy: half on 4 hot triangles, a
    tenth -1; each column within SCATTER_RTOL of its max|plain|, two
    launches bitwise equal."""
    import numpy as np

    from spath_tpu_torch.ops.kernels import stream_scatter as ss

    rng = np.random.default_rng(n_tris)
    idx = rng.integers(0, n_tris, size=n_events).astype(np.int32)
    hot = rng.integers(0, n_tris, size=4)
    on_hot = rng.random(n_events) < 0.5
    idx[on_hot] = hot[rng.integers(0, 4, size=int(on_hot.sum()))]
    idx[rng.random(n_events) < 0.1] = -1
    val = rng.normal(size=(n_events, cols)).astype(np.float32)
    i, v = torch.from_numpy(idx).to(dev), torch.from_numpy(val).to(dev)

    def zeros():
        return torch.zeros((n_tris, cols), dtype=torch.float32, device=dev)

    got = ss.stream_scatter_call(zeros(), i, v)
    again = ss.stream_scatter_call(zeros(), i, v)
    torch.cuda.synchronize()
    want = ss.stream_scatter_plain(zeros(), i, v)
    scale = want.abs().amax(0)
    err = (got - want).abs().amax(0)
    check(torch.isfinite(got).all().item(), "K7 not finite")
    check(bool((err <= SCATTER_RTOL * scale).all()), f"K7 off its plain "
          f"version by {err.tolist()}, max|plain| {scale.tolist()}")
    check(torch.equal(got, again), "K7: two launches differ")
    return dict(n_tris=n_tris, events=n_events,
                depth=int(np.bincount(idx[idx >= 0]).max()),
                max_abs_err=err.max().item(),
                rel_err=(err / scale).max().item(), deterministic=True)


def big_vs_k1(torch, cam, scene, cfg, name: str) -> dict:
    """Phase 19: K6 equals K1 to the bit on the same rays."""
    from spath_tpu_torch.ops.kernels import bigscene as bs
    from spath_tpu_torch.ops.kernels import megakernel as mk

    o, d, seeds = mk.pack_rays(cam, cfg, 0)
    tri = mk.scene_table(scene)
    got = bs.bigscene_call(o, d, seeds, tri, cfg)
    want = mk.mega_call(o, d, seeds, tri, cfg)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"{name}: K6 differs from K1 by "
          f"{(got - want).abs().max().item():.6g}")
    return dict(bit_exact=True, mean=got.mean().item())


def big_vs_plain(torch, cam, scene, cfg, name: str, tri_block: int) -> dict:
    """Phase 19: K6 against ``megakernel_plain`` on the same rays, to the
    bit, and with phase 2's bounds (the plain sweep's ``tri_block``
    changes its memory, not its result)."""
    from spath_tpu_torch.ops.kernels import bigscene as bs
    from spath_tpu_torch.ops.kernels import megakernel as mk

    o, d, seeds = mk.pack_rays(cam, cfg, 0)
    tri = mk.scene_table(scene)
    got = bs.bigscene_call(o, d, seeds, tri, cfg)
    torch.cuda.synchronize()
    want = mk.megakernel_plain(o, d, seeds, tri,
                               cfg.replace(tri_block=tri_block))
    c = check_against_plain(torch, got, want, name)
    check(c["bit_exact"], f"{name}: K6 differs from its plain version by "
          f"{c['max_abs_err']:.6g}")
    return c


def big_serving(torch, dev, cam, n_tris: int, cfg, tri_block: int) -> dict:
    """Phase 21: ``render_pt_fast`` on procedural_scene(n_tris, seed=0)
    at full width through one K6 launch and nothing else; the frame's
    band of rows against the plain version on the same rays and seeds
    (to the bit, and phase 2's bounds) and against K6 launched on the
    band alone (to the bit); the frame not vacuous."""
    from spath_tpu_torch.models.pathtracer import render_pt_fast
    from spath_tpu_torch.ops.kernels import bigscene as bs
    from spath_tpu_torch.ops.kernels import megakernel as mk
    from spath_tpu_torch.scene import procedural_scene

    scene = procedural_scene(n_tris, seed=0, device=dev)
    kernels = {**conformance_kernels(True), **conformance_kernels(False)}
    zero_counts(kernels)
    t0 = time.perf_counter()
    img = render_pt_fast(scene, cam, cfg, 0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launched = counts(kernels)
    check(launched == {"K6": 1, "K8": 0, "K7": 0, "K1": 0, "K2": 0},
          f"render_pt_fast on {n_tris} triangles launched {launched}")
    check(tuple(img.shape) == (cfg.height, cfg.width, 3),
          f"shape {tuple(img.shape)}")
    check(torch.isfinite(img).all().item(), "frame not finite")
    check(img.min().item() >= 0.0 and img.max().item() <= 1.0,
          "frame outside [0, 1]")
    mean = img.mean().item()
    check(mean > 1e-3, f"vacuous frame: mean {mean}")
    o, d, seeds = mk.pack_rays(cam, cfg, 0)
    tri = mk.scene_table(scene)
    band = rows_of(torch, cfg.width, BAND_ROWS, o, d, seeds)
    band_k = bs.bigscene_call(*band, tri, cfg)
    torch.cuda.synchronize()
    check(torch.equal(img[BAND_ROWS.start:BAND_ROWS.stop].reshape(-1, 3),
                      band_k.clamp(0.0, 1.0)),
          "the frame's band differs from K6 launched on the band")
    band_p = mk.megakernel_plain(*band, tri,
                                 cfg.replace(tri_block=tri_block))
    c = check_against_plain(torch, band_k, band_p,
                            f"{n_tris} triangles, rows {BAND_ROWS}")
    check(c["bit_exact"], f"{n_tris} triangles: the band differs from the "
          f"plain version by {c['max_abs_err']:.6g}")
    return dict(launches=launched, first_s=first_s, mean=mean,
                band_vs_plain=c, rays=(o, d, seeds), band=band, tri=tri,
                img=img,
                scene=scene)


def big_cli(cli) -> str:
    """Phase 24: ``render --scene procedural:10000`` through K6 alone and
    ``invert --scene procedural:2000`` through K6, K8 and K7 alone; the
    albedo error falls."""
    import contextlib
    import io
    import re

    from spath_tpu_torch.utils.image import read_png

    kernels = {**conformance_kernels(True), **conformance_kernels(False)}
    w, h = CLI_SIZE
    zero_counts(kernels)
    with tempfile.TemporaryDirectory() as tmp:
        png = Path(tmp) / "big.png"
        check(cli.main(["render", "--scene", f"procedural:{BIG_T}",
                        "--size", f"{w}x{h}", "--spp", "16", "--out",
                        str(png)]) == 0, "cli render --scene failed")
        img = read_png(str(png))
        check(img.shape == (h, w, 3) and img.max() > 0, "scene PNG is black")
    rendered = counts(kernels)
    check(rendered == {"K6": 1, "K8": 0, "K7": 0, "K1": 0, "K2": 0},
          f"cli render --scene launched {rendered}")
    zero_counts(kernels)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["invert", "--scene", "procedural:2000", "--size",
                       f"{w}x{h}", "--spp", "16", "--steps", "5"])
    text = out.getvalue()
    inverted = counts(kernels)
    m = re.search(r"albedo error ([0-9.]+) -> ([0-9.]+)", text)
    check(rc == 0 and m is not None, f"cli invert: rc {rc}, {text!r}")
    check(float(m[2]) < float(m[1]), f"albedo error did not fall: {text!r}")
    check(inverted["K1"] == inverted["K2"] == 0
          and min(inverted["K6"], inverted["K8"], inverted["K7"]) > 0,
          f"cli invert --scene launched {inverted}")
    return (f"render launched {rendered}; invert launched {inverted}: "
            f"{text.strip()}")


def bwd_split_ms(torch, call, *args) -> tuple:
    """CUDA-event ms of one streamed backward call (``bigscene_bwd_call``
    or ``bigq_bwd_call``) on ``args``, split into its K7 calls (events
    around each) and the rest, which is its K8 or K10 launches and a few
    small fills and copies; and the call's output."""
    from spath_tpu_torch.ops.kernels import stream_scatter as ss

    module = sys.modules[call.__module__]
    marks = []

    def timed(adj, idx, val):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = ss.stream_scatter_call(adj, idx, val)
        b.record()
        marks.append((a, b))
        return out

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    module.stream_scatter_call = timed
    try:
        start.record()
        out = call(*args)
        end.record()
        torch.cuda.synchronize()
    finally:
        module.stream_scatter_call = ss.stream_scatter_call
    k7 = sum(a.elapsed_time(b) for a, b in marks)
    return start.elapsed_time(end) - k7, k7, out


def first_chunk_events(torch, call, *args):
    """The events of the first K7 call of one streamed backward call on
    ``args``: ``(idx, val)``."""
    from spath_tpu_torch.ops.kernels import stream_scatter as ss

    module = sys.modules[call.__module__]
    captured = []

    def capture(adj, idx, val):
        if not captured:
            captured.append((idx.clone(), val.clone()))
        return ss.stream_scatter_call(adj, idx, val)

    module.stream_scatter_call = capture
    try:
        call(*args)
        torch.cuda.synchronize()
    finally:
        module.stream_scatter_call = ss.stream_scatter_call
    return captured[0]


def scatter_timing(torch, dev, idx, val, n_tris: int) -> dict:
    """K7 on one chunk's events: held to its plain version (each column
    within SCATTER_RTOL of its max|plain|), two launches bitwise equal;
    timed in turns with its plain version and in turns with
    ``index_add_`` (K7, index_add_, index_add_, K7); and its bound."""
    from spath_tpu_torch.ops.kernels import stream_scatter as ss

    cols = val.shape[1]
    valid = idx >= 0
    n_valid = int(valid.sum())
    lidx, lval = idx[valid].long(), val[valid]

    def zeros():
        return torch.zeros((n_tris, cols), device=dev)

    def kernel():
        ss.stream_scatter_call(zeros(), idx, val)

    def plain():
        ss.stream_scatter_plain(zeros(), idx, val)

    got = ss.stream_scatter_call(zeros(), idx, val)
    again = ss.stream_scatter_call(zeros(), idx, val)
    want = ss.stream_scatter_plain(zeros(), idx, val)
    scale = want.abs().amax(0)
    err = (got - want).abs().amax(0)
    check(bool((err <= SCATTER_RTOL * scale).all()),
          f"K7 on {cols}-column events off its plain version by "
          f"{err.tolist()}, max|plain| {scale.tolist()}")
    check(torch.equal(got, again), f"K7 on {cols}-column events: two "
          "launches differ")
    del got, again, want
    ms, plain_ms = in_turns(torch, kernel, plain, kernel_reps=3)
    lib_adj = zeros()

    def library():
        lib_adj.index_add_(0, lidx, lval)

    library()
    turns = [event_ms(torch, f, 3) for f in (kernel, library, library,
                                               kernel)]
    ms += [turns[0], turns[3]]
    # one add a column an event; each slot's index read, each valid
    # event's values read, the float64 adjoint written
    bound_ = bound(cols * n_valid,
                   idx.shape[0] * 4 + n_valid * 4 * cols + n_tris * 8 * cols)
    return dict(slots=idx.shape[0], events=n_valid, ms=ms, plain_ms=plain_ms,
                library_ms=turns[1:3], max_abs_err=err.max().item(),
                rel_err=(err / scale.clamp_min(1e-30)).max().item(),
                deterministic=True, bound=bound_)


def in_turns(torch, kernel, plain, kernel_reps: int = 1):
    """Plain, kernel, kernel, plain, each timed with CUDA events; the
    kernel once only where a launch passes LONG_LAUNCH_MS. Returns
    ``(kernel ms list, plain ms list)``."""
    plain_ms = [event_ms(torch, plain, 1)]
    kernel_ms = [event_ms(torch, kernel, kernel_reps)]
    if kernel_ms[0] < LONG_LAUNCH_MS:
        kernel_ms.append(event_ms(torch, kernel, kernel_reps))
    plain_ms.append(event_ms(torch, plain, 1))
    return kernel_ms, plain_ms


def quality_kernels(big: bool) -> dict:
    """The wrappers of the quality path: the light distribution with the
    fused K3/K4, or with the streamed K9/K10/K7."""
    from spath_tpu_torch.ops.kernels import bigscene_quality as bq
    from spath_tpu_torch.ops.kernels import bigscene_quality_grad as bqg
    from spath_tpu_torch.ops.kernels import light_cdf as lc
    from spath_tpu_torch.ops.kernels import megakernel_quality as mq
    from spath_tpu_torch.ops.kernels import megakernel_quality_grad as mqg
    from spath_tpu_torch.ops.kernels import stream_scatter as ss

    if big:
        return {"light": lc.light_cdf_call, "K9": bq.bigq_call,
                "K10": bqg.bigq_bwd_call, "K7": ss.stream_scatter_call}
    return {"light": lc.light_cdf_call, "K3": mq.quality_call,
            "K4": mqg.quality_bwd_call}


def every_kernel() -> dict:
    return {**conformance_kernels(False), **conformance_kernels(True),
            **quality_kernels(False), **quality_kernels(True),
            **vis_kernels(), **t1_kernels(), **stream_kernels()}


def launched_only(expect: dict, what: str) -> dict:
    """The counts of every kernel since they were zeroed: exactly
    ``expect`` ({name: launches}), every other kernel 0."""
    launched = counts(every_kernel())
    want = {k: expect.get(k, 0) for k in launched}
    check(launched == want, f"{what} launched {launched}, want {want}")
    return {k: v for k, v in launched.items() if v}


def k9_vs_k3(torch, cam, scene, cfg, name: str) -> dict:
    """Phase 27: K9 equals K3 to the bit on the same rays and keys."""
    from spath_tpu_torch.ops.kernels import bigscene_quality as bq
    from spath_tpu_torch.ops.kernels import megakernel_quality as mq

    o, d, keys = mq.pack_rays(cam, cfg, 0)
    tri, rows = mq.quality_table(scene), bq.light_rows(scene)
    got = bq.bigq_call(o, d, keys, tri, rows, cfg)
    want = mq.quality_call(o, d, keys, tri, rows, cfg)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"{name}: K9 differs from K3 by "
          f"{(got - want).abs().max().item():.6g}")
    return dict(bit_exact=True, mean=got.mean().item())


def k9_vs_plain(torch, cam, scene, cfg, name: str, tri_block: int,
                dark: bool = False) -> dict:
    """Phase 27: K9 against ``quality_plain`` on the same rays and keys,
    with phase 2's bounds; an all-dark scene's frame equals the plain
    version's, black and finite."""
    from spath_tpu_torch.ops.kernels import bigscene_quality as bq
    from spath_tpu_torch.ops.kernels import megakernel_quality as mq

    o, d, keys = mq.pack_rays(cam, cfg, 0)
    tri, rows = mq.quality_table(scene), bq.light_rows(scene)
    got = bq.bigq_call(o, d, keys, tri, rows, cfg)
    torch.cuda.synchronize()
    want = mq.quality_plain(o, d, keys, tri, rows,
                            cfg.replace(tri_block=tri_block))
    if dark:
        check(torch.isfinite(got).all().item() and got.max().item() == 0.0
              and torch.equal(got, want), f"{name}: the dark frame is "
              f"not black, finite and equal to the plain version's")
        return dict(bit_exact=True, max=0.0, lights=len(rows))
    return dict(check_against_plain(torch, got, want, name),
                lights=len(rows))


def quality_serving(torch, dev, cam, n_tris: int, cfg, tri_block: int
                    ) -> dict:
    """Phase 29: ``render_pt_fast`` in the quality config on
    procedural_scene(n_tris, seed=0) at full width through one light
    distribution launch and one K9 launch and nothing else; the frame's
    band of rows against the plain version on the same rays and keys
    (phase 2's bounds) and against K9 launched on the band alone (to the
    bit); the frame not vacuous."""
    from spath_tpu_torch.models.pathtracer import render_pt_fast
    from spath_tpu_torch.ops.kernels import bigscene_quality as bq
    from spath_tpu_torch.ops.kernels import megakernel_quality as mq
    from spath_tpu_torch.scene import procedural_scene

    scene = procedural_scene(n_tris, seed=0, device=dev)
    bq.light_rows(scene)  # copied to the device once, as a server would
    torch.cuda.synchronize()
    zero_counts(every_kernel())
    t0 = time.perf_counter()
    img = render_pt_fast(scene, cam, cfg, 0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launched = launched_only({"light": 1, "K9": 1},
                             f"render_pt_fast quality on {n_tris} triangles")
    check(tuple(img.shape) == (cfg.height, cfg.width, 3),
          f"shape {tuple(img.shape)}")
    check(torch.isfinite(img).all().item(), "frame not finite")
    check(img.min().item() >= 0.0 and img.max().item() <= 1.0,
          "frame outside [0, 1]")
    mean = img.mean().item()
    check(mean > 1e-3, f"vacuous frame: mean {mean}")
    o, d, keys = mq.pack_rays(cam, cfg, 0)
    tri, rows = mq.quality_table(scene), bq.light_rows(scene)
    band = rows_of(torch, cfg.width, BAND_ROWS, o, d, keys)
    band_k = bq.bigq_call(*band, tri, rows, cfg)
    torch.cuda.synchronize()
    check(torch.equal(img[BAND_ROWS.start:BAND_ROWS.stop].reshape(-1, 3),
                      band_k.clamp(0.0, 1.0)),
          "the frame's band differs from K9 launched on the band")
    band_p = mq.quality_plain(*band, tri, rows,
                              cfg.replace(tri_block=tri_block))
    c = check_against_plain(torch, band_k, band_p,
                            f"quality, {n_tris} triangles, rows {BAND_ROWS}")
    return dict(launches=launched, first_s=first_s, mean=mean,
                band_vs_plain=c, rays=(o, d, keys), band=band, tri=tri,
                rows=rows, scene=scene, img=img)


def quality_big_cli(cli) -> str:
    """Phase 32: ``render --mode quality --scene procedural:10000``
    through the light distribution and K9 alone, and ``invert --mode
    quality --scene procedural:2000`` through the light distribution, K9,
    K10 and K7 alone; the albedo error falls."""
    import contextlib
    import io
    import re

    from spath_tpu_torch.utils.image import read_png

    w, h = CLI_SIZE
    zero_counts(every_kernel())
    with tempfile.TemporaryDirectory() as tmp:
        png = Path(tmp) / "bigq.png"
        check(cli.main(["render", "--mode", "quality", "--scene",
                        f"procedural:{BIG_T}", "--size", f"{w}x{h}",
                        "--spp", "16", "--out", str(png)]) == 0,
              "cli render --mode quality --scene failed")
        img = read_png(str(png))
        check(img.shape == (h, w, 3) and img.max() > 0, "scene PNG is black")
    rendered = launched_only({"light": 1, "K9": 1},
                             "cli render --mode quality --scene")
    zero_counts(every_kernel())
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["invert", "--mode", "quality", "--scene",
                       "procedural:2000", "--size", f"{w}x{h}", "--spp",
                       "16", "--steps", "5"])
    text = out.getvalue()
    inverted = counts(every_kernel())
    m = re.search(r"albedo error ([0-9.]+) -> ([0-9.]+)", text)
    check(rc == 0 and m is not None, f"cli invert: rc {rc}, {text!r}")
    check(float(m[2]) < float(m[1]), f"albedo error did not fall: {text!r}")
    others = {k: v for k, v in inverted.items()
              if k not in ("light", "K9", "K10", "K7")}
    check(not any(others.values())
          and min(inverted[k] for k in ("light", "K9", "K10", "K7")) > 0,
          f"cli invert --mode quality --scene launched {inverted}")
    return (f"render launched {rendered}; invert launched "
            f"{ {k: v for k, v in inverted.items() if v} }: {text.strip()}")


def quality_cta_walk(torch, o, d, keys, tri, rows, cfg, cta: int = 128,
                     queue_ctas: int = 1, chunk: int | None = None,
                     chunk_ctas: int = 1) -> dict:
    """The quality walk's work on these rays from the plain replay, as
    ``quality_walk_counts``, and the streamed kernels' CTA sweeps: each
    pixel's sweeps (``bigscene_quality.quality_sweep_totals``) under the
    lockstep, regeneration and queue schedules (``bigscene.
    lane_schedules``, ``queue_ctas`` CTAs sharing the queue) under
    ``schedules``; ``cta_sweeps`` and ``idle_lane_share`` are lockstep's
    (the first port's schedule: a 128-ray CTA sweeps at a bounce while
    any of its rays is alive there), the queue's K9's and K11's. With
    ``chunk``, also K10's: the schedules of each launch of ``chunk``
    samples (``bigscene.chunk_totals``: the first sweeps the camera rays,
    the later ones read their hits back), ``chunk_ctas`` CTAs sharing
    each launch's queue, under ``chunk_schedules``."""
    from spath_tpu_torch.ops.kernels import bigscene as bs
    from spath_tpu_torch.ops.kernels import bigscene_quality as bq

    walk = quality_walk_counts(torch, o, d, keys, tri, rows, cfg)
    totals = bq.quality_sweep_totals(o, d, keys, tri, rows, cfg)
    sched = bs.lane_schedules(totals, cta, queue_ctas)
    out = dict(walk, cta_sweeps=sched["lockstep"]["cta_sweeps"],
               idle_lane_share=sched["lockstep"]["idle_lane_share"],
               schedules=sched)
    if chunk is not None:
        out["chunk_schedules"] = [
            bs.lane_schedules(bs.chunk_totals(
                totals, s0, min(chunk, cfg.spp - s0)), cta, chunk_ctas)
            for s0 in range(0, cfg.spp, chunk)]
    return out


# ---- visibility gradients, K5 and K11 (phases 34-41) ----


def blocker_scene(device):
    """tests/test_vis_residual.py's scene: a floor, a two-triangle area
    light and a blocker between them, so both visibility terms (the
    light's silhouette, the blocker's shadow boundary) are live."""
    import numpy as np

    from spath_tpu_torch.scene import make_scene

    verts = np.array([
        [[-20, -1, -20], [20, -1, -20], [0, -1, 40]],
        [[-20, -1, 20], [20, -1, -20], [20, -1, 20]],
        [[-0.5, 0.75, -0.5], [0.5, 0.75, -0.5], [-0.5, 0.75, 0.5]],
        [[0.5, 0.75, 0.5], [0.5, 0.75, -0.5], [-0.5, 0.75, 0.5]],
        [[-0.35, 0.0, -0.25], [0.35, 0.0, -0.25], [0.0, 0.0, 0.45]],
    ], np.float32)
    albedo = np.array([[0.7] * 3, [0.7] * 3, [0] * 3, [0] * 3, [0.3] * 3],
                      np.float32)
    emission = np.array([[0] * 3, [0] * 3, [2] * 3, [2] * 3, [0] * 3],
                        np.float32)
    return make_scene(verts, albedo, emission, device)


def vis_kernels() -> dict:
    """The wrappers of this slice: K5 and K11."""
    from spath_tpu_torch.ops.kernels import bigscene_quality as bq
    from spath_tpu_torch.ops.kernels import intersect as k5

    return {"K5": k5.nearest_hit_call, "K11": bq.bigq_hits_call}


def k5_ray_sets(torch, scene, o, d, seed: int) -> dict:
    """K5's inputs on the path, from camera rays ``(o, d)``: the camera
    rays themselves; bounce-shaped rays (from each camera hit in a
    direction drawn uniform on the sphere, excluding the hit triangle);
    edge-shaped rays (from each camera hit toward a point drawn on a mesh
    edge, as ``ops/warp.py``'s shadow-boundary rays). Lanes whose camera
    ray missed keep the camera ray and no source, as a wavefront's ended
    paths do."""
    from spath_tpu_torch.models.pathtracer import scene_geometry
    from spath_tpu_torch.ops.intersect import _sweep

    v0, e1, e2 = scene_geometry(scene)[:3]
    n = o.shape[0]
    none = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    dist, idx = _sweep(o, d, v0, e1, e2, none, 512)
    hit = idx >= 0
    p = torch.where(hit[:, None], o + dist[:, None] * d, o)
    gen = torch.Generator().manual_seed(seed)
    rd = torch.randn((n, 3), generator=gen).to(o.device)
    rd = rd / rd.norm(dim=1, keepdim=True)
    tri_e = torch.randint(0, scene.n_tris, (n,), generator=gen).to(o.device)
    k = torch.randint(0, 3, (n,), generator=gen).to(o.device)
    s = torch.rand((n, 1), generator=gen).to(o.device)
    verts = scene.vertices.detach()[tri_e]
    ea = verts[torch.arange(n, device=o.device), k]
    eb = verts[torch.arange(n, device=o.device), (k + 1) % 3]
    toward = ea + s * (eb - ea) - p
    toward = toward / toward.norm(dim=1, keepdim=True).clamp_min(1e-20)
    src = torch.where(hit, idx, none)
    return {"camera": (o, d, none),
            "bounce": (p, torch.where(hit[:, None], rd, d), src),
            "edge": (p, torch.where(hit[:, None], toward, d), src)}


def k5_table(scene):
    """K5's ``(T, 9)`` table of ``scene``."""
    from spath_tpu_torch.models.pathtracer import scene_geometry
    from spath_tpu_torch.ops.kernels import intersect as k5

    return k5.pack_triangles(*scene_geometry(scene)[:3])


def k5_vs_plain(torch, tri, rays, name: str) -> dict:
    """K5 against its plain version ``_sweep`` on the same rays and
    ``(T, 9)`` table, both outputs to the bit, and two launches bitwise
    equal."""
    from spath_tpu_torch.ops.kernels import intersect as k5

    o, d, src = (t.contiguous() for t in rays)
    dist, idx = k5.nearest_hit_call(o, d, tri, src)
    again = k5.nearest_hit_call(o, d, tri, src)
    torch.cuda.synchronize()
    want_d, want_i = k5.nearest_hit_plain(o, d, tri, src)
    same = torch.equal(dist, want_d) and torch.equal(idx, want_i)
    check(same, f"{name}: K5 differs from the plain sweep on "
          f"{int((idx != want_i).sum())} indices, "
          f"{int((dist != want_d).sum())} distances")
    check(torch.equal(dist, again[0]) and torch.equal(idx, again[1]),
          f"{name}: two K5 launches differ")
    return dict(rays=o.shape[0], n_tris=tri.shape[0], bit_exact=True,
                max_abs_err=(dist - want_d).abs().max().item(),
                hits=int((want_i >= 0).sum()))


def k5_ops(o, d, tri) -> tuple:
    """``(operations, pairs the cull rejects)``: the work K5's function
    needs on these rays, MT_OPS a (ray, row) pair, MT_CULL_OPS where
    ``may_pass_plain`` rejects the pair (its a and s . h computed by the
    kernel's expressions), a chunk of rays at a time."""
    from spath_tpu_torch.ops.kernels import intersect as k5

    n, t = o.shape[0], tri.shape[0]
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri.T[:, None, :]
    chunk, rejected = max(1, (1 << 24) // t), 0
    for i in range(0, n, chunk):
        ox, oy, oz = o[i:i + chunk].T[:, :, None]
        dx, dy, dz = d[i:i + chunk].T[:, :, None]
        hx = dy * e2z - dz * e2y
        hy = dz * e2x - dx * e2z
        hz = dx * e2y - dy * e2x
        a = e1x * hx + e1y * hy + e1z * hz
        sh = (ox - v0x) * hx + (oy - v0y) * hy + (oz - v0z) * hz
        rejected += int((~k5.may_pass_plain(a, sh)).sum())
    return (n * t * MT_OPS - rejected * (MT_OPS - MT_CULL_OPS)), rejected


def k5_timing(torch, tri, rays, reps: int = 3) -> dict:
    """K5 and its plain version timed in turns on the same rays and
    ``(T, 9)`` table, ``reps`` kernel launches a timing; the bound counts
    the operations of ``k5_ops`` and each ray and row read once, each
    result written once."""
    from spath_tpu_torch.ops.kernels import intersect as k5

    o, d, src = (t.contiguous() for t in rays)
    k5.nearest_hit_call(o, d, tri, src)
    kernel_ms, plain_ms = in_turns(
        torch, lambda: k5.nearest_hit_call(o, d, tri, src),
        lambda: k5.nearest_hit_plain(o, d, tri, src), kernel_reps=reps)
    n, t = o.shape[0], tri.shape[0]
    ops, rejected = k5_ops(o, d, tri)
    b = bound(ops, n * (24 + 8 + 4 + 8) + t * 36)
    return dict(rays=n, n_tris=t, ms=kernel_ms, plain_ms=plain_ms,
                bound=b, ops=ops, culled_pair_share=rejected / (n * t),
                tests_per_s=n * t / (min(kernel_ms) / 1e3))


def k11_vs_k9_and_plain(torch, cam, scene, cfg, name: str,
                        tri_block: int = 512) -> dict:
    """Phase 35: K11's radiance equal to K9's to the bit on the same rays
    and keys, and K11's radiance and hits equal to ``quality_hits_plain``'s
    to the bit."""
    from spath_tpu_torch.ops.kernels import bigscene_quality as bq
    from spath_tpu_torch.ops.kernels import megakernel_quality as mq

    o, d, keys = mq.pack_rays(cam, cfg, 0)
    tri, rows = mq.quality_table(scene), bq.light_rows(scene)
    out, dist, idx = bq.bigq_hits_call(o, d, keys, tri, rows, cfg)
    k9 = bq.bigq_call(o, d, keys, tri, rows, cfg)
    torch.cuda.synchronize()
    check(torch.equal(out, k9), f"{name}: K11's radiance differs from K9's")
    want, want_d, want_i = bq.quality_hits_plain(
        o, d, keys, tri, rows, cfg.replace(tri_block=tri_block))
    check(torch.equal(out, want), f"{name}: K11's radiance differs from "
          "its plain version")
    check(torch.equal(dist, want_d) and torch.equal(idx, want_i),
          f"{name}: K11's hits differ from quality_hits_plain's on "
          f"{int((idx != want_i).sum())} indices")
    return dict(rays=o.shape[0], n_tris=scene.n_tris, spp=cfg.spp,
                bit_exact=True, hits=int((idx >= 0).sum()),
                ended=int((idx < 0).sum()))


def weighted_grads(torch, dev, render, scene, cam, cfg) -> tuple:
    """Gradients in vertices, albedo, emission and camera position of a
    fixed random weighting of ``render``'s frame."""
    from spath_tpu_torch.camera import Camera
    from spath_tpu_torch.scene import Scene

    gen = torch.Generator().manual_seed(7)
    wts = (torch.rand((cfg.height, cfg.width, 3), generator=gen) * 0.9
           + 0.1).to(dev)
    leaves = [t.detach().clone().requires_grad_()
              for t in (scene.vertices, scene.albedo, scene.emission,
                        cam.pos)]
    img = render(Scene(*leaves[:3], scene.light_idx),
                 Camera(leaves[3], cam.angle, cam.focal), cfg, 0)
    return torch.autograd.grad((img * wts).sum(), leaves)


def vis_spread(torch, dev, cam, scene, cfg, got=None) -> dict:
    """Run-to-run spread of ``render_radiance_fastgrad``'s ``vis_grad``
    gradient: two calls on the same inputs and seed (``got``, the first,
    if given), for each group the largest difference over the group's
    largest magnitude and the count of elements that differ, which must
    be 0 in every group: the residual's row gathers add their backward
    with the stream scatter K7 in a fixed order (``ops/gather.py``)."""
    from spath_tpu_torch.models.pathtracer import render_radiance_fastgrad

    if got is None:
        got = weighted_grads(torch, dev, render_radiance_fastgrad, scene,
                             cam, cfg)
    again = weighted_grads(torch, dev, render_radiance_fastgrad, scene, cam,
                           cfg)
    out = {}
    for name, a, b in zip(("vertices", "albedo", "emission", "camera"), got,
                          again):
        diff = (a - b).abs()
        out[name] = dict(rel=diff.max().item()
                         / max(a.abs().max().item(), 1e-30),
                         differ=int((diff > 0).sum()))
        check(out[name]["differ"] == 0, f"two vis_grad {name} gradients "
              f"differ in {out[name]['differ']} elements")
    return out


def gather_k7_check(torch, run) -> dict:
    """Phases 39-40: K7 as the row gathers' backward (``ops/gather.py``)
    at the shapes the ``vis_grad`` residual gives it. ``run()`` computes
    gradients while every call of ``gather.scatter_backward`` is recorded,
    the first of each (rows, columns) kept with its events and its
    result; each is then held to a float64 ``index_add_`` of the same
    events, table by table, within GATHER_RTOL of the table's max. Both of
    K7's widths (9, 19) must be among them."""
    from spath_tpu_torch.ops import gather as ga

    seen = {}
    inner = ga.scatter_backward

    def record(index, grads, n_rows):
        out = inner(index, grads, n_rows)
        key = (n_rows, sum(g.shape[1] for g in grads))
        if key not in seen:
            seen[key] = (index.clone(), [g.clone() for g in grads],
                         [o.clone() for o in out])
        return out

    ga.scatter_backward = record
    try:
        run()
    finally:
        ga.scatter_backward = inner
    out = {}
    for (n_rows, cols), (index, grads, got) in seen.items():
        errs = []
        for g, o in zip(grads, got):
            want = torch.zeros((n_rows, g.shape[1]), dtype=torch.float64,
                               device=g.device).index_add_(0, index,
                                                           g.double())
            errs.append((o.double() - want).abs().max().item()
                        / max(want.abs().max().item(), 1e-30))
        check(max(errs) <= GATHER_RTOL, f"K7 as the gathers' backward, "
              f"{index.shape[0]} events of {cols} columns into {n_rows} "
              f"rows: off the float64 index_add_ by {errs} of each max")
        out[f"{n_rows} rows, {cols} columns"] = dict(
            events=index.shape[0], width=ga.k7_width(cols), rel_err=errs)
    widths = {v["width"] for v in out.values()}
    check(widths == {9, 19}, f"the gathers' backward ran K7 at widths "
          f"{sorted(widths)}, want 9 and 19")
    return out


def vis_gradient_entry(torch, dev, cam, scene, cfg, expect) -> dict:
    """Phase 38: ``render_radiance_fastgrad`` with ``vis_grad`` on the card
    (``VisGradFusedRenderer``) against autograd of the plain wavefront
    with ``vis_grad`` (every sweep the plain ``_sweep``): vertex, albedo,
    emission and camera-position gradients within ENTRY_RTOL of each
    group's max. The kernels in ``expect`` (an interior's and K5, or K11's)
    launch, no other does; the residual walk's own radiance is exactly
    0."""
    from spath_tpu_torch.camera import generate_rays
    from spath_tpu_torch.models.pathtracer import (
        render_radiance, render_radiance_fastgrad, trace_mean_radiance,
    )
    from spath_tpu_torch.models.renderer import grad_renderer
    from spath_tpu_torch.ops.intersect import plain_sweep

    route = grad_renderer(scene, cfg).name
    check(route == "visgrad", f"vis_grad routed to {route}")

    def grads(render):
        return weighted_grads(torch, dev, render, scene, cam, cfg)

    zero_counts(every_kernel())
    got = grads(render_radiance_fastgrad)
    torch.cuda.synchronize()
    launched = counts(every_kernel())
    check(all(launched[k] > 0 for k in expect)
          and not any(v for k, v in launched.items() if k not in expect),
          f"render_radiance_fastgrad with vis_grad launched {launched}, "
          f"want {sorted(expect)}")
    with plain_sweep():
        want = grads(render_radiance)
    errs = {}
    for name, g, w in zip(("vertices", "albedo", "emission", "camera"), got,
                          want):
        scale = w.abs().max().item()
        check(scale > 0.0 and torch.isfinite(g).all().item(),
              f"{name}: zero or non-finite gradient")
        errs[name] = (g - w).abs().max().item() / scale
        check(errs[name] <= ENTRY_RTOL, f"{name} gradient off the plain "
              f"wavefront's by {errs[name]:.3g} of its max")
    o, d = generate_rays(cam, cfg.width, cfg.height)
    with torch.no_grad():
        res = trace_mean_radiance(scene, o, d, cfg, 0, vis_residual=True)
    check(not res.any().item(), "the residual's radiance is not 0")
    return dict(launches={k: v for k, v in launched.items() if v},
                rel_err=errs, residual_zero=True,
                spread=vis_spread(torch, dev, cam, scene, cfg, got))


def vis_training(torch, dev, cam, scene, cfg, expect, steps: int) -> dict:
    """Phases 39-40: ``steps`` quality train steps with ``vis_grad`` at
    full width through ``VisGradFusedRenderer``, the albedo perturbed as
    the CLI does and the pose group at rate 0; every step launches each
    kernel of ``expect`` and no other kernel; the loss falls."""
    import numpy as np

    from spath_tpu_torch.models.inverse import (
        InverseParams, init_state, make_train_step, param_group_optimizer,
    )
    from spath_tpu_torch.models.renderer import forward_renderer

    target = forward_renderer(scene, cfg).render_radiance(scene, cam, cfg, 0)
    true_albedo = scene.albedo.cpu().numpy()
    rng = np.random.default_rng(1)
    bad = np.clip(true_albedo + rng.uniform(-0.4, 0.4, true_albedo.shape)
                  .astype(np.float32), 0.05, 1.0)
    params = InverseParams(cam_pos=cam.pos, cam_angle=cam.angle,
                           cam_focal=cam.focal,
                           albedo=torch.from_numpy(bad).to(dev))
    state = init_state(param_group_optimizer(
        freeze_pose=False, pose_lr=QUALITY_POSE_LR, albedo_lr=2e-2), params)
    step = make_train_step(scene, cfg, fixed_seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(every_kernel())
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, aux = step(state, target)
        losses.append(float(aux["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launched = counts(every_kernel())
    check(all(launched[k] >= steps for k in expect)
          and not any(v for k, v in launched.items() if k not in expect),
          f"{steps} vis_grad train steps launched {launched}, want "
          f"{sorted(expect)}")
    check(all(np.isfinite(losses)), f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    return dict(launches={k: v for k, v in launched.items() if v},
                losses=losses, step_s=step_s,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def pose_measurement(torch, dev, cam, cfg) -> dict:
    """Phase 41, recorded, not asserted: from the true camera, 3 quality
    train steps with the pose group at POSE_STEP_LR (the JAX package's
    default), albedo perturbed, with and without ``vis_grad``; and where
    the frame jumps when the camera moves EDGE_MOVE: the changed pixels
    whose camera ray hits another triangle (a primary-hit edge, which
    ``vis_grad`` leaves detached at bounce 0, as the JAX package) and the
    others."""
    import numpy as np

    from spath_tpu_torch.camera import Camera, generate_rays
    from spath_tpu_torch.models.inverse import (
        InverseParams, init_state, make_train_step, param_group_optimizer,
    )
    from spath_tpu_torch.models.pathtracer import scene_geometry
    from spath_tpu_torch.models.renderer import forward_renderer
    from spath_tpu_torch.ops.intersect import sweep
    from spath_tpu_torch.scene import default_scene

    scene = default_scene(dev)
    target = forward_renderer(scene, cfg).render_radiance(scene, cam, cfg, 0)
    albedo = scene.albedo.cpu().numpy()
    bad = np.clip(albedo + np.random.default_rng(1).uniform(
        -0.4, 0.4, albedo.shape).astype(np.float32), 0.05, 1.0)
    out = {}
    for vis in (False, True):
        c = cfg.replace(vis_grad=vis)
        state = init_state(param_group_optimizer(pose_lr=POSE_STEP_LR),
                           InverseParams(cam.pos, cam.angle, cam.focal,
                                         torch.from_numpy(bad).to(dev)))
        step = make_train_step(scene, c, fixed_seed=0)
        losses = []
        for _ in range(3):
            state, aux = step(state, target)
            losses.append(float(aux["loss"]))
        out["vis_grad" if vis else "interior"] = dict(
            losses=losses, moved=(state.params.cam_pos - cam.pos).abs()
            .max().item())
    serve = forward_renderer(scene, cfg).render_radiance
    pos = cam.pos.clone()
    pos[0] += EDGE_MOVE
    moved_cam = Camera(pos, cam.angle, cam.focal)
    changed = ((serve(scene, moved_cam, cfg, 0) - serve(scene, cam, cfg, 0))
               .abs() > 1e-3).any(-1).flatten()
    v0, e1, e2 = scene_geometry(scene)[:3]
    firsts = []
    for c_ in (cam, moved_cam):
        o, d = generate_rays(c_, cfg.width, cfg.height)
        none = torch.full((o.shape[0],), -1, dtype=torch.int64, device=dev)
        firsts.append(sweep(o, d, v0, e1, e2, none, 512)[1])
    other_tri = firsts[0] != firsts[1]
    out["edge_move"] = dict(
        pixels_changed=int(changed.sum()),
        changed_with_another_primary_triangle=int((changed & other_tri)
                                                  .sum()),
        primary_triangle_changed=int(other_tri.sum()))
    return out


# ---- T1, the matmul-only sweep microbenchmark (phase 42) ----


def t1_kernels() -> dict:
    """T1's wrapper, one count for both depths. No render path launches
    it, so every earlier ``launched_only`` holds it to 0."""
    from spath_tpu_torch.ops.kernels import sweep_mm as sm

    return {"T1": sm.sweep_mm_call}


def ptxas_lines(source: str) -> str:
    """A source's register, shared-memory and spill lines from the build
    log."""
    from spath_tpu_torch.ops.kernels import build

    text = (build.BUILD_DIR / "build.log").read_text()
    check(f"== {source}" in text, f"{source} is not in the build log")
    part = text[text.index(f"== {source}"):]
    end = part.find("\n== ", 1)
    part = part if end < 0 else part[:end]
    return " | ".join(ln.strip() for ln in part.splitlines()
                      if "registers" in ln or "spill" in ln
                      or "smem" in ln)


def sass_opcodes(part: str) -> dict:
    """The static instruction counts by opcode of each built kernel whose
    name holds ``part`` (``cuobjdump -sass`` of the library, as
    ``tools/sass_loop.py`` reads it): ``{kernel: {opcode: count}}``."""
    import re
    from collections import Counter

    from spath_tpu_torch.ops.kernels import build

    lib = build.build()
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    listing = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                             capture_output=True, text=True, check=True,
                             timeout=300).stdout
    found, name = {}, None
    for line in listing.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            if part not in name:
                name = None
            else:
                found[name] = Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                      line)
        if name is not None and m:
            found[name][m[1]] += 1
    return {k: dict(v) for k, v in found.items()}


def t1_sass() -> dict:
    """The count of ``HGMMA`` (wgmma), ``UTMALDG`` (TMA loads) and
    ``HMMA`` (mma.sync) instructions in each built ``sweep_mm`` kernel.
    Each must hold the first two and not the third: a return to
    ``mma.sync`` fails here."""
    found = {name: {op: ops.get(op, 0) for op in ("HGMMA", "UTMALDG", "HMMA")}
             for name, ops in sass_opcodes("8sweep_mm").items()}
    check(len(found) == 2, f"T1: {len(found)} sweep_mm kernels in the SASS, "
          "want 2 (K = 64 and 128)")
    for fn, c in found.items():
        check(c["HGMMA"] > 0 and c["UTMALDG"] > 0 and c["HMMA"] == 0,
              f"T1: {fn} has {c} in its SASS: want HGMMA and UTMALDG, no "
              "HMMA")
    return found


def t1_vs_plain(torch, ops: dict, k: int) -> dict:
    """T1 at depth ``k`` against ``sweep_mm_plain`` on the whole shape:
    finite, every ray within ``TIGHT_SHARE`` of the bound, two launches
    bitwise equal; the control, the plain version without the split's
    lo terms, beyond ``TIGHT_SHARE``; the yardstick's share recorded."""
    from spath_tpu_torch.ops.kernels import sweep_mm as sm
    from spath_tpu_torch.tools import sweep_microbench as tool

    g, r = ops["t1"][k]
    first, second = sm.sweep_mm_call(g, r), sm.sweep_mm_call(g, r)
    torch.cuda.synchronize()
    check(tuple(first.shape) == (ops["n_rays"],)
          and torch.isfinite(first).all().item(),
          f"T1 K={k}: output not finite or of shape {tuple(first.shape)}")
    check(torch.equal(first, second), f"T1 K={k}: two launches differ")
    ref = sm.sweep_mm_plain(g, r)
    check(ref.abs().max().item() > 1.0, f"T1 K={k}: the plain output is "
          "near 0, the comparison would be vacuous")
    scale = sm.sweep_mm_scale(g, r)
    share = sm.error_ratio(first, ref, scale)
    check(share <= sm.TIGHT_SHARE, f"T1 K={k}: {share:.4e} of the bound "
          f"2^-16 · (scale + |plain|), above {sm.TIGHT_SHARE}")
    control = sm.error_ratio(sm.sweep_mm_plain(*sm.drop_lo(g, r)), ref,
                             scale)
    check(control > sm.TIGHT_SHARE, f"T1 K={k}: the lo-dropping control "
          f"is within {control:.4e} of the bound: the check cannot see a "
          "16-bit product")
    yard = tool.yardstick(g, r)
    return dict(rays=ops["n_rays"], n_tris=ops["n_tris"], bitwise_equal=True,
                bound_share=share, control_bound_share=control,
                max_abs_err=(first - ref).abs().max().item(),
                plain_mean=ref.double().mean().item(),
                yardstick_bound_share=sm.error_ratio(yard, ref, scale))


def t1_ragged(torch, ops: dict, k: int) -> dict:
    """T1 at depth ``k`` on ``T1_RAY_COUNTS`` rays, evenly spaced over the
    tool's, against ``T1_TRI_COUNTS`` triangles (the first blocks of the
    tool's table): every pair finite, two launches bitwise equal, every
    ray within ``TIGHT_SHARE`` of the bound of ``sweep_mm_plain``.
    Returns the largest share of the bound by shape."""
    from spath_tpu_torch.ops.kernels import sweep_mm as sm

    g_all, r_all = ops["t1"][k]
    out = {}
    for n in T1_RAY_COUNTS:
        pick = torch.linspace(0, r_all.shape[1] - 1, n,
                              device=r_all.device).round().long()
        r = r_all[:, pick].contiguous()
        for n_tris in T1_TRI_COUNTS:
            g = g_all[:4 * n_tris]
            name = f"T1 K={k}, {n} rays x {n_tris} triangles"
            first, second = sm.sweep_mm_call(g, r), sm.sweep_mm_call(g, r)
            torch.cuda.synchronize()
            check(tuple(first.shape) == (n,)
                  and torch.isfinite(first).all().item(),
                  f"{name}: output not finite or of shape "
                  f"{tuple(first.shape)}")
            check(torch.equal(first, second), f"{name}: two launches differ")
            share = sm.error_ratio(first, sm.sweep_mm_plain(g, r),
                                   sm.sweep_mm_scale(g, r))
            check(share <= sm.TIGHT_SHARE, f"{name}: {share:.4e} of the "
                  f"bound, above {sm.TIGHT_SHARE}")
            out[f"{n}x{n_tris}"] = share
    return out


def cold_l2_ms(torch, fn, reps: int = 3) -> float:
    """Mean ms of single calls of ``fn``, each after a 256 MB write has
    evicted the 50 MB L2, CUDA events around the call alone."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def t1_phase(torch) -> tuple:
    """Phase 42: the microbenchmark through its entry point, with every
    count zeroed just before and read just after; T1 and K5 held to their
    plain versions on the tensors the tool timed. Returns T1's two
    entries of the kernels' record and K5's check at this shape."""
    from spath_tpu_torch.ops.kernels import sweep_mm as sm
    from spath_tpu_torch.tools import sweep_microbench as tool

    log(f"[42] T1 ptxas: {ptxas_lines('sweep_mm.cu')}")
    log(f"[42] T1 SASS (cuobjdump): {t1_sass()}")
    w, h, n_tris = T1_SHAPE
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    built = {}
    for k in (128, 64):
        plan = sm.launch_plan(k, w * h, n_tris, sms)
        built[k] = sm.compiled_plan(k)
        check(all(plan[key] == v for key, v in built[k].items()),
              f"T1 K={k}: compiled launch {built[k]} is not launch_plan's "
              f"{plan}")
        log(f"[42] T1 K={k} plan at {w * h} rays x {n_tris} triangles: "
            f"{plan['cta_rays']} rays a CTA ({plan['wg_rays']} a consumer "
            f"warpgroup), {plan['ctas']} CTAs, cluster {plan['cluster']}, "
            f"{plan['waves']:.4f} waves of one CTA an SM on the card's "
            f"{sms} SMs, {plan['stages']} stages, {plan['smem_bytes']} "
            f"bytes of shared memory; G through L2 counted from the launch "
            f"(CTAs x size of G, not read): "
            f"{plan['l2_bytes_of_g'] / 1e9:.4f} GB")
    zero_counts(every_kernel())
    bench = tool.run(["--width", str(w), "--height", str(h), "--tris",
                      str(n_tris), "--reps", str(T1_REPS)])
    per_line = 1 + 2 * T1_REPS
    launched = launched_only({"K5": per_line, "T1": 2 * per_line},
                             "the microbenchmark")
    lines = bench["lines"]
    for k in (128, 64):
        got = lines[f"T1 K={k}"]["launches"]
        check(got == per_line, f"T1 K={k} launched {got} times in the "
              f"microbenchmark, want {per_line}")
    log(f"[42] the microbenchmark at {w}x{h} x {n_tris} triangles "
        f"launched {launched}")
    ops = bench["ops"]
    k5_check = k5_vs_plain(torch, ops["tri"],
                           (ops["o"], ops["d"], ops["src"]),
                           "K5 microbenchmark")
    k5_check["launches"] = launched["K5"]
    log(f"[42] K5 vs plain, {k5_check['rays']} rays x {n_tris} triangles "
        f"(the whole shape, the tool's tensors): {k5_check}")
    records = []
    for k in (128, 64):
        c = t1_vs_plain(torch, ops, k)
        ragged = t1_ragged(torch, ops, k)
        log(f"[42] T1 K={k} at ragged and small shapes, share of the bound "
            f"by rays x triangles: {ragged}")
        g, r = ops["t1"][k]
        plain_ms = [event_ms(torch, lambda: sm.sweep_mm_plain(g, r), 1)
                    for _ in range(2)]
        cold = cold_l2_ms(torch, lambda: sm.sweep_mm_call(g, r))
        t1, yard = lines[f"T1 K={k}"], lines[f"cuBLAS K={k}"]
        b = sm.bound(ops["n_rays"], n_tris, k)
        log(f"[42] T1 K={k} vs plain, {c['rays']} rays x {n_tris} "
            f"triangles (the whole shape, the tool's tensors): {c}; plain "
            f"{plain_ms} ms; after an L2 flush {cold:.4f} ms")
        records.append({
            "name": f"sweep_matmul_k{k}",
            "route": "cuda",
            "source": "spath_tpu_torch/csrc/sweep_mm.cu",
            "replaces": "tools/sweep_microbench.py:"
                        + ("59" if k == 128 else "74"),
            "launches": t1["launches"],
            "launches_by_path": {"microbenchmark": t1["launches"],
                                 "render paths": 0},
            "max_abs_err": c["max_abs_err"],
            "bound_share_of_error": c["bound_share"],
            "control_bound_share": c["control_bound_share"],
            "ms": t1["mean_ms"],
            "ms_in_turns": t1["ms"],
            "ms_cold_l2": cold,
            "plain_ms": sum(plain_ms) / 2,
            "at": f"{ops['n_rays']} rays x {n_tris} triangles",
            "bound_ms": b["ms"],
            "bound_by": b["by"],
            "ceiling_ms": b["ceiling_ms"],
            "bound_share": b["ms"] / t1["mean_ms"],
            "ceiling_share": b["ceiling_ms"] / t1["mean_ms"],
            "compiled_plan": built[k],
            "sms": sms,
            "ragged_bound_share": max(ragged.values()),
            "library_ms": yard["mean_ms"],
            "library_call": "torch.mm of the bf16 operands into float32 "
                            "(cuBLAS), then amin and the ordered block "
                            "sum: a GEMM plus amin, not one call",
            "k5_ms_same_shape": lines["K5"]["mean_ms"],
        })
    del ops, bench
    return records, k5_check


def stream_kernels() -> dict:
    """The threefry kernel's wrapper (phases 43-46)."""
    from spath_tpu_torch.ops.kernels import threefry as tf

    return {"threefry": tf.threefry_call}


def threefry_bound(n: int, n_draws: int):
    """The threefry kernel's bound at ``n`` pixels: ``(ms, by, ops,
    bytes)`` from THREEFRY_BLOCK_OPS over PEAK_INT32_OPS and the bytes
    over PEAK_BYTES."""
    ops = n * ((n_draws + 1) * THREEFRY_BLOCK_OPS
               + n_draws * THREEFRY_DRAW_OPS)
    nbytes = n * (8 + 4 * n_draws)
    t_ops, t_bytes = ops / PEAK_INT32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations", ops, nbytes
    return t_bytes, "bytes", ops, nbytes


def device_ms_by_kernel(torch, fn, names: dict) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the device ms of the
    kernels whose names hold each value of ``names``, of every kernel, the
    kernels' count, and the call's host ms (ending in a synchronise)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    out = {key: sum(e["dur"] for e in kernels if part in e.get("name", ""))
           / 1e3 for key, part in names.items()}
    out.update(all_kernels_ms=sum(e["dur"] for e in kernels) / 1e3,
               kernels=len(kernels), wall_ms=wall_ms)
    return out


def threefry_phase(torch, dev) -> dict:
    """Phase 43: the threefry kernel bit-equal to ``per_pixel_uniforms`` over
    the 1080p frame's pixel ids and 131,072 ids near 2^32, at
    THREEFRY_DRAWS draws and THREEFRY_STEPS' keys; two launches bitwise
    equal; timed in turns with its plain version at the QUALITY preset's
    step (1080p, 5 draws), beside its bound (PEAK_INT32_OPS)."""
    from spath_tpu_torch.ops import rng
    from spath_tpu_torch.ops.kernels import threefry as tf

    log(f"[43] threefry ptxas: {ptxas_lines('threefry.cu')}")
    sass = sass_opcodes("threefry_draws")
    check(len(sass) == 1, f"{len(sass)} threefry kernels in the SASS")
    log(f"[43] threefry SASS, static instructions by opcode (the block's "
        f"adds as IADD3 or IMAD, rotations SHF, xors LOP3): {sass}")
    n = HEADLINE["width"] * HEADLINE["height"]
    frame_ids = torch.arange(n, dtype=torch.int64, device=dev)
    gen = torch.Generator().manual_seed(43)
    high = torch.cat([(1 << 32) - 1 - torch.arange(65_536),
                      torch.randint(1 << 31, 1 << 32, (65_536,),
                                    generator=gen)]).to(dev)
    checked = 0
    for seed, sample, bounce in THREEFRY_STEPS:
        key = rng.fold_in(rng.fold_in(rng.threefry_key(seed), sample),
                          bounce)
        for ids in (frame_ids, high):
            for n_draws in THREEFRY_DRAWS:
                got = tf.threefry_call(key, ids, n_draws)
                want = rng.per_pixel_uniforms(key, ids, n_draws)
                torch.cuda.synchronize()
                check(torch.equal(got.view(torch.int32),
                                  want.view(torch.int32)),
                      f"threefry at step {(seed, sample, bounce)}, "
                      f"{n_draws} draws, {ids.shape[0]} ids: "
                      f"{int((got != want).sum())} draws differ from "
                      "per_pixel_uniforms")
                checked += got.numel()
    key = rng.fold_in(rng.fold_in(rng.threefry_key(0), 0), 0)
    first = tf.threefry_call(key, frame_ids, 5)
    check(torch.equal(first.view(torch.int32),
                      tf.threefry_call(key, frame_ids, 5).view(torch.int32)),
          "two threefry launches differ")
    check(0.0 <= first.min().item() and first.max().item() < 1.0
          and abs(first.mean().item() - 0.5) < 1e-3,
          f"threefry draws: min {first.min().item()}, max "
          f"{first.max().item()}, mean {first.mean().item()}")
    ms, plain_ms = in_turns(
        torch, lambda: tf.threefry_call(key, frame_ids, 5),
        lambda: rng.per_pixel_uniforms(key, frame_ids, 5), kernel_reps=50)
    b_ms, b_by, ops, nbytes = threefry_bound(n, 5)
    out = dict(draws_checked=checked, ms=sum(ms) / len(ms), ms_runs=ms,
               plain_ms=sum(plain_ms) / 2, plain_runs=plain_ms,
               bound_ms=b_ms, bound_by=b_by, ops=ops, bytes=nbytes,
               mean=first.mean().item())
    log(f"[43] threefry vs per_pixel_uniforms bit for bit: {checked} draws "
        f"({len(THREEFRY_STEPS)} steps x {THREEFRY_DRAWS} draws x the 1080p "
        f"ids and 131072 ids near 2^32); two launches bitwise equal; at "
        f"1080p, 5 draws, in turns, on {card()}: kernel {ms} ms (50 "
        f"launches each), plain {plain_ms} ms; bound {b_ms:.5f} ms "
        f"({b_by}: {ops / 1e9:.4f} G integer operations at the SMs' "
        f"issue rate, {PEAK_INT32_OPS / 1e12:.2f} T/s, {nbytes / 1e6:.2f} "
        "MB)")
    return out


def quality_preset_frame(torch, dev, cam) -> dict:
    """Phase 44: ``render_pt_fast`` on ``config.QUALITY`` at the headline
    shape: routed to the wavefront, it launches K5, the light distribution
    and the threefry kernel (a launch a sample and bounce) and nothing
    else; its first call, two frames through ``FrameTimer``, one under the
    profiler for the kernels' device shares; at STREAM_CHECK bit-equal to
    the frame of the plain sweep and plain draws; ``bounce_stats`` at
    1080p."""
    from spath_tpu_torch.config import QUALITY
    from spath_tpu_torch.models.pathtracer import render_pt_fast
    from spath_tpu_torch.models.renderer import forward_renderer
    from spath_tpu_torch.scene import default_scene
    from spath_tpu_torch.utils.profiling import FrameTimer, bounce_stats

    scene = default_scene(dev)
    cfg = QUALITY.replace(**HEADLINE)
    check(forward_renderer(scene, cfg).name == "wavefront",
          "the QUALITY preset is not routed to the wavefront")
    zero_counts(every_kernel())
    t0 = time.perf_counter()
    img = render_pt_fast(scene, cam, cfg, 0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launched = {k: v for k, v in counts(every_kernel()).items() if v}
    steps = cfg.spp * cfg.max_bounces
    check(set(launched) == {"K5", "light", "threefry"}
          and launched["threefry"] == steps,
          f"the QUALITY frame launched {launched}; want K5, the light "
          f"distribution and {steps} threefry launches only")
    check(tuple(img.shape) == (cfg.height, cfg.width, 3)
          and torch.isfinite(img).all().item()
          and img.min().item() >= 0.0 and img.max().item() <= 1.0,
          "the QUALITY frame is not a finite (H, W, 3) frame in [0, 1]")
    mean = img.mean().item()
    check(mean > 0.01, f"the QUALITY frame is black (mean {mean})")
    del img
    ft = FrameTimer(cfg)
    for _ in range(2):
        with ft.frame():
            render_pt_fast(scene, cam, cfg, 0)
    shares = device_ms_by_kernel(
        torch, lambda: render_pt_fast(scene, cam, cfg, 0),
        {"threefry_ms": "threefry_draws", "k5_ms": "nearest_hit",
         "merge_ms": "merge_hits", "light_ms": "light_cdf"})
    small = QUALITY.replace(**STREAM_CHECK)
    got = render_pt_fast(scene, cam, small, 0)
    with plain_sweep():
        want = render_pt_fast(scene, cam, small, 0)
    check(torch.equal(got, want), "the QUALITY frame at 320x240x4 differs "
          "from the plain sweep's and plain draws' in "
          f"{int((got != want).any(-1).sum())} pixels")
    stats = bounce_stats(scene, cam, cfg, 0).tolist()
    out = dict(launches=launched, first_s=first_s, frame_s=ft.times,
               rays_per_s=ft.rays_per_s, mean=mean, profiled=shares,
               threefry_share=shares["threefry_ms"] / (ft.last_s * 1e3),
               bounce_stats=stats)
    log(f"[44] render_pt_fast on config.QUALITY, {cfg.width}x{cfg.height} "
        f"spp{cfg.spp} {cfg.max_bounces} bounces, on {card()}, route "
        f"{serving_route(scene, cam, cfg)}: launched "
        f"{launched}; first call {first_s:.3f} s, frames {ft.times} s, "
        f"{ft.rays_per_s:.6g} rays/s (FrameTimer), mean {mean:.6f}; "
        f"profiled frame {shares}; threefry's share of a frame "
        f"{out['threefry_share']:.6f}; at 320x240x4 bit-equal to the plain "
        f"sweep's and plain draws' frame; bounce_stats {stats}")
    return out


def wavefront_grads(torch, scene, cam, cfg):
    """Gradients of ``mean(img^2)`` through ``render_radiance_fastgrad``
    with respect to the scene's vertices, albedo and emission."""
    from spath_tpu_torch.models.pathtracer import render_radiance_fastgrad

    leaves = [t.detach().clone().requires_grad_()
              for t in (scene.vertices, scene.albedo, scene.emission)]
    img = render_radiance_fastgrad(
        dataclasses.replace(scene, vertices=leaves[0], albedo=leaves[1],
                            emission=leaves[2]), cam, cfg, 0)
    return torch.autograd.grad(img.square().mean(), leaves)


def table_stream_phase(torch, dev, cam) -> dict:
    """Phase 45: a conformance frame on the table stream (angle sampler)
    at the headline shape through ``render_pt_fast``: the wavefront on K5
    and no other kernel; two frames through ``FrameTimer``; at
    STREAM_CHECK bit-equal to the plain sweep's frame, and its gradient
    (vertices, albedo, emission; the wavefront on K5, its gathers' backward
    on K7) within GRAD_RTOL of each max of the plain sweep's."""
    from spath_tpu_torch.config import RenderConfig
    from spath_tpu_torch.models.pathtracer import render_pt_fast
    from spath_tpu_torch.models.renderer import forward_renderer, \
        grad_renderer
    from spath_tpu_torch.scene import default_scene
    from spath_tpu_torch.utils.profiling import FrameTimer

    scene = default_scene(dev)
    cfg = RenderConfig(**HEADLINE, rng="table")
    check(forward_renderer(scene, cfg).name == "wavefront",
          "the table stream is not routed to the wavefront")
    zero_counts(every_kernel())
    t0 = time.perf_counter()
    img = render_pt_fast(scene, cam, cfg, 0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launched = {k: v for k, v in counts(every_kernel()).items() if v}
    check(set(launched) == {"K5"}, f"the table frame launched {launched}; "
          "want K5 only")
    check(torch.isfinite(img).all().item() and img.mean().item() > 0.01,
          "the table frame is black or not finite")
    mean = img.mean().item()
    del img
    ft = FrameTimer(cfg)
    for _ in range(2):
        with ft.frame():
            render_pt_fast(scene, cam, cfg, 0)
    small = cfg.replace(**STREAM_CHECK)
    got = render_pt_fast(scene, cam, small, 0)
    with plain_sweep():
        want = render_pt_fast(scene, cam, small, 0)
    check(torch.equal(got, want), "the table frame at 320x240x4 differs "
          "from the plain sweep's in "
          f"{int((got != want).any(-1).sum())} pixels")
    check(grad_renderer(scene, small).name == "wavefront",
          "the table stream's gradient is not routed to the wavefront")
    zero_counts(every_kernel())
    grads = wavefront_grads(torch, scene, cam, small)
    torch.cuda.synchronize()
    glaunched = {k: v for k, v in counts(every_kernel()).items() if v}
    check(set(glaunched) == {"K5", "K7"}, f"the table stream's gradient "
          f"launched {glaunched}; want K5 and K7")
    with plain_sweep():
        plain = wavefront_grads(torch, scene, cam, small)
    errs = {}
    for name, g, w in zip(("vertices", "albedo", "emission"), grads, plain):
        scale = w.abs().max().item()
        err = (g - w).abs().max().item()
        check(scale > 0 and err <= GRAD_RTOL * scale, f"the table stream's "
              f"{name} gradient off the plain sweep's by {err:.6g}, max "
              f"{scale:.6g}")
        errs[name] = err / scale
    out = dict(launches=launched, first_s=first_s, frame_s=ft.times,
               rays_per_s=ft.rays_per_s, mean=mean,
               grad_launches=glaunched, grad_rel_err=errs)
    log(f"[45] render_pt_fast on the table stream, {cfg.width}x"
        f"{cfg.height} spp{cfg.spp} {cfg.max_bounces} bounces, on {card()}, "
        f"route {serving_route(scene, cam, cfg)}: "
        f"launched {launched}; first call {first_s:.3f} s, frames "
        f"{ft.times} s, {ft.rays_per_s:.6g} rays/s, mean {mean:.6f}; at "
        f"320x240x4 bit-equal to the plain sweep's frame; its gradient "
        f"launched {glaunched}, off the plain sweep's by {errs} of each max")
    return out


def quality_preset_training(torch, dev, cam) -> dict:
    """Phase 46: 3 ``recover`` steps on ``config.QUALITY`` at 1080p,
    PRESET_TRAIN_SPP samples, 5 bounces, the CLI's perturbation and
    optimizer (albedo at 2e-2, pose frozen), the target's seed fixed:
    through the wavefront's autograd, launching K5, K7, the light
    distribution and the threefry kernel and none of K1-K4, K6, K8-K11;
    the loss falls; two gradients on one seed bitwise equal."""
    import numpy as np

    from spath_tpu_torch.config import QUALITY
    from spath_tpu_torch.models.inverse import (
        InverseParams, param_group_optimizer, recover, render_loss,
    )
    from spath_tpu_torch.models.renderer import forward_renderer, \
        grad_renderer
    from spath_tpu_torch.scene import default_scene

    scene = default_scene(dev)
    cfg = QUALITY.replace(**HEADLINE).replace(spp=PRESET_TRAIN_SPP)
    check(grad_renderer(scene, cfg).name == "wavefront",
          "the QUALITY preset's gradient is not routed to the wavefront")
    target = forward_renderer(scene, cfg).render_radiance(scene, cam, cfg, 0)
    true_albedo = scene.albedo.cpu().numpy()
    bad = np.clip(true_albedo + np.random.default_rng(1).uniform(
        -0.4, 0.4, true_albedo.shape).astype(np.float32), 0.05, 1.0)
    params = InverseParams(cam_pos=cam.pos, cam_angle=cam.angle,
                           cam_focal=cam.focal,
                           albedo=torch.from_numpy(bad).to(dev))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts(every_kernel())
    msgs = []
    t0 = time.perf_counter()
    state, losses = recover(
        scene, target, params, cfg,
        param_group_optimizer(freeze_pose=True, albedo_lr=2e-2), steps=3,
        fixed_seed=0, log_every=1, log_fn=msgs.append)
    torch.cuda.synchronize()
    steps_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    launched = {k: v for k, v in counts(every_kernel()).items() if v}
    draws = 3 * cfg.spp * cfg.max_bounces
    check(set(launched) == {"K5", "K7", "light", "threefry"}
          and launched["threefry"] == draws,
          f"3 QUALITY train steps launched {launched}; want K5, K7, the "
          f"light distribution and {draws} threefry launches only")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"QUALITY training: the loss did not fall: {losses}")
    leaves = state.params.leaves()
    grads, fwd_bwd_s = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        loss = render_loss(leaves, scene, target, cfg, 0)
        grads.append(torch.autograd.grad(loss, [leaves.albedo])[0])
        torch.cuda.synchronize()
        fwd_bwd_s.append(time.perf_counter() - t0)
    check(torch.isfinite(grads[0]).all().item()
          and grads[0].abs().max().item() > 0, "QUALITY training: the "
          "albedo gradient is zero or not finite")
    check(torch.equal(grads[0], grads[1]), "two QUALITY gradients on one "
          "seed differ by " f"{(grads[0] - grads[1]).abs().max().item()}")
    out = dict(launches=launched, losses=losses, steps_s=steps_s,
               step_s=steps_s / 3, fwd_bwd_s=fwd_bwd_s, peak_gb=peak_gb,
               log=msgs)
    log(f"[46] 3 recover steps on config.QUALITY, {cfg.width}x{cfg.height} "
        f"spp{cfg.spp} (cut from 64 for time) {cfg.max_bounces} bounces, "
        f"on {card()}: launched {launched}; losses {losses}; {steps_s:.3f} "
        f"s in all; two gradients on one seed bitwise equal, "
        f"{fwd_bwd_s} s each; peak device memory {peak_gb:.3f} GB")
    return out


#: The sharded phases (47, 48): the 10k scene's frame in both, and the
#: two-rank phase's default-scene frame and the wavefront's
#: (``config.QUALITY``) in both, cut for time (the headline's 64 spp stay
#: in phase 47 for K1-K4).
SHARD_BIG = dict(width=320, height=240, spp=4, max_bounces=5)
SHARD_FRAME = dict(width=1920, height=1080, spp=8, max_bounces=5)
SHARD_GROUPS = ("vertices", "albedo", "emission", "pos", "angle", "focal")
#: pairs of one-device and one-rank headline calls timed in phase 47
OVERHEAD_TURNS = 8
#: Phase 47's scene above K9's light cap: procedural_scene(LIGHT_CAP_T,
#: seed=0, emissive_fraction=LIGHT_CAP_EMISSIVE), about 70,000 lights, at
#: a frame the plain sweep renders in about a second.
LIGHT_CAP_T, LIGHT_CAP_EMISSIVE = 100_000, 0.7
LIGHT_CAP_FRAME = dict(width=64, height=48, spp=1, max_bounces=5)
#: the kernels' records by the short names of the launch counts
RECORD_NAMES = {
    "K1": "megakernel_forward", "K2": "megakernel_backward",
    "light": "light_cdf", "K3": "quality_forward", "K4": "quality_backward",
    "K5": "nearest_hit", "K6": "bigscene_forward", "K7": "stream_scatter",
    "K8": "bigscene_backward", "K9": "bigscene_quality_forward",
    "K10": "bigscene_quality_backward", "threefry": "threefry"}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def shard_cases(torch, dev, frame: dict, big: dict) -> list:
    """``(name, scene, cfg, forward kernels, gradient kernels)`` of the
    five sharded routes: the default scene at ``frame`` (K1; K1, K2; the
    light distribution and K3; and K4), procedural_scene(10_000) at
    ``big`` (K6; K6, K8, K7; the light distribution and K9; K9, K10,
    K7), and the wavefront on ``config.QUALITY`` (threefry) on the
    default scene at SHARD_FRAME (K5, the light distribution and the
    threefry kernel; and K7, the gathers' backward)."""
    from spath_tpu_torch.config import QUALITY as PRESET
    from spath_tpu_torch.config import RenderConfig
    from spath_tpu_torch.scene import default_scene, procedural_scene

    dscene, ten_k = default_scene(dev), procedural_scene(BIG_T, seed=0,
                                                         device=dev)
    return [
        ("conformance", dscene, RenderConfig(**frame), {"K1"},
         {"K1", "K2"}),
        ("quality", dscene, RenderConfig(**frame, **QUALITY),
         {"light", "K3"}, {"light", "K3", "K4"}),
        ("conformance 10k", ten_k, RenderConfig(**big), {"K6"},
         {"K6", "K8", "K7"}),
        ("quality 10k", ten_k, RenderConfig(**big, **QUALITY),
         {"light", "K9"}, {"light", "K9", "K10", "K7"}),
        ("wavefront, config.QUALITY", dscene, PRESET.replace(**SHARD_FRAME),
         {"K5", "light", "threefry"}, {"K5", "K7", "light", "threefry"}),
    ]


def shard_weights(torch, cfg, dev):
    """The loss weights of the sharded gradients, the same in every
    process."""
    g = torch.Generator().manual_seed(11)
    return (0.5 + torch.rand((cfg.height, cfg.width, 3), generator=g)
            ).to(dev)


def six_grads(torch, scene, cam, cfg, mesh=None) -> list:
    """The gradients of ``sum(weights * render_radiance_fastgrad)`` in the
    scene's vertices, albedo and emission and the camera's position,
    angles and focal length, through ``mesh`` or on one device, on the
    route the sharded call takes (``require_jittable``: never a compacted
    one)."""
    from spath_tpu_torch.camera import Camera
    from spath_tpu_torch.models.pathtracer import render_radiance_fastgrad
    from spath_tpu_torch.scene import Scene

    leaves = [t.detach().clone().requires_grad_() for t in (
        scene.vertices, scene.albedo, scene.emission, cam.pos, cam.angle,
        cam.focal)]
    img = render_radiance_fastgrad(Scene(*leaves[:3], scene.light_idx),
                                   Camera(*leaves[3:]), cfg, 0, mesh=mesh,
                                   require_jittable=True)
    loss = (img * shard_weights(torch, cfg, img.device)).sum()
    return list(torch.autograd.grad(loss, leaves))


def launched_set(expect: set, what: str) -> dict:
    """The counts since they were zeroed: every kernel of ``expect``
    launched, no other."""
    launched = {k: v for k, v in counts(every_kernel()).items() if v}
    check(set(launched) == expect, f"{what} launched {launched}, want "
          f"{sorted(expect)} and nothing else")
    return launched


def shard_train_state(torch, dev, scene, cam):
    """A train state at step 0 with the CLI's albedo perturbation, pose
    frozen (phase 8's)."""
    import numpy as np

    from spath_tpu_torch.models.inverse import (
        InverseParams, init_state, param_group_optimizer,
    )

    true_albedo = scene.albedo.cpu().numpy()
    rng = np.random.default_rng(1)
    bad = np.clip(true_albedo + rng.uniform(-0.4, 0.4, true_albedo.shape)
                  .astype(np.float32), 0.05, 1.0)
    params = InverseParams(cam_pos=cam.pos, cam_angle=cam.angle,
                           cam_focal=cam.focal,
                           albedo=torch.from_numpy(bad).to(dev))
    return params, init_state(param_group_optimizer(
        freeze_pose=True, albedo_lr=2e-2), params)


def collective_ms(torch, mesh, dev, timer) -> dict:
    """ms of the sharded paths' collectives on ``mesh``, 10 calls after
    one: the all-gather of a rank's block of the 1080p frame, and the
    rank-ordered sum's all-gather of the 10k scene's six gradients
    (15 floats a triangle, 7 of the camera)."""
    pixels = HEADLINE["width"] * HEADLINE["height"]
    block = torch.zeros((pixels // mesh.size, 3), device=dev)
    grads = torch.zeros(BIG_T * 15 + 7, device=dev)
    out = {}
    for name, t in (("frame all-gather", block), ("gradient sum", grads)):
        mesh.all_gather(t)
        out[name] = timer(torch, lambda: mesh.all_gather(t), 10)
    return out


def host_ms(torch, fn, reps: int) -> float:
    """ms a call on the host's clock, ending in a synchronise: a gloo
    collective blocks the host."""
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def light_cap_check(torch, dev, cam, mesh) -> dict:
    """Phase 47's scene above K9's ``LIGHT_MAX`` lights, with NEE: K9 and
    K10 decline it and the wavefront takes it, forward and gradient; its
    frame launches K5 and the light distribution only and is bit-equal to
    the plain sweep's, on one device and on ``mesh``; its gradient
    (vertices, albedo, emission) within GRAD_RTOL of each max of the
    plain sweep's."""
    from spath_tpu_torch.config import RenderConfig
    from spath_tpu_torch.models.pathtracer import render_pt_fast
    from spath_tpu_torch.models.renderer import forward_renderer, \
        grad_renderer
    from spath_tpu_torch.ops.kernels.bigscene_quality import (
        LIGHT_MAX, static_light_idx,
    )
    from spath_tpu_torch.scene import procedural_scene

    scene = procedural_scene(LIGHT_CAP_T, seed=0,
                             emissive_fraction=LIGHT_CAP_EMISSIVE,
                             device=dev)
    lights = len(static_light_idx(scene))
    cfg = RenderConfig(**LIGHT_CAP_FRAME, **QUALITY)
    shape = f"{cfg.width}x{cfg.height} spp{cfg.spp}"
    check(lights > LIGHT_MAX, f"{lights} lights, not above {LIGHT_MAX}")
    check(forward_renderer(scene, cfg).name == "wavefront"
          and grad_renderer(scene, cfg).name == "wavefront",
          f"{lights} lights with NEE are not routed to the wavefront")
    zero_counts(every_kernel())
    img = render_pt_fast(scene, cam, cfg, 0)
    torch.cuda.synchronize()
    launched = launched_set({"K5", "light"}, f"{lights} lights' frame")
    with plain_sweep():
        want = render_pt_fast(scene, cam, cfg, 0)
    check(torch.equal(img, want), f"{lights} lights, {shape}: the frame "
          f"differs from the plain sweep's in "
          f"{int((img != want).any(-1).sum())} pixels")
    check(torch.equal(render_pt_fast(scene, cam, cfg, 0, mesh=mesh), img),
          f"{lights} lights, {shape}: the one-rank frame differs")
    mean = img.mean().item()
    check(torch.isfinite(img).all().item() and mean > 0.01,
          f"{lights} lights: the frame is black or not finite ({mean})")
    zero_counts(every_kernel())
    grads = wavefront_grads(torch, scene, cam, cfg)
    torch.cuda.synchronize()
    glaunched = launched_set({"K5", "K7", "light"},
                             f"{lights} lights' gradient")
    with plain_sweep():
        plain = wavefront_grads(torch, scene, cam, cfg)
    errs = {}
    for name, g, w in zip(("vertices", "albedo", "emission"), grads, plain):
        scale, err = w.abs().max().item(), (g - w).abs().max().item()
        check(scale > 0 and err <= GRAD_RTOL * scale, f"{lights} lights: "
              f"the {name} gradient off the plain sweep's by {err:.6g}, "
              f"max {scale:.6g}")
        errs[name] = err / scale
    log(f"[47] procedural_scene({LIGHT_CAP_T}) with {lights} lights (> "
        f"LIGHT_MAX {LIGHT_MAX}), NEE, {shape}: routed to the wavefront; "
        f"frame bit-equal to the plain sweep's and to one rank's, mean "
        f"{mean:.6f} ({launched}); gradient ({glaunched}) off the plain "
        f"sweep's by {errs} of each max")
    return dict(lights=lights, launches=launched, grad_launches=glaunched,
                grad_rel_err=errs, mean=mean)


def one_rank_phase(torch, dev, cam) -> dict:
    """Phase 47: ``init_multihost`` with a world of one on NCCL, and the
    five sharded routes on ``make_mesh(1)`` against one device: frames
    bit-equal, the six gradients and a train step bitwise equal (a world
    of one sums nothing), each sharded call launching its route's kernels
    only; a scene above K9's light cap (``light_cap_check``); the sharded
    call's overhead over the one-device call, in turns."""
    import torch.distributed as dist

    from spath_tpu_torch import parallel
    from spath_tpu_torch.models.inverse import make_train_step
    from spath_tpu_torch.models.pathtracer import render_pt_fast

    check(parallel.init_multihost(f"localhost:{free_port()}", 1, 0),
          "init_multihost started no process group")
    check(not parallel.init_multihost(f"localhost:{free_port()}", 1, 0),
          "a second init_multihost was not a no-op")
    mesh = parallel.make_mesh(1)
    check(mesh.backend == "nccl" and mesh.device == dev
          and mesh.group is not None, f"mesh {mesh}")
    out = {"launches": {}, "grad_launches": {}}
    for name, scene, cfg, fwd, grad in shard_cases(torch, dev, HEADLINE,
                                                   SHARD_BIG):
        shape = f"{cfg.width}x{cfg.height} spp{cfg.spp}"
        zero_counts(every_kernel())
        sharded = render_pt_fast(scene, cam, cfg, 0, mesh=mesh)
        torch.cuda.synchronize()
        out["launches"][name] = launched_set(fwd, f"sharded {name}")
        check(torch.equal(sharded, render_pt_fast(scene, cam, cfg, 0)),
              f"{name} {shape}: the one-rank frame differs from one "
              "device's")
        zero_counts(every_kernel())
        got = six_grads(torch, scene, cam, cfg, mesh)
        torch.cuda.synchronize()
        out["grad_launches"][name] = launched_set(
            grad, f"the sharded {name} gradient")
        want = six_grads(torch, scene, cam, cfg)
        for group, g, w in zip(SHARD_GROUPS, got, want):
            check(torch.equal(g, w), f"{name} {shape}: the one-rank "
                  f"{group} gradient differs from one device's")
        target = render_pt_fast(scene, cam, cfg, 0)
        steps = [make_train_step(scene, cfg, 0, mesh=m)(
            shard_train_state(torch, dev, scene, cam)[1], target)
            for m in (mesh, None)]
        check(torch.equal(steps[0][1]["loss"], steps[1][1]["loss"])
              and torch.equal(steps[0][1]["grad_norm"],
                              steps[1][1]["grad_norm"])
              and torch.equal(steps[0][0].params.albedo,
                              steps[1][0].params.albedo),
              f"{name} {shape}: the one-rank train step differs from one "
              "device's")
        log(f"[47] one rank on NCCL, {name} {shape}: frame bit-equal to "
            f"render_pt_fast ({out['launches'][name]}); six gradients and "
            f"a train step bitwise equal ({out['grad_launches'][name]})")
    out["light_cap"] = light_cap_check(torch, dev, cam, mesh)
    # the sharded call's overhead at the headline: after a call each way,
    # OVERHEAD_TURNS pairs of 5 calls each way, the order alternating, a
    # difference a pair
    from spath_tpu_torch.models.renderer import forward_renderer

    scene, cfg = shard_cases(torch, dev, HEADLINE, SHARD_BIG)[0][1:3]
    full = forward_renderer(scene, cfg)         # the sharded call's route
    calls = {"one": lambda: full.render(scene, cam, cfg, 0),
             "sharded": lambda: render_pt_fast(scene, cam, cfg, 0,
                                               mesh=mesh)}
    for fn in calls.values():
        fn()
    ms = {"one": [], "sharded": []}
    for turn in range(OVERHEAD_TURNS):
        for k in (("one", "sharded") if turn % 2 else ("sharded", "one")):
            ms[k].append(event_ms(torch, calls[k], 5))
    diffs = sorted(s - o for s, o in zip(ms["sharded"], ms["one"]))
    out["overhead_ms"] = sum(diffs) / len(diffs)
    out["overhead_ms_median"] = (diffs[(len(diffs) - 1) // 2]
                                 + diffs[len(diffs) // 2]) / 2
    out["overhead_ms_range"] = [diffs[0], diffs[-1]]
    out["one_device_ms"], out["sharded_ms"] = ms["one"], ms["sharded"]
    out["collective_ms"] = collective_ms(torch, mesh, dev, event_ms)
    log(f"[47] the headline serving call, CUDA events, {OVERHEAD_TURNS} "
        f"pairs in alternating order, 5 calls each, on {card()}: one "
        f"device {ms['one']} ms, one rank on NCCL {ms['sharded']} ms; "
        f"overhead by pair {diffs} ms, mean {out['overhead_ms']:.4f}, "
        f"median {out['overhead_ms_median']:.4f} ms; "
        f"the collectives alone (CUDA events): {out['collective_ms']}")
    dist.destroy_process_group()
    return out


def two_rank_worker(rank: int, port: int, out: str) -> None:
    """Phase 48's rank ``rank`` of two sharing card 0 on gloo (NCCL refuses
    two ranks on one GPU; the mesh stages each collective's tensors
    through host memory): the four routes' frames and gradients (twice),
    3 ``recover`` steps and ``scaling_efficiency``, saved for the parent
    to check."""
    import torch
    import torch.distributed as dist

    from spath_tpu_torch import parallel
    from spath_tpu_torch.camera import Camera
    from spath_tpu_torch.config import RenderConfig
    from spath_tpu_torch.models.inverse import (
        param_group_optimizer, recover,
    )
    from spath_tpu_torch.models.pathtracer import render_pt_fast
    from spath_tpu_torch.parallel.shard_fast import (
        render_radiance_fast_sharded,
    )
    from spath_tpu_torch.scene import default_scene

    parallel.init_multihost(f"localhost:{port}", 2, rank, backend="gloo")
    dev = torch.device("cuda", 0)
    mesh = parallel.make_mesh(2)
    cam = Camera.default(dev)
    res = {"device": str(mesh.device), "backend": mesh.backend,
           "staged": mesh.staged(torch.empty(1, device=dev))}
    for name, scene, cfg, _, _ in shard_cases(torch, dev, SHARD_FRAME,
                                              SHARD_BIG):
        zero_counts(every_kernel())
        res[f"frame/{name}"] = render_pt_fast(scene, cam, cfg, 0,
                                              mesh=mesh).cpu()
        res[f"launches/{name}"] = {k: v for k, v in
                                   counts(every_kernel()).items() if v}
        zero_counts(every_kernel())
        grads = six_grads(torch, scene, cam, cfg, mesh)
        res[f"grad_launches/{name}"] = {k: v for k, v in
                                        counts(every_kernel()).items() if v}
        again = six_grads(torch, scene, cam, cfg, mesh)
        res[f"grad/{name}"] = [g.cpu() for g in grads]
        res[f"again/{name}"] = all(torch.equal(a, b)
                                   for a, b in zip(grads, again))
    res["collective_ms"] = collective_ms(torch, mesh, dev, host_ms)
    scene, cfg = default_scene(dev), RenderConfig(**SHARD_FRAME)
    params, _ = shard_train_state(torch, dev, scene, cam)
    target = render_radiance_fast_sharded(scene, cam, cfg, 0, mesh)
    t0 = time.perf_counter()
    state, losses = recover(
        scene, target, params, cfg,
        param_group_optimizer(freeze_pose=True, albedo_lr=2e-2), steps=3,
        fixed_seed=0, log_every=0, mesh=mesh)
    torch.cuda.synchronize()
    res["recover_s"] = time.perf_counter() - t0
    res["losses"] = losses
    res["params"] = {k: t.detach().cpu() for k, t in
                     state.params.tensors().items()}
    res["scaling"] = parallel.scaling_efficiency(
        scene, cam, RenderConfig(width=320, height=240, spp=8), 2, reps=2)
    torch.save(res, f"{out}/rank{rank}.pt")
    dist.destroy_process_group()


def two_rank_phase(torch, dev, cam) -> dict:
    """Phase 48: two ranks sharing the card, spawned here
    (``two_rank_worker``), held to one device: frames bit-equal, the six
    gradients (rank-ordered sums) within GRAD_RTOL of each group's max
    and bitwise equal across the ranks and across two runs, each call
    launching its route's kernels only; 3 ``recover`` steps lower the
    loss with both ranks' parameters bitwise equal; ``scaling_efficiency``
    logged, which on one card measures nothing of scaling."""
    import torch.multiprocessing as mp

    from spath_tpu_torch.models.pathtracer import render_pt_fast

    torch.cuda.empty_cache()            # the ranks share the card
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.spawn(two_rank_worker, args=(free_port(), tmp), nprocs=2,
                 join=True)
        spawn_s = time.perf_counter() - t0
        res = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
               for r in range(2)]
    out = {"spawn_s": spawn_s, "launches": {}, "grad_launches": {}}
    for r in res:
        check(r["backend"] == "gloo" and r["staged"]
              and r["device"] == str(dev), f"rank: {r['backend']}, "
              f"staged {r['staged']}, {r['device']}")
    log(f"[48] two ranks on one card ({dev}): gloo, each collective's "
        "tensors staged through host memory (NCCL refuses two ranks on "
        f"one GPU); spawn to exit {spawn_s:.2f} s")
    for name, scene, cfg, fwd, grad in shard_cases(torch, dev, SHARD_FRAME,
                                                   SHARD_BIG):
        shape = f"{cfg.width}x{cfg.height} spp{cfg.spp}"
        one = render_pt_fast(scene, cam, cfg, 0).cpu()
        want = [g.cpu() for g in six_grads(torch, scene, cam, cfg)]
        errs = {}
        for rank, r in enumerate(res):
            check(set(r[f"launches/{name}"]) == fwd
                  and set(r[f"grad_launches/{name}"]) == grad,
                  f"rank {rank}, {name}: launched {r[f'launches/{name}']} "
                  f"and {r[f'grad_launches/{name}']}, want {sorted(fwd)} "
                  f"and {sorted(grad)}")
            check(torch.equal(r[f"frame/{name}"], one), f"rank {rank}, "
                  f"{name} {shape}: the two-rank frame differs from one "
                  "device's")
            check(r[f"again/{name}"], f"rank {rank}, {name}: two sharded "
                  "gradients differ")
            for group, g, w in zip(SHARD_GROUPS, r[f"grad/{name}"], want):
                err = (g - w).abs().max().item()
                scale = w.abs().max().item()
                check(err <= GRAD_RTOL * scale, f"rank {rank}, {name}: the "
                      f"{group} gradient is {err} off, over {GRAD_RTOL} of "
                      f"its max {scale}")
                errs[group] = err / scale if scale else err
        for group, a, b in zip(SHARD_GROUPS, res[0][f"grad/{name}"],
                               res[1][f"grad/{name}"]):
            check(torch.equal(a, b), f"{name}: the ranks' {group} "
                  "gradients differ")
        out["launches"][name] = res[0][f"launches/{name}"]
        out["grad_launches"][name] = res[0][f"grad_launches/{name}"]
        log(f"[48] two ranks, {name} {shape}: both frames bit-equal to one "
            f"device's ({out['launches'][name]} a rank); gradients bitwise "
            f"equal across the ranks and two runs ("
            f"{out['grad_launches'][name]} a rank), against one device "
            f"(share of each group's max): {errs}")
    losses = [r["losses"] for r in res]
    check(losses[0] == losses[1] and losses[0][-1] < losses[0][0],
          f"3 sharded recover steps: losses {losses}")
    for k, t in res[0]["params"].items():
        check(torch.equal(t, res[1]["params"][k]),
              f"after 3 sharded recover steps the ranks' {k} differ")
    eff, t1, tn = res[0]["scaling"]
    check(res[0]["scaling"] == res[1]["scaling"] and all(
        x > 0 for x in (eff, t1, tn)), f"scaling {res[0]['scaling']} "
        f"{res[1]['scaling']}")
    out.update(losses=losses[0], recover_s=[r["recover_s"] for r in res],
               scaling=dict(efficiency=eff, t1_s=t1, tn_s=tn),
               collective_ms=[r["collective_ms"] for r in res])
    log(f"[48] the collectives through host memory, host clock, by rank: "
        f"{out['collective_ms']}")
    log(f"[48] 3 recover steps on two ranks, default scene "
        f"{SHARD_FRAME['width']}x{SHARD_FRAME['height']} "
        f"spp{SHARD_FRAME['spp']}: losses {losses[0]}, parameters bitwise "
        f"equal on both ranks, {out['recover_s']} s")
    log(f"[48] scaling_efficiency(2) of render_pt_sharded, 320x240 spp8, "
        f"on {card()} (two ranks on one card: machinery only, not a "
        f"scaling result): efficiency {eff}, t1 {t1} s, t2 {tn} s")
    return out


#: Phases 49-50, the triangle ring: the JAX README's ring point and T1's
#: scene, procedural_scene(RING_T, seed=0), at 1920x1080, RING_SPP samples
#: a frame (2) and 1 a gradient, 5 bounces.
RING_T = 65_536
RING_FRAME = dict(width=1920, height=1080, spp=2, max_bounces=5)
RING_GRAD_SPP = 1
#: the remat check: 9 samples (above the 8 that cfg.remat needs) at 16x8
RING_REMAT = dict(width=16, height=8, spp=9, max_bounces=5)
#: the ring's train steps: 3 SGD steps at this rate from a perturbed albedo
#: on the wall-and-light scene, whose frame is smooth in its vertices
#: (ring_train_step steps every leaf; on a scene of small triangles a
#: vertex step moves edges across pixels)
RING_TRAIN_STEPS, RING_TRAIN_LR = 3, 1.0


def ring_cases(torch, dev) -> list:
    """``(name, cfg, forward kernels, gradient kernels)`` of the ring's
    three estimators at RING_FRAME: conformance (LCG, angle: K5; K5, K7),
    quality (hash, cosine, NEE+MIS, roulette from bounce 2: K5, light; and
    K7) and ``config.QUALITY`` (threefry, cosine, NEE+MIS: K5, light,
    threefry; and K7). The gradients are taken of the first and last."""
    from spath_tpu_torch.config import QUALITY as PRESET
    from spath_tpu_torch.config import RenderConfig

    return [
        ("conformance", RenderConfig(**RING_FRAME), {"K5"}, {"K5", "K7"}),
        ("quality", RenderConfig(**RING_FRAME, **QUALITY, rr_start=2),
         {"K5", "light"}, {"K5", "K7", "light"}),
        ("config.QUALITY", PRESET.replace(**RING_FRAME),
         {"K5", "light", "threefry"}, {"K5", "K7", "light", "threefry"}),
    ]


def ring_grads(torch, scene, cam, cfg, mesh=None) -> list:
    """The six gradients (vertices, albedo, emission, camera position,
    angles, focal length) of ``sum(weights * radiance)`` through
    ``render_radiance_ring`` on ``mesh``, or through the one-device
    wavefront ``render_radiance`` without one; zeros where a group gets
    none."""
    from spath_tpu_torch.camera import Camera
    from spath_tpu_torch.models.pathtracer import render_radiance
    from spath_tpu_torch.parallel.ring import render_radiance_ring
    from spath_tpu_torch.scene import Scene

    leaves = [t.detach().clone().requires_grad_() for t in (
        scene.vertices, scene.albedo, scene.emission, cam.pos, cam.angle,
        cam.focal)]
    sc, c = Scene(*leaves[:3], scene.light_idx), Camera(*leaves[3:])
    img = render_radiance(sc, c, cfg, 0) if mesh is None else \
        render_radiance_ring(sc, c, cfg, mesh, 0)
    loss = (img * shard_weights(torch, cfg, img.device)).sum()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for g, x in zip(grads, leaves)]


def grads_close(torch, got, want, what: str) -> dict:
    """Each group within GRAD_RTOL of its max in ``want``; the shares."""
    errs = {}
    for group, g, w in zip(SHARD_GROUPS, got, want):
        err = (g.cpu() - w.cpu()).abs().max().item()
        scale = w.abs().max().item()
        check(err <= GRAD_RTOL * scale, f"{what}: the {group} gradient is "
              f"{err} off, over {GRAD_RTOL} of its max {scale}")
        errs[group] = err / scale if scale else err
    return errs


def ring_one_rank_phase(torch, dev, cam) -> dict:
    """Phase 49: the triangle ring with a world of one on NCCL, on
    procedural_scene(RING_T) at 1920x1080. ``render_pt_ring`` in three
    estimators and ``render_flat_ring`` bit-equal to the one-device
    wavefront ``render_pt`` (its sweeps on K5) and ``render_flat``; the
    six gradients through ``render_radiance_ring`` at RING_GRAD_SPP within
    GRAD_RTOL of each group's max of the one-device wavefront's and
    bitwise equal over two runs; one ``ring_train_step``; remat against no
    remat at RING_REMAT; each call launching its kernels only. Returns the
    counts and, for phase 50, the one-device frames and gradients on the
    host."""
    import torch.distributed as dist

    from spath_tpu_torch import parallel
    from spath_tpu_torch.config import RenderConfig
    from spath_tpu_torch.models.flat import render_flat
    from spath_tpu_torch.models.pathtracer import render_pt
    from spath_tpu_torch.parallel import ring
    from spath_tpu_torch.scene import Scene, procedural_scene

    check(parallel.init_multihost(f"localhost:{free_port()}", 1, 0),
          "init_multihost started no process group")
    mesh = parallel.make_mesh(1, axis="shard")
    check(mesh.backend == "nccl" and mesh.axis == "shard"
          and mesh.group is not None, f"mesh {mesh}")
    scene = procedural_scene(RING_T, seed=0, device=dev)
    out = {"launches": {}, "grad_launches": {}, "ms": {}, "one_ms": {},
           "frames": {}, "grads": {}}
    torch.cuda.reset_peak_memory_stats()
    for name, cfg, fwd, grad in ring_cases(torch, dev):
        shape = f"{cfg.width}x{cfg.height} spp{cfg.spp}"
        zero_counts(every_kernel())
        t0 = time.perf_counter()
        img = ring.render_pt_ring(scene, cam, cfg, mesh, 0)
        torch.cuda.synchronize()
        out["ms"][name] = (time.perf_counter() - t0) * 1e3
        out["launches"][name] = launched_set(fwd, f"ring {name}")
        t0 = time.perf_counter()
        one = render_pt(scene, cam, cfg, 0)
        torch.cuda.synchronize()
        out["one_ms"][name] = (time.perf_counter() - t0) * 1e3
        mean = img.mean().item()
        check(tuple(img.shape) == (cfg.height, cfg.width, 3)
              and torch.isfinite(img).all().item() and mean > 0.0,
              f"ring {name} {shape}: shape {tuple(img.shape)}, mean {mean}")
        check(torch.equal(img, one), f"ring {name} {shape}: the frame "
              f"differs from the one-device wavefront's in "
              f"{int((img != one).any(-1).sum())} pixels")
        out["frames"][name] = one.cpu()
        log(f"[49] render_pt_ring, world of one on NCCL, {name}, "
            f"procedural_scene({RING_T}) {shape}: bit-equal to render_pt, "
            f"mean {mean:.6f}; {out['ms'][name]:.1f} ms (one device "
            f"{out['one_ms'][name]:.1f} ms, host clock); "
            f"{out['launches'][name]}")
    # after the first calls, the conformance frame in turns: ring, one
    # device, one device, ring
    cfg = ring_cases(torch, dev)[0][1]
    turns = {"ring": [], "one": []}
    for k in ("ring", "one", "one", "ring"):
        t0 = time.perf_counter()
        if k == "ring":
            ring.render_pt_ring(scene, cam, cfg, mesh, 0)
        else:
            render_pt(scene, cam, cfg, 0)
        torch.cuda.synchronize()
        turns[k].append((time.perf_counter() - t0) * 1e3)
    out["turns_ms"] = turns
    log(f"[49] the conformance frame in turns (ring, one device, one "
        f"device, ring; host clock) on {card()}: ring {turns['ring']} ms, "
        f"one device {turns['one']} ms")
    flat_cfg = RenderConfig(width=RING_FRAME["width"],
                            height=RING_FRAME["height"])
    zero_counts(every_kernel())
    flat = ring.render_flat_ring(scene, cam, flat_cfg, mesh)
    torch.cuda.synchronize()
    out["launches"]["flat"] = launched_set({"K5"}, "render_flat_ring")
    check(torch.equal(flat, render_flat(scene, cam, flat_cfg)),
          "render_flat_ring differs from render_flat")
    log(f"[49] render_flat_ring 1920x1080 bit-equal to render_flat "
        f"({out['launches']['flat']})")
    for name, cfg, fwd, grad in ring_cases(torch, dev)[::2]:
        cfg = cfg.replace(spp=RING_GRAD_SPP)
        shape = f"{cfg.width}x{cfg.height} spp{cfg.spp}"
        zero_counts(every_kernel())
        t0 = time.perf_counter()
        got = ring_grads(torch, scene, cam, cfg, mesh)
        torch.cuda.synchronize()
        grad_ms = (time.perf_counter() - t0) * 1e3
        out["grad_launches"][name] = launched_set(grad,
                                                  f"ring {name} gradient")
        again = ring_grads(torch, scene, cam, cfg, mesh)
        for group, a, b in zip(SHARD_GROUPS, got, again):
            check(torch.equal(a, b), f"ring {name}: two {group} gradients "
                  "differ")
        want = [g.cpu() for g in ring_grads(torch, scene, cam, cfg)]
        errs = grads_close(torch, got, want, f"ring {name} {shape}")
        check(want[1].abs().max().item() > 0, f"{name}: no albedo gradient")
        out["grads"][name] = want
        log(f"[49] render_radiance_ring's six gradients, {name} {shape}: "
            f"bitwise equal over two runs, against the one-device "
            f"wavefront (share of each group's max) {errs}; "
            f"{grad_ms:.1f} ms forward and backward (host clock); "
            f"{out['grad_launches'][name]}")
    name, cfg = ring_cases(torch, dev)[1][:2]
    cfg = cfg.replace(spp=RING_GRAD_SPP)
    target = ring.render_radiance_ring(scene, cam, cfg, mesh, 0)
    start = Scene(scene.vertices, (scene.albedo + 0.25).clamp(0.0, 1.0),
                  scene.emission, scene.light_idx)
    zero_counts(every_kernel())
    loss, new = ring.ring_train_step(start, cam, cfg, mesh, target, 0, 1.0)
    torch.cuda.synchronize()
    out["train_launches"] = launched_set({"K5", "K7", "light"},
                                         "ring_train_step")
    check(torch.isfinite(loss).item() and loss.item() > 0
          and all(torch.isfinite(t).all().item() for t in
                  (new.vertices, new.albedo, new.emission))
          and not torch.equal(new.albedo, start.albedo),
          f"ring_train_step: loss {loss.item()}")
    log(f"[49] ring_train_step, {name} at {RING_GRAD_SPP} spp from the "
        f"albedo raised by 0.25: loss {loss.item():.6g}, the new scene "
        f"finite ({out['train_launches']})")
    rcfg = ring_cases(torch, dev)[2][1].replace(**RING_REMAT)
    remat = ring_grads(torch, scene, cam, rcfg, mesh)
    plain = ring_grads(torch, scene, cam, rcfg.replace(remat=False), mesh)
    for group, a, b in zip(SHARD_GROUPS, remat, plain):
        check(torch.equal(a, b), f"ring remat: the {group} gradient differs "
              "from the one without remat")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[49] remat (9 samples, each checkpointed) against no remat, "
        f"config.QUALITY 16x8: six gradients bitwise equal; peak device "
        f"memory of the phase {out['peak_gb']:.2f} GB on {card()}")
    dist.destroy_process_group()
    return out


def ring_two_rank_worker(rank: int, port: int, out: str) -> None:
    """Phase 50's rank ``rank`` of two sharing card 0 on gloo: the ring's
    frames and gradients (twice) on procedural_scene(RING_T), three
    ``ring_train_step`` steps on the wall-and-light scene, the resident
    shard's rows, a rotation's ms through host memory and the peak device
    memory, saved for the parent to check."""
    import torch
    import torch.distributed as dist

    from spath_tpu_torch import parallel
    from spath_tpu_torch.camera import Camera
    from spath_tpu_torch.config import RenderConfig
    from spath_tpu_torch.parallel import ring
    from spath_tpu_torch.scene import Scene, procedural_scene

    parallel.init_multihost(f"localhost:{port}", 2, rank, backend="gloo")
    dev = torch.device("cuda", 0)
    mesh = parallel.make_mesh(2, axis="shard")
    cam = Camera.default(dev)
    scene = procedural_scene(RING_T, seed=0, device=dev)
    torch.cuda.reset_peak_memory_stats()
    res = {"backend": mesh.backend, "ms": {}}
    for name, cfg, _, _ in ring_cases(torch, dev):
        zero_counts(every_kernel())
        t0 = time.perf_counter()
        res[f"frame/{name}"] = ring.render_pt_ring(scene, cam, cfg, mesh,
                                                   0).cpu()
        res["ms"][name] = (time.perf_counter() - t0) * 1e3
        res[f"launches/{name}"] = {k: v for k, v in
                                   counts(every_kernel()).items() if v}
    for name, cfg, _, _ in ring_cases(torch, dev)[::2]:
        cfg = cfg.replace(spp=RING_GRAD_SPP)
        zero_counts(every_kernel())
        grads = ring_grads(torch, scene, cam, cfg, mesh)
        res[f"grad_launches/{name}"] = {k: v for k, v in
                                        counts(every_kernel()).items() if v}
        again = ring_grads(torch, scene, cam, cfg, mesh)
        res[f"grad/{name}"] = [g.cpu() for g in grads]
        res[f"again/{name}"] = all(torch.equal(a, b)
                                   for a, b in zip(grads, again))
    table = ring._ring_table(scene, ring_cases(torch, dev)[1][1], mesh.size)
    shard = table[:table.shape[0] // mesh.size].contiguous()
    res["shard_rows"] = shard.shape[0]
    mesh.shift(shard)
    res["shift_ms"] = host_ms(torch, lambda: mesh.shift(shard), 10)
    wall = wall_and_light_scene(dev)
    cfg = RenderConfig(**RING_FRAME)
    target = ring.render_radiance_ring(wall, cam, cfg, mesh, 0)
    state = Scene(wall.vertices, (wall.albedo + 0.25).clamp(0.0, 1.0),
                  wall.emission, wall.light_idx)
    losses = []
    for _ in range(RING_TRAIN_STEPS):
        loss, state = ring.ring_train_step(state, cam, cfg, mesh, target, 0,
                                           RING_TRAIN_LR)
        losses.append(loss.item())
    res["losses"], res["trained_albedo"] = losses, state.albedo.cpu()
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.save(res, f"{out}/rank{rank}.pt")
    dist.destroy_process_group()


def ring_two_rank_phase(torch, dev, one: dict) -> dict:
    """Phase 50: two ranks sharing the card on gloo (``ring_two_rank_worker``,
    spawned as phase 48's): both ranks' frames bit-equal to phase 49's
    one-device frames, the gradients within GRAD_RTOL of each group's max
    of one device's and bitwise equal across the ranks and over two runs,
    each call launching its kernels only; three ``ring_train_step`` steps
    lower the loss, the same on both ranks."""
    import torch.multiprocessing as mp

    torch.cuda.empty_cache()            # the ranks share the card
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.spawn(ring_two_rank_worker, args=(free_port(), tmp), nprocs=2,
                 join=True)
        spawn_s = time.perf_counter() - t0
        res = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
               for r in range(2)]
    out = {"spawn_s": spawn_s, "launches": {}, "grad_launches": {}}
    for name, cfg, fwd, grad in ring_cases(torch, dev):
        shape = f"{cfg.width}x{cfg.height} spp{cfg.spp}"
        for rank, r in enumerate(res):
            check(r["backend"] == "gloo", f"rank {rank}: {r['backend']}")
            check(set(r[f"launches/{name}"]) == fwd, f"rank {rank}, ring "
                  f"{name}: launched {r[f'launches/{name}']}, want "
                  f"{sorted(fwd)}")
            check(torch.equal(r[f"frame/{name}"], one["frames"][name]),
                  f"rank {rank}, ring {name} {shape}: the frame differs "
                  "from one device's")
        out["launches"][name] = res[0][f"launches/{name}"]
        log(f"[50] two ranks on one card (gloo), render_pt_ring {name}, "
            f"procedural_scene({RING_T}) {shape}: both frames bit-equal to "
            f"one device's; ms by rank (host clock) "
            f"{[r['ms'][name] for r in res]}; {out['launches'][name]} a "
            f"rank")
    for name, cfg, fwd, grad in ring_cases(torch, dev)[::2]:
        errs = {}
        for rank, r in enumerate(res):
            check(set(r[f"grad_launches/{name}"]) == grad, f"rank {rank}, "
                  f"ring {name} gradient: launched "
                  f"{r[f'grad_launches/{name}']}, want {sorted(grad)}")
            check(r[f"again/{name}"], f"rank {rank}, ring {name}: two "
                  "gradients differ")
            errs = grads_close(torch, r[f"grad/{name}"], one["grads"][name],
                               f"rank {rank}, ring {name}")
        for group, a, b in zip(SHARD_GROUPS, res[0][f"grad/{name}"],
                               res[1][f"grad/{name}"]):
            check(torch.equal(a, b), f"ring {name}: the ranks' {group} "
                  "gradients differ")
        out["grad_launches"][name] = res[0][f"grad_launches/{name}"]
        log(f"[50] two ranks, render_radiance_ring's six gradients, {name} "
            f"at {RING_GRAD_SPP} spp: bitwise equal across the ranks and two "
            f"runs, against one device (share of each group's max) {errs}; "
            f"{out['grad_launches'][name]} a rank")
    losses = [r["losses"] for r in res]
    check(losses[0] == losses[1] and losses[0][-1] < losses[0][0]
          and torch.equal(res[0]["trained_albedo"], res[1]["trained_albedo"]),
          f"{RING_TRAIN_STEPS} ring_train_step steps: losses {losses}")
    out.update(losses=losses[0], spawn_s=spawn_s,
               shard_rows=[r["shard_rows"] for r in res],
               shift_ms=[r["shift_ms"] for r in res],
               peak_gb=[r["peak_gb"] for r in res])
    log(f"[50] {RING_TRAIN_STEPS} ring_train_step steps (lr "
        f"{RING_TRAIN_LR}) on the wall-and-light scene at "
        f"{RING_FRAME['width']}x{RING_FRAME['height']} spp"
        f"{RING_FRAME['spp']} from the albedo raised by 0.25: losses "
        f"{losses[0]}, the same on both ranks")
    log(f"[50] by rank, on {card()}: resident table rows {out['shard_rows']} "
        f"(of {RING_T}), a rotation of the 17-column shard through host "
        f"memory {out['shift_ms']} ms (host clock, 10 calls), peak device "
        f"memory {out['peak_gb']} GB; spawn to exit {spawn_s:.2f} s")
    return out


#: Phase 51's cells: the default scene at the headline (K1; K1+K2; the
#: light distribution and K3; and K4), procedural_scene(BIG_T) at
#: 1920x1080, 8 spp conformance (K6; K6+K8+K7) and 4 spp quality (K9;
#: K9+K10+K7), cut for time as PERF.md section 4 cuts the training cells,
#: and the compacted wavefront on config.QUALITY at 1920x1080, 8 spp (K5,
#: the light distribution, the threefry kernel)
COMPACT_BIG = dict(width=1920, height=1080, spp=8, max_bounces=5)
COMPACT_BIG_Q = dict(width=1920, height=1080, spp=4, max_bounces=5)
COMPACT_PRESET = dict(width=1920, height=1080, spp=8, max_bounces=5)
#: the render_any / get_renderer check's frame
COMPACT_SMALL = dict(width=320, height=240, spp=8, max_bounces=5)


def compact_cases(torch, dev) -> list:
    """``(route, scene, cfg, full forward, full gradient, forward kernels,
    gradient kernels, plain)`` of the four kernel routes phase 51
    compacts; ``plain(cam)`` is the plain version's frame rows and the
    rows of the frame it covers (the whole frame on the default scene,
    rows BAND_ROWS at 10k)."""
    from spath_tpu_torch.config import RenderConfig
    from spath_tpu_torch.ops.kernels import bigscene as bs
    from spath_tpu_torch.ops.kernels import bigscene_grad as bg
    from spath_tpu_torch.ops.kernels import bigscene_quality as bq
    from spath_tpu_torch.ops.kernels import bigscene_quality_grad as bqg
    from spath_tpu_torch.ops.kernels import megakernel as mk
    from spath_tpu_torch.ops.kernels import megakernel_grad as mg
    from spath_tpu_torch.ops.kernels import megakernel_quality as mq
    from spath_tpu_torch.ops.kernels import megakernel_quality_grad as mqg
    from spath_tpu_torch.scene import default_scene, procedural_scene

    dscene = default_scene(dev)
    ten_k = procedural_scene(BIG_T, seed=0, device=dev)

    def conformance_plain(scene, cfg, band):
        def plain(cam):
            o, d, seeds = mk.pack_rays(cam, cfg, 0)
            rays = rows_of(torch, cfg.width, BAND_ROWS, o, d, seeds) \
                if band else (o, d, seeds)
            with plain_sweep():
                return mk.megakernel_plain(*rays, mk.scene_table(scene),
                                           cfg.replace(tri_block=2048))
        return plain

    def quality_plain(scene, cfg, band, light_rows):
        def plain(cam):
            o, d, keys = mq.pack_rays(cam, cfg, 0)
            rays = rows_of(torch, cfg.width, BAND_ROWS, o, d, keys) \
                if band else (o, d, keys)
            with plain_sweep():
                return mq.quality_plain(*rays, mq.quality_table(scene),
                                        light_rows(scene),
                                        cfg.replace(tri_block=2048))
        return plain

    conf = RenderConfig(**HEADLINE)
    qual = RenderConfig(**HEADLINE, **QUALITY)
    big = RenderConfig(**COMPACT_BIG)
    bigq = RenderConfig(**COMPACT_BIG_Q, **QUALITY)
    return [
        ("conformance", dscene, conf, mk.render_radiance_megakernel,
         mg.render_radiance_mega, {"K1"}, {"K1", "K2"},
         conformance_plain(dscene, conf, False)),
        ("quality", dscene, qual, mq.render_radiance_quality_megakernel,
         mqg.render_radiance_quality_grad, {"light", "K3"},
         {"light", "K3", "K4"},
         quality_plain(dscene, qual, False, mq.light_rows)),
        ("bigscene", ten_k, big, bs.render_radiance_bigscene,
         bg.render_radiance_bigscene_grad, {"K6"}, {"K6", "K8", "K7"},
         conformance_plain(ten_k, big, True)),
        ("bigscene_quality", ten_k, bigq,
         bq.render_radiance_bigscene_quality,
         bqg.render_radiance_bigscene_quality_grad, {"light", "K9"},
         {"light", "K9", "K10", "K7"},
         quality_plain(ten_k, bigq, True, bq.light_rows)),
    ]


def leaf_grads(torch, render, leaves, light_idx, cfg, weights) -> list:
    """The gradients of ``sum(weights * render)`` in ``leaves`` (the
    scene's vertices, albedo, emission, the camera's position, angles and
    focal length); zeros where the render does not reach a leaf."""
    from spath_tpu_torch.camera import Camera
    from spath_tpu_torch.scene import Scene

    img = render(Scene(*leaves[:3], light_idx), Camera(*leaves[3:]), cfg, 0)
    got = torch.autograd.grad((img * weights).sum(), leaves,
                              allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for g, t in zip(got, leaves)]


def compact_turns(torch, full, compact, reps: int) -> dict:
    """Full, compacted, compacted, full after a call of each, CUDA events
    over ``reps`` calls each; ``pays``: both compacted times under both
    full ones."""
    full()
    compact()
    full_ms = [event_ms(torch, full, reps)]
    compact_ms = [event_ms(torch, compact, reps),
                  event_ms(torch, compact, reps)]
    full_ms.append(event_ms(torch, full, reps))
    return dict(full_ms=full_ms, compact_ms=compact_ms,
                pays=max(compact_ms) < min(full_ms))


def key_timing(torch, scene, cam, cfg, reps: int = 3) -> dict:
    """Host ms of the plan cache's two lookups on ``scene``: the fast key
    (``compact_fast.has_plan``) and the value key (``_value_key``), each
    ``reps`` times after a sync."""
    from spath_tpu_torch.models import compact_fast as cf

    def timed(fn) -> list:
        ms = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms

    tensors = cf._inputs(scene, cam)
    return dict(fast_ms=timed(lambda: cf.has_plan(scene, cam, cfg)),
                value_ms=timed(lambda: cf._value_key(tensors, cfg)),
                vertex_mb=scene.vertices.numel() * 4 / 1e6)


def compaction_phase(torch, dev, cam) -> dict:
    """Phase 51: camera-ray compaction (``models/compact_fast.py``) on
    every kernel route, against the full launch, and the compacted
    wavefront against the wavefront; the all-miss view; ``render_any``
    and ``get_renderer``; each compacted route timed in turns with the
    full launch, the plan cached, and its first call with the plan build
    apart. The routing rule's own choice is logged beside the timings."""
    from spath_tpu_torch.camera import Camera
    from spath_tpu_torch.config import QUALITY as PRESET
    from spath_tpu_torch.config import RenderConfig
    from spath_tpu_torch.convert import camera_from_numpy
    from spath_tpu_torch.models import compact_fast as cf
    from spath_tpu_torch.models import pathtracer, renderer
    from spath_tpu_torch.models.pathtracer import render_pt_fast
    from spath_tpu_torch.scene import Scene, default_scene, procedural_scene

    out = {"launches": {}, "grad_launches": {}, "routes": {}}
    for (name, scene, cfg, full_fwd, full_grad, fwd_k, grad_k,
         plain) in compact_cases(torch, dev):
        shape = f"{cfg.width}x{cfg.height} spp{cfg.spp}"
        n = cfg.width * cfg.height
        big = scene.n_tris > 7
        reps = 1 if big else 5
        cf._PLAN_CACHE.clear()
        plan_ms = [event_ms(torch, lambda: cf.make_compact_plan(
            scene, cam, cfg), 1) for _ in range(2)]
        zero_counts(every_kernel())
        t0 = time.perf_counter()
        got = cf.render_radiance_compact_fused(scene, cam, cfg, 0)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        first_launches = launched_set(fwd_k | {"K5"},
                                      f"the compacted {name} first call")
        plan = cf._cached_plan(scene, cam, cfg)
        zero_counts(every_kernel())
        again = cf.render_radiance_compact_fused(scene, cam, cfg, 0)
        torch.cuda.synchronize()
        out["launches"][name] = launched_set(
            fwd_k, f"the compacted {name} call, plan cached")
        want = full_fwd(scene, cam, cfg, 0)
        check(torch.equal(got, want) and torch.equal(again, want),
              f"{name} {shape}: the compacted frame differs from the full "
              "launch's")
        rows = got[BAND_ROWS.start:BAND_ROWS.stop] if big else got
        band = plain(cam)
        check(torch.equal(rows.reshape(-1, 3), band), f"{name} {shape}: "
              "the compacted frame differs from the plain version's")
        check(torch.isfinite(got).all().item() and got.mean().item() > 1e-3,
              f"{name} {shape}: the compacted frame is not finite or black")
        fwd_t = compact_turns(
            torch, lambda: full_fwd(scene, cam, cfg, 0),
            lambda: cf.render_radiance_compact_fused(scene, cam, cfg, 0),
            reps)
        # the rule: on this camera, whose plan is cached, compaction
        # where the card measured it faster; on an equal camera built
        # anew, whose plan is not, the full launch (before the gradients'
        # cloned leaves take the plan's entry)
        rule = (serving_route(scene, cam, cfg), grad_route(scene, cam, cfg))
        fresh = Camera(cam.pos.clone(), cam.angle.clone(), cam.focal.clone())
        cold = (serving_route(scene, fresh, cfg),
                grad_route(scene, fresh, cfg))
        full_name = renderer.KERNEL_RENDERERS[name].name
        check(rule == tuple(
            "compact_fused" if name in routes else full_name for routes in
            (renderer.COMPACT_ROUTES, renderer.COMPACT_GRAD_ROUTES)),
            f"{name} {shape}: the rule routes the cached plan's calls to "
            f"{rule}")
        check(cold == (full_name, full_name), f"{name} {shape}: the rule "
              f"routes a call with no cached plan to {cold}")
        zero_counts(every_kernel())
        served = render_pt_fast(scene, cam, cfg, 0)
        torch.cuda.synchronize()
        launched_set(fwd_k, f"render_pt_fast on {name}, routed to {rule[0]}")
        check(torch.equal(served, torch.clamp(want, 0.0, 1.0)),
              f"{name} {shape}: render_pt_fast differs from the full launch")
        if name == "bigscene":
            keys = {BIG_T: key_timing(torch, scene, cam, cfg)}
        weights = shard_weights(torch, cfg, dev)
        leaves = [t.detach().clone().requires_grad_() for t in (
            scene.vertices, scene.albedo, scene.emission, cam.pos,
            cam.angle, cam.focal)]
        zero_counts(every_kernel())
        g1 = leaf_grads(torch, cf.render_radiance_compact_grad, leaves,
                            scene.light_idx, cfg, weights)
        torch.cuda.synchronize()
        out["grad_launches"][name] = launched_set(
            grad_k, f"the compacted {name} gradient")
        g2 = leaf_grads(torch, cf.render_radiance_compact_grad, leaves,
                            scene.light_idx, cfg, weights)
        for group, a, b in zip(SHARD_GROUPS, g1, g2):
            check(torch.equal(a, b), f"{name} {shape}: two compacted "
                  f"{group} gradients on one seed differ")
        gf = leaf_grads(torch, full_grad, leaves, scene.light_idx, cfg,
                            weights)
        errs = grads_close(torch, g1, gf, f"the compacted {name} gradient")
        grad_t = compact_turns(
            torch,
            lambda: leaf_grads(torch, full_grad, leaves,
                                   scene.light_idx, cfg, weights),
            lambda: leaf_grads(torch, cf.render_radiance_compact_grad,
                                   leaves, scene.light_idx, cfg, weights),
            reps if not big else 1)
        out["routes"][name] = dict(
            n_live=plan.n_live, live_share=plan.n_live / n,
            plan_ms=plan_ms, first_ms=first_ms,
            first_launches=first_launches, forward=fwd_t, gradient=grad_t,
            grad_err_share=errs, rule=rule)
        log(f"[51] compacted {name}, {scene.n_tris} triangles, {shape}, on "
            f"{card()}: n_live {plan.n_live} of {n} "
            f"({plan.n_live / n:.4f}); plan build {plan_ms} ms; first call "
            f"with its plan {first_ms:.3f} ms ({first_launches}); frame "
            f"bit-equal to the full launch's and the plain version's "
            f"({out['launches'][name]}); forward ms in turns full "
            f"{fwd_t['full_ms']} compacted {fwd_t['compact_ms']} (pays "
            f"{fwd_t['pays']}); gradient within {errs} of each max, "
            f"bitwise over two calls ({out['grad_launches'][name]}); "
            f"forward+backward ms full {grad_t['full_ms']} compacted "
            f"{grad_t['compact_ms']} (pays {grad_t['pays']}); the rule "
            f"routes forward to {rule[0]}, gradient to {rule[1]} (with no "
            f"cached plan to {cold[0]}, {cold[1]}); render_pt_fast on the "
            f"cached plan launched its kernels only, equal to the full launch")
        del got, again, want, g1, g2, gf, leaves, weights, served

    # the plan cache's lookups: the fast key, and the value key (a sync,
    # the vertices and camera to the host, a SHA1) that a new Scene or
    # Camera, or an in-place change, pays on a compacted call by name
    cfg = RenderConfig(**COMPACT_BIG)
    keys[1 << 20] = key_timing(
        torch, procedural_scene(1 << 20, seed=0, device=dev), cam, cfg)
    out["keys"] = keys
    log(f"[51] the plan cache's keys, host ms over three calls each, on "
        f"{card()}: " + "; ".join(
            f"{t} triangles ({k['vertex_mb']:.1f} MB of vertices) fast key "
            f"{k['fast_ms']}, value key {k['value_ms']}"
            for t, k in keys.items()))

    # the compacted wavefront on config.QUALITY: K5, light, threefry
    dscene = default_scene(dev)
    cfg = PRESET.replace(**COMPACT_PRESET)
    wave = {"K5", "light", "threefry"}
    zero_counts(every_kernel())
    got = pathtracer.render_radiance_compact(dscene, cam, cfg, 0)
    torch.cuda.synchronize()
    out["launches"]["wavefront, config.QUALITY"] = launched_set(
        wave, "the compacted wavefront")
    zero_counts(every_kernel())
    want = pathtracer.render_radiance(dscene, cam, cfg, 0)
    torch.cuda.synchronize()
    full_launches = launched_set(wave, "the wavefront")
    check(torch.equal(got, want), "config.QUALITY: the compacted "
          "wavefront's frame differs from the wavefront's")
    wave_t = compact_turns(
        torch, lambda: pathtracer.render_radiance(dscene, cam, cfg, 0),
        lambda: pathtracer.render_radiance_compact(dscene, cam, cfg, 0), 1)
    out["routes"]["wavefront, config.QUALITY"] = dict(
        forward=wave_t, full_launches=full_launches,
        rule=renderer.forward_renderer(dscene, cfg,
                                       require_jittable=False).name)
    log(f"[51] compacted wavefront, config.QUALITY, 1920x1080 spp"
        f"{cfg.spp}, on {card()}: frame bit-equal to the wavefront's; "
        f"launches {out['launches']['wavefront, config.QUALITY']} against "
        f"{full_launches}; ms in turns full {wave_t['full_ms']} compacted "
        f"{wave_t['compact_ms']} (pays {wave_t['pays']}); the rule routes "
        f"it to {out['routes']['wavefront, config.QUALITY']['rule']}")
    del got, want

    # the all-miss view: zeros, and no kernel past the plan's sweep
    away = camera_from_numpy((0.0, 0.0, -50.0), (0.0, 3.14159265, 0.0), 2.0,
                             device=dev)
    cfg = RenderConfig(**HEADLINE)
    zero_counts(every_kernel())
    check(cf._cached_plan(dscene, away, cfg).n_live == 0,
          "the all-miss view has live rays")
    launched_set({"K5"}, "the all-miss plan")
    zero_counts(every_kernel())
    zeros = torch.zeros((cfg.height, cfg.width, 3), device=dev)
    check(torch.equal(cf.render_radiance_compact_fused(dscene, away, cfg),
                      zeros), "the all-miss view is not zeros")
    albedo = dscene.albedo.clone().requires_grad_()
    img = cf.render_radiance_compact_grad(
        Scene(dscene.vertices, albedo, dscene.emission, dscene.light_idx),
        away, cfg)
    (g,) = torch.autograd.grad(img.sum(), [albedo])
    check(torch.equal(img.detach(), zeros) and not g.any().item(),
          "the all-miss gradient is not zeros")
    torch.cuda.synchronize()
    launched_set(set(), "the all-miss view")
    zero_counts(every_kernel())
    check(torch.equal(pathtracer.render_radiance_compact(dscene, away, cfg),
                      zeros), "the compacted wavefront's all-miss view is "
          "not zeros")
    launched_set({"K5"}, "the compacted wavefront's all-miss view")
    log("[51] the all-miss view (camera at z=-50 facing away): zeros, "
        "forward and gradient with no kernel launch past the plan's K5 "
        "sweep; the compacted wavefront launches its first-hit K5 only")

    # render_any and get_renderer reach the kernels by name
    cfg = RenderConfig(**COMPACT_SMALL)
    cf._PLAN_CACHE.clear()
    zero_counts(every_kernel())
    img = renderer.render_any(dscene, cam, cfg, 0, backend="compact_fused")
    torch.cuda.synchronize()
    by_name = launched_set({"K5", "K1"}, "render_any(backend=compact_fused)")
    check(torch.equal(img, renderer.get_renderer("megakernel").render(
        dscene, cam, cfg, 0)), "render_any(backend=compact_fused) differs "
        "from the full launch")
    leaves = [dscene.albedo.clone().requires_grad_()]
    zero_counts(every_kernel())
    img = renderer.get_renderer("compact_fused").render_radiance_grad(
        Scene(dscene.vertices, leaves[0], dscene.emission,
              dscene.light_idx), cam, cfg, 0)
    torch.autograd.grad(img.sum(), leaves)
    torch.cuda.synchronize()
    by_name_grad = launched_set({"K1", "K2"},
                                "get_renderer(compact_fused)'s gradient")
    zero_counts(every_kernel())
    img = renderer.render_any(dscene, cam, cfg, 0, backend="compact")
    torch.cuda.synchronize()
    launched_set({"K5"}, "render_any(backend=compact)")
    with plain_sweep():
        check(torch.equal(img, pathtracer.render_pt(dscene, cam, cfg, 0)),
              "render_any(backend=compact) differs from the plain "
              "wavefront")
    auto = serving_route(dscene, cam, RenderConfig(**HEADLINE))
    out["by_name"] = dict(compact_fused=by_name, grad=by_name_grad,
                          auto_headline=auto)
    log(f"[51] render_any(backend='compact_fused') at 320x240 spp8: "
        f"{by_name}, equal to the full launch; get_renderer('compact_fused')"
        f"'s gradient: {by_name_grad}; render_any(backend='compact'): K5 "
        f"only, equal to the plain wavefront; render_any at the headline "
        f"takes {auto}")
    return out


def run() -> None:
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    from spath_tpu_torch.camera import Camera
    from spath_tpu_torch.config import RenderConfig
    from spath_tpu_torch.models.pathtracer import render_pt, render_pt_fast
    from spath_tpu_torch.ops.kernels import build
    from spath_tpu_torch.ops.kernels import megakernel as mk
    from spath_tpu_torch.scene import default_scene, procedural_scene
    from spath_tpu_torch.utils.image import read_png

    dev = torch.device("cuda", 0)
    smi = card()
    log(f"[1] device: {torch.cuda.get_device_name(0)} | {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in
             (build.BUILD_DIR / "build.log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    log(f"[1] kernels built in {build_s:.2f} s; " + " | ".join(ptxas))

    # 2. kernel vs plain on the same rays
    cam = Camera.default(dev)
    small = RenderConfig(width=320, height=240, spp=8, max_bounces=5)
    for name, scene in (("default", default_scene(dev)),
                        ("25 triangles", scene_25(dev))):
        o, d, seeds = mk.pack_rays(cam, small, 0)
        tri = mk.scene_table(scene)
        got = mk.mega_call(o, d, seeds, tri, small)
        torch.cuda.synchronize()
        want = mk.megakernel_plain(o, d, seeds, tri, small)
        c = check_against_plain(torch, got, want, name)
        check(c["bit_exact"], f"K1 on {name}: not bit-equal to "
              "megakernel_plain")
        log(f"[2] kernel vs plain, {name}, 320x240 spp8: {c}")

    # 3. the serving path at full width, through the kernel
    scene = default_scene(dev)
    cfg = RenderConfig(**HEADLINE)
    mk.mega_call.launches = 0
    t0 = time.perf_counter()
    img = render_pt_fast(scene, cam, cfg, 0)
    torch.cuda.synchronize()
    slice_first_s = time.perf_counter() - t0
    launches = mk.mega_call.launches
    check(launches > 0, "render_pt_fast did not launch the CUDA kernel")
    check(tuple(img.shape) == (cfg.height, cfg.width, 3),
          f"shape {tuple(img.shape)}")
    check(torch.isfinite(img).all().item(), "frame not finite")
    check(img.min().item() >= 0.0 and img.max().item() <= 1.0,
          "frame outside [0, 1]")
    t0 = time.perf_counter()
    with plain_sweep():
        plain = render_pt(scene, cam, cfg, 0)
    torch.cuda.synchronize()
    plain_first_s = time.perf_counter() - t0
    m, pm = img.mean().item(), plain.mean().item()
    flipped = ((img - plain).abs() > FLIP_ATOL).any(-1).float().mean().item()
    frame = f"{cfg.width}x{cfg.height} spp{cfg.spp}"
    log(f"[3] render_pt_fast {frame}: {launches} launch(es), "
        f"first call {slice_first_s:.3f} s, mean {m:.6f}; plain render_pt "
        f"{plain_first_s:.3f} s, mean {pm:.6f}; pixels off >1e-4: "
        f"{flipped:.6f}; bit-exact {torch.equal(img, plain)}")
    check(torch.equal(img, plain), f"the {frame} frame through K1 is not "
          "bit-equal to the plain wavefront's")
    check(flipped < FLIP_MAX, f"{flipped:.6f} of the frame's pixels differ "
          "from the plain wavefront")
    check(abs(m - pm) <= SLICE_MEAN_RTOL * abs(pm), "slice mean differs "
          "from the plain wavefront")
    check(m > 0.01, "frame is black")

    # 4. the CLI
    from spath_tpu_torch import cli

    w, h = CLI_SIZE
    with tempfile.TemporaryDirectory() as tmp:
        pt_png, flat_png = Path(tmp) / "pt.png", Path(tmp) / "flat.png"
        check(cli.main(["render", "--size", f"{w}x{h}", "--spp", "16",
                        "--out", str(pt_png)]) == 0, "cli render failed")
        check(cli.main(["render", "--size", f"{w}x{h}", "--flat",
                        "--out", str(flat_png)]) == 0, "cli --flat failed")
        check(pt_png.is_file() and flat_png.is_file(), "PNG missing")
        pt_img, flat_img = read_png(str(pt_png)), read_png(str(flat_png))
        check(pt_img.shape == (h, w, 3) and pt_img.max() > 200,
              "path-traced PNG is wrong")
        for colour in ([255, 0, 0], [255, 255, 255], [0, 0, 0]):
            check((flat_img == colour).all(-1).any(),
                  f"flat PNG lacks {colour}")
    log(f"[4] cli render and render --flat wrote {w}x{h} PNGs")

    # 5. at 1080p64: kernel vs plain on the main path's rays, then timing
    # in turns: plain, kernel, kernel, plain
    o, d, seeds = mk.pack_rays(cam, cfg, 0)
    tri = mk.scene_table(scene)
    got = mk.mega_call(o, d, seeds, tri, cfg)
    torch.cuda.synchronize()
    want = mk.megakernel_plain(o, d, seeds, tri, cfg)
    headline = check_against_plain(torch, got, want, frame)
    check(headline["bit_exact"], f"K1's {frame} frame is not bit-equal to "
          "megakernel_plain's")
    log(f"[5] kernel vs plain, default scene, {frame}: {headline}")
    del got, want

    def kernel():
        mk.mega_call(o, d, seeds, tri, cfg)

    def plain_fn():
        mk.megakernel_plain(o, d, seeds, tri, cfg)

    plain_ms = [event_ms(torch, plain_fn, 1)]
    kernel_ms = [event_ms(torch, kernel, 5), event_ms(torch, kernel, 5)]
    plain_ms.append(event_ms(torch, plain_fn, 1))
    slice_ms = event_ms(torch, lambda: render_pt_fast(scene, cam, cfg, 0), 3)
    k_ms, p_ms = sum(kernel_ms) / 2, sum(plain_ms) / 2
    segs = cfg.width * cfg.height * cfg.spp * cfg.max_bounces
    log(f"[5] {frame} {cfg.max_bounces} bounces on {smi}: kernel "
        f"{kernel_ms} ms, "
        f"plain {plain_ms} ms, render_pt_fast {slice_ms:.3f} ms (route "
        f"{serving_route(scene, cam, cfg)}); "
        f"kernel {segs / (k_ms / 1e3):.4e} rays/s, plain "
        f"{segs / (p_ms / 1e3):.4e} rays/s, serving path "
        f"{segs / (slice_ms / 1e3):.4e} rays/s; build {build_s:.2f} s")
    check(k_ms > 0 and p_ms > 0, "timing failed")

    # 6. the backward kernel against its plain version
    from spath_tpu_torch.ops.kernels import megakernel_grad as mg

    for name, bscene in (("default", default_scene(dev)),
                         ("25 triangles", scene_25(dev))):
        c, _ = backward_vs_plain(torch, *mk.pack_rays(cam, small, 0),
                                 mk.scene_table(bscene), small, name)
        log(f"[6] K2 vs plain, {name}, 320x240 spp8: {c}")
    largest = RenderConfig(width=64, height=48, spp=2, max_bounces=5)
    c, _ = backward_vs_plain(
        torch, *mk.pack_rays(cam, largest, 0),
        mk.scene_table(procedural_scene(mg.GRAD_MAX_TRIS, seed=1,
                                        device=dev)),
        largest, f"{mg.GRAD_MAX_TRIS} triangles")
    log(f"[6] K2 vs plain, {mg.GRAD_MAX_TRIS} triangles, 64x48 spp2: {c}")
    bwd_headline, gbar = backward_vs_plain(torch, o, d, seeds, tri, cfg,
                                           frame)
    log(f"[6] K2 vs plain, default scene, {frame}: {bwd_headline}")

    # 7. the gradient entry point
    log(f"[7] render_radiance_fastgrad 320x240 spp8: "
        f"{gradient_entry(torch, dev, cam, default_scene(dev))}")

    # 8. the training slice at full width
    tr = training(torch, dev, cam, scene, cfg)
    log(f"[8] 3 train steps {frame} {cfg.max_bounces} bounces on {smi}: "
        f"launches {tr['launches']}, losses {tr['losses']}, "
        f"step s {[round(x, 6) for x in tr['step_s']]}; "
        f"render_radiance_fastgrad forward+backward {tr['fwd_bwd_ms']:.3f} "
        f"ms (route {tr['fwd_bwd_route']}), "
        f"{segs / (tr['fwd_bwd_ms'] / 1e3):.4e} rays/s")

    # 9. the CLI's invert
    log(f"[9] cli invert {CLI_SIZE[0]}x{CLI_SIZE[1]} spp16, 5 steps: "
        f"{cli_invert(cli)}")

    # 10. at 1080p64: K2 and its plain version timed in turns
    def backward():
        mg.mega_bwd_call(o, d, seeds, tri, gbar, cfg)

    def backward_plain():
        mg.mega_bwd_plain(o, d, seeds, tri, gbar, cfg)

    bplain_ms = [event_ms(torch, backward_plain, 1)]
    bkernel_ms = [event_ms(torch, backward, 3), event_ms(torch, backward, 3)]
    bplain_ms.append(event_ms(torch, backward_plain, 1))
    k2_ms, p2_ms = sum(bkernel_ms) / 2, sum(bplain_ms) / 2
    # the walk's work, from the plain replay
    n, n_tris = o.shape[0], tri.shape[0]
    walk10 = walk_counts(torch, o, d, seeds, tri, cfg)
    sweeps, hits = walk10["sweeps"], walk10["hits"]
    ray_bytes = n * (24 + 8) + n_tris * 18 * 4
    k1_ops = sweeps * n_tris * MT_OPS + hits * K1_HIT_OPS
    k2_ops = sweeps * n_tris * MT_OPS + hits * K2_HIT_OPS
    k1_bound = bound(k1_ops, ray_bytes + n * 12)
    k2_bound = bound(k2_ops, ray_bytes + n * 12 + n_tris * 18 * 4)
    conf_lanes = conformance_lane_counts(torch, o, d, seeds, tri, cfg)
    log(f"[10] K1's and K2's lanes on rows {list(COUNT_ROWS)}, {frame}: "
        f"{conf_lanes}")
    log(f"[10] a warp-wide cull in K1's lane loop on rows "
        f"{list(COUNT_ROWS)}: " + str(warp_cull_counts(
            torch, *rows_of(torch, cfg.width, COUNT_ROWS, o, d, seeds), tri,
            cfg)))
    log(f"[10] {frame} on {smi}: K2 {bkernel_ms} ms, plain {bplain_ms} ms; "
        f"K2 {segs / (k2_ms / 1e3):.4e} rays/s; the walk: {sweeps} sweeps, "
        f"{hits} hits; bound K1 {k1_bound[0]:.4f} ms, K2 "
        f"{k2_bound[0]:.4f} ms ({k1_bound[1]}); without FMA at "
        f"{NOFMA_OPS:.3g}/s: K1 {k1_ops / NOFMA_OPS * 1e3:.4f} ms, K2 "
        f"{k2_ops / NOFMA_OPS * 1e3:.4f} ms")
    check(k2_ms > 0 and p2_ms > 0, "timing failed")

    # 11. K3 against its plain version on the same rays and keys
    from spath_tpu_torch.ops.kernels import megakernel_quality as mq
    from spath_tpu_torch.ops.kernels import megakernel_quality_grad as mqg

    from spath_tpu_torch.ops.kernels import light_cdf as lc

    small_scenes = (("default", default_scene(dev)),
                    ("25 triangles", scene_25(dev)))
    big = procedural_scene(mq.MAX_TRIS, seed=1, device=dev)
    dark = default_scene(dev)
    for name, lscene in (*small_scenes, (f"{mq.MAX_TRIS} triangles", big),
                         ("all dark", dataclasses.replace(
                             dark, emission=torch.zeros_like(dark.emission))),
                         ("wall and light", wall_and_light_scene(dev))):
        log(f"[11] light distribution vs plain, {name}: "
            f"{light_cdf_vs_plain(torch, lscene, name)}")
    for n_light in LIGHT_SMALL_T:
        log(f"[11] light distribution vs plain, {n_light} triangles: "
            f"{light_vs_plain(torch, *light_inputs(torch, dev, n_light,
                                                   n_light),
                              f'{n_light} triangles')}")
    for name, qscene in small_scenes:
        for label, est in QUALITY_GRID:
            qcfg = small.replace(**est)
            c = quality_vs_plain(torch, cam, qscene, qcfg,
                                 f"K3 {name} {label}")
            log(f"[11] K3 vs plain, {name}, {label}, 320x240 spp8: {c}")
    big_cfg = largest.replace(**QUALITY)
    c = quality_vs_plain(torch, cam, big, big_cfg,
                         f"K3 {mq.MAX_TRIS} triangles")
    log(f"[11] K3 vs plain, {mq.MAX_TRIS} triangles "
        f"({len(big.light_idx)} lights), 64x48 spp2: {c}")

    # 12. the quality serving path at full width, through K3
    qcfg = cfg.replace(**QUALITY)
    mq.quality_call.launches = lc.light_cdf_call.launches = 0
    t0 = time.perf_counter()
    qimg = render_pt_fast(scene, cam, qcfg, 0)
    torch.cuda.synchronize()
    q_first_s = time.perf_counter() - t0
    q_launches = mq.quality_call.launches
    l_launches = lc.light_cdf_call.launches
    check(q_launches > 0 and l_launches > 0, f"render_pt_fast launched the "
          f"light distribution kernel {l_launches} and K3 {q_launches} times")
    check(tuple(qimg.shape) == (cfg.height, cfg.width, 3),
          f"shape {tuple(qimg.shape)}")
    check(torch.isfinite(qimg).all().item(), "quality frame not finite")
    t0 = time.perf_counter()
    with plain_sweep():
        qplain = render_pt(scene, cam, qcfg, 0)
    torch.cuda.synchronize()
    qplain_s = time.perf_counter() - t0
    m, pm = qimg.mean().item(), qplain.mean().item()
    flipped = ((qimg - qplain).abs() > FLIP_ATOL).any(-1).float().mean().item()
    log(f"[12] render_pt_fast quality {frame}: K3 {q_launches} and light "
        f"distribution {l_launches} launch(es), "
        f"first call {q_first_s:.3f} s, mean {m:.6f}; plain render_pt "
        f"{qplain_s:.3f} s, mean {pm:.6f}; pixels off >1e-4: {flipped:.6f}; "
        f"bit-exact {torch.equal(qimg, qplain)}")
    check(flipped < FLIP_MAX, f"{flipped:.6f} of the quality frame's pixels "
          "differ from the plain wavefront")
    check(abs(m - pm) <= SLICE_MEAN_RTOL * abs(pm), "quality slice mean "
          "differs from the plain wavefront")
    check(m > 0.01, "quality frame is black")
    del qimg, qplain

    # 13. K4 against its plain version
    for name, qscene in small_scenes:
        for label, est in QUALITY_GRID:
            qs = small.replace(**est)
            c, _ = quality_backward_vs_plain(
                torch, *mq.pack_rays(cam, qs, 0), mq.quality_table(qscene),
                mq.light_rows(qscene), qs, f"K4 {name} {label}")
            log(f"[13] K4 vs plain, {name}, {label}, 320x240 spp8: {c}")
    c, _ = quality_backward_vs_plain(
        torch, *mq.pack_rays(cam, big_cfg, 0), mq.quality_table(big),
        mq.light_rows(big), big_cfg, f"K4 {mq.MAX_TRIS} triangles")
    log(f"[13] K4 vs plain, {mq.MAX_TRIS} triangles, 64x48 spp2: {c}")
    qo, qd, qkeys = mq.pack_rays(cam, qcfg, 0)
    qtri, qrows = mq.quality_table(scene), mq.light_rows(scene)
    qbwd_headline, qgbar = quality_backward_vs_plain(
        torch, qo, qd, qkeys, qtri, qrows, qcfg, f"K4 {frame}")
    log(f"[13] K4 vs plain, default scene, quality {frame}: {qbwd_headline}")
    got = mq.quality_call(qo, qd, qkeys, qtri, qrows, qcfg)
    torch.cuda.synchronize()
    want = mq.quality_plain(qo, qd, qkeys, qtri, qrows, qcfg)
    qheadline = check_against_plain(torch, got, want, f"K3 {frame}")
    check(torch.equal(got, want), f"K3's {frame} frame is not bit-equal to "
          "quality_plain's")
    log(f"[13] K3 vs plain, default scene, quality {frame}: {qheadline}; "
        "bit-equal")
    del got, want

    # 14. the quality gradient entry point
    log(f"[14] render_radiance_fastgrad quality 320x240 spp8: "
        f"{quality_gradient_entry(torch, dev, cam, default_scene(dev))}")

    # 15. the quality training slice at full width, pose free
    qtr = quality_training(torch, dev, cam, scene, qcfg)
    log(f"[15] 3 quality train steps {frame} {cfg.max_bounces} bounces, "
        f"pose group at rate {QUALITY_POSE_LR}, on {smi}: light distribution "
        f"{qtr['light']}, K3 {qtr['k3']} and K4 {qtr['k4']} launches, "
        f"losses {qtr['losses']}, step s "
        f"{[round(x, 6) for x in qtr['step_s']]}; camera gradient "
        f"{qtr['cam_grad']}; "
        f"render_radiance_fastgrad forward+backward {qtr['fwd_bwd_ms']:.3f} "
        f"ms (route {qtr['fwd_bwd_route']}), "
        f"{segs / (qtr['fwd_bwd_ms'] / 1e3):.4e} rays/s")
    log(f"[15] the camera moved {EDGE_MOVE} along x, quality {frame}: "
        f"{edge_witness(torch, cam, scene, qcfg)}")
    pose = pose_recovery(torch, dev, cam, qcfg)
    log(f"[15] pose recovery {frame}, silhouette-free scene, pose group "
        f"free at rate {POSE_RECOVERY_LR}: K3 {pose['k3']} and K4 "
        f"{pose['k4']} launches, losses {pose['losses']}, |z error| "
        f"{pose['z_err']}")

    # 16. the CLI in quality mode
    log(f"[16] cli --mode quality {CLI_SIZE[0]}x{CLI_SIZE[1]} spp16: "
        f"{quality_cli(cli)}")

    # 17. at 1080p64: K3 and K4 and their plain versions timed in turns
    def k3():
        mq.quality_call(qo, qd, qkeys, qtri, qrows, qcfg)

    def k3_plain():
        mq.quality_plain(qo, qd, qkeys, qtri, qrows, qcfg)

    def k4():
        mqg.quality_bwd_call(qo, qd, qkeys, qtri, qrows, qgbar, qcfg)

    def k4_plain():
        mqg.quality_bwd_plain(qo, qd, qkeys, qtri, qrows, qgbar, qcfg)

    timed = {}
    for key, fn, plain, reps in (("k3", k3, k3_plain, 5),
                                 ("k4", k4, k4_plain, 3)):
        plain_times = [event_ms(torch, plain, 1)]
        times = [event_ms(torch, fn, reps), event_ms(torch, fn, reps)]
        plain_times.append(event_ms(torch, plain, 1))
        timed[key] = (times, plain_times)
        check(min(times) > 0 and min(plain_times) > 0, "timing failed")
    q_slice_ms = event_ms(torch, lambda: render_pt_fast(scene, cam, qcfg, 0),
                          3)
    walk = quality_walk_counts(torch, qo, qd, qkeys, qtri, qrows, qcfg)
    k3_ops = (walk["sweep_tests"] * MT_OPS
              + walk["fused_shadow_tests"] * SHARED_MT_OPS
              + walk["last_shadow_tests"] * MT_OPS
              + walk["hits"] * K3_HIT_OPS + walk["select_steps"])
    k4_ops = (k3_ops + walk["hits"] * (K4_HIT_OPS - K3_HIT_OPS)
              + walk["nee_lanes"] * K4_NEE_OPS)
    n_rows = len(scene.light_idx)
    q_bytes = n * (24 + 8) + n_tris * 21 * 4 + n_rows * 4
    k3_bound = bound(k3_ops, q_bytes + n * 12)
    k4_bound = bound(k4_ops, q_bytes + n * 12 + n * 24 + n_tris * 19 * 4)
    k3_ms = sum(timed["k3"][0]) / 2
    k4_ms = sum(timed["k4"][0]) / 2
    lanes = lane_counts(torch, qo, qd, qkeys, qtri, qrows, qcfg)

    # the light distribution on the main path's scene: the kernel, and the
    # plain version, which takes the card's tensors through the host
    from spath_tpu_torch.ops import nee

    emission, area = scene.emission, nee.triangle_areas(scene)

    def light():
        lc.light_cdf_call(emission, area)

    def light_plain():
        lc.light_cdf_plain(emission, area)

    light_plain_ms = [event_ms(torch, light_plain, 20)]
    light_ms = [kernel_device_ms(torch, light, 50, "light_cdf"),
                kernel_device_ms(torch, light, 50, "light_cdf")]
    light_call_ms = event_ms(torch, light, 200)
    light_plain_ms.append(event_ms(torch, light_plain, 20))
    # the library call beside it: torch.cumsum of the prob column
    lprob = lc.light_cdf_call(emission, area)[1]
    light_lib_ms = device_calls(torch, lambda: torch.cumsum(lprob, 0),
                                50)["busy_ms"]
    check(min(light_ms) > 0 and min(light_plain_ms) > 0, "timing failed")
    light_bound = bound(LIGHT_OPS * n_tris, LIGHT_BYTES * n_tris)
    log(f"[17] light distribution, {n_tris} triangles, on {smi}: kernel "
        f"{light_ms} ms on the device, {light_call_ms:.6f} ms a call "
        f"back to back; plain {light_plain_ms} ms; torch.cumsum of prob "
        f"{light_lib_ms:.6f} ms on the device (its kernels); bound "
        f"{light_bound[0]:.4g} ms ({light_bound[1]})")
    log(f"[17] quality {frame} on {smi}: K3 {timed['k3'][0]} ms, plain "
        f"{timed['k3'][1]} ms; K4 {timed['k4'][0]} ms, plain "
        f"{timed['k4'][1]} ms; render_pt_fast {q_slice_ms:.3f} ms (route "
        f"{serving_route(scene, cam, qcfg)}); K3 "
        f"{segs / (k3_ms / 1e3):.4e} rays/s, serving path "
        f"{segs / (q_slice_ms / 1e3):.4e} rays/s; the walk: {walk}; "
        f"operations K3 {k3_ops:.4e}, K4 {k4_ops:.4e}; bound K3 "
        f"{k3_bound[0]:.4f} ms, K4 {k4_bound[0]:.4f} ms ({k3_bound[1]}); "
        f"without FMA: K3 {k3_ops / NOFMA_OPS * 1e3:.4f} ms, K4 "
        f"{k4_ops / NOFMA_OPS * 1e3:.4f} ms")
    log(f"[17] K3's and K4's lanes on rows {list(COUNT_ROWS)}, quality "
        f"{frame}: {lanes}")


    # ---- large scenes: the streamed kernels K6, K8 and K7 ----
    from spath_tpu_torch.ops.kernels import bigscene as bs
    from spath_tpu_torch.ops.kernels import bigscene_grad as bg
    from spath_tpu_torch.ops.kernels import stream_scatter as ss

    # 18. K7 against its plain version on synthetic events
    for n_tris_s, n_events in SCATTER_CASES:
        log(f"[18] K7 vs plain, T={n_tris_s}, {n_events} events: "
            f"{scatter_vs_plain(torch, dev, n_tris_s, n_events)}")

    # 19. K6 against K1 (to the bit) and against its plain version
    combined = combined_scene(dev)
    huge = procedural_scene(bs.BIG_MAX_TRIS, seed=0, device=dev)
    for name, kscene in (("default", default_scene(dev)),
                         ("25 triangles", scene_25(dev)),
                         ("1024 triangles",
                          procedural_scene(1024, seed=1, device=dev))):
        for kcfg in (small, largest):
            log(f"[19] K6 vs K1, {name}, {kcfg.width}x{kcfg.height} "
                f"spp{kcfg.spp}: {big_vs_k1(torch, cam, kscene, kcfg, name)}")
    big_shapes = (
        (f"{combined.n_tris} triangles", combined, small, 512),
        (f"{BIG_T} triangles", procedural_scene(BIG_T, seed=0, device=dev),
         largest, 2048),
        (f"{bs.BIG_MAX_TRIS} triangles", huge,
         RenderConfig(width=32, height=16, spp=1, max_bounces=3), 8192))
    for name, kscene, kcfg, block in big_shapes:
        c = big_vs_plain(torch, cam, kscene, kcfg, name, block)
        log(f"[19] K6 vs plain, {name}, {kcfg.width}x{kcfg.height} "
            f"spp{kcfg.spp} {kcfg.max_bounces} bounces: {c}")

    # 20. K8 (with K7) against mega_bwd_plain, and against K2 where K2
    # takes the scene
    for name, kscene, kcfg in (("default", default_scene(dev), small),
                               ("25 triangles", scene_25(dev), small),
                               ("1024 triangles",
                                procedural_scene(1024, seed=1, device=dev),
                                largest)):
        c, _ = backward_vs_plain(torch, *mk.pack_rays(cam, kcfg, 0),
                                 mk.scene_table(kscene), kcfg,
                                 f"K8 {name}", streamed=True)
        log(f"[20] K8 vs plain and K2, {name}, {kcfg.width}x{kcfg.height} "
            f"spp{kcfg.spp}: {c}")
    for name, kscene, kcfg, block in big_shapes:
        c, _ = backward_vs_plain(torch, *mk.pack_rays(cam, kcfg, 0),
                                 mk.scene_table(kscene), kcfg, f"K8 {name}",
                                 streamed=True, tri_block=block)
        log(f"[20] K8 vs plain, {name}, {kcfg.width}x{kcfg.height} "
            f"spp{kcfg.spp} {kcfg.max_bounces} bounces: {c}")
    del huge, big_shapes

    # 21. the large-scene serving slice at full width, through K6 alone
    big_cfg = RenderConfig(**HEADLINE)
    serve = big_serving(torch, dev, cam, BIG_T, big_cfg, 2048)
    big_frame = f"{big_cfg.width}x{big_cfg.height} spp{big_cfg.spp}"
    log(f"[21] render_pt_fast, {BIG_T} triangles, {big_frame} "
        f"{big_cfg.max_bounces} bounces: launches {serve['launches']}, first "
        f"call {serve['first_s']:.3f} s, mean {serve['mean']:.6f}; rows "
        f"{BAND_ROWS.start}-{BAND_ROWS.stop - 1} vs plain: "
        f"{serve['band_vs_plain']}; the frame's band equals K6 on the band")
    huge_cfg = big_cfg.replace(spp=HUGE_SPP)
    huge_serve = big_serving(torch, dev, cam, HUGE_T, huge_cfg, 2048)
    log(f"[21] render_pt_fast, {HUGE_T} triangles, {huge_cfg.width}x"
        f"{huge_cfg.height} spp{huge_cfg.spp} (cut from 64 for time) "
        f"{huge_cfg.max_bounces} bounces: launches {huge_serve['launches']}, "
        f"first call {huge_serve['first_s']:.3f} s, mean "
        f"{huge_serve['mean']:.6f}; band vs plain: "
        f"{huge_serve['band_vs_plain']}")
    del huge_serve

    # 22. the gradient entry point on a scene above the crossover
    log(f"[22] render_radiance_fastgrad, {combined.n_tris} triangles, "
        f"320x240 spp8: {gradient_entry(torch, dev, cam, combined, big=True)}")

    # 23. the large-scene training slice at full width
    train_cfg = big_cfg.replace(spp=BIG_TRAIN_SPP)
    n_full = big_cfg.width * big_cfg.height
    chunks = -(-train_cfg.spp // bg.chunk_samples(n_full, train_cfg))
    btr = training(torch, dev, cam, serve["scene"], train_cfg,
                   per_step={"K6": 1, "K8": chunks, "K7": chunks})
    log(f"[23] 3 train steps, {BIG_T} triangles, {big_cfg.width}x"
        f"{big_cfg.height} spp{train_cfg.spp} (cut from 64 for time) "
        f"{train_cfg.max_bounces} bounces, {chunks} chunks of "
        f"{bg.chunk_samples(n_full, train_cfg)} samples, on {smi}: launches "
        f"{btr['launches']}, losses {btr['losses']}, step s "
        f"{[round(x, 6) for x in btr['step_s']]}; forward+backward "
        f"{btr['fwd_bwd_ms']:.3f} ms (route {btr['fwd_bwd_route']})")

    # 24. the CLI on large scenes
    log(f"[24] cli --scene {CLI_SIZE[0]}x{CLI_SIZE[1]} spp16: {big_cli(cli)}")

    # 25. the routing crossover table, then K6, K8 and K7 timed at the
    # main path's shapes
    crossover = []
    for n_x in CROSSOVER_T:
        xscene = procedural_scene(n_x, seed=0, device=dev)
        xo, xd, xs = mk.pack_rays(cam, small, 0)
        xtri = mk.scene_table(xscene)
        xg = torch.rand((xo.shape[0], 3), generator=torch.Generator()
                        .manual_seed(3)).to(dev)
        fused_f = lambda: mk.mega_call(xo, xd, xs, xtri, small)  # noqa: E731
        streamed_f = lambda: bs.bigscene_call(  # noqa: E731
            xo, xd, xs, xtri, small)

        def fused_b():
            mk.mega_call(xo, xd, xs, xtri, small)
            mg.mega_bwd_call(xo, xd, xs, xtri, xg, small)

        def streamed_b():
            bs.bigscene_call(xo, xd, xs, xtri, small)
            bg.bigscene_bwd_call(xo, xd, xs, xtri, xg, small)

        row = dict(n_tris=n_x)
        for key, f1, f2 in (("forward", fused_f, streamed_f),
                            ("forward+backward", fused_b, streamed_b)):
            f1(), f2()
            t = [event_ms(torch, f1, 5), event_ms(torch, f2, 5),
                 event_ms(torch, f2, 5), event_ms(torch, f1, 5)]
            row[key] = dict(fused_ms=(t[0] + t[3]) / 2,
                            streamed_ms=(t[1] + t[2]) / 2)
        crossover.append(row)
        log(f"[25] crossover, {n_x} triangles, 320x240 spp8, on {smi}: "
            f"{row}")
    from spath_tpu_torch.models import renderer as rt
    log(f"[25] route: K1 up to {rt.SMEM_ROUTE_MAX_TRIS} triangles, K1+K2 "
        f"up to {rt.GRAD_ROUTE_MAX_TRIS}; the streamed kernels above")

    # K6 at the serving shape: the checked launch was the warm-up. The
    # queue hands pixels out in another order every launch: two whole
    # frames are bitwise equal, equal the served frame, and their count
    # rows equal the plain version's
    bo, bd, bseeds = serve["rays"]
    btri = serve["tri"]
    band = serve["band"]
    frames = []

    def k6_frame():
        frames.append(bs.bigscene_call(bo, bd, bseeds, btri, big_cfg))

    k6_ms = [event_ms(torch, k6_frame, 1)]
    if k6_ms[0] < LONG_LAUNCH_MS:
        k6_ms.append(event_ms(torch, k6_frame, 1))
    else:
        k6_frame()
    check(torch.equal(frames[0], frames[1]), "K6: two whole frames differ")
    check(torch.equal(frames[0].clamp(0.0, 1.0).reshape(serve["img"].shape),
                      serve["img"]), "K6: the frame differs from the served "
          "frame")
    plain_cfg = big_cfg.replace(tri_block=2048)
    count_rays = rows_of(torch, big_cfg.width, COUNT_ROWS, bo, bd, bseeds)
    count_plain = mk.megakernel_plain(*count_rays, btri, plain_cfg)
    count_rows = rows_of(torch, big_cfg.width, COUNT_ROWS, frames[0])[0]
    check(torch.equal(count_rows, count_plain), "K6: the frame's rows "
          f"{list(COUNT_ROWS)} differ from the plain version by "
          f"{(count_rows - count_plain).abs().max().item():.6g}")
    del frames, count_plain, count_rows
    k6_band_ms, k6_plain_ms = in_turns(
        torch, lambda: bs.bigscene_call(*band, btri, big_cfg),
        lambda: mk.megakernel_plain(*band, btri, plain_cfg))
    per_sm, sms = bs.resident_ctas(dev.index, "K6")
    k6_grid = bs.queue_plan(bo.shape[0], per_sm, sms)
    walk = walk_counts(torch, *count_rays, btri, plain_cfg,
                       queue_ctas=queue_ctas(bo.shape[0],
                                             count_rays[0].shape[0], per_sm,
                                             sms))
    walk = scaled(walk, big_cfg.height / len(COUNT_ROWS))
    nb_rays, nb_tris = bo.shape[0], btri.shape[0]
    k6_ms_mean = sum(k6_ms) / len(k6_ms)
    k6_ops = walk["sweeps"] * nb_tris * MT_OPS + walk["hits"] * K1_HIT_OPS
    k6_bound = bound(k6_ops, nb_rays * (24 + 8 + 12) + nb_tris * 18 * 4)
    big_segs = big_cfg.width * big_cfg.height * big_cfg.spp \
        * big_cfg.max_bounces
    log(f"[25] K6, {BIG_T} triangles, {big_frame} on {smi}: {k6_ms} ms a "
        f"frame ({big_segs / (k6_ms_mean / 1e3):.4e} rays/s), two frames "
        f"bitwise equal, rows {list(COUNT_ROWS)} bit-equal to the plain "
        f"version; grid {k6_grid} CTAs ({per_sm} resident a SM x {sms} "
        f"SMs); on rows {BAND_ROWS.start}-{BAND_ROWS.stop - 1}: K6 "
        f"{k6_band_ms} ms, plain {k6_plain_ms} ms; the walk (rows "
        f"{list(COUNT_ROWS)} counted, scaled to the frame): {walk}; "
        f"operations {k6_ops:.4e}, bound {k6_bound[0]:.4f} ms "
        f"({k6_bound[1]})")

    # K8 and K7 at the training shape
    to, td, tseeds = mk.pack_rays(cam, train_cfg, 0)
    tgbar = (torch.rand((to.shape[0], 3), generator=torch.Generator()
                        .manual_seed(3)) * 0.9 + 0.1).to(dev)
    cidx, cval = first_chunk_events(torch, bg.bigscene_bwd_call, to, td,
                                    tseeds, btri, tgbar, train_cfg)
    split = [bwd_split_ms(torch, bg.bigscene_bwd_call, to, td, tseeds, btri,
                          tgbar, train_cfg) for _ in range(2)]
    k8_ms = [t[0] for t in split]
    k7_in_call_ms = [t[1] for t in split]
    # K8's queue hands pixels out in another order every launch; its
    # events stay at their fixed slots, so two calls' table gradients are
    # the same bits
    check(torch.equal(split[0][2], split[1][2]), "K8+K7: two calls' table "
          "gradients differ at the training shape")
    del split
    tband = rows_of(torch, big_cfg.width, BAND_ROWS, to, td, tseeds, tgbar)
    tplain_cfg = train_cfg.replace(tri_block=2048)
    k8_band_ms, k8_plain_ms = in_turns(
        torch, lambda: bg.bigscene_bwd_call(*tband[:3], btri, tband[3],
                                            train_cfg),
        lambda: mg.mega_bwd_plain(*tband[:3], btri, tband[3], tplain_cfg))
    k8_check, _ = backward_vs_plain(
        torch, *tband[:3], btri, train_cfg,
        f"K8 {BIG_T} triangles, rows {BAND_ROWS.start}-{BAND_ROWS.stop - 1}",
        streamed=True, tri_block=2048)
    log(f"[25] K8 vs plain, {BIG_T} triangles, {big_cfg.width}x"
        f"{big_cfg.height} spp{train_cfg.spp}, rows {BAND_ROWS.start}-"
        f"{BAND_ROWS.stop - 1}: {k8_check}")
    tcount = rows_of(torch, big_cfg.width, COUNT_ROWS, to, td, tseeds)
    k8_per_sm = bs.resident_ctas(dev.index, "K8")[0]
    k8_grid = bs.queue_plan(to.shape[0], k8_per_sm, sms)
    twalk = walk_counts(torch, *tcount, btri, tplain_cfg,
                        queue_ctas=queue_ctas(to.shape[0],
                                              tcount[0].shape[0], k8_per_sm,
                                              sms),
                        chunk=bg.chunk_samples(to.shape[0], train_cfg))
    twalk = scaled(twalk, big_cfg.height / len(COUNT_ROWS))
    slots = to.shape[0] * train_cfg.spp * train_cfg.max_bounces
    k8_ops = twalk["sweeps"] * nb_tris * MT_OPS + twalk["hits"] * K8_HIT_OPS
    k8_bound = bound(k8_ops, to.shape[0] * (24 + 8 + 12) + nb_tris * 18 * 4
                     + slots * bg.EVENT_BYTES)
    log(f"[25] K8, {BIG_T} triangles, {big_cfg.width}x{big_cfg.height} "
        f"spp{train_cfg.spp} on {smi}: {k8_ms} ms of K8 launches a call "
        f"({chunks} launches), K7 {k7_in_call_ms} ms a call "
        f"(CUDA events around each K7 call; K8 the rest of the call), two "
        f"calls' gradients bitwise equal; grid {k8_grid} CTAs ({k8_per_sm} "
        f"resident a SM x {sms} SMs); on rows {BAND_ROWS.start}-"
        f"{BAND_ROWS.stop - 1}: "
        f"K8+K7 {k8_band_ms} ms, plain {k8_plain_ms} ms; the walk: {twalk}; "
        f"operations {k8_ops:.4e}, bound {k8_bound[0]:.4f} ms "
        f"({k8_bound[1]})")

    # K7 on the first chunk's events of that call
    k7 = scatter_timing(torch, dev, cidx, cval, nb_tris)
    log(f"[25] K7 on one chunk's events ({k7['slots']} slots, {k7['events']} "
        f"events, {BIG_T} triangles) on {smi}: {k7['ms']} ms, plain "
        f"{k7['plain_ms']} ms, index_add_ {k7['library_ms']} ms (in turns "
        f"with K7's last two); max error {k7['max_abs_err']:.3g} "
        f"({k7['rel_err']:.3g} of its "
        f"column's max), two launches bitwise equal; bound "
        f"{k7['bound'][0]:.4f} ms ({k7['bound'][1]})")
    del cidx, cval

    # ---- the quality estimator on large scenes: the light distribution
    # beyond one block, K9, K10 and K7 at 19 columns ----
    from spath_tpu_torch.ops.kernels import bigscene_quality as bq
    from spath_tpu_torch.ops.kernels import bigscene_quality_grad as bqg

    # 26. the light distribution up to 2^20 triangles, and K7 at 19
    # columns, against their plain versions; the light distribution timed
    # at every size beside its bound and torch.cumsum, and its two routes
    # in turns around SHARED_TRIS
    light_big = {}
    light_cases = [(f"procedural_scene({n_light})", n_light)
                   for n_light in (BIG_T, HUGE_T, 1 << 20)]
    light_cases += [(f"{n_light} triangles", n_light)
                    for n_light in (*LIGHT_SMALL_T, *LIGHT_BIG_T)]
    light_cases.append((f"{HUGE_T} triangles, all dark", HUGE_T))
    for name, n_light in light_cases:
        if name.startswith("procedural"):
            lscene = procedural_scene(n_light, seed=0, device=dev)
            emission, area = lscene.emission, nee.triangle_areas(lscene)
            del lscene
        else:
            emission, area = light_inputs(torch, dev, n_light, n_light,
                                          lit="dark" not in name)
        c = light_vs_plain(torch, emission, area, name)
        light_big[name] = dict(light_timing(torch, emission, area),
                               launches_per_call=c["launches_per_call"])
        log(f"[26] light distribution vs plain, {name}: {c}; timed on "
            f"{smi}: {light_big[name]}")
    del emission, area
    light_routes = light_crossover(torch, dev)
    log(f"[26] light distribution, the one-block route and the grid in "
        f"turns on {smi} (device ms a call; SHARED_TRIS = "
        f"{lc.SHARED_TRIS}): {light_routes}")
    for n_tris_s, n_events in SCATTER_CASES:
        log(f"[26] K7 at 19 columns vs plain, T={n_tris_s}, {n_events} "
            f"events: {scatter_vs_plain(torch, dev, n_tris_s, n_events,
                                        cols=ss.QUALITY_COLS)}")

    # 27. K9 against K3 (to the bit) and against quality_plain
    qsmall, q1024_cfg = small.replace(**QUALITY), largest.replace(**QUALITY)
    for name, kscene in (("default", default_scene(dev)),
                         ("25 triangles", scene_25(dev))):
        for label, est in QUALITY_GRID:
            kcfg = small.replace(**est)
            log(f"[27] K9 vs K3, {name}, {label}, 320x240 spp8: "
                f"{k9_vs_k3(torch, cam, kscene, kcfg, f'{name} {label}')}")
    log(f"[27] K9 vs K3, {mq.MAX_TRIS} triangles, 64x48 spp2: "
        f"{k9_vs_k3(torch, cam, big, q1024_cfg, f'{mq.MAX_TRIS} triangles')}")
    huge_q = procedural_scene(bq.BIGQ_MAX_TRIS, seed=0, device=dev)
    dark_c = dataclasses.replace(
        combined, emission=torch.zeros_like(combined.emission),
        light_idx=())
    bigq_shapes = (
        (f"{combined.n_tris} triangles", combined, qsmall, 512, False),
        (f"{BIG_T} triangles",
         procedural_scene(BIG_T, seed=0, emissive_fraction=0.01,
                          device=dev), q1024_cfg, 2048, False),
        (f"{bq.BIGQ_MAX_TRIS} triangles", huge_q,
         RenderConfig(width=32, height=16, spp=1, max_bounces=3, **QUALITY),
         8192, False),
        (f"{combined.n_tris} triangles, all dark", dark_c, qsmall, 512,
         True))
    for name, kscene, kcfg, block, dark in bigq_shapes:
        c = k9_vs_plain(torch, cam, kscene, kcfg, name, block, dark)
        log(f"[27] K9 vs plain, {name}, {kcfg.width}x{kcfg.height} "
            f"spp{kcfg.spp} {kcfg.max_bounces} bounces: {c}")

    # 28. K10 with K7 against quality_bwd_plain, and against K4 where K4
    # takes the scene
    for name, kscene, kcfg in (("default", default_scene(dev), qsmall),
                               ("25 triangles", scene_25(dev), qsmall),
                               (f"{mq.MAX_TRIS} triangles", big,
                                q1024_cfg)):
        c, _ = quality_backward_vs_plain(
            torch, *mq.pack_rays(cam, kcfg, 0), mq.quality_table(kscene),
            bq.light_rows(kscene), kcfg, f"K10 {name}", streamed=True)
        log(f"[28] K10 vs plain and K4, {name}, {kcfg.width}x{kcfg.height} "
            f"spp{kcfg.spp}: {c}")
    for name, kscene, kcfg, block, dark in bigq_shapes:
        c, _ = quality_backward_vs_plain(
            torch, *mq.pack_rays(cam, kcfg, 0), mq.quality_table(kscene),
            bq.light_rows(kscene), kcfg, f"K10 {name}", streamed=True,
            tri_block=block)
        log(f"[28] K10 vs plain, {name}, {kcfg.width}x{kcfg.height} "
            f"spp{kcfg.spp} {kcfg.max_bounces} bounces: {c}")
    del huge_q, bigq_shapes

    # 29. quality serving on a large scene at full width, through the
    # light distribution and K9 alone
    serve_q_cfg = RenderConfig(**HEADLINE, **QUALITY).replace(
        spp=BIGQ_SERVE_SPP)
    serve_q = quality_serving(torch, dev, cam, BIG_T, serve_q_cfg, 2048)
    serve_q_frame = (f"{serve_q_cfg.width}x{serve_q_cfg.height} "
                     f"spp{serve_q_cfg.spp}")
    log(f"[29] render_pt_fast quality, {BIG_T} triangles, {serve_q_frame} "
        f"(cut from 64 for time) {serve_q_cfg.max_bounces} bounces: launches "
        f"{serve_q['launches']}, "
        f"first call {serve_q['first_s']:.3f} s, mean {serve_q['mean']:.6f}; "
        f"rows {BAND_ROWS.start}-{BAND_ROWS.stop - 1} vs plain: "
        f"{serve_q['band_vs_plain']}; the frame's band equals K9 on the band")
    huge_q_cfg = serve_q_cfg.replace(spp=BIGQ_HUGE_SPP)
    huge_q_serve = quality_serving(torch, dev, cam, HUGE_T, huge_q_cfg, 2048)
    log(f"[29] render_pt_fast quality, {HUGE_T} triangles, "
        f"{huge_q_cfg.width}x{huge_q_cfg.height} spp{huge_q_cfg.spp} (cut "
        f"from 64 for time) {huge_q_cfg.max_bounces} bounces: launches "
        f"{huge_q_serve['launches']}, first call "
        f"{huge_q_serve['first_s']:.3f} s, mean {huge_q_serve['mean']:.6f}; "
        f"band vs plain: {huge_q_serve['band_vs_plain']}")
    del huge_q_serve

    # 30. the quality gradient entry point above the crossover
    log(f"[30] render_radiance_fastgrad quality, {combined.n_tris} "
        f"triangles, 320x240 spp8: "
        f"{quality_gradient_entry(torch, dev, cam, combined, big=True)}")

    # 31. quality training on a large scene at full width
    train_q_cfg = serve_q_cfg.replace(spp=BIGQ_TRAIN_SPP)
    q_chunk = bqg.chunk_samples(n_full, train_q_cfg)
    q_chunks = -(-train_q_cfg.spp // q_chunk)
    qbtr = quality_training(torch, dev, cam, serve_q["scene"], train_q_cfg,
                            per_step={"light": 1, "K9": 1, "K10": q_chunks,
                                      "K7": q_chunks})
    log(f"[31] 3 quality train steps, {BIG_T} triangles, "
        f"{train_q_cfg.width}x{train_q_cfg.height} spp{train_q_cfg.spp} "
        f"(cut from 64 for time) {train_q_cfg.max_bounces} bounces, pose "
        f"group at rate {QUALITY_POSE_LR}, {q_chunks} chunks of {q_chunk} "
        f"samples, on {smi}: launches {qbtr['launches']}, losses "
        f"{qbtr['losses']}, step s {[round(x, 6) for x in qbtr['step_s']]}; "
        f"camera gradient {qbtr['cam_grad']}; forward+backward "
        f"{qbtr['fwd_bwd_ms']:.3f} ms (route {qbtr['fwd_bwd_route']})")

    # 32. the CLI on large scenes in quality mode
    log(f"[32] cli --mode quality --scene {CLI_SIZE[0]}x{CLI_SIZE[1]} spp16: "
        f"{quality_big_cli(cli)}")

    # 33. the quality crossover table, then K9, K10 and K7 at 19 columns
    # timed at the main path's shapes
    q_crossover = []
    for n_x in CROSSOVER_T:
        xscene = procedural_scene(n_x, seed=0, device=dev)
        xo, xd, xk = mq.pack_rays(cam, qsmall, 0)
        xtri, xrows = mq.quality_table(xscene), bq.light_rows(xscene)
        xg = torch.rand((xo.shape[0], 3), generator=torch.Generator()
                        .manual_seed(3)).to(dev)
        fused_f = lambda: mq.quality_call(  # noqa: E731
            xo, xd, xk, xtri, xrows, qsmall)
        streamed_f = lambda: bq.bigq_call(  # noqa: E731
            xo, xd, xk, xtri, xrows, qsmall)

        def fused_b():
            mq.quality_call(xo, xd, xk, xtri, xrows, qsmall)
            mqg.quality_bwd_call(xo, xd, xk, xtri, xrows, xg, qsmall)

        def streamed_b():
            bq.bigq_call(xo, xd, xk, xtri, xrows, qsmall)
            bqg.bigq_bwd_call(xo, xd, xk, xtri, xrows, xg, qsmall)

        row = dict(n_tris=n_x)
        for key, f1, f2 in (("forward", fused_f, streamed_f),
                            ("forward+backward", fused_b, streamed_b)):
            f1(), f2()
            t = [event_ms(torch, f1, 5), event_ms(torch, f2, 5),
                 event_ms(torch, f2, 5), event_ms(torch, f1, 5)]
            row[key] = dict(fused_ms=(t[0] + t[3]) / 2,
                            streamed_ms=(t[1] + t[2]) / 2)
        q_crossover.append(row)
        log(f"[33] quality crossover, {n_x} triangles, 320x240 spp8, on "
            f"{smi}: {row}")
    log(f"[33] route: K3 up to {rt.QUALITY_ROUTE_MAX_TRIS} triangles, K3+K4 "
        f"up to {rt.QUALITY_GRAD_ROUTE_MAX_TRIS}; the streamed quality "
        "kernels above")

    # K9 at the serving shape: the checked launch was the warm-up. The
    # queue hands pixels out in another order every launch: two whole
    # frames are bitwise equal, equal the served frame, and their count
    # rows equal the plain version's
    qo, qd, qk = serve_q["rays"]
    qbtri, qbrows, qband = serve_q["tri"], serve_q["rows"], serve_q["band"]
    qframes = []

    def k9_frame():
        qframes.append(bq.bigq_call(qo, qd, qk, qbtri, qbrows, serve_q_cfg))

    k9_ms = [event_ms(torch, k9_frame, 1)]
    if k9_ms[0] < LONG_LAUNCH_MS:
        k9_ms.append(event_ms(torch, k9_frame, 1))
    else:
        k9_frame()
    check(torch.equal(qframes[0], qframes[1]), "K9: two whole frames differ")
    check(torch.equal(qframes[0].clamp(0.0, 1.0).reshape(
        serve_q["img"].shape), serve_q["img"]), "K9: the frame differs from "
          "the served frame")
    qplain_cfg = serve_q_cfg.replace(tri_block=2048)
    qcount_rays = rows_of(torch, serve_q_cfg.width, COUNT_ROWS, qo, qd, qk)
    qcount_plain = mq.quality_plain(*qcount_rays, qbtri, qbrows, qplain_cfg)
    qcount_rows = rows_of(torch, serve_q_cfg.width, COUNT_ROWS,
                          qframes[0])[0]
    check(torch.equal(qcount_rows, qcount_plain), "K9: the frame's rows "
          f"{list(COUNT_ROWS)} differ from quality_plain by "
          f"{(qcount_rows - qcount_plain).abs().max().item():.6g}")
    del qframes, qcount_plain, qcount_rows
    k9_band_ms, k9_plain_ms = in_turns(
        torch, lambda: bq.bigq_call(*qband, qbtri, qbrows, serve_q_cfg),
        lambda: mq.quality_plain(*qband, qbtri, qbrows, qplain_cfg))
    k9_per_sm, q_sms = bs.resident_ctas(dev.index, "K9")
    k9_grid = bs.queue_plan(qo.shape[0], k9_per_sm, q_sms)
    qwalk = quality_cta_walk(torch, *qcount_rays, qbtri, qbrows, qplain_cfg,
                             queue_ctas=queue_ctas(qo.shape[0],
                                                   qcount_rays[0].shape[0],
                                                   k9_per_sm, q_sms))
    qwalk = scaled(qwalk, serve_q_cfg.height / len(COUNT_ROWS))
    nq_rays, nq_tris, nq_rows = qo.shape[0], qbtri.shape[0], len(qbrows)
    k9_ms_mean = sum(k9_ms) / len(k9_ms)
    k9_ops = (qwalk["sweep_tests"] * MT_OPS
              + qwalk["fused_shadow_tests"] * SHARED_MT_OPS
              + qwalk["last_shadow_tests"] * MT_OPS
              + qwalk["hits"] * K3_HIT_OPS + qwalk["select_steps"])
    q_in_bytes = nq_tris * 21 * 4 + nq_rows * 8
    k9_bound = bound(k9_ops, nq_rays * (24 + 8 + 12) + q_in_bytes)
    q_segs = serve_q_cfg.width * serve_q_cfg.height * serve_q_cfg.spp \
        * serve_q_cfg.max_bounces
    log(f"[33] K9, {BIG_T} triangles, {serve_q_frame} on {smi}: {k9_ms} ms a "
        f"frame ({q_segs / (k9_ms_mean / 1e3):.4e} rays/s), two frames "
        f"bitwise equal and equal to the served frame, rows "
        f"{list(COUNT_ROWS)} bit-equal to quality_plain; grid {k9_grid} CTAs "
        f"({k9_per_sm} resident a SM x {q_sms} SMs); on rows "
        f"{BAND_ROWS.start}-{BAND_ROWS.stop - 1}: K9 {k9_band_ms} ms, plain "
        f"{k9_plain_ms} ms; the walk (rows {list(COUNT_ROWS)} counted, "
        f"scaled to the frame): {qwalk}; operations {k9_ops:.4e}, bound "
        f"{k9_bound[0]:.4f} ms ({k9_bound[1]}); without FMA "
        f"{k9_ops / NOFMA_OPS * 1e3:.4f} ms")

    # K10 and K7 at the training shape
    to, td, tk = mq.pack_rays(cam, train_q_cfg, 0)
    tgbar = (torch.rand((to.shape[0], 3), generator=torch.Generator()
                        .manual_seed(3)) * 0.9 + 0.1).to(dev)
    qidx, qval = first_chunk_events(torch, bqg.bigq_bwd_call, to, td, tk,
                                    qbtri, qbrows, tgbar, train_q_cfg)
    qsplit = [bwd_split_ms(torch, bqg.bigq_bwd_call, to, td, tk, qbtri,
                           qbrows, tgbar, train_q_cfg) for _ in range(2)]
    k10_ms = [t[0] for t in qsplit]
    k7q_in_call_ms = [t[1] for t in qsplit]
    # K10's queue hands pixels out in another order every launch: two
    # whole backward calls give the same bits
    check(torch.equal(qsplit[0][2][0], qsplit[1][2][0])
          and torch.equal(qsplit[0][2][1], qsplit[1][2][1]),
          "K10+K7: two whole backward calls differ")
    del qsplit
    qtband = rows_of(torch, train_q_cfg.width, BAND_ROWS, to, td, tk, tgbar)
    qtplain_cfg = train_q_cfg.replace(tri_block=2048)
    k10_band_ms, k10_plain_ms = in_turns(
        torch, lambda: bqg.bigq_bwd_call(*qtband[:3], qbtri, qbrows,
                                         qtband[3], train_q_cfg),
        lambda: mqg.quality_bwd_plain(*qtband[:3], qbtri, qbrows, qtband[3],
                                      qtplain_cfg))
    k10_check, _ = quality_backward_vs_plain(
        torch, *qtband[:3], qbtri, qbrows, train_q_cfg,
        f"K10 {BIG_T} triangles, rows {BAND_ROWS.start}-"
        f"{BAND_ROWS.stop - 1}", streamed=True, tri_block=2048)
    log(f"[33] K10 vs plain, {BIG_T} triangles, {train_q_cfg.width}x"
        f"{train_q_cfg.height} spp{train_q_cfg.spp}, rows {BAND_ROWS.start}-"
        f"{BAND_ROWS.stop - 1}: {k10_check}")
    # the 4-spp walk: lockstep; the queue on K11's own grid, and K10's
    # launch by launch on its own
    k11_per_sm = bs.resident_ctas(dev.index, "K11")[0]
    k11_grid = bs.queue_plan(to.shape[0], k11_per_sm, q_sms)
    k10_per_sm = bs.resident_ctas(dev.index, "K10")[0]
    k10_grid = bs.queue_plan(to.shape[0], k10_per_sm, q_sms)
    tqcount = rows_of(torch, train_q_cfg.width, COUNT_ROWS, to, td, tk)
    tqwalk = quality_cta_walk(
        torch, *tqcount, qbtri, qbrows, qtplain_cfg,
        queue_ctas=queue_ctas(to.shape[0], tqcount[0].shape[0], k11_per_sm,
                              q_sms),
        chunk=q_chunk, chunk_ctas=queue_ctas(to.shape[0],
                                             tqcount[0].shape[0],
                                             k10_per_sm, q_sms))
    k10_idle = [{k: v["idle_lane_share"] for k, v in c.items()
                 if isinstance(v, dict)} for c in tqwalk["chunk_schedules"]]
    tqwalk = scaled(tqwalk, train_q_cfg.height / len(COUNT_ROWS))
    q_slots = to.shape[0] * train_q_cfg.spp * train_q_cfg.max_bounces
    k10_ops = (tqwalk["sweep_tests"] * MT_OPS
               + tqwalk["fused_shadow_tests"] * SHARED_MT_OPS
               + tqwalk["last_shadow_tests"] * MT_OPS
               + tqwalk["hits"] * K4_HIT_OPS + tqwalk["select_steps"]
               + tqwalk["nee_lanes"] * K4_NEE_OPS)
    k10_bound = bound(k10_ops, to.shape[0] * (24 + 8 + 12 + 24) + q_in_bytes
                      + q_slots * 2 * bqg.EVENT_BYTES)
    log(f"[33] K10, {BIG_T} triangles, {train_q_cfg.width}x"
        f"{train_q_cfg.height} spp{train_q_cfg.spp} on {smi}: {k10_ms} ms of "
        f"K10 launches a call ({q_chunks} launches), K7 {k7q_in_call_ms} ms "
        f"a call (CUDA events around each K7 call; K10 the rest of the "
        f"call), two calls' table gradients and ray adjoints bitwise equal; "
        f"grid {k10_grid} CTAs ({k10_per_sm} resident a SM x {q_sms} SMs), "
        f"idle lanes by launch {k10_idle}; on rows "
        f"{BAND_ROWS.start}-{BAND_ROWS.stop - 1}: K10+K7 "
        f"{k10_band_ms} ms, plain {k10_plain_ms} ms; the walk: {tqwalk}; "
        f"operations {k10_ops:.4e}, bound {k10_bound[0]:.4f} ms "
        f"({k10_bound[1]})")

    # K7 at 19 columns on the first chunk's events of that call
    k7q = scatter_timing(torch, dev, qidx, qval, nq_tris)
    log(f"[33] K7 at 19 columns on one chunk's events ({k7q['slots']} "
        f"slots, {k7q['events']} events, {BIG_T} triangles) on {smi}: "
        f"{k7q['ms']} ms, plain {k7q['plain_ms']} ms, index_add_ "
        f"{k7q['library_ms']} ms (in turns with K7's last two); max error "
        f"{k7q['max_abs_err']:.3g} ({k7q['rel_err']:.3g} of its column's "
        f"max), two launches bitwise equal; bound {k7q['bound'][0]:.4f} ms "
        f"({k7q['bound'][1]})")
    del qidx, qval

    # ---- visibility gradients: K5, K11, deeper gradients (34-41) ----
    from spath_tpu_torch.camera import generate_rays
    from spath_tpu_torch.models import pathtracer as pt
    from spath_tpu_torch.models.renderer import (
        forward_renderer, grad_renderer,
    )
    from spath_tpu_torch.ops.kernels import intersect as k5

    # 34. K5 against the plain sweep, to the bit
    side = int(round(pt.VIS_CHUNK ** 0.5))
    co, cd = generate_rays(cam, side, side)
    ten_k, combined = serve_q["scene"], combined_scene(dev)
    k5_sets, k5_err = {}, 0.0
    for name, scene_k in (("default", default_scene(dev)),
                          ("1150", combined), (f"{BIG_T}", ten_k)):
        k5_sets[name] = k5_ray_sets(torch, scene_k, co, cd, seed=5)
        tri_k = k5_table(scene_k)
        for kind, rays in k5_sets[name].items():
            c = k5_vs_plain(torch, tri_k, rays, f"K5 {name} {kind}")
            k5_err = max(k5_err, c["max_abs_err"])
            log(f"[34] K5 vs plain, {name} triangles, {kind} rays "
                f"({side}x{side}, one residual slice): {c}")
        # ray counts that end inside a CTA's ray tile
        for m in K5_RAY_COUNTS:
            c = k5_vs_plain(torch, tri_k, tuple(
                t[:m] for t in k5_sets[name]["bounce"]),
                f"K5 {name} {m} bounce rays")
            k5_err = max(k5_err, c["max_abs_err"])
        log(f"[34] K5 vs plain, {name} triangles, the first "
            f"{list(K5_RAY_COUNTS)} bounce rays: bit-exact, two launches "
            "bitwise equal")
    huge_scene = procedural_scene(1 << 20, seed=0, device=dev)
    huge_tri = k5_table(huge_scene)
    for kind, rays in k5_ray_sets(torch, huge_scene, *generate_rays(
            cam, 64, 64), seed=6).items():
        c = k5_vs_plain(torch, huge_tri, rays, f"K5 2^20 {kind}")
        k5_err = max(k5_err, c["max_abs_err"])
        log(f"[34] K5 vs plain, 2^20 triangles, {kind} rays (64x64): {c}")
    del huge_scene, huge_tri
    k5_slice = k5_timing(torch, k5_table(ten_k),
                         k5_sets[f"{BIG_T}"]["bounce"])
    k5_tile, k5_per_sm, k5_sms = k5.resident_ctas(dev.index)
    k5_grid = dict(zip(("ray_tiles", "splits"), k5.sweep_plan(
        k5_slice["rays"], k5_slice["n_tris"], k5_tile, k5_per_sm, k5_sms)),
        rays_per_cta=k5_tile, resident_per_sm=k5_per_sm, sms=k5_sms)
    fo, fd = generate_rays(cam, HEADLINE["width"], HEADLINE["height"])
    # a launch of ~0.05 ms on an H100: timed over K5_FRAME_REPS launches
    none = torch.full((fo.shape[0],), -1, dtype=torch.int64, device=dev)
    k5_frame = k5_timing(torch, k5_table(default_scene(dev)),
                         (fo, fd, none), K5_FRAME_REPS)
    for what, t in (("a residual slice's bounce rays", k5_slice),
                    ("1080p camera rays", k5_frame)):
        log(f"[34] K5 on {what}, {t['rays']} rays x {t['n_tris']} "
            f"triangles, on {smi}: {t['ms']} ms, plain {t['plain_ms']} ms "
            f"(in turns), bound {t['bound'][0]:.4f} ms ({t['bound'][1]}; "
            f"{t['ops']:.4e} operations, {t['culled_pair_share']:.4f} of "
            f"the pairs culled), {t['tests_per_s']:.4e} tests/s")
    log(f"[34] K5's grid on the slice: {k5_grid}")
    del k5_sets

    # 35. K11 against K9 and its plain version, to the bit
    q320 = RenderConfig(width=320, height=240, spp=8, max_bounces=5,
                        **QUALITY)
    for name, scene_k, cfg_k, tb in (
            ("default", default_scene(dev), q320, 512),
            ("1150", combined, q320.replace(spp=4), 512),
            ("1150 rr2 strat", combined,
             q320.replace(spp=4, rr_start=2, stratify=True), 512),
            (f"{BIG_T}", ten_k, q320.replace(width=64, height=48, spp=2),
             2048)):
        c = k11_vs_k9_and_plain(torch, cam, scene_k, cfg_k, name, tb)
        log(f"[35] K11 vs K9 and quality_hits_plain, {name} triangles, "
            f"{cfg_k.width}x{cfg_k.height} spp{cfg_k.spp}: {c}")
    k11_ms, k9_turn_ms = in_turns(
        torch, lambda: bq.bigq_hits_call(to, td, tk, qbtri, qbrows,
                                         train_q_cfg),
        lambda: bq.bigq_call(to, td, tk, qbtri, qbrows, train_q_cfg))
    k11_band_ms, k11_plain_ms = in_turns(
        torch, lambda: bq.bigq_hits_call(*qtband[:3], qbtri, qbrows,
                                         train_q_cfg),
        lambda: bq.quality_hits_plain(*qtband[:3], qbtri, qbrows,
                                      qtplain_cfg))
    # the timed calls' outputs: K11's radiance equal to K9's on the whole
    # training frame; on the band K11's radiance and hits equal to its
    # plain version's, both from the band's own launch and from the
    # frame's (spp, B, n) export at the band's pixels
    k11_out, k11_dist, k11_idx = bq.bigq_hits_call(to, td, tk, qbtri, qbrows,
                                                   train_q_cfg)
    k9_out = bq.bigq_call(to, td, tk, qbtri, qbrows, train_q_cfg)
    band_out, band_dist, band_idx = bq.bigq_hits_call(
        *qtband[:3], qbtri, qbrows, train_q_cfg)
    torch.cuda.synchronize()
    want_out, want_dist, want_idx = bq.quality_hits_plain(
        *qtband[:3], qbtri, qbrows, qtplain_cfg)
    band_px = torch.cat([torch.arange(r * train_q_cfg.width,
                                      (r + 1) * train_q_cfg.width)
                         for r in BAND_ROWS]).to(dev)
    check(torch.equal(k11_out, k9_out), "K11's radiance differs from K9's "
          f"on the {BIG_T}-triangle training frame at "
          f"{int((k11_out != k9_out).any(1).sum())} pixels")
    for what, (o_, d_, i_) in (
            ("the band's launch", (band_out, band_dist, band_idx)),
            ("the frame's export", (k11_out[band_px], k11_dist[:, :, band_px],
                                    k11_idx[:, :, band_px]))):
        check(torch.equal(o_, want_out) and torch.equal(d_, want_dist)
              and torch.equal(i_, want_idx),
              f"K11 on rows {BAND_ROWS.start}-{BAND_ROWS.stop - 1} "
              f"({what}) differs from quality_hits_plain: "
              f"{int((i_ != want_idx).sum())} indices, "
              f"{int((d_ != want_dist).sum())} distances, "
              f"{int((o_ != want_out).any(1).sum())} pixels")
    k11_err = max((k11_out - k9_out).abs().max().item(),
                  (band_out - want_out).abs().max().item(),
                  (band_dist - want_dist).abs().max().item(),
                  (k11_dist[:, :, band_px] - want_dist).abs().max().item())
    k11_hits = int((k11_idx >= 0).sum())
    del k11_out, k11_dist, k11_idx, k9_out
    k11_ops = (tqwalk["sweep_tests"] * MT_OPS
               + tqwalk["fused_shadow_tests"] * SHARED_MT_OPS
               + tqwalk["last_shadow_tests"] * MT_OPS
               + tqwalk["hits"] * K3_HIT_OPS + tqwalk["select_steps"])
    k11_bound = bound(k11_ops, to.shape[0] * (24 + 8 + 12) + q_in_bytes
                      + q_slots * 8)
    log(f"[35] K11 and K9 in turns, {BIG_T} triangles, {train_q_cfg.width}x"
        f"{train_q_cfg.height} spp{train_q_cfg.spp} on {smi}: K11 {k11_ms} "
        f"ms, K9 {k9_turn_ms} ms a frame; on rows {BAND_ROWS.start}-"
        f"{BAND_ROWS.stop - 1}: K11 {k11_band_ms} ms, plain {k11_plain_ms} "
        f"ms; bound {k11_bound[0]:.4f} ms ({k11_bound[1]}; the walk as "
        f"K10's above, and {q_slots * 8 / 1e6:.1f} MB of hits written); "
        f"grid {k11_grid} CTAs ({k11_per_sm} resident a SM x {q_sms} SMs), "
        f"idle lanes {tqwalk['schedules']}; "
        f"the frame's radiance bit-equal to K9's, and on the rows its "
        f"radiance and hits ({k11_hits} hits in the frame) bit-equal to "
        f"quality_hits_plain's, max error {k11_err}")

    # 36. gradients deeper than 16 bounces
    deep = {}
    for bounces in (17, 32):
        cfg_b = RenderConfig(width=64, height=48, spp=2, max_bounces=bounces)
        qcfg_b = cfg_b.replace(rr_start=3, **QUALITY)
        for name, scene_k in (("default", default_scene(dev)),
                              ("1150", combined)):
            streamed = name == "1150"
            check(grad_renderer(scene_k, cfg_b).name
                  == ("bigscene" if streamed else "megakernel")
                  and grad_renderer(scene_k, qcfg_b).name
                  == ("quality_bigscene" if streamed else "quality"),
                  f"{bounces} bounces on {name} triangles not routed to "
                  "the backward kernels")
            o, d, seeds = mk.pack_rays(cam, cfg_b, 0)
            c, _ = backward_vs_plain(torch, o, d, seeds,
                                     mk.scene_table(scene_k), cfg_b,
                                     f"{bounces} bounces {name}",
                                     streamed=streamed)
            log(f"[36] {'K8+K7' if streamed else 'K2'} vs plain at "
                f"{bounces} bounces, {name} triangles, 64x48 spp2: {c}")
            o, d, keys = mq.pack_rays(cam, qcfg_b, 0)
            c, _ = quality_backward_vs_plain(
                torch, o, d, keys, mq.quality_table(scene_k),
                bq.light_rows(scene_k), qcfg_b, f"{bounces} bounces {name}",
                streamed=streamed)
            log(f"[36] {'K10+K7' if streamed else 'K4'} vs plain at "
                f"{bounces} bounces (rr from 3), {name} triangles, 64x48 "
                f"spp2: {c}")
    dscene = default_scene(dev)
    for bounces in (5, 16, 17, 32):
        cfg_b = small.replace(max_bounces=bounces)
        qcfg_b = cfg_b.replace(**QUALITY)
        o, d, seeds = mk.pack_rays(cam, cfg_b, 0)
        tri_b = mk.scene_table(dscene)
        g_b = torch.ones((o.shape[0], 3), device=dev)
        qo, qd, qk = mq.pack_rays(cam, qcfg_b, 0)
        qtri_b, qrows_b = mq.quality_table(dscene), mq.light_rows(dscene)
        mg.mega_bwd_call(o, d, seeds, tri_b, g_b, cfg_b)
        mqg.quality_bwd_call(qo, qd, qk, qtri_b, qrows_b, g_b, qcfg_b)
        deep[bounces] = dict(
            k2=event_ms(torch, lambda: mg.mega_bwd_call(
                o, d, seeds, tri_b, g_b, cfg_b), 3),
            k4=event_ms(torch, lambda: mqg.quality_bwd_call(
                qo, qd, qk, qtri_b, qrows_b, g_b, qcfg_b), 3))
    log(f"[36] K2 and K4 ms at 320x240 spp8 by max_bounces, on {smi}: "
        f"{deep}")

    # 37. the wavefront on the card, for what no fused kernel takes
    wcfg = RenderConfig(width=320, height=240, spp=4, max_bounces=5,
                        rng="hash", sampler="uniform", nee=True, mis=True)
    check(forward_renderer(dscene, wcfg).name == "wavefront"
          and grad_renderer(dscene, wcfg).name == "wavefront",
          "hash+uniform not routed to the wavefront")
    zero_counts(every_kernel())
    wimg = render_pt_fast(dscene, cam, wcfg, 0)
    torch.cuda.synchronize()
    wlaunched = launched_only({"K5": counts(every_kernel())["K5"],
                               "light": 1}, "the wavefront hash+uniform")
    check(wlaunched["K5"] > 0, "the wavefront did not launch K5")
    with plain_sweep():
        wplain = render_pt_fast(dscene, cam, wcfg, 0)
    check(torch.equal(wimg, wplain), "the wavefront on K5 differs from "
          "the wavefront on the plain sweep")
    check(wimg.mean().item() > 0.01, "the wavefront's frame is black")
    wang = render_pt_fast(dscene, cam, wcfg.replace(sampler="angle"), 0)
    check(torch.isfinite(wang).all().item(), "hash+angle frame not finite")

    def wgrads(cfg_w, scene_w):
        leaves = [t.detach().clone().requires_grad_()
                  for t in (scene_w.vertices, scene_w.albedo)]
        img = pt.render_radiance_fastgrad(
            dataclasses.replace(scene_w, vertices=leaves[0],
                                albedo=leaves[1]), cam, cfg_w, 0)
        return torch.autograd.grad(img.square().mean(), leaves)

    wdeep = {}
    for label, cfg_w in (("hash+uniform", wcfg.replace(spp=2)),
                         ("65 bounces", RenderConfig(
                             width=64, height=48, spp=1, max_bounces=65)),
                         ("65 bounces quality", RenderConfig(
                             width=64, height=48, spp=1, max_bounces=65,
                             rr_start=3, **QUALITY))):
        check(grad_renderer(dscene, cfg_w).name == "wavefront",
              f"{label} gradient not routed to the wavefront")
        k5.nearest_hit_call.launches = 0
        got = wgrads(cfg_w, dscene)
        torch.cuda.synchronize()
        n5 = k5.nearest_hit_call.launches
        with plain_sweep():
            want = wgrads(cfg_w, dscene)
        errs = [((g - w).abs().max() / w.abs().max()).item()
                for g, w in zip(got, want)]
        check(n5 > 0 and all(e <= GRAD_RTOL for e in errs),
              f"{label}: K5 {n5} launches, gradient off the plain sweep's "
              f"by {errs} of each max")
        wdeep[label] = dict(k5_launches=n5, rel_err=errs)
    log(f"[37] the wavefront on the card: hash+uniform 320x240 spp4 "
        f"launched {wlaunched}, equal to the plain sweep's frame to the "
        f"bit; gradients on K5 against the plain sweep's: {wdeep}")

    # 38. the vis_grad gradient entry point against the plain wavefront
    bscene = blocker_scene(dev)
    vis_q = RenderConfig(width=320, height=240, spp=4, max_bounces=3,
                         vis_grad=True, **QUALITY)
    vis_entry = {}
    for label, scene_v, cfg_v, expect in (
            ("blocker, conformance", bscene,
             RenderConfig(width=320, height=240, spp=4, max_bounces=3,
                          vis_grad=True), {"K1", "K2", "K5", "K7"}),
            ("blocker, quality", bscene, vis_q,
             {"light", "K3", "K4", "K5", "K7"}),
            ("1150, quality, K11", combined, vis_q.replace(spp=2),
             {"light", "K11", "K10", "K7", "K5"})):
        vis_entry[label] = vis_gradient_entry(torch, dev, cam, scene_v,
                                              cfg_v, expect)
        log(f"[38] render_radiance_fastgrad vis_grad, {label}, "
            f"{cfg_v.width}x{cfg_v.height} spp{cfg_v.spp}: "
            f"{vis_entry[label]}")
    vis_frame = render_pt_fast(bscene, cam, vis_q, 0)
    check(torch.equal(vis_frame, render_pt_fast(
        bscene, cam, vis_q.replace(vis_grad=False), 0)),
        "the vis_grad frame differs from the frame without it")

    # 39. vis_grad training at full width on the default scene
    vis_train_cfg = RenderConfig(**HEADLINE, vis_grad=True, **QUALITY
                                 ).replace(spp=VIS_TRAIN_SPP)
    vtr = vis_training(torch, dev, cam, dscene, vis_train_cfg,
                       {"light", "K3", "K4", "K5", "K7"}, 3)
    log(f"[39] 3 vis_grad quality train steps, default scene, 1920x1080 "
        f"spp{VIS_TRAIN_SPP}, on {smi}: {vtr}")
    spread = {}
    vis_gathers = {"default": gather_k7_check(torch, lambda: spread.update(
        vis_spread(torch, dev, cam, dscene, vis_train_cfg)))}
    log(f"[39] run-to-run spread of the vis_grad gradient, default scene, "
        f"1920x1080 spp{VIS_TRAIN_SPP} (none allowed): {spread}")
    log(f"[39] K7 as the row gathers' backward against a float64 "
        f"index_add_, default scene (within {GATHER_RTOL}): "
        f"{vis_gathers['default']}")

    # 40. vis_grad training on the 10k scene through K11
    vbtr = vis_training(torch, dev, cam, ten_k,
                        train_q_cfg.replace(vis_grad=True),
                        {"light", "K11", "K10", "K7", "K5"}, 2)
    log(f"[40] 2 vis_grad quality train steps, {BIG_T} triangles, "
        f"1920x1080 spp{train_q_cfg.spp}, on {smi}: {vbtr}")
    big_spread = {}
    vis_gathers["10k"] = gather_k7_check(torch, lambda: big_spread.update(
        vis_spread(torch, dev, cam, ten_k,
                   train_q_cfg.replace(vis_grad=True))))
    log(f"[40] run-to-run spread of the vis_grad gradient, {BIG_T} "
        f"triangles, 1920x1080 spp{train_q_cfg.spp} (none allowed): "
        f"{big_spread}")
    log(f"[40] K7 as the row gathers' backward against a float64 "
        f"index_add_, {BIG_T} triangles (within {GATHER_RTOL}): "
        f"{vis_gathers['10k']}")

    # 41. the pose step from the true camera, recorded
    pose = pose_measurement(torch, dev, cam, RenderConfig(
        width=320, height=240, spp=8, max_bounces=5, **QUALITY))
    log(f"[41] pose steps at {POSE_STEP_LR} from the true camera, default "
        f"scene, 320x240 spp8 quality (recorded, not asserted): {pose}")

    # 42. T1, the matmul-only sweep microbenchmark, through its tool
    t1_records, k5_bench = t1_phase(torch)

    # 43-46. the threefry and table streams: the threefry kernel, the
    # QUALITY preset's frame, the table stream, training on QUALITY
    tf_check = threefry_phase(torch, dev)
    preset = quality_preset_frame(torch, dev, cam)
    table = table_stream_phase(torch, dev, cam)
    preset_tr = quality_preset_training(torch, dev, cam)

    # 47-48. ray-sharded rendering and training: one rank on NCCL, then
    # two ranks sharing the card on gloo
    one_rank = one_rank_phase(torch, dev, cam)
    two_ranks = two_rank_phase(torch, dev, cam)

    # 49-50. the triangle ring: a world of one on NCCL, then two ranks
    # sharing the card on gloo
    ring_one = ring_one_rank_phase(torch, dev, cam)
    ring_two = ring_two_rank_phase(torch, dev, ring_one)

    # 51. camera-ray compaction on every kernel route and the wavefront
    compact = compaction_phase(torch, dev, cam)

    record = {"kernels": [{
        "name": "megakernel_forward",
        "route": "cuda",
        "source": "spath_tpu_torch/csrc/megakernel.cu",
        "replaces": "spath_tpu/ops/pallas/megakernel.py:182",
        "launches": tr["k1"],
        "launches_by_path": {"serving": launches, "training": tr["k1"]},
        "max_abs_err": headline["max_abs_err"],
        "ms": k_ms,
        "idle_lane_share": {
            "lockstep": conf_lanes["k1"]["lockstep"]["idle_lane_share"],
            "shipped": conf_lanes["k1"]["shipped"]["idle_lane_share"]},
        "grid": conf_lanes["k1"]["grid"],
        "plain_ms": p_ms,
        "bound_ms": k1_bound[0],
        "bound_by": k1_bound[1],
        "library_ms": None,
    }, {
        "name": "megakernel_backward",
        "route": "cuda",
        "source": "spath_tpu_torch/csrc/megakernel_grad.cu",
        "replaces": "spath_tpu/ops/pallas/megakernel_grad.py:370",
        "launches": tr["k2"],
        "launches_by_path": {"serving": 0, "training": tr["k2"]},
        "max_abs_err": bwd_headline["max_abs_err"],
        "ms": k2_ms,
        "reverse_idle_lane_share": {
            "lockstep": conf_lanes["k2"]["lockstep"][
                "reverse_idle_lane_share"],
            "epochs": conf_lanes["k2"]["epochs"][mg.EPOCH][
                "reverse_idle_lane_share"]},
        "grid": conf_lanes["k2"]["grid"],
        "plain_ms": p2_ms,
        "bound_ms": k2_bound[0],
        "bound_by": k2_bound[1],
        "library_ms": None,
    }, {
        "name": "light_cdf",
        "route": "cuda",
        "source": "spath_tpu_torch/csrc/light_cdf.cu",
        "replaces": "spath_tpu/ops/nee.py:60",
        "replaces_note": "the XLA prologue of K3's table "
                         "(megakernel_quality.py:573 quality_table); no "
                         "Pallas kernel computes it",
        "launches": qtr["light"],
        "launches_by_path": {"serving": l_launches, "training": qtr["light"]},
        "max_abs_err": 0.0,
        "ms": sum(light_ms) / 2,
        "call_ms": light_call_ms,
        "plain_ms": sum(light_plain_ms) / 2,
        "bound_ms": light_bound[0],
        "bound_by": light_bound[1],
        "library_ms": light_lib_ms,
        "library_call": "torch.cumsum of the prob column (the cdf alone, "
                        "not in the plain version's order)",
        "by_triangles": light_big,
        "routes_by_triangles": light_routes,
    }, {
        "name": "quality_forward",
        "route": "cuda",
        "source": "spath_tpu_torch/csrc/megakernel_quality.cu",
        "replaces": "spath_tpu/ops/pallas/megakernel_quality.py:535",
        "launches": qtr["k3"],
        "launches_by_path": {"serving": q_launches, "training": qtr["k3"]},
        "max_abs_err": qheadline["max_abs_err"],
        "ms": k3_ms,
        "idle_lane_share": {
            "lockstep": lanes["k3"]["lockstep"]["idle_lane_share"],
            "shipped": lanes["k3"]["shipped"]["idle_lane_share"]},
        "grid": lanes["k3"]["grid"],
        "plain_ms": sum(timed["k3"][1]) / 2,
        "bound_ms": k3_bound[0],
        "bound_by": k3_bound[1],
        "library_ms": None,
    }, {
        "name": "quality_backward",
        "route": "cuda",
        "source": "spath_tpu_torch/csrc/megakernel_quality_grad.cu",
        "replaces": "spath_tpu/ops/pallas/megakernel_quality_grad.py:322",
        "launches": qtr["k4"],
        "launches_by_path": {"serving": 0, "training": qtr["k4"]},
        "max_abs_err": qbwd_headline["max_abs_err"],
        "ms": k4_ms,
        "idle_lane_share": {
            "lockstep": lanes["k4"]["lockstep"]["idle_lane_share"],
            "epochs": lanes["k4"]["epochs"]["idle_lane_share"]},
        "grid": lanes["k4"]["grid"],
        "plain_ms": sum(timed["k4"][1]) / 2,
        "bound_ms": k4_bound[0],
        "bound_by": k4_bound[1],
        "library_ms": None,
    }, {
        "name": "bigscene_forward",
        "route": "cuda",
        "source": "spath_tpu_torch/csrc/bigscene.cu",
        "replaces": "spath_tpu/ops/pallas/megakernel_bigscene.py:410",
        "launches": btr["k6"],
        "launches_by_path": {"serving": serve["launches"]["K6"],
                             "training": btr["k6"]},
        "max_abs_err": serve["band_vs_plain"]["max_abs_err"],
        "ms": k6_ms_mean,
        "idle_lane_share": {
            k: v["idle_lane_share"] for k, v in walk["schedules"].items()
            if isinstance(v, dict)},
        "grid": {"ctas": k6_grid, "resident_per_sm": per_sm, "sms": sms},
        "band_ms": sum(k6_band_ms) / len(k6_band_ms),
        "plain_ms": sum(k6_plain_ms) / 2,
        "plain_at": f"rows {BAND_ROWS.start}-{BAND_ROWS.stop - 1}",
        "bound_ms": k6_bound[0],
        "bound_by": k6_bound[1],
        "library_ms": None,
    }, {
        "name": "stream_scatter",
        "route": "cuda",
        "source": "spath_tpu_torch/csrc/stream_scatter.cu",
        "replaces": "spath_tpu/ops/pallas/megakernel_bigscene.py:257",
        "launches": btr["k7"],
        "launches_by_path": {"serving": 0, "training": btr["k7"],
                             "quality training": qbtr["k7"],
                             "vis_grad training": vtr["launches"]["K7"]},
        "max_abs_err": k7["max_abs_err"],
        "ms": sum(k7["ms"]) / len(k7["ms"]),
        "plain_ms": sum(k7["plain_ms"]) / 2,
        "bound_ms": k7["bound"][0],
        "bound_by": k7["bound"][1],
        "library_ms": sum(k7["library_ms"]) / 2,
        "at_19_columns": {
            "ms": sum(k7q["ms"]) / len(k7q["ms"]),
            "plain_ms": sum(k7q["plain_ms"]) / 2,
            "bound_ms": k7q["bound"][0],
            "bound_by": k7q["bound"][1],
            "library_ms": sum(k7q["library_ms"]) / 2,
            "max_abs_err": k7q["max_abs_err"]},
        "as_gather_backward": vis_gathers,
    }, {
        "name": "bigscene_backward",
        "route": "cuda",
        "source": "spath_tpu_torch/csrc/bigscene_grad.cu",
        "replaces": "spath_tpu/ops/pallas/megakernel_bigscene_grad.py:69",
        "launches": btr["k8"],
        "launches_by_path": {"serving": 0, "training": btr["k8"]},
        "max_abs_err": k8_check["max_abs_err"],
        "ms": sum(k8_ms) / 2,
        "idle_lane_share": [
            {k: v["idle_lane_share"] for k, v in c.items()
             if isinstance(v, dict)} for c in twalk["chunk_schedules"]],
        "grid": {"ctas": k8_grid, "resident_per_sm": k8_per_sm, "sms": sms},
        "band_ms": sum(k8_band_ms) / len(k8_band_ms),
        "plain_ms": sum(k8_plain_ms) / 2,
        "plain_at": f"rows {BAND_ROWS.start}-{BAND_ROWS.stop - 1}, K8+K7",
        "bound_ms": k8_bound[0],
        "bound_by": k8_bound[1],
        "library_ms": None,
    }, {
        "name": "bigscene_quality_forward",
        "route": "cuda",
        "source": "spath_tpu_torch/csrc/bigscene_quality.cu",
        "replaces": "spath_tpu/ops/pallas/megakernel_bigscene_quality.py:329",
        "launches": qbtr["k9"],
        "launches_by_path": {"serving": serve_q["launches"]["K9"],
                             "training": qbtr["k9"]},
        "max_abs_err": serve_q["band_vs_plain"]["max_abs_err"],
        "ms": k9_ms_mean,
        "idle_lane_share": {
            k: v["idle_lane_share"] for k, v in qwalk["schedules"].items()
            if isinstance(v, dict)},
        "grid": {"ctas": k9_grid, "resident_per_sm": k9_per_sm,
                 "sms": q_sms},
        "band_ms": sum(k9_band_ms) / len(k9_band_ms),
        "plain_ms": sum(k9_plain_ms) / 2,
        "plain_at": f"rows {BAND_ROWS.start}-{BAND_ROWS.stop - 1}",
        "bound_ms": k9_bound[0],
        "bound_by": k9_bound[1],
        "library_ms": None,
    }, {
        "name": "bigscene_quality_backward",
        "route": "cuda",
        "source": "spath_tpu_torch/csrc/bigscene_quality_grad.cu",
        "replaces": "spath_tpu/ops/pallas/megakernel_bigscene_quality.py:542",
        "launches": qbtr["k10"],
        "launches_by_path": {"serving": 0, "training": qbtr["k10"]},
        "max_abs_err": k10_check["max_abs_err"],
        "ms": sum(k10_ms) / 2,
        "idle_lane_share": k10_idle,
        "grid": {"ctas": k10_grid, "resident_per_sm": k10_per_sm,
                 "sms": q_sms},
        "band_ms": sum(k10_band_ms) / len(k10_band_ms),
        "plain_ms": sum(k10_plain_ms) / 2,
        "plain_at": f"rows {BAND_ROWS.start}-{BAND_ROWS.stop - 1}, K10+K7",
        "bound_ms": k10_bound[0],
        "bound_by": k10_bound[1],
        "library_ms": None,
    }, {
        "name": "nearest_hit",
        "route": "cuda",
        "source": "spath_tpu_torch/csrc/intersect.cu",
        "replaces": "spath_tpu/ops/pallas/intersect_pallas.py:163",
        "launches": vtr["launches"]["K5"],
        "launches_by_path": {"vis_grad training": vtr["launches"]["K5"],
                             "vis_grad training, 10k": vbtr["launches"]["K5"],
                             "wavefront hash+uniform": wlaunched["K5"],
                             "microbenchmark": k5_bench["launches"]},
        "max_abs_err": max(k5_err, k5_bench["max_abs_err"]),
        "ms": sum(k5_slice["ms"]) / len(k5_slice["ms"]),
        "plain_ms": sum(k5_slice["plain_ms"]) / 2,
        "at": f"{k5_slice['rays']} rays x {k5_slice['n_tris']} triangles",
        "grid": k5_grid,
        "bound_ms": k5_slice["bound"][0],
        "bound_by": k5_slice["bound"][1],
        "bound_ops": k5_slice["ops"],
        "culled_pair_share": k5_slice["culled_pair_share"],
        "library_ms": None,
        "at_1080p_7_triangles": {
            "ms": sum(k5_frame["ms"]) / len(k5_frame["ms"]),
            "plain_ms": sum(k5_frame["plain_ms"]) / 2,
            "bound_ms": k5_frame["bound"][0],
            "bound_by": k5_frame["bound"][1]},
    }, {
        "name": "bigscene_quality_hits",
        "route": "cuda",
        "source": "spath_tpu_torch/csrc/bigscene_quality.cu",
        "replaces": "spath_tpu/ops/pallas/megakernel_bigscene_quality.py:390",
        "launches": vbtr["launches"]["K11"],
        "launches_by_path": {"vis_grad training, 10k": vbtr["launches"]["K11"]},
        "max_abs_err": k11_err,
        "ms": sum(k11_ms) / len(k11_ms),
        "idle_lane_share": {
            k: v["idle_lane_share"] for k, v in tqwalk["schedules"].items()
            if isinstance(v, dict)},
        "grid": {"ctas": k11_grid, "resident_per_sm": k11_per_sm,
                 "sms": q_sms},
        "k9_ms_in_turns": sum(k9_turn_ms) / len(k9_turn_ms),
        "band_ms": sum(k11_band_ms) / len(k11_band_ms),
        "plain_ms": sum(k11_plain_ms) / 2,
        "plain_at": f"rows {BAND_ROWS.start}-{BAND_ROWS.stop - 1}",
        "bound_ms": k11_bound[0],
        "bound_by": k11_bound[1],
        "library_ms": None,
    }, *t1_records, {
        "name": "threefry",
        "route": "cuda",
        "source": "spath_tpu_torch/csrc/threefry.cu",
        "replaces": "spath_tpu/ops/rng.py:220",
        "replaces_note": "per_pixel_uniforms, XLA; no Pallas kernel",
        "launches": preset["launches"]["threefry"],
        "launches_by_path": {
            "QUALITY serving": preset["launches"]["threefry"],
            "QUALITY training": preset_tr["launches"]["threefry"]},
        "max_abs_err": 0.0,
        "ms": tf_check["ms"],
        "ms_runs": tf_check["ms_runs"],
        "at": f"{HEADLINE['width']}x{HEADLINE['height']} pixels, 5 draws",
        "share_of_quality_frame": preset["threefry_share"],
        "plain_ms": tf_check["plain_ms"],
        "bound_ms": tf_check["bound_ms"],
        "bound_by": tf_check["bound_by"],
        "bound_rate": "33.4e12 integer operations/s (the SMs' issue "
                      "rate)",
        "library_ms": None,
        "library_note": "none: torch.rand is Philox, another stream",
    }]}
    by_name = {k["name"]: k for k in record["kernels"]}
    for path, runs in (
            ("sharded serving, one rank", one_rank["launches"]),
            ("sharded training, one rank", one_rank["grad_launches"]),
            ("sharded serving, rank 0 of two", two_ranks["launches"]),
            ("sharded training, rank 0 of two",
             two_ranks["grad_launches"]),
            ("above LIGHT_MAX lights, serving",
             {"": one_rank["light_cap"]["launches"]}),
            ("above LIGHT_MAX lights, training",
             {"": one_rank["light_cap"]["grad_launches"]}),
            ("ring serving, one rank", ring_one["launches"]),
            ("ring training, one rank", {**ring_one["grad_launches"],
                                         "step": ring_one["train_launches"]}),
            ("ring serving, rank 0 of two", ring_two["launches"]),
            ("ring training, rank 0 of two", ring_two["grad_launches"]),
            ("compact serving", compact["launches"]),
            ("compact training", compact["grad_launches"])):
        for launched in runs.values():
            for short, n in launched.items():
                paths = by_name[RECORD_NAMES[short]]["launches_by_path"]
                paths[path] = paths.get(path, 0) + n
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main() -> int:
    try:
        run()
    except Exception as e:  # noqa: BLE001 — every failure ends the run
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
