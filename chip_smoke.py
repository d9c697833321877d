#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``spath_tpu_torch/csrc`` and drives the
port's serving path and training path through the entry points a user
calls, in ten phases; any failure exits non-zero before a result is
printed.

1. Device: the card's name and power limit, and the kernel build.
2. Kernel against its plain PyTorch version on the same rays: the
   default scene and a 25-triangle scene at 320x240, 8 spp.
3. The slice at full width: ``render_pt_fast`` on the default scene at
   1920x1080, 64 spp, 5 bounces, through the CUDA kernel, against the
   plain wavefront ``render_pt`` at the same config, pixel by pixel.
4. The CLI: a path-traced and a flat 640x480 frame written as PNG.
5. At 1080p64: kernel against its plain version on the same rays, with
   the bounds of phase 2; then both timed, CUDA events around launches
   after warm-up, in turns (plain, kernel, kernel, plain).
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
    sweeps and hits counted by the plain replay for the kernels' bounds.

The last three lines of standard output are the kernels' JSON record,
the card as ``nvidia-smi`` names it, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

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
#: Operations counted from the kernels' source (compares, selects, loads
#: and integer work not counted): one Moller-Trumbore test is 18
#: multiplies, 15 adds or subtracts, 12 more in u, v and u + v, and one
#: divide; a hit costs K1 ~44 more (flip, two LCG divides, the sampler
#: with its 4 trig calls counted as one each, weight, radiance,
#: throughput, next origin); K2 replays the hit without the radiance (38)
#: and adds the reverse sweep and its 9 accumulating adds (43).
MT_OPS, K1_HIT_OPS, K2_HIT_OPS = 46, 44, 81
#: Peak rates of an H100 SXM (NVIDIA's data sheet): float32 outside the
#: tensor cores 67e12 FLOP/s, memory 3.35e12 bytes/s. The bound uses
#: them. The kernels are built with -fmad=false, so no multiply and add
#: fuse: they cannot do float32 work faster than half the peak,
#: NOFMA_OPS, reported beside the bound as a second ceiling.
PEAK_OPS, PEAK_BYTES, NOFMA_OPS = 67e12, 3.35e12, 67e12 / 2


class SmokeFailure(Exception):
    pass


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


def event_ms(torch, fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(ops: float, nbytes: float):
    """The least time the card could take, ms, and what bounds it."""
    t_ops, t_bytes = ops / PEAK_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def backward_vs_plain(torch, o, d, seeds, tri, cfg, name: str):
    """K2 against ``mega_bwd_plain`` on the same rays and a cotangent
    drawn uniform in [0.1, 1) from seed 3: each column group within
    GRAD_RTOL of its own max|plain| (exactly equal where the plain group
    is zero), columns 0-8 exactly zero, two launches bitwise equal.
    Returns the comparison and the cotangent."""
    from spath_tpu_torch.ops.kernels import megakernel_grad as mg

    gen = torch.Generator().manual_seed(3)
    gbar = (torch.rand((o.shape[0], 3), generator=gen) * 0.9
            + 0.1).to(o.device)
    got = mg.mega_bwd_call(o, d, seeds, tri, gbar, cfg)
    again = mg.mega_bwd_call(o, d, seeds, tri, gbar, cfg)
    torch.cuda.synchronize()
    want = mg.mega_bwd_plain(o, d, seeds, tri, gbar, cfg)
    check(torch.isfinite(got).all().item(), f"{name}: K2 not finite")
    check(want.abs().max().item() > 0.0, f"{name}: the plain adjoint is "
          "zero")
    rel = {}
    for group, cols in GRAD_GROUPS.items():
        scale = want[:, cols].abs().max().item()
        err = (got[:, cols] - want[:, cols]).abs().max().item()
        check(err <= GRAD_RTOL * scale, f"{name}: K2's {group} adjoint off "
              f"its plain version by {err:.6g}, max|plain| {scale:.6g}")
        rel[group] = err / scale if scale else 0.0
    check(bool((got[:, :9] == 0).all()), f"{name}: columns 0-8 not zero")
    check(torch.equal(got, again), f"{name}: two launches differ")
    return dict(max_abs_err=(got - want).abs().max().item(),
                rel_err_by_group=rel, deterministic=True), gbar


def gradient_entry(torch, dev, cam, scene) -> str:
    """Phase 7: ``render_radiance_fastgrad`` on the card against autograd
    of the plain wavefront, then emission linearity through K1 twice."""
    from spath_tpu_torch.config import RenderConfig
    from spath_tpu_torch.models.pathtracer import (
        render_radiance, render_radiance_fastgrad,
    )
    from spath_tpu_torch.ops.kernels import megakernel as mk
    from spath_tpu_torch.ops.kernels import megakernel_grad as mg
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

    mk.mega_call.launches = mg.mega_bwd_call.launches = 0
    got = grads(render_radiance_fastgrad)
    torch.cuda.synchronize()
    k1, k2 = mk.mega_call.launches, mg.mega_bwd_call.launches
    check(k1 > 0 and k2 > 0, f"render_radiance_fastgrad launched K1 {k1} "
          f"and K2 {k2} times")
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
    return (f"K1 {k1} and K2 {k2} launches; gradient error / max: "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f"; emission <g, dir> {got_d:.7g} vs L(e+dir) - L(e) "
            f"{want_d:.7g}")


def training(torch, dev, cam, scene, cfg) -> dict:
    """Phase 8: three train steps at full width through K1 and K2."""
    import dataclasses

    import numpy as np

    from spath_tpu_torch.models.inverse import (
        InverseParams, init_state, make_train_step, param_group_optimizer,
    )
    from spath_tpu_torch.models.pathtracer import render_radiance_fastgrad
    from spath_tpu_torch.models.renderer import forward_renderer
    from spath_tpu_torch.ops.kernels import megakernel as mk
    from spath_tpu_torch.ops.kernels import megakernel_grad as mg

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

    mk.mega_call.launches = mg.mega_bwd_call.launches = 0
    losses, step_s = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        state, aux = step(state, target)
        losses.append(float(aux["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    k1, k2 = mk.mega_call.launches, mg.mega_bwd_call.launches
    check(k1 == 3 and k2 == 3, f"3 train steps launched K1 {k1} and K2 "
          f"{k2} times")
    check(all(np.isfinite(losses)), f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")

    albedo = state.params.albedo.detach().clone().requires_grad_()

    def fwd_bwd():
        img = render_radiance_fastgrad(
            dataclasses.replace(scene, albedo=albedo), cam, cfg, 0)
        torch.autograd.grad(((img - target) ** 2).mean(), [albedo])

    fwd_bwd()
    ms = event_ms(torch, fwd_bwd, 3)
    return dict(k1=k1, k2=k2, losses=losses, step_s=step_s, fwd_bwd_ms=ms)


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
    plain = render_pt(scene, cam, cfg, 0)
    torch.cuda.synchronize()
    plain_first_s = time.perf_counter() - t0
    m, pm = img.mean().item(), plain.mean().item()
    flipped = ((img - plain).abs() > FLIP_ATOL).any(-1).float().mean().item()
    frame = f"{cfg.width}x{cfg.height} spp{cfg.spp}"
    log(f"[3] render_pt_fast {frame}: {launches} launch(es), "
        f"first call {slice_first_s:.3f} s, mean {m:.6f}; plain render_pt "
        f"{plain_first_s:.3f} s, mean {pm:.6f}; pixels off >1e-4: "
        f"{flipped:.6f}")
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
        f"plain {plain_ms} ms, render_pt_fast {slice_ms:.3f} ms; "
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
        f"K1 {tr['k1']} and K2 {tr['k2']} launches, losses {tr['losses']}, "
        f"step s {[round(x, 6) for x in tr['step_s']]}; "
        f"render_radiance_fastgrad forward+backward {tr['fwd_bwd_ms']:.3f} "
        f"ms, {segs / (tr['fwd_bwd_ms'] / 1e3):.4e} rays/s")

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
    # the walk's work, from the plain replay: one camera sweep per ray,
    # then a sweep for every bounce after a hit
    n, n_tris = o.shape[0], tri.shape[0]
    sweeps, hits = n, 0
    with torch.no_grad():
        for saved in mg.replay(o, d, seeds, tri, cfg):
            per_bounce = torch.stack([hit.sum() for hit, *_ in saved])
            hits += int(per_bounce.sum())
            sweeps += int(per_bounce[:-1].sum())
    ray_bytes = n * (24 + 8) + n_tris * 18 * 4
    k1_ops = sweeps * n_tris * MT_OPS + hits * K1_HIT_OPS
    k2_ops = sweeps * n_tris * MT_OPS + hits * K2_HIT_OPS
    k1_bound = bound(k1_ops, ray_bytes + n * 12)
    k2_bound = bound(k2_ops, ray_bytes + n * 12 + n_tris * 18 * 4)
    log(f"[10] {frame} on {smi}: K2 {bkernel_ms} ms, plain {bplain_ms} ms; "
        f"K2 {segs / (k2_ms / 1e3):.4e} rays/s; the walk: {sweeps} sweeps, "
        f"{hits} hits; bound K1 {k1_bound[0]:.4f} ms, K2 "
        f"{k2_bound[0]:.4f} ms ({k1_bound[1]}); without FMA at "
        f"{NOFMA_OPS:.3g}/s: K1 {k1_ops / NOFMA_OPS * 1e3:.4f} ms, K2 "
        f"{k2_ops / NOFMA_OPS * 1e3:.4f} ms")
    check(k2_ms > 0 and p2_ms > 0, "timing failed")

    print(json.dumps({"kernels": [{
        "name": "megakernel_forward",
        "route": "cuda",
        "source": "spath_tpu_torch/csrc/megakernel.cu",
        "replaces": "spath_tpu/ops/pallas/megakernel.py:182",
        "launches": tr["k1"],
        "launches_by_path": {"serving": launches, "training": tr["k1"]},
        "max_abs_err": headline["max_abs_err"],
        "ms": k_ms,
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
        "plain_ms": p2_ms,
        "bound_ms": k2_bound[0],
        "bound_by": k2_bound[1],
        "library_ms": None,
    }]}))
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
