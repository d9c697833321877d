#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``spath_tpu_torch/csrc`` and drives the
port's serving path through the entry points a user calls, in five
phases; any failure exits non-zero before a result is printed.

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


def run() -> None:
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    from spath_tpu_torch.camera import Camera
    from spath_tpu_torch.config import RenderConfig
    from spath_tpu_torch.models.pathtracer import render_pt, render_pt_fast
    from spath_tpu_torch.ops.kernels import build
    from spath_tpu_torch.ops.kernels import megakernel as mk
    from spath_tpu_torch.scene import default_scene
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

    print(json.dumps({"kernels": [{
        "name": "megakernel_forward",
        "route": "cuda",
        "source": "spath_tpu_torch/csrc/megakernel.cu",
        "replaces": "spath_tpu/ops/pallas/megakernel.py:182",
        "launches": launches,
        "max_abs_err": headline["max_abs_err"],
        "ms": k_ms,
        "plain_ms": p_ms,
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
