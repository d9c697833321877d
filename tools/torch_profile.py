#!/usr/bin/env python3
"""Where the device time of the port's two paths goes, on one CUDA card.

    python3 tools/torch_profile.py [--calls 5] [--out build/profile]
                                   [--paths conformance,quality,big,...]

At 1920x1080, 64 spp, 5 bounces on the default scene, after warm-up,
traces ``--calls`` calls of each path with ``torch.profiler``, for the
conformance estimator (K1, K2) and for the quality estimator as the CLI's
``--mode quality`` builds it (K3, K4); then ``BIG_CALLS`` calls of each
path on ``procedural_scene(10_000, seed=0)`` in the conformance
estimator (K6; K6, K8 and K7), serving at 64 spp and training at 8, as
``chip_smoke.py`` phases 21 and 23 run them, and in the quality estimator
(the light distribution and K9; with K10 and K7), serving at
``BIGQ_SERVE_SPP`` spp and training at ``BIGQ_TRAIN_SPP``, as phases 29
and 31 run them:

- serving: ``render_pt_fast``;
- training: ``make_train_step`` with the CLI's perturbation and
  optimizer (``param_group_optimizer(freeze_pose=True)``), fixed seed;
  in the quality estimator the pose group is enabled at rate 0, as
  ``chip_smoke.py`` phase 15 runs it, so the step also carries the
  camera's gradient.

Visibility gradients (``vis``, ``big_vis``): a quality train step with
``vis_grad`` through ``VisGradFusedRenderer``, as ``chip_smoke.py``
phases 39 and 40 run it: the default scene at 1920x1080, ``VIS_TRAIN_SPP``
spp (the interior K3+K4, the residual's sweeps on K5), and the 10k scene
at ``BIGQ_TRAIN_SPP`` (the interior's forward K11 with its hit export,
K10 and K7, the residual's edge sweeps on K5).

For each path it prints one JSON line: CUDA-event ms per call around the
traced calls, the device's busy ms per call (the union of the kernels'
intervals), the idle share (1 - busy / event time), the kernels grouped
by name with their count and ms per call, largest first, and the device
ms per call split into the port's kernels (K1-K11, the light
distribution) and the glue, every other kernel. ``--paths`` picks the
paths (default: all). The chrome traces go under ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

HEADLINE = dict(width=1920, height=1080, spp=64, max_bounces=5)
QUALITY = dict(rng="hash", sampler="cosine", nee=True, mis=True)
# Traced calls of each large-scene path: one serving frame at 10k
# triangles takes ~15 s on an H100.
BIG_CALLS = 1
# The quality estimator's large-scene shapes (chip_smoke.py phases 29, 31).
BIGQ_SERVE_SPP, BIGQ_TRAIN_SPP = 16, 4
# The vis_grad training cell (chip_smoke.py phase 39).
VIS_TRAIN_SPP = 8
PATHS = ("conformance", "quality", "big", "big_quality", "vis", "big_vis")
#: The port's kernels by a substring of their name, tested in this order
#: (the streamed kernels' names hold the fused ones'); each is a function
#: of an anonymous namespace, which sets them apart from PyTorch's own
#: (``at::native::_scatter_gather_elementwise_kernel``).
KERNEL_GROUPS = tuple((group, "namespace)::" + key) for group, key in (
    ("K11", "bigscene_quality_forward<true>"),
    ("K9", "bigscene_quality_forward"), ("K10", "bigscene_quality_backward"),
    ("K6", "bigscene_forward"), ("K8", "bigscene_backward"),
    ("K3", "quality_forward"), ("K4", "quality_backward"),
    ("K1", "megakernel_forward"), ("K2", "megakernel_backward"),
    ("K5", "nearest_hit"), ("K7", "scatter_"), ("light", "cdf_"),
    ("light", "light_cdf")))


def split(table) -> dict:
    """Device ms per call by the port's kernel, the rest as glue."""
    out: dict[str, float] = {}
    for name, _, ms in table:
        group = next((g for g, key in KERNEL_GROUPS if key in name), "glue")
        out[group] = out.get(group, 0.0) + ms
    return out


def busy_and_kernels(trace: dict, calls: int):
    """Union of kernel intervals (ms per call) and per-name totals."""
    kernels = [e for e in trace["traceEvents"]
               if e.get("cat") == "kernel" and "dur" in e]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict[str, list] = {}
    for e in kernels:
        name = e["name"][:80]
        rec = by_name.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += e["dur"]
    table = sorted(((n, c / calls, us / 1e3 / calls)
                    for n, (c, us) in by_name.items()),
                   key=lambda r: -r[2])
    return busy / 1e3 / calls, table


def profile(name: str, fn, calls: int, out: Path, host: bool = True) -> dict:
    """One path's line. ``host=False`` traces the device alone: a vis_grad
    step launches ~10^5-10^6 small kernels, whose host-side events would
    make the trace several times larger."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    activities = [ProfilerActivity.CUDA]
    if host:
        activities.insert(0, ProfilerActivity.CPU)
    with torch_profile(activities=activities) as prof:
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
    path = out / f"{name}.json"
    prof.export_chrome_trace(str(path))
    busy, table = busy_and_kernels(json.loads(path.read_text()), calls)
    ms = start.elapsed_time(end) / calls
    return dict(path=name, ms_per_call=ms, busy_ms_per_call=busy,
                idle_share=1.0 - busy / ms, split_ms=split(table),
                kernels=[dict(name=n, count=c, ms=t) for n, c, t in table])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--out", default="build/profile")
    ap.add_argument("--paths", default=",".join(PATHS),
                    help="comma-separated, of " + ", ".join(PATHS))
    args = ap.parse_args()
    paths = args.paths.split(",")
    if not set(paths) <= set(PATHS):
        raise SystemExit(f"--paths: unknown {set(paths) - set(PATHS)}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from spath_tpu_torch.camera import Camera
    from spath_tpu_torch.config import RenderConfig
    from spath_tpu_torch.models.inverse import (
        InverseParams, init_state, make_train_step, param_group_optimizer,
    )
    from spath_tpu_torch.models.pathtracer import render_pt_fast
    from spath_tpu_torch.models.renderer import forward_renderer
    from spath_tpu_torch.scene import default_scene, procedural_scene

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    cam = Camera.default(dev)
    small, big = default_scene(dev), procedural_scene(10_000, seed=0,
                                                       device=dev)
    frozen = param_group_optimizer(freeze_pose=True, albedo_lr=2e-2)
    pose_at_0 = param_group_optimizer(freeze_pose=False, pose_lr=0.0,
                                      albedo_lr=2e-2)
    quality = RenderConfig(**HEADLINE, **QUALITY)
    vis = quality.replace(vis_grad=True)
    for path, prefix, scene, cfg, train_cfg, optimizer, calls in (
            ("conformance", "", small, RenderConfig(**HEADLINE), None, frozen,
             args.calls),
            ("quality", "quality_", small, quality, None, pose_at_0,
             args.calls),
            ("big", "big_", big, RenderConfig(**HEADLINE),
             RenderConfig(**dict(HEADLINE, spp=8)), frozen, BIG_CALLS),
            ("big_quality", "big_quality_", big,
             quality.replace(spp=BIGQ_SERVE_SPP),
             quality.replace(spp=BIGQ_TRAIN_SPP), pose_at_0, BIG_CALLS),
            ("vis", "vis_", small, None, vis.replace(spp=VIS_TRAIN_SPP),
             pose_at_0, BIG_CALLS),
            ("big_vis", "big_vis_", big, None,
             vis.replace(spp=BIGQ_TRAIN_SPP), pose_at_0, BIG_CALLS)):
        if path not in paths:
            continue
        if cfg is not None:     # the vis_grad frame is the quality frame
            print(json.dumps(profile(
                prefix + "serving",
                lambda: render_pt_fast(scene, cam, cfg, 0), calls, out)),
                flush=True)

        cfg = train_cfg or cfg
        albedo = scene.albedo.cpu().numpy()
        bad = np.clip(albedo + np.random.default_rng(1).uniform(
            -0.4, 0.4, albedo.shape).astype(np.float32), 0.05, 1.0)

        target = forward_renderer(scene, cfg).render_radiance(scene, cam,
                                                              cfg, 0)
        state = [init_state(optimizer, InverseParams(
            cam.pos, cam.angle, cam.focal, torch.from_numpy(bad).to(dev)))]
        step = make_train_step(scene, cfg, fixed_seed=0)

        def train():
            state[0], _ = step(state[0], target)

        print(json.dumps(profile(prefix + "training", train, calls, out,
                                 host=not cfg.vis_grad)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
