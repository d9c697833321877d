"""Command-line interface of the port.

  render   one frame of a scene → PNG/PPM
  invert   recover the scene's albedo from a rendered target

``--scene`` picks the scene: ``default`` (the reference's 7 triangles),
``procedural:N[:seed]`` (N random triangles) or a ``.obj``/``.ply``
mesh. Scenes of up to 2^20 triangles render and train on a CUDA device
in both modes: the fused kernels (K1/K2, K3/K4) take the small ones, the
streamed kernels (K6/K8/K7, K9/K10/K7) the large ones.

``--mode conformance`` (the default) is the reference's estimator, LCG
and angle sampler, or with ``--rng table`` the reference's ``vec_dist``
table stream; ``--mode quality`` is the cosine sampler with next-event
estimation and MIS on a counter-based stream, ``--rng hash`` (the
default) or ``--rng threefry`` (``jax.random``'s stream, the JAX
package's ``QUALITY`` preset), with ``--rr-start`` (Russian roulette) and
``--stratify``, as the JAX package's CLI builds it. The clamped frame
goes through ``render_pt_fast``, the serving path (on a CUDA device the
CUDA kernel of the mode, K1, K6, K3 or K9; the threefry and table streams
take the wavefront on K5, threefry's draws from ``csrc/threefry.cu``);
``--tonemap`` maps the serving path's unclamped radiance instead, after
``--exposure``; ``--flat`` renders the flat debug view. ``--intersect``
names the JAX package's nearest-hit implementation; each is the same
exact sweep in the port. ``invert`` trains through
``render_radiance_fastgrad`` (the kernel forward and its reverse sweep
backward, K1+K2, K6+K8, K3+K4 or K9+K10, on a CUDA device; the wavefront
with autograd for the threefry and table streams). Examples::

  python -m spath_tpu_torch.cli render --size 640x480 --spp 128 --out frame.png
  python -m spath_tpu_torch.cli render --scene procedural:10000 --size 1920x1080 --spp 64
  python -m spath_tpu_torch.cli render --mode quality --spp 32 --out q.png
  python -m spath_tpu_torch.cli render --mode quality --scene procedural:10000
  python -m spath_tpu_torch.cli render --mode quality --rng threefry --spp 32
  python -m spath_tpu_torch.cli render --mode quality --tonemap aces --exposure 2
  python -m spath_tpu_torch.cli render --rng table --device cpu --out t.png
  python -m spath_tpu_torch.cli render --flat --device cpu --out flat.png
  python -m spath_tpu_torch.cli invert --size 640x480 --spp 16 --steps 100
"""

from __future__ import annotations

import argparse
import sys
import time


def _parse_vec3(s: str):
    parts = [float(x) for x in s.split(",")]
    if len(parts) != 3:
        raise argparse.ArgumentTypeError(f"expected x,y,z — got {s!r}")
    return parts


def _parse_size(s: str):
    w, h = s.lower().split("x")
    return int(w), int(h)


def _device(name: str):
    import torch

    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {name}: no CUDA device here "
                             "(use --device cpu for the plain wavefront)")
        if (device.index or 0) >= torch.cuda.device_count():
            raise SystemExit(f"--device {name}: only "
                             f"{torch.cuda.device_count()} CUDA devices")
    elif device.type != "cpu":
        raise SystemExit(f"--device {name}: use cuda or cpu")
    return device


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--size", type=_parse_size, default=(640, 480),
                   help="WxH resolution (reference default 640x480)")
    p.add_argument("--spp", type=int, default=128,
                   help="samples per pixel (reference default 128)")
    p.add_argument("--bounces", type=int, default=5,
                   help="path length cap (reference: hard 5)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scene", default="default",
                   help='"default" (the 7-triangle scene), '
                        '"procedural:N[:seed]", or a path to a .obj/.ply '
                        'mesh (MTL Kd/Ke -> albedo/emission)')
    p.add_argument("--camera-pos", type=_parse_vec3, default=[0, 0, -3])
    p.add_argument("--camera-angle", type=_parse_vec3, default=[0, 0, 0])
    p.add_argument("--focal", type=float, default=2.0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the CUDA kernels) or cpu (the plain "
                        "wavefront); a missing card is an error")
    p.add_argument("--mode", choices=["conformance", "quality"],
                   default="conformance",
                   help="conformance = reference LCG+angle sampler; "
                        "quality = cosine+NEE+MIS (counter-based RNG)")
    p.add_argument("--rng", choices=["hash", "threefry", "table"],
                   default="hash",
                   help="quality-mode RNG: 'hash' (default, the fused "
                        "quality kernels) or 'threefry' (jax.random's "
                        "stream, the wavefront with the threefry kernel). "
                        "Conformance mode is always the reference LCG, "
                        "except '--rng table', the reference's vec_dist "
                        "shuffled-table debug RNG (src/frand.h:32-50), "
                        "conformance mode only")
    p.add_argument("--intersect",
                   choices=["reference", "pluecker", "pallas", "pallas_fast"],
                   default=None,
                   help="the JAX package's nearest-hit implementation "
                        "(default pluecker); every one is the same exact "
                        "sweep here")
    p.add_argument("--rr-start", type=int, default=0,
                   help="Russian-roulette start bounce (0 = off; quality "
                        "mode only)")
    p.add_argument("--stratify", action="store_true",
                   help="stratify first-bounce sampling across spp "
                        "(quality mode only)")


def _config(args):
    """The ``RenderConfig`` of the arguments, with the JAX CLI's refusals
    (``spath_tpu/cli.py::_build``)."""
    from spath_tpu_torch.config import RenderConfig

    w, h = args.size
    base = dict(width=w, height=h, spp=args.spp, max_bounces=args.bounces,
                intersect=args.intersect or "pluecker")
    if args.mode == "quality":
        if args.rng == "table":
            raise SystemExit(
                "--rng table is a conformance-mode debug RNG (quality "
                "mode's NEE needs a counter-based stream)")
        return RenderConfig(**base, rng=args.rng, sampler="cosine",
                            nee=True, rr_start=args.rr_start,
                            stratify=args.stratify)
    if args.rr_start or args.stratify:
        raise SystemExit(
            "--rr-start/--stratify need --mode quality (the conformance "
            "LCG stream layout has no slot for them)")
    return RenderConfig(**base, rng="table" if args.rng == "table"
                        else "lcg", sampler="angle")


def _scene(spec: str, device):
    """The scene ``--scene`` names, on ``device``; an unknown form exits
    non-zero (``spath_tpu/cli.py::_build``)."""
    from spath_tpu_torch.scene import default_scene, procedural_scene

    if spec == "default":
        return default_scene(device)
    if spec.startswith("procedural:"):
        parts = spec.split(":")
        try:
            n = int(parts[1])
            seed = int(parts[2]) if len(parts) > 2 else 0
        except (IndexError, ValueError):
            raise SystemExit(f"unknown scene {spec!r}") from None
        return procedural_scene(n, seed=seed, device=device)
    if spec.lower().endswith((".obj", ".ply")):
        from spath_tpu_torch.scene_io import load_scene

        return load_scene(spec, device=device)
    raise SystemExit(f"unknown scene {spec!r}")


def cmd_render(args) -> int:
    cfg = _config(args)
    if args.flat and args.tonemap != "clamp":
        raise SystemExit(
            "--tonemap operators need HDR radiance; the flat debug "
            "view is already LDR (drop --flat or --tonemap)")
    device = _device(args.device)

    from spath_tpu_torch.convert import camera_from_numpy
    from spath_tpu_torch.models.flat import render_flat
    from spath_tpu_torch.models.pathtracer import render_pt_fast
    from spath_tpu_torch.models.renderer import forward_renderer
    from spath_tpu_torch.utils.image import tonemap, write_png, write_ppm

    scene = _scene(args.scene, device)
    cam = camera_from_numpy(args.camera_pos, args.camera_angle, args.focal,
                            device=device)
    w, h = args.size
    t0 = time.perf_counter()
    if args.flat:
        img = render_flat(scene, cam, cfg).cpu().numpy()
    elif args.tonemap != "clamp":
        # the serving path's unclamped radiance (its kernel on the card)
        hdr = forward_renderer(scene, cfg).render_radiance(scene, cam, cfg,
                                                           args.seed)
        img = tonemap(hdr.cpu().numpy(), args.tonemap, args.exposure)
    else:
        img = render_pt_fast(scene, cam, cfg, args.seed).cpu().numpy()
    dt = time.perf_counter() - t0
    n_rays = w * h * (1 if args.flat else cfg.spp * cfg.max_bounces)
    print(f"rendered {w}x{h} on {device} in {dt:.3f}s "
          f"({n_rays / dt:.4g} rays/s incl. kernel build)", file=sys.stderr)

    if args.out.endswith(".ppm"):
        write_ppm(args.out, img)
    else:
        write_png(args.out, img)
    print(args.out)
    return 0


def cmd_invert(args) -> int:
    """Albedo recovery, as the JAX package's ``invert``: render the target
    at the true scene, perturb the albedo (``default_rng(1)`` uniform
    ±0.4, clipped to [0.05, 1]) and descend with the pose frozen and the
    target's seed fixed."""
    cfg = _config(args)
    device = _device(args.device)

    import numpy as np
    import torch

    from spath_tpu_torch.convert import camera_from_numpy
    from spath_tpu_torch.models.inverse import (
        InverseParams, param_group_optimizer, recover,
    )
    from spath_tpu_torch.models.renderer import forward_renderer

    scene = _scene(args.scene, device)
    cam = camera_from_numpy(args.camera_pos, args.camera_angle, args.focal,
                            device=device)
    print("rendering target...", file=sys.stderr)
    # render_radiance's value, through the serving path's renderer (the
    # fused kernel on a CUDA device)
    target = forward_renderer(scene, cfg).render_radiance(scene, cam, cfg,
                                                          args.seed)

    true_albedo = scene.albedo.cpu().numpy()
    rng = np.random.default_rng(1)
    bad_albedo = np.clip(
        true_albedo
        + rng.uniform(-0.4, 0.4, true_albedo.shape).astype(np.float32),
        0.05, 1.0)
    params = InverseParams(
        cam_pos=cam.pos, cam_angle=cam.angle, cam_focal=cam.focal,
        albedo=torch.from_numpy(bad_albedo).to(device))
    t0 = time.perf_counter()
    state, losses = recover(
        scene, target, params, cfg, steps=args.steps,
        optimizer=param_group_optimizer(freeze_pose=True, albedo_lr=2e-2),
        fixed_seed=args.seed, checkpoint_dir=args.checkpoint_dir,
        log_fn=lambda m: print(m, file=sys.stderr))
    dt = time.perf_counter() - t0
    err0 = np.abs(bad_albedo - true_albedo).mean()
    err1 = np.abs(state.params.albedo.detach().cpu().numpy()
                  - true_albedo).mean()
    if losses:
        print(f"{len(losses)} steps on {device} in {dt:.3f}s",
              file=sys.stderr)
        print(f"albedo error {err0:.4f} -> {err1:.4f}; "
              f"loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    else:
        print(f"albedo error {err0:.4f} -> {err1:.4f}; no step left to run")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="spath-tpu-torch", description=__doc__)
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("render", help="render one frame to an image file")
    _add_common(p)
    p.add_argument("--flat", action="store_true",
                   help="flat-shaded debug view (reference render_flat)")
    p.add_argument("--tonemap", default="clamp",
                   choices=["clamp", "reinhard", "aces", "gamma22"],
                   help="HDR->display operator (clamp = reference "
                        "semantics, src/scene.h:32-39)")
    p.add_argument("--exposure", type=float, default=1.0,
                   help="linear exposure multiplier before tonemapping")
    p.add_argument("--out", default="frame.png")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("invert", help="inverse-rendering demo: recover "
                                      "the albedo")
    _add_common(p)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--checkpoint-dir", default=None,
                   help="save every 50 steps and at the end; resume from "
                        "the newest checkpoint found there")
    p.set_defaults(fn=cmd_invert)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
