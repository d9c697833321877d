"""Time the intersection sweep's matrix product apart from its epilogue,
on one CUDA card.

    python -m spath_tpu_torch.tools.sweep_microbench [--width 640]
        [--height 360] [--tris 65536] [--reps 5] [--device cuda|cpu]

The counterpart of ``tools/sweep_microbench.py``. On
``procedural_scene(--tris, seed=0)`` against the ``--width`` x
``--height`` camera rays of ``Camera.default()`` it times:

- the full sweep kernel: K5, the nearest hit (``nearest_hit_call``, no
  source triangle), Moller-Trumbore on the CUDA cores;
- T1 at K = 128 and at K = 64 (``sweep_mm_call``): the Plücker product
  on the bf16 tensor cores (warpgroup ``wgmma`` fed by TMA) with a bare
  min in place of the epilogue;
- the library yardstick at K = 128 and at K = 64 (``yardstick``): cuBLAS
  through ``torch.mm`` of the same bf16 operands with a float32 result, a
  chunk of blocks at a time, then ``amin`` and the ordered block sum. It
  writes every product to device memory, which T1 never does; the port
  never calls it.

Each line gives ms a call (CUDA events around ``--reps`` calls after a
warm-up; the lines are timed in turns, in order and then in reverse, so
each has two times), pairs/s, TFLOP/s and the share of its bound: T1's
and the yardstick's is ``sweep_mm.bound`` (the 60 live bf16 products of a
quad at the tensor cores' peak), K5's its float32 operations at the CUDA
cores' peak. The card's name and power limit go on a line of their own.

``--device cpu`` runs the plain versions once, as a rehearsal, prints
what they computed and that they ran on the CPU, and times nothing.
Without a card and without ``--device cpu`` it exits non-zero.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import torch

from spath_tpu_torch.camera import Camera, generate_rays
from spath_tpu_torch.ops.kernels import intersect as k5
from spath_tpu_torch.ops.kernels import sweep_mm
from spath_tpu_torch.scene import procedural_scene

#: Float32 operations of one Moller-Trumbore test in K5 (csrc/intersect.cu:
#: 18 multiplies, 15 adds, 12 more in u, v and u + v, one divide).
K5_PAIR_OPS = 46
#: Bytes of float32 products the yardstick holds at once.
YARD_CHUNK_BYTES = 8 << 30


def card() -> str:
    """The card as ``nvidia-smi`` names it, with its power limit."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def operands(width: int, height: int, n_tris: int, device) -> dict:
    """The sweep's inputs: the scene, the camera rays, the scene's K5
    table and the T1 operands at K = 128 and K = 64."""
    scene = procedural_scene(n_tris, seed=0, device=device)
    o, d = generate_rays(Camera.default(device), width, height)
    v0, v1, v2 = scene.v0, scene.v1, scene.v2
    g128, r128 = sweep_mm.sweep_operands(o, d, v0, v1, v2)
    g64, r64 = sweep_mm.pack_k64(g128, r128)
    return dict(scene=scene, o=o.contiguous(), d=d.contiguous(),
                n_rays=o.shape[0],
                n_tris=n_tris, tri=k5.pack_triangles(v0, v1 - v0, v2 - v0),
                src=torch.full((o.shape[0],), -1, dtype=torch.int64,
                               device=device),
                t1={128: (g128, r128), 64: (g64, r64)})


def yardstick(gfeat, rfeat):
    """T1's function through the library: ``torch.mm`` of the bf16
    operands into float32 products, a chunk of blocks at a time, each
    block's ``amin`` over its rows, the minima added in block order in
    float32. CUDA tensors only."""
    n = rfeat.shape[1]
    g = gfeat.reshape(-1, sweep_mm.BLOCK_ROWS, gfeat.shape[1])
    per = max(1, YARD_CHUNK_BYTES // (sweep_mm.BLOCK_ROWS * n * 4))
    total = torch.zeros(n, dtype=torch.float32, device=gfeat.device)
    for b0 in range(0, g.shape[0], per):
        chunk = g[b0:b0 + per]
        quads = torch.mm(chunk.reshape(-1, gfeat.shape[1]), rfeat,
                         out_dtype=torch.float32)
        for part in quads.reshape(chunk.shape[0], -1, n).amin(dim=1):
            total += part
    return total


def _event_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def lines(ops: dict) -> list[dict]:
    """The timed lines: name, the call, its executed FLOP (or float32
    operations for K5) and its bound."""
    n, t = ops["n_rays"], ops["n_tris"]
    pairs = n * t
    k5_ops = K5_PAIR_OPS * pairs
    k5_bytes = n * (24 + 8 + 4 + 8) + t * 36
    k5_bound = max(k5_ops / sweep_mm.PEAK_FP32, k5_bytes / sweep_mm.PEAK_BYTES)
    out = [dict(name="full sweep kernel (K5)", key="K5",
                call=lambda: k5.nearest_hit_call(ops["o"], ops["d"],
                                                 ops["tri"], ops["src"]),
                flop=k5_ops, bound_ms=k5_bound * 1e3)]
    for k in (128, 64):
        g, r = ops["t1"][k]
        b = sweep_mm.bound(n, t, k)
        out.append(dict(name=f"T1 matmul-only K={k} (wgmma bf16, TMA)",
                        key=f"T1 K={k}", call=lambda g=g, r=r:
                        sweep_mm.sweep_mm_call(g, r),
                        flop=2 * 4 * k * pairs, bound_ms=b["ms"]))
    for k in (128, 64):
        g, r = ops["t1"][k]
        out.append(dict(name=f"cuBLAS bf16 GEMM + amin, K={k}",
                        key=f"cuBLAS K={k}",
                        call=lambda g=g, r=r: yardstick(g, r),
                        flop=2 * 4 * k * pairs,
                        bound_ms=sweep_mm.bound(n, t, k)["ms"]))
    return out


def measure(ops: dict, reps: int) -> dict:
    """Every line timed in turns (in order, then in reverse), each after a
    warm-up call; ``{key: dict(ms=[two times], launches=T1's launches in
    the line's calls, warm-up included, ...)}``."""
    todo = lines(ops)

    def counted(line, fn):
        before = sweep_mm.sweep_mm_call.launches
        out = fn()
        line["launches"] += sweep_mm.sweep_mm_call.launches - before
        return out

    for line in todo:
        line.update(ms=[], launches=0)
        counted(line, line["call"])
    torch.cuda.synchronize()
    for line in todo + todo[::-1]:
        line["ms"].append(counted(line, lambda: _event_ms(line["call"],
                                                          reps)))
    pairs = ops["n_rays"] * ops["n_tris"]
    for line in todo:
        ms = sum(line["ms"]) / len(line["ms"])
        line.update(mean_ms=ms, pairs_per_s=pairs / (ms / 1e3),
                    tflops=line["flop"] / (ms / 1e3) / 1e12,
                    bound_share=line["bound_ms"] / ms)
    return {line["key"]: {k: v for k, v in line.items() if k != "call"}
            for line in todo}


def rehearse(ops: dict) -> dict:
    """The plain versions once on the CPU: K5's hits and T1's outputs."""
    _, idx = k5.nearest_hit_call(ops["o"], ops["d"], ops["tri"], ops["src"])
    t1 = {k: sweep_mm.sweep_mm_call(*ops["t1"][k]) for k in (128, 64)}
    return dict(k5_hits=int((idx >= 0).sum()),
                t1_sum={k: v.double().sum().item() for k, v in t1.items()},
                t1_k128_vs_k64=(t1[128] - t1[64]).abs().max().item())


def run(argv=None) -> dict:
    """Parse the arguments, measure (or rehearse on the CPU), print the
    lines; returns what was printed, as numbers, and on the card the
    operands it timed (``ops``)."""
    ap = argparse.ArgumentParser(
        prog="python -m spath_tpu_torch.tools.sweep_microbench",
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--tris", type=int, default=65536)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.tris < sweep_mm.TILE_T or args.tris % sweep_mm.TILE_T:
        raise SystemExit(f"--tris {args.tris}: a positive multiple of "
                         f"{sweep_mm.TILE_T}")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device here: the microbenchmark times the "
                         "card (use --device cpu for a rehearsal of the "
                         "plain versions)")
    device = torch.device(args.device)
    ops = operands(args.width, args.height, args.tris, device)
    n, t = ops["n_rays"], ops["n_tris"]
    shape = f"{n} rays x {t} triangles ({n * t:.4e} pairs)"
    if device.type == "cpu":
        plain = rehearse(ops)
        print(f"ran on the CPU, the plain versions once, nothing timed: "
              f"{shape}", flush=True)
        print(f"K5 plain: {plain['k5_hits']} rays hit; T1 plain sums "
              f"{plain['t1_sum']}, max |K=128 - K=64| "
              f"{plain['t1_k128_vs_k64']:.3e}", flush=True)
        return dict(device="cpu", **plain)
    b128, b64 = sweep_mm.bound(n, t, 128), sweep_mm.bound(n, t, 64)
    smi = card()
    print(f"card: {smi}", flush=True)
    print(f"{shape}; T1 bound {b64['ms']:.4f} ms ({b64['by']}: "
          f"{b64['flop']:.4e} bf16 FLOP of {sweep_mm.LIVE_TERMS} live "
          f"terms), ceilings {b128['ceiling_ms']:.4f} ms (K=128), "
          f"{b64['ceiling_ms']:.4f} ms (K=64), the min on the CUDA cores "
          f"{b64['min_ms']:.4f} ms", flush=True)
    result = measure(ops, args.reps)
    for line in result.values():
        print(f"{line['name']:38s} {line['mean_ms']:10.4f} ms "
              f"{line['ms']}  {line['pairs_per_s']:.4e} pairs/s  "
              f"{line['tflops']:8.2f} TFLOP/s  bound "
              f"{line['bound_ms']:.4f} ms, {100 * line['bound_share']:.1f}%"
              f" of it", flush=True)
    return dict(device=torch.cuda.get_device_name(0), card=smi,
                lines=result, ops=ops)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
