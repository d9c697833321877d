#!/usr/bin/env python3
"""Make variant copies of the port's package for timing a kernel's parts.

    python3 tools/kernel_variants.py --out build/variants [--root DIR] \
        NAME [NAME ...]

Copies ``spath_tpu_torch/`` of ``--root`` (default: this checkout) into
``OUT/NAME/`` for each variant NAME and edits its sources as the variant
says (``VARIANTS``: each edit replaces one exact passage of one file,
which must occur exactly once, else the tool exits non-zero). Time
the copies against the unchanged package with ``tools/kernel_ab.py
--root OUT/NAME``, in turns in one call to the card; ``A+B`` makes one
copy with the edits of both. ``--list`` prints the
variants. Each variant names the tree its passages come from: a variant
of another tree's sources fails on this one's, and makes nothing.
"""

from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path

#: name -> (what it shows, the tree whose sources it edits, [(file under
#: spath_tpu_torch/, passage, replacement), ...])
VARIANTS = {
    # K2 as it was before its lane loop (commit 002a799): the three
    # parts of its time, replay, reverse and accumulation.
    "k2_lockstep_no_adds": (
        "K2's lockstep loop without its accumulation's adds: the reverse "
        "sweep still stages every adjoint in shared memory, lanes 0-8 add "
        "none of them",
        "the lockstep K1/K2, 002a799",
        [("csrc/megakernel_grad.cu",
          "        if (lane < kAdj) {\n"
          "          for (unsigned m = hits; m != 0u; m &= m - 1u) {",
          "        if (lane < kAdj && n_tris < 0) {\n"
          "          for (unsigned m = hits; m != 0u; m &= m - 1u) {")]),
    "k2_lockstep_no_reverse": (
        "K2's lockstep loop without its reverse sweep (and so without its "
        "accumulation): the replay of K1's walk alone",
        "the lockstep K1/K2, 002a799",
        [("csrc/megakernel_grad.cu",
          "const int depth = __reduce_max_sync(kFull, len);",
          "const int depth = __reduce_max_sync(kFull, len) * 0;")]),
    # K1 and K2 on their lane loop.
    "k2_no_reverse": (
        "K2's forward epochs alone, recording every bounce in the ring: no "
        "reverse epoch reverses a record",
        "the lane-loop K1/K2",
        [("csrc/megakernel_grad.cu",
          "const int depth = __reduce_max_sync(kFull, rec.fin);",
          "const int depth = __reduce_max_sync(kFull, rec.fin) * 0;")]),
    "k2_no_adds": (
        "K2 without its accumulation's adds: the reverse epochs still "
        "compute every adjoint",
        "the lane-loop K1/K2",
        [("csrc/megakernel_grad.cu",
          "        if (kPairs) {\n          // each pair",
          "        if (n_tris < 0) {\n"
          "        } else if (kPairs) {\n          // each pair")]),
    "k2_epoch_16": (
        "K2 with epochs of 16 forward steps (its ring 16 + max_bounces - 1 "
        "records)",
        "the lane-loop K1/K2",
        [("csrc/megakernel_grad.cu", "constexpr int kEpoch = 4;",
          "constexpr int kEpoch = 16;")]),
    "k2_epoch_8": (
        "K2 with epochs of 8 forward steps",
        "the lane-loop K1/K2",
        [("csrc/megakernel_grad.cu", "constexpr int kEpoch = 4;",
          "constexpr int kEpoch = 8;")]),
    "k2_no_stores": (
        "K2 without its records' stores (the reverse epochs read whatever "
        "the ring holds: a timing, not a gradient)",
        "the lane-loop K1/K2",
        [("csrc/megakernel_grad.cu",
          "    put(ring + kRecord * head, idx, s, tr, tg, tb);\n",
          "")]),
    "k2_epoch_64": (
        "K2 with epochs of 64 forward steps (kMaxBounces, K4's)",
        "the lane-loop K1/K2",
        [("csrc/megakernel_grad.cu", "constexpr int kEpoch = 4;",
          "constexpr int kEpoch = 64;")]),
    "k2_runs_1": (
        "K2's queue with 1 run a warp (a static assignment)",
        "the lane-loop K1/K2",
        [("ops/kernels/megakernel_grad.py",
          "EPOCH, RUNS_PER_WARP, WARP = 4, 2, 32",
          "EPOCH, RUNS_PER_WARP, WARP = 4, 1, 32")]),
    "k2_epoch_2": (
        "K2 with epochs of 2 forward steps",
        "the lane-loop K1/K2",
        [("csrc/megakernel_grad.cu", "constexpr int kEpoch = 4;",
          "constexpr int kEpoch = 2;")]),
    "k2_regs_64": (
        "K2 held to 64 registers (8 CTAs an SM)",
        "the lane-loop K1/K2",
        [("csrc/megakernel_grad.cu",
          "template <bool kPairs>\n"
          "__global__ void __launch_bounds__(kBlock)",
          "template <bool kPairs>\n"
          "__global__ void __launch_bounds__(kBlock, 8)")]),
    "k2_runs_16": (
        "K2's queue with 16 runs a warp",
        "the lane-loop K1/K2",
        [("ops/kernels/megakernel_grad.py",
          "EPOCH, RUNS_PER_WARP, WARP = 4, 2, 32",
          "EPOCH, RUNS_PER_WARP, WARP = MAX_BOUNCES, 16, 32")]),
    "k2_runs_4": (
        "K2's queue with 4 runs a warp (each a quarter as long)",
        "the lane-loop K1/K2",
        [("ops/kernels/megakernel_grad.py",
          "EPOCH, RUNS_PER_WARP, WARP = 4, 2, 32",
          "EPOCH, RUNS_PER_WARP, WARP = MAX_BOUNCES, 4, 32")]),
    "cosf_sinf": (
        "the angle sampler's two angles through cosf and sinf, a range "
        "reduction a call, in place of one sincosf an angle, in every "
        "kernel that walks the conformance bounce (K1, K2, K6; K8 runs "
        "them so; the lockstep K1's form)",
        "the lane-loop K1/K2",
        [("csrc/megakernel_common.cuh", "constexpr bool kSinCos = true;",
          "constexpr bool kSinCos = false;")]),
    "k8_sincosf": (
        "K8's replay drawing its angles with sincosf, as K1, K2 and K6 do",
        "the lane-loop K1/K2",
        [("csrc/bigscene_grad.cu",
          "spath::walk_step<false>(tri, h, bounce, seed, p, sv);",
          "spath::walk_step(tri, h, bounce, seed, p, sv);")]),
    "k1_table_shared": (
        "K1's sweep reading v0, e1, e2 from a copy in shared memory (up to "
        "256 triangles) in place of the read-only cache",
        "the lane-loop K1/K2",
        [("csrc/megakernel_lanes.cuh",
          "  int n_tris, spp, max_bounces;\n};",
          "  int n_tris, spp, max_bounces;\n"
          "  const float* stab = nullptr;  // v0, e1, e2 in shared "
          "memory\n};"),
         ("csrc/megakernel_lanes.cuh",
          "    const Hit h = nearest(a.tri, a.n_tris, p.ox, p.oy, p.oz, "
          "p.dx, p.dy,\n                          p.dz, p.src);",
          "    Hit h{kBig, -1};\n"
          "    if (a.stab != nullptr) {\n"
          "      for (int t = 0; t < a.n_tris; ++t) {\n"
          "        const float* r = a.stab + 9 * t;\n"
          "        mt_test<SharedRow>(r, t, origin_terms<SharedRow>(r, p.ox, "
          "p.oy, p.oz), p.dx, p.dy, p.dz, p.src, h);\n"
          "      }\n"
          "    } else {\n"
          "      h = nearest(a.tri, a.n_tris, p.ox, p.oy, p.oz, p.dx, p.dy, "
          "p.dz, p.src);\n"
          "    }"),
         ("csrc/megakernel.cu",
          "  const spath::ConfArgs a{tri, n_tris, spp, max_bounces};",
          "  __shared__ float stab[9 * 256];\n"
          "  for (int k = threadIdx.x; k < 9 * n_tris && n_tris <= 256; "
          "k += kBlock) {\n"
          "    stab[k] = tri[(k / 9) * spath::kCols + k % 9];\n"
          "  }\n"
          "  __syncthreads();\n"
          "  const spath::ConfArgs a{tri, n_tris, spp, max_bounces,\n"
          "                         n_tris <= 256 ? stab : nullptr};")]),
    # T1 (the wgmma kernel): the parts of its time.
    "t1_no_fold": (
        "T1 without its fold: one accumulator's min a stage in place of "
        "the 56 (wrong sums; the product, the ring and the block ends "
        "alone)",
        "the wgmma T1",
        [("csrc/sweep_mm.cu",
          "          lo[2 * j + c] = fminf(lo[2 * j + c],\n"
          "                                fminf(acc[4 * j + c], "
          "acc[4 * j + 2 + c]));",
          "          if (j == 0 && c == 0) lo[0] = fminf(lo[0], acc[0]);")]),
    "t1_stages_4": (
        "T1 with a ring of 4 stages at both depths (8 and 6 shipped)",
        "the wgmma T1",
        [("csrc/sweep_mm.cu",
          "static constexpr int kStages = K == 64 ? 8 : 6;",
          "static constexpr int kStages = 4;")]),
}


def make(root: Path, out: Path, name: str) -> Path:
    """``out/name``: the package of ``root`` with variant ``name``'s
    edits (``a+b``: a's and b's, in that order). Raises ``SystemExit`` if
    a passage does not occur exactly once."""
    tree = VARIANTS[name.split("+")[0]][1]
    edits = [e for part in name.split("+") for e in VARIANTS[part][2]]
    dest = out / name
    if dest.exists():
        shutil.rmtree(dest)
    shutil.copytree(root / "spath_tpu_torch", dest / "spath_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for fname, old, new in edits:
        path = dest / "spath_tpu_torch" / fname
        text = path.read_text()
        if text.count(old) != 1:
            shutil.rmtree(dest)
            raise SystemExit(f"{name}: {fname} holds the passage "
                             f"{text.count(old)} times, not once (the "
                             f"variant edits the sources of {tree})")
        path.write_text(text.replace(old, new))
    return dest


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--out", default="build/variants")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("names", nargs="*")
    args = ap.parse_args()
    if args.list:
        for name, (what, tree, _) in VARIANTS.items():
            print(f"{name} ({tree}): {what}")
        return 0
    unknown = {part for name in args.names
               for part in name.split("+")} - set(VARIANTS)
    if unknown or not args.names:
        raise SystemExit(
            f"kernel_variants: name variants of {sorted(VARIANTS)}"
            + (f"; unknown {sorted(unknown)}" if unknown else ""))
    for name in args.names:
        print(make(Path(args.root).resolve(), Path(args.out), name))
    return 0


if __name__ == "__main__":
    sys.exit(main())
