#!/usr/bin/env python3
"""Count the SASS instructions of a kernel's loops, per (ray, row) pair.

    python3 tools/sass_loop.py [--root DIR] [--function nearest_hit]
                               [--sass FILE]

Builds the kernels of the ``spath_tpu_torch`` package under ``--root``
(default: this checkout; ``ops/kernels/build.py``, so ``nvcc`` must be
there), disassembles the library with ``cuobjdump -sass`` (or reads a
listing saved with ``--sass``), and prints one JSON line for the kernel
whose name is ``--function``: each loop of it (a backward branch) with

- ``instructions``: the loop body as compiled, one iteration;
- ``pairs``: the (ray, row) tests in that body, one per ``VOTE.ANY``
  where the tests are culled warp by warp (K5), else one per
  ``MUFU.RCP`` (each test's correctly rounded reciprocal);
- ``per_pair``: the instructions a pair on the path where every test
  runs in full and each reciprocal takes its fast path (the slow path's
  call, its return address and the branch past it do not run);
- ``culled_per_pair``: with a cull, a pair where the warp skips every
  culled test (each ``@!P BRA`` right after a ``VOTE.ANY`` taken);
- ``inner_loops``: the loops inside it. The fused quality kernels' step
  loop (``--function quality_forward``, K3; ``quality_backward``, K4) is
  the one around their sweeps' loops: its ``instructions`` are a bounce
  step's whole body as compiled.

Only the card's toolchain has ``cuobjdump``; the counts are of the
``sm_90a`` build that the kernels run.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

INSTRUCTION = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
TARGET = re.compile(r"BRA\s+(?:`\(\.L_x_\d+\)|0x([0-9a-f]+))")


def functions(listing: str) -> dict[str, list[tuple[int, str]]]:
    """``{mangled name: [(address, instruction)]}`` of a ``cuobjdump
    -sass`` listing."""
    out, name = {}, None
    for line in listing.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            out[name] = []
            continue
        m = INSTRUCTION.search(line)
        if name is not None and m:
            out[name].append((int(m[1], 16), m[2]))
    return out


def branch_target(text: str) -> int | None:
    m = TARGET.search(text)
    return int(m[1], 16) if m and m[1] else None


def loops(code: list[tuple[int, str]]) -> list[dict]:
    """Each loop of one function's code, counted as the module docstring
    says."""
    at = {addr: k for k, (addr, _) in enumerate(code)}
    out = []
    for k, (addr, text) in enumerate(code):
        target = branch_target(text) if "BRA" in text else None
        if target is None or target >= addr or target not in at:
            continue
        body = code[at[target]:k + 1]
        votes = sum("VOTE.ANY" in t for _, t in body)
        pairs = votes or sum("MUFU.RCP" in t for _, t in body)
        if pairs == 0:
            continue
        # each reciprocal's slow path: MOV of the return address, CALL,
        # BRA past the fast path
        calls = sum("CALL.REL" in t for _, t in body)
        full = len(body) - 3 * calls
        entry = dict(start=hex(target), end=hex(addr),
                     instructions=len(body), pairs=pairs,
                     per_pair=full / pairs)
        if votes:
            skipped = 0
            for j, (a, t) in enumerate(body[:-1]):
                nxt = body[j + 1][1]
                to = branch_target(nxt) if "VOTE.ANY" in t else None
                if to is not None and nxt.startswith("@!") and to > a:
                    inner = [x for x in body if body[j + 1][0] < x[0] < to]
                    skipped += len(inner)
                    calls -= sum("CALL.REL" in x for _, x in inner)
            entry["culled_per_pair"] = (len(body) - skipped - 3 * calls) / pairs
        out.append(entry)
    return out


def nested(found: list[dict]) -> list[dict]:
    """``loops``' entries, each with ``inner_loops``: how many of the
    others lie inside it."""
    span = [(int(e["start"], 16), int(e["end"], 16)) for e in found]
    return [dict(e, inner_loops=sum(lo <= a and b <= hi
                                    for j, (a, b) in enumerate(span)
                                    if j != k))
            for k, (e, (lo, hi)) in enumerate(zip(found, span))]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--function", default="nearest_hit")
    ap.add_argument("--sass", default="")
    args = ap.parse_args()
    if args.sass:
        listing = Path(args.sass).read_text()
    else:
        sys.path.insert(0, str(Path(args.root).resolve()))
        from spath_tpu_torch.ops.kernels import build

        lib = build.build()
        cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
        listing = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                                 capture_output=True, text=True,
                                 check=True).stdout
    token = f"{len(args.function)}{args.function}E"
    found = {n: c for n, c in functions(listing).items() if token in n}
    if not found:
        raise SystemExit(f"sass_loop: no function {args.function!r}")
    print(json.dumps({n: nested(loops(c)) for n, c in found.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
