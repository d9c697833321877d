"""Build and load the port's CUDA kernels.

On first use, ``nvcc`` compiles every ``spath_tpu_torch/csrc/*.cu`` (one
compiler process per source, all started together) and links the objects
into one shared library with a plain C interface,
``build/kernels/libspath_kernels.so`` at the root of the checkout, which
``ctypes`` loads. The library is rebuilt when the hash of the compiler
flags or of any file under ``csrc/`` changes, the headers the kernels
share (``*.cuh``, ``*.h``) included. Nothing is built when a module is
imported: the CPU tests import every module on machines without
``nvcc``.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` without
``--use_fast_math``, so the kernels round op for op like their plain
PyTorch versions (fast math turns ``cosf``/``sinf`` into approximations
and division into an approximate reciprocal; either flips paths).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
LIBRARY = BUILD_DIR / "libspath_kernels.so"

#: Flags of each source's compilation; the link adds ``-shared``.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def sources() -> list[Path]:
    """The translation units ``nvcc`` compiles."""
    return sorted(SOURCE_DIR.glob("*.cu"))


def hashed_files() -> list[Path]:
    """Every file the library is built from: the sources and the headers
    they include."""
    return sorted(p for p in SOURCE_DIR.iterdir()
                  if p.suffix in (".cu", ".cuh", ".h"))


def nvcc_path() -> str:
    """``nvcc`` from ``CUDA_HOME``, ``PATH`` or ``/usr/local/cuda``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def compile_command(source: Path, obj: Path) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-c", "-o", str(obj), str(source)]


def link_command(objs: list[Path], output: Path) -> list[str]:
    return [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-shared", "-o", str(output), *map(str, objs)]


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in hashed_files():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile the library unless one built from the same sources exists.
    Returns its path; raises ``RuntimeError`` with the compiler's output if
    ``nvcc`` fails. The compiler's report (registers, spills) is kept in
    ``build/kernels/build.log``."""
    digest = source_hash()
    stamp = BUILD_DIR / "libspath_kernels.sha256"
    if LIBRARY.is_file() and stamp.is_file() \
            and stamp.read_text().strip() == digest:
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pid = os.getpid()
    tmp = BUILD_DIR / f"libspath_kernels.{pid}.so"
    objs = [BUILD_DIR / f"{src.stem}.{pid}.o" for src in sources()]
    procs = [subprocess.Popen(compile_command(src, obj),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources(), objs)]
    log, failed = [], []
    for src, proc in zip(sources(), procs):
        out, _ = proc.communicate()
        log.append(f"== {src.name} (exit {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if not failed:
        proc = subprocess.run(link_command(objs, tmp), capture_output=True,
                              text=True, check=False)
        log.append(f"== link (exit {proc.returncode})\n"
                   f"{proc.stdout}{proc.stderr}")
        if proc.returncode != 0:
            failed.append("link")
    for obj in objs:
        obj.unlink(missing_ok=True)
    (BUILD_DIR / "build.log").write_text("".join(log))
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n"
                           + "".join(log))
    os.replace(tmp, LIBRARY)
    stamp.write_text(digest + "\n")
    return LIBRARY


@functools.cache
def library() -> ctypes.CDLL:
    """The built library with every entry point's argument types set."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # K1: rays, seeds, table, out, the queue's counter, n, n_tris, spp,
    # max_bounces, grid
    lib.spath_megakernel_forward.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    lib.spath_megakernel_forward.restype = i32
    lib.spath_megakernel_forward_occupancy.argtypes = []
    lib.spath_megakernel_forward_occupancy.restype = i32
    # K2: rays, seeds, table, gbar, the runs' rows, rings, the queue's
    # counter, n, n_tris, spp, max_bounces, pixels a run, grid
    lib.spath_megakernel_backward.argtypes = [ptr] * 8 + [i32] * 6 + [ptr]
    lib.spath_megakernel_backward.restype = i32
    # K2's resident CTAs an SM for T triangles; a lane's ring floats for
    # max_bounces
    for fn in (lib.spath_megakernel_backward_occupancy,
               lib.spath_megakernel_backward_ring):
        fn.argtypes = [i32]
        fn.restype = i32
    # K3 and K4: rays, keys, table, rows, ..., n, n_tris, n_rows, spp,
    # max_bounces, rr_start, flags, inv_spp
    quality = [i32] * 7 + [ctypes.c_float]
    # K3: rays, keys, table, rows, out, the queue's counter, then n ...,
    # then its grid
    lib.spath_quality_forward.argtypes = [ptr] * 7 + quality + [i32, ptr]
    lib.spath_quality_forward.restype = i32
    lib.spath_quality_forward_occupancy.argtypes = []
    lib.spath_quality_forward_occupancy.restype = i32
    # K4: rays, keys, table, rows, gbar, partial, grays, rings, then n
    # ..., then its pixels a run and grid
    lib.spath_quality_backward.argtypes = (
        [ptr] * 9 + quality + [i32, i32, ptr])
    lib.spath_quality_backward.restype = i32
    # K4's block threads and resident CTAs an SM for T triangles
    for fn in (lib.spath_quality_backward_threads,
               lib.spath_quality_backward_occupancy):
        fn.argtypes = [i32]
        fn.restype = i32
    # the light choice's distribution: emission, area, cdf, prob, scratch,
    # T, the grid route; the scratch floats it needs for T on the route;
    # the kernels it has launched
    lib.spath_light_cdf.argtypes = [ptr] * 5 + [i32, i32, ptr]
    lib.spath_light_cdf.restype = i32
    lib.spath_light_cdf_scratch.argtypes = [i32, i32]
    lib.spath_light_cdf_scratch.restype = i32
    lib.spath_light_cdf_kernel_launches.argtypes = []
    lib.spath_light_cdf_kernel_launches.restype = ctypes.c_longlong
    # the threefry draws: key words, ids, out, n, n_draws
    lib.spath_threefry.argtypes = [ctypes.c_uint, ctypes.c_uint, ptr, ptr,
                                   i32, i32, ptr]
    lib.spath_threefry.restype = i32
    # K6: K1's arguments with the queue's counter after out, then the grid
    lib.spath_bigscene_forward.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
    lib.spath_bigscene_forward.restype = i32
    lib.spath_bigscene_forward_occupancy.argtypes = []
    lib.spath_bigscene_forward_occupancy.restype = i32
    # K9: rays, keys, table, rows, cdf at the rows, out, the queue's
    # counter, n, then K3's, then the grid
    lib.spath_bigscene_quality_forward.argtypes = [ptr] * 8 + quality + [
        i32, ptr]
    lib.spath_bigscene_quality_forward.restype = i32
    # K11: K9's arguments with the hit buffers after out
    lib.spath_bigscene_quality_forward_hits.argtypes = (
        [ptr] * 10 + quality + [i32, ptr])
    lib.spath_bigscene_quality_forward_hits.restype = i32
    # K9's (0) or K11's (1) resident CTAs an SM
    lib.spath_bigscene_quality_forward_occupancy.argtypes = [i32]
    lib.spath_bigscene_quality_forward_occupancy.restype = i32
    # K10: rays, keys, table, rows, cdf at the rows, gbar, first hit, ray
    # adjoint, events, the queue's counter, n, K3's scalars, first sample,
    # samples, grid
    lib.spath_bigscene_quality_backward.argtypes = (
        [ptr] * 13 + quality + [i32, i32, i32, ptr])
    lib.spath_bigscene_quality_backward.restype = i32
    lib.spath_bigscene_quality_backward_occupancy.argtypes = []
    lib.spath_bigscene_quality_backward_occupancy.restype = i32
    # K8: rays, seeds, table, gbar, first hit, state, events, the queue's
    # counter, n, n_tris, spp, max_bounces, first sample, samples, grid
    lib.spath_bigscene_backward.argtypes = [ptr] * 11 + [i32] * 7 + [ptr]
    lib.spath_bigscene_backward.restype = i32
    lib.spath_bigscene_backward_occupancy.argtypes = []
    lib.spath_bigscene_backward_occupancy.restype = i32
    # K7: idx, val, E, adj, T, columns, order, counts, starts, partial,
    # arrive, units, splits
    lib.spath_stream_scatter.argtypes = [
        ptr, ptr, ctypes.c_int64, ptr, i32, i32, ptr, ptr, ptr, ptr, ptr,
        i32, i32, ptr]
    lib.spath_stream_scatter.restype = i32
    # K5: origins, directions, src, tri, dist, idx, the partial hits, n,
    # T, splits; its ray tile and resident CTAs an SM
    lib.spath_nearest_hit.argtypes = [ptr] * 8 + [i32, i32, i32, ptr]
    lib.spath_nearest_hit.restype = i32
    for fn in (lib.spath_nearest_hit_tile, lib.spath_nearest_hit_occupancy):
        fn.argtypes = []
        fn.restype = i32
    # T1: gfeat, rfeat, out, n_rays, n_blocks
    for k in (64, 128):
        fn = getattr(lib, f"spath_sweep_mm_k{k}")
        fn.argtypes = [ptr] * 3 + [i32, i32, ptr]
        fn.restype = i32
    # T1's launch as compiled: K, five ints out
    lib.spath_sweep_mm_plan.argtypes = [i32, ptr]
    lib.spath_sweep_mm_plan.restype = i32
    lib.spath_error_string.argtypes = [i32]
    lib.spath_error_string.restype = ctypes.c_char_p
    return lib
