"""Standalone nearest hit of rays against triangles in one CUDA launch (K5).

The port of ``spath_tpu/ops/pallas/intersect_pallas.py`` (``_kernel``,
``_forward``, ``nearest_hit_pallas``): the sweep of the wavefront outside
the fused kernels and of the visibility residual (``ops/warp.py``'s
shadow-boundary edge rays, and the residual's re-walk when no hits are
exported). The kernel is ``csrc/intersect.cu``: a CTA stages the
triangles through shared memory in blocks of ``TILE_ROWS`` rows, each
thread tests the rays it holds against each staged row, a warp leaving a
test before its division where no lane can pass it (``may_pass_plain``
is that cull's plain model), and the grid is the ray tiles times ranges
of row blocks (``sweep_plan``, from the kernel's resident CTAs), whose
nearest hits a second launch merges in range order
(``merge_hits_plain`` is its plain model).

Layouts, as the wrapper checks them (all contiguous):

- ``origins``, ``directions``: float32 ``(n, 3)``;
- ``tri``: float32 ``(T, 9)``, rows v0, e1 = v1 - v0, e2 = v2 - v0
  (``pack_triangles``), ``T >= 1``;
- ``src``: int64 ``(n,)``, each ray's source triangle (-1 for none);
- outputs: ``dist`` float32 ``(n,)`` (``BIG`` on a miss) and ``idx``
  int64 ``(n,)`` (-1 on a miss).

K5 is bit-identical to its plain version, the reference sweep
``ops/intersect.py::_sweep``, in both outputs. The JAX kernel's bf16 split
packing of Plücker features (``pack_tri_blocks``) is a layout for the
TPU's matrix unit and is not K5's: the port keeps it only as the operands
of the matmul-only microbenchmark T1 (``ops/kernels/sweep_mm.py``). The backward stays the O(N)
derivative of the selected triangle's distance (``ops/intersect.py``:
``_dist_selected``), which is XLA in the JAX package too.

``nearest_hit_call`` launches the kernel for CUDA tensors and counts each
call in ``nearest_hit_call.launches`` (a call launches the sweep and,
where its plan splits the rows, the merge after it); for CPU tensors it
computes the same function with ``nearest_hit_plain``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from spath_tpu_torch.ops.kernels.build import library

#: Columns of the packed table: v0, e1, e2.
COLS = 9
#: Rows a staged block (``kTileRows`` of ``csrc/stream_sweep.cuh``): the
#: ranges a ray tile's rows are split into are whole blocks.
TILE_ROWS = 256
#: Waves of the card's resident CTAs a plan aims at: many CTAs a slot
#: even out the time of the last ones, whose warps cull unevenly (timed
#: against other counts with ``tools/kernel_ab.py --k5-splits``, PERF.md);
#: and the most ranges a ray tile's rows are split into, which bounds the
#: partials and the merge.
WAVES, MAX_SPLITS = 24, 256


def pack_triangles(v0, e1, e2) -> torch.Tensor:
    """The ``(T, 9)`` table of triangles given as ``v0`` and edges."""
    return torch.cat([v0, e1, e2], dim=1).contiguous()


def nearest_hit_plain(origins, directions, tri, src):
    """The plain PyTorch version: the reference sweep. Returns ``(dist
    (n,), idx (n,) int64)``."""
    from spath_tpu_torch.ops.intersect import _sweep

    return _sweep(origins, directions, tri[:, 0:3], tri[:, 3:6],
                  tri[:, 6:9], src, 512)


def sweep_plan(n: int, n_tris: int, tile: int, per_sm: int,
               sms: int) -> tuple[int, int]:
    """``(ray tiles, splits)``: K5's grid for ``n`` rays of ``tile`` a
    CTA against ``n_tris`` triangles, on a card that holds ``per_sm`` of
    its CTAs on each of ``sms`` SMs. The rows are cut into the fewest
    ranges of whole ``TILE_ROWS`` blocks whose CTAs make ``WAVES`` waves
    of the resident CTAs, at most ``MAX_SPLITS`` and at most the blocks:
    so a few rays against many triangles still keep every SM busy, and
    no SM waits long on its last CTAs."""
    if n < 1 or n_tris < 1 or tile < 1 or per_sm < 1 or sms < 1:
        raise ValueError(f"no plan for n={n}, T={n_tris}, tile {tile}, "
                         f"{per_sm} CTAs an SM, {sms} SMs")
    tiles, blocks = -(-n // tile), -(-n_tris // TILE_ROWS)
    splits = -(-WAVES * per_sm * sms // tiles)
    return tiles, max(1, min(splits, blocks, MAX_SPLITS))


def split_rows(n_tris: int, splits: int) -> list[tuple[int, int]]:
    """The row range ``[start, stop)`` of each split, as the kernel cuts
    them: split ``k`` takes blocks ``k * B // splits`` to ``(k + 1) * B
    // splits`` of the ``B`` blocks of ``TILE_ROWS`` rows."""
    blocks = -(-n_tris // TILE_ROWS)
    if not 1 <= splits <= blocks:
        raise ValueError(f"{splits} splits of {blocks} blocks")
    return [(min(k * blocks // splits * TILE_ROWS, n_tris),
             min((k + 1) * blocks // splits * TILE_ROWS, n_tris))
            for k in range(splits)]


def merge_hits_plain(part_dist, part_idx):
    """The merge's plain model: ``(dist (n,), idx (n,) int64)`` from the
    ``(splits, n)`` partial hits, each split's taken where it is strictly
    nearer than the splits before it, so ties go to the lowest index."""
    from spath_tpu_torch.ops.intersect import BIG

    dist = torch.full(part_dist.shape[1:], BIG, dtype=torch.float32,
                      device=part_dist.device)
    idx = torch.full(part_dist.shape[1:], -1, dtype=torch.int64,
                     device=part_dist.device)
    for d, i in zip(part_dist, part_idx):
        nearer = d < dist
        dist = torch.where(nearer, d, dist)
        idx = torch.where(nearer, i.long(), idx)
    return dist, idx


def split_hits_plain(origins, directions, tri, src, splits: int):
    """The split sweep's plain model: each range of ``split_rows`` swept
    alone (``_sweep``, indices offset by the range's start, the source
    index as well), its partial hits merged by ``merge_hits_plain``."""
    from spath_tpu_torch.ops.intersect import _sweep

    parts = []
    for start, stop in split_rows(tri.shape[0], splits):
        t = tri[start:stop]
        d, i = _sweep(origins, directions, t[:, 0:3], t[:, 3:6], t[:, 6:9],
                      src - start, 512)
        parts.append((d, torch.where(i >= 0, i + start, i)))
    return merge_hits_plain(torch.stack([d for d, _ in parts]),
                            torch.stack([i for _, i in parts]))


@functools.cache
def resident_ctas(device_index: int) -> tuple[int, int, int]:
    """``(tile, per_sm, sms)``: the rays a K5 CTA holds, its CTAs
    resident on one SM of the card (the occupancy query) and the SMs."""
    lib = library()
    with torch.cuda.device(device_index):
        per_sm = lib.spath_nearest_hit_occupancy()
    if per_sm <= 0:
        err = lib.spath_error_string(-per_sm).decode()
        raise RuntimeError(f"K5 occupancy query failed: CUDA error "
                           f"{-per_sm} ({err})")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return lib.spath_nearest_hit_tile(), per_sm, sms


#: The cull's bounds (``csrc/intersect.cu``: may_pass), float32: 2^-100 and
#: 1 + 2^-21.
CULL_TINY, CULL_ABOVE_ONE = 2.0 ** -100, 1.0 + 2.0 ** -21


def may_pass_plain(a, sh):
    """The plain model of K5's cull before the division: False only where
    the Möller–Trumbore test (``ops/intersect.py::_mt_block``) rejects a
    pair whose ``a = e1 · (d × e2)`` and ``sh = s · (d × e2)`` (float32
    tensors) are these, whatever ``f = 1 / a`` and ``u = f · sh`` round to:
    ``a`` degenerate, or ``u`` below 0 or above 1 by a margin that no
    rounding crosses (the proof is in the kernel's source). A warp skips
    the rest of its test only where every lane's pair fails this."""
    from spath_tpu_torch.ops.intersect import EPS

    m = a.abs()
    su = torch.where(a < 0.0, -sh, sh)
    tiny = torch.tensor(CULL_TINY, dtype=torch.float32)
    above = torch.tensor(CULL_ABOVE_ONE, dtype=torch.float32)
    return (m >= EPS) & ~(su < -(m * tiny)) & ~(su > m * above)


def _check(origins, directions, tri, src) -> None:
    n = origins.shape[0] if origins.dim() == 2 else -1
    for name, rays in (("origins", origins), ("directions", directions)):
        if rays.dtype != torch.float32 or tuple(rays.shape) != (n, 3):
            raise ValueError(f"{name} must be float32 ({n}, 3), got "
                             f"{rays.dtype} {tuple(rays.shape)}")
    if src.dtype != torch.int64 or tuple(src.shape) != (n,):
        raise ValueError(f"src must be int64 ({n},), got {src.dtype} "
                         f"{tuple(src.shape)}")
    if tri.dtype != torch.float32 or tri.dim() != 2 or tri.shape[1] != COLS:
        raise ValueError(f"tri must be float32 (T, {COLS}), got {tri.dtype} "
                         f"{tuple(tri.shape)}")
    if tri.shape[0] < 1 or tri.shape[0] >= 2**31 // COLS:
        raise ValueError(f"T={tri.shape[0]} outside the kernel's range")
    if 3 * n >= 2**31:
        raise ValueError(f"{n} rays overflow the kernel's int32 indexing")
    if not origins.device == directions.device == tri.device == src.device:
        raise ValueError("origins, directions, tri and src must be on one "
                         "device")
    if not all(t.is_contiguous() for t in (origins, directions, tri, src)):
        raise ValueError("origins, directions, tri and src must be "
                         "contiguous")


def nearest_hit_call(origins, directions, tri, src):
    """``(dist (n,), idx (n,) int64)``: the nearest hit of ``n`` rays
    against the ``(T, 9)`` table (layouts in the module docstring),
    excluding each ray's ``src``. Launches K5 on CUDA tensors, on
    PyTorch's current stream and without synchronising; a failed build or
    launch raises. CPU tensors take ``nearest_hit_plain``."""
    _check(origins, directions, tri, src)
    if origins.device.type == "cpu":
        return nearest_hit_plain(origins, directions, tri, src)
    if origins.device.type != "cuda":
        raise ValueError(f"no nearest-hit kernel for device {origins.device}")
    n, dev = origins.shape[0], origins.device
    dist = torch.empty(n, dtype=torch.float32, device=dev)
    idx = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return dist, idx
    lib = library()
    index = torch.cuda.current_device() if dev.index is None else dev.index
    _, splits = sweep_plan(n, tri.shape[0], *resident_ctas(index))
    part_dist = part_idx = None
    if splits > 1:
        part_dist = torch.empty((splits, n), dtype=torch.float32, device=dev)
        part_idx = torch.empty((splits, n), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.spath_nearest_hit(
            *(ctypes.c_void_p(t.data_ptr()) for t in (
                origins, directions, src, tri, dist, idx)),
            *(ctypes.c_void_p(None if t is None else t.data_ptr())
              for t in (part_dist, part_idx)),
            n, tri.shape[0], splits, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"nearest-hit kernel launch failed: CUDA error "
                           f"{err} ({lib.spath_error_string(err).decode()})")
    nearest_hit_call.launches += 1
    return dist, idx


nearest_hit_call.launches = 0
