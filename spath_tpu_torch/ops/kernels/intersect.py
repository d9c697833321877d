"""Standalone nearest hit of rays against triangles in one CUDA launch (K5).

The port of ``spath_tpu/ops/pallas/intersect_pallas.py`` (``_kernel``,
``_forward``, ``nearest_hit_pallas``): the sweep of the wavefront outside
the fused kernels and of the visibility residual (``ops/warp.py``'s
shadow-boundary edge rays, and the residual's re-walk when no hits are
exported). The kernel is ``csrc/intersect.cu``: one thread a ray, the
triangles staged through shared memory in blocks of 256 rows
(``csrc/stream_sweep.cuh``).

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
launch in ``nearest_hit_call.launches``; for CPU tensors it computes the
same function with ``nearest_hit_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from spath_tpu_torch.ops.kernels.build import library

#: Columns of the packed table: v0, e1, e2.
COLS = 9


def pack_triangles(v0, e1, e2) -> torch.Tensor:
    """The ``(T, 9)`` table of triangles given as ``v0`` and edges."""
    return torch.cat([v0, e1, e2], dim=1).contiguous()


def nearest_hit_plain(origins, directions, tri, src):
    """The plain PyTorch version: the reference sweep. Returns ``(dist
    (n,), idx (n,) int64)``."""
    from spath_tpu_torch.ops.intersect import _sweep

    return _sweep(origins, directions, tri[:, 0:3], tri[:, 3:6],
                  tri[:, 6:9], src, 512)


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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.spath_nearest_hit(
            *(ctypes.c_void_p(t.data_ptr()) for t in (
                origins, directions, src, tri, dist, idx)),
            n, tri.shape[0], ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"nearest-hit kernel launch failed: CUDA error "
                           f"{err} ({lib.spath_error_string(err).decode()})")
    nearest_hit_call.launches += 1
    return dist, idx


nearest_hit_call.launches = 0
