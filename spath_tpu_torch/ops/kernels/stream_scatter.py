"""Deterministic scatter-add of adjoint events into a ``(T, C)`` adjoint
(K7), ``C`` = 9 (the conformance backward K8) or 19 (the quality
backward K10).

The port of ``spath_tpu/ops/pallas/megakernel_bigscene.py::
stream_scatter_rmw``, the read-modify-write pass the streamed backward
kernels run over their adjoint in blocks of 256 triangles. The kernel,
``csrc/stream_scatter.cu``, reads the event slots once in units of
``UNIT`` slots and sorts each unit's events stably by triangle block
into the unit's own section (the bin launch, a persistent grid); then a
CTA per block and part of its events adds them window by window, each
window sorted by row and each (row, column) summed in float64 by its own
thread, and the block's last CTA adds the parts in order (the accumulate
launch). Its sums are in an order fixed by the events and the sizes, so
two launches give the same bits (no float atomics).

Layouts (all contiguous): ``idx`` int32 ``(E,)``, the event's triangle or
-1 for none; ``val`` float32 ``(E, C)``; ``adj`` float32 ``(T, C)``,
which the call adds into in place and returns.

``stream_scatter_call`` launches the kernel for CUDA tensors and counts
each call in ``stream_scatter_call.launches``; for CPU tensors it
computes the same function with ``stream_scatter_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from spath_tpu_torch.ops.kernels.build import library

#: Triangles a block (``kRows`` of the kernel).
TILE_T = 256
#: Columns of an event and of the adjoint: normal, albedo, emission (K8);
#: v0, e1, e2, normal, albedo, emission, area (K10).
COLS = 9
QUALITY_COLS = 19
WIDTHS = (COLS, QUALITY_COLS)
#: Largest scene: the bin keeps 9 counters per block in shared memory.
MAX_TRIS = 1 << 20
#: Event slots a unit of the bin (``kUnit``): one CTA reads them once.
UNIT = 4096
#: CTAs the accumulation aims for (8 on each of an H100's 132 SMs, about
#: three waves of its 3 resident CTAs an SM, so that the parts of unequal
#: blocks even out), so that a hot block is shared by several: a block's
#: events are split into up to MAX_SPLITS parts of equal count.
TARGET_CTAS, MAX_SPLITS = 1056, 64


def plan(n_events: int, n_tris: int) -> tuple[int, int, int]:
    """``(n_blocks, units, splits)`` of a launch: blocks of ``TILE_T``
    triangles, units of ``UNIT`` consecutive event slots for the bin,
    parts of each block's events for the accumulation. Fixed by the sizes
    alone, so two launches on the same events sum in the same order."""
    n_blocks = -(-n_tris // TILE_T)
    units = -(-n_events // UNIT)
    splits = max(1, min(MAX_SPLITS, -(-TARGET_CTAS // n_blocks)))
    return n_blocks, units, splits


def stream_scatter_plain(adj, idx, val) -> torch.Tensor:
    """The plain PyTorch version: ``adj[idx[e]] += val[e]`` for every event
    with ``idx[e] >= 0``, summed in float64 and rounded once, in place."""
    keep = idx >= 0
    out = adj.double().index_add_(0, idx[keep].long(), val[keep].double())
    return adj.copy_(out)


def _check(adj, idx, val) -> None:
    if adj.dtype != torch.float32 or adj.dim() != 2 \
            or adj.shape[1] not in WIDTHS:
        raise ValueError(f"adj must be float32 (T, C), C in {WIDTHS}, got "
                         f"{adj.dtype} {tuple(adj.shape)}")
    cols = adj.shape[1]
    if not 1 <= adj.shape[0] <= MAX_TRIS:
        raise ValueError(f"T={adj.shape[0]} outside [1, {MAX_TRIS}]")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError(f"idx must be int32 (E,), got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    e = idx.shape[0]
    if val.dtype != torch.float32 or tuple(val.shape) != (e, cols):
        raise ValueError(f"val must be float32 ({e}, {cols}), got "
                         f"{val.dtype} {tuple(val.shape)}")
    if e >= 2**31:
        raise ValueError(f"{e} events overflow the kernel's int32 ids")
    if not adj.device == idx.device == val.device:
        raise ValueError("adj, idx and val must be on one device")
    if not all(t.is_contiguous() for t in (adj, idx, val)):
        raise ValueError("adj, idx and val must be contiguous")


def stream_scatter_call(adj, idx, val) -> torch.Tensor:
    """Add the events ``(idx, val)`` into ``adj`` in place and return it
    (layouts in the module docstring). Launches K7 on CUDA tensors, on
    PyTorch's current stream and without synchronising; a failed build or
    launch raises. CPU tensors take ``stream_scatter_plain``. Indices must
    lie in ``[-1, T)``; the kernel does not check them."""
    _check(adj, idx, val)
    if adj.device.type == "cpu":
        return stream_scatter_plain(adj, idx, val)
    if adj.device.type != "cuda":
        raise ValueError(f"no scatter kernel for device {adj.device}")
    n_events, (n_tris, cols) = idx.shape[0], adj.shape
    if n_events == 0:
        return adj
    n_blocks, units, splits = plan(n_events, n_tris)
    i32 = dict(dtype=torch.int32, device=adj.device)
    order = torch.empty(n_events, **i32)
    counts = torch.empty(n_blocks * units, **i32)
    starts = torch.empty(n_blocks * units, **i32)
    arrive = torch.empty(n_blocks, **i32)
    partial = torch.empty(n_blocks * splits * TILE_T * cols if splits > 1
                          else 1, dtype=torch.float64, device=adj.device)
    lib = library()
    with torch.cuda.device(adj.device):
        stream = torch.cuda.current_stream(adj.device).cuda_stream
        err = lib.spath_stream_scatter(
            ctypes.c_void_p(idx.data_ptr()), ctypes.c_void_p(val.data_ptr()),
            n_events, ctypes.c_void_p(adj.data_ptr()), n_tris, cols,
            ctypes.c_void_p(order.data_ptr()),
            ctypes.c_void_p(counts.data_ptr()),
            ctypes.c_void_p(starts.data_ptr()),
            ctypes.c_void_p(partial.data_ptr()),
            ctypes.c_void_p(arrive.data_ptr()), units, splits,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"stream scatter launch failed: CUDA error {err} "
                           f"({lib.spath_error_string(err).decode()})")
    stream_scatter_call.launches += 1
    return adj


stream_scatter_call.launches = 0
