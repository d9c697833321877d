"""Row gathers whose backward adds in a fixed order
(``spath_tpu/ops/gather.py``).

The JAX package gathers a small table's rows with a one-hot matmul,
whose backward is a matmul: the same sums in the same order every run.
The port gathers with ``index_select``, whose backward on the card is an
``index_add_`` with float atomics, adding a row's duplicates in no fixed
order: two runs of a ``vis_grad`` gradient differed in the last bits.
``gather_rows`` keeps the forward (``index_select``, the same bits) and
replaces the backward: on CUDA tensors the gradient rows of every table
gathered by one index are stacked into ``(E, C)`` events, ``C`` zero
padded to one of the stream scatter K7's widths (9 or 19 columns,
``ops/kernels/stream_scatter.py``; no gather of the port takes more than
19), and K7 adds them in float64 in an order fixed by the events, so two
runs give the same bits. On CPU tensors the backward is ``index_add_``,
what ``index_select``'s own is. Inside ``ops/intersect.py``'s
``plain_sweep()``, where the plain versions run, ``gather_rows`` is
``index_select`` itself, so a plain reference launches no K7.
"""

from __future__ import annotations

import torch

from spath_tpu_torch.ops.intersect import in_plain_sweep
from spath_tpu_torch.ops.kernels.stream_scatter import (
    WIDTHS, stream_scatter_call,
)


def k7_width(cols: int) -> int:
    """The narrowest of K7's widths (``WIDTHS``) that holds ``cols``
    stacked gradient columns."""
    fits = [w for w in WIDTHS if w >= cols]
    if not fits:
        raise ValueError(f"{cols} gathered columns are more than K7's "
                         f"{max(WIDTHS)}")
    return min(fits)


def scatter_backward(index, grads, n_rows: int) -> list[torch.Tensor]:
    """``(n_rows, c_i)`` gradients of the tables from the ``(E, c_i)``
    gradients of their gathered rows, through K7 (``stream_scatter_call``:
    the kernel on CUDA tensors, its float64 plain version on CPU ones): the
    rows stacked column by column, zero padded to ``k7_width``, added into
    a zero ``(n_rows, C)`` adjoint and cut apart again."""
    cols = [g.shape[1] for g in grads]
    width = k7_width(sum(cols))
    parts = list(grads)
    if width > sum(cols):
        parts.append(grads[0].new_zeros((index.shape[0], width - sum(cols))))
    adj = torch.zeros((n_rows, width), dtype=torch.float32,
                      device=grads[0].device)
    stream_scatter_call(adj, index.to(torch.int32).contiguous(),
                        torch.cat(parts, dim=1).contiguous())
    return list(adj.split(cols + [width - sum(cols)], dim=1)[:len(grads)])


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, index, *tables):
        ctx.save_for_backward(index)
        ctx.shapes = [t.shape for t in tables]
        return tuple(t.index_select(0, index) for t in tables)

    @staticmethod
    def backward(ctx, *grads):
        (index,) = ctx.saved_tensors
        want = [i for i, need in enumerate(ctx.needs_input_grad[1:]) if need]
        out = [None] * len(grads)
        if not want:
            return (None, *out)
        if index.device.type == "cpu":
            for i in want:
                out[i] = grads[i].new_zeros(ctx.shapes[i]).index_add_(
                    0, index, grads[i])
            return (None, *out)
        flat = [grads[i].reshape(grads[i].shape[0], -1) for i in want]
        for i, g in zip(want, scatter_backward(index, flat,
                                               ctx.shapes[want[0]][0])):
            out[i] = g.reshape(ctx.shapes[i])
        return (None, *out)


def gather_rows(index: torch.Tensor, *tables: torch.Tensor) -> tuple:
    """``tuple(t.index_select(0, index) for t in tables)``, the same bits,
    with a backward in a fixed order (module docstring). The tables share
    their row count; ``index`` is int64 ``(E,)`` with every entry a row."""
    rows = {t.shape[0] for t in tables}
    if len(rows) != 1:
        raise ValueError(f"gather_rows takes tables of one row count, got "
                         f"{sorted(rows)}")
    if in_plain_sweep():
        return tuple(t.index_select(0, index) for t in tables)
    return _GatherRows.apply(index, *tables)
