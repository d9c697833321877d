"""The reference's per-pixel LCG, the conformance estimator's only
random source (``spath_tpu/ops/rng.py``)::

    seed = 214013 * seed + 2531011          (uint32 wrap-around)
    u    = ((seed >> 16) & 0x7FFF) / 32767.0

PyTorch's uint32 support is partial, so seeds are int64 tensors holding
uint32 values, and every step masks with ``0xFFFFFFFF``. The uniform is a
float32 division by 32767, not a multiplication by its rounded
reciprocal: the two differ by 1 ulp on some draws, which is enough to
flip a path.
"""

from __future__ import annotations

import torch

_MUL = 214013
_ADD = 2531011
_U32 = 0xFFFFFFFF


def lcg_next(seed: torch.Tensor):
    """Advance the LCG. ``seed`` is int64 holding uint32 values.

    Returns ``(new_seed, u)`` with ``u`` float32 in [0, 1].
    """
    seed = (seed * _MUL + _ADD) & _U32
    bits = (seed >> 16) & 0x7FFF
    # The divisor is a tensor on the seed's device: PyTorch's CUDA
    # division by a Python scalar multiplies by the reciprocal instead.
    norm = torch.tensor(32767.0, dtype=torch.float32, device=seed.device)
    return seed, bits.to(torch.float32) / norm


def pixel_seeds(n_pixels: int, offset: int = 0, *, device) -> torch.Tensor:
    """Per-pixel seeds ``pixel index + offset`` (mod 2^32), int64."""
    return (torch.arange(n_pixels, dtype=torch.int64, device=device)
            + offset) & _U32
