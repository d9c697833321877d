"""The port's random streams (``spath_tpu/ops/rng.py``).

**LCG**, the conformance estimator's per-pixel stream::

    seed = 214013 * seed + 2531011          (uint32 wrap-around)
    u    = ((seed >> 16) & 0x7FFF) / 32767.0

**Hash**, the quality estimator's counter-based stream: two rounds of the
murmur3 finalizer keyed by ``(seed, pixel, sample, bounce, draw)``, so a
draw needs no state and the fused kernel K3 and the wavefront draw the
same numbers::

    h0 = seed * GOLD + pixel
    h  = fmix(fmix(h0) + sample * C1 + bounce * C2 + draw * C3)
    u  = (h >> 8) * 2^-24

PyTorch's uint32 support is partial, so stream states are int64 tensors
holding uint32 values, and every step masks with ``0xFFFFFFFF``. That is
enough for the LCG's small multiplier, but not for the murmur constants:
``0x85EBCA6B * h`` reaches 2^63 and overflows int64. ``mul32`` therefore
multiplies by the constant's 16-bit halves, each partial product below
2^48. The LCG's uniform is a float32 division by 32767, not a
multiplication by its rounded reciprocal: the two differ by 1 ulp on some
draws, which is enough to flip a path.
"""

from __future__ import annotations

import torch

_MUL = 214013
_ADD = 2531011
_U32 = 0xFFFFFFFF

#: The hash stream's constants (``spath_tpu/ops/rng.py:249-254``).
GOLD = 0x9E3779B9
M1 = 0x85EBCA6B
M2 = 0xC2B2AE35
C1 = 0x27D4EB2F
C2 = 0x165667B1
C3 = 0xD3A2646C


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


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for int64 ``x`` holding uint32 values and a
    uint32 constant ``c``, without overflowing int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """The murmur3 finalizer on int64 tensors holding uint32 values."""
    h = h ^ (h >> 16)
    h = mul32(h, M1)
    h = h ^ (h >> 13)
    h = mul32(h, M2)
    return h ^ (h >> 16)


def hash_keys(seed: int, pixel_ids: torch.Tensor) -> torch.Tensor:
    """``seed * GOLD + pixel`` (mod 2^32), int64: each ray's stream key,
    the ``keys`` of the fused kernels."""
    return (((seed & _U32) * GOLD & _U32) + pixel_ids) & _U32


def hash_u32(seed, pixel, sample, bounce, draw) -> torch.Tensor:
    """Stateless uint32 stream value, as int64. ``seed`` and ``pixel``
    are ints or int64 tensors (broadcasting); the counters are ints."""
    h = torch.as_tensor(seed, dtype=torch.int64) & _U32
    h = (mul32(h, GOLD) + pixel) & _U32
    return _mix_counters(fmix32(h), sample, bounce, draw)


def _mix_counters(h1: torch.Tensor, sample: int, bounce: int,
                  draw: int) -> torch.Tensor:
    """The second round: ``fmix(h1 + sample*C1 + bounce*C2 + draw*C3)``,
    with ``h1 = fmix(seed*GOLD + pixel)``."""
    counters = (sample * C1 + bounce * C2 + draw * C3) & _U32
    return fmix32((h1 + counters) & _U32)


def _to_uniform(h: torch.Tensor) -> torch.Tensor:
    """The top 24 bits as a float32 in [0, 1): exact."""
    return (h >> 8).to(torch.float32) * 2.0 ** -24


def hash_uniform(seed, pixel, sample, bounce, draw) -> torch.Tensor:
    """float32 uniform in [0, 1) from ``hash_u32``."""
    return _to_uniform(hash_u32(seed, pixel, sample, bounce, draw))


def hash_uniforms(seed, pixel_ids: torch.Tensor, sample: int, bounce: int,
                  n_draws: int) -> torch.Tensor:
    """``(n_draws, N)`` float32 uniforms for one (sample, bounce) step."""
    h1 = fmix32(hash_keys(int(seed), pixel_ids))
    return key_uniforms(h1, sample, bounce, n_draws)


def key_uniforms(h1: torch.Tensor, sample: int, bounce: int,
                 n_draws: int) -> torch.Tensor:
    """``hash_uniforms`` from the rays' first-round hashes
    ``h1 = fmix32(keys)``, which stay the same for every draw of a ray."""
    return torch.stack([_to_uniform(_mix_counters(h1, sample, bounce, d))
                        for d in range(n_draws)])
