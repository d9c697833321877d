"""The port's random streams (``spath_tpu/ops/rng.py``): the LCG, the
hash stream, ``jax.random``'s threefry stream and the reference's
``vec_dist`` table stream.

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

**Threefry**, the ``QUALITY`` preset's stream, as jax 0.9.0 computes it
with its default ``jax_threefry_partitionable=True``: the frame key
``threefry_key(seed)``, folded with the sample and the bounce on the
host (``fold_in``, Python ints), then with each pixel's global id, whose
key draws ``jax.random.uniform(key, (n_draws,))``. On the card
``csrc/threefry.cu`` draws a step in one launch; ``per_pixel_uniforms``
is its plain version, in int64 with masks.

**Table**, the reference's ``vec_dist`` debug stream: the libstdc++
shuffle of evenly spaced values (``vec_dist_table``, from glibc's
``rand``, ``GlibcRand``), read by each pixel from a cursor at its global
id (``table_uniforms``), a gather as the JAX package's ``jnp.take``.
"""

from __future__ import annotations

import functools

import numpy as np
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
    return lcg_seeds(offset, torch.arange(n_pixels, dtype=torch.int64,
                                          device=device))


def lcg_seeds(seed: int, pixel_ids: torch.Tensor) -> torch.Tensor:
    """``pixel id + seed`` (mod 2^32), int64: each ray's LCG seed, the
    ``seeds`` of the fused kernels."""
    return (pixel_ids + seed) & _U32


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


# ---------------------------------------------------------------------------
# threefry: jax.random's counter-based stream (jax 0.9.0, the default
# jax_threefry_partitionable=True), the quality preset's stream
# ---------------------------------------------------------------------------

#: Rotations of the even and odd groups of four rounds, and the key
#: schedule's parity constant (``jax/_src/prng.py:883-905``).
THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
THREEFRY_PARITY = 0x1BD11BDA
#: The largest seed ``jax.random.key`` takes, and the smallest: it
#: converts the seed to a C long first.
_SEED_MAX, _SEED_MIN = (1 << 63) - 1, -(1 << 63)


def _rotl32(x, r: int):
    """Rotate left by ``r`` (0 < r < 32) on uint32 values held in int64
    (or Python ints): the left shift is masked, the right shift sees a
    value already below 2^32."""
    return ((x << r) & _U32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block, 20 rounds, as ``jax.random`` runs it:
    key ``(k0, k1)``, counter ``(x0, x1)`` -> ``(y0, y1)``. Each argument
    is a Python int or an int64 tensor holding uint32 values
    (broadcasting)."""
    ks = (k0, k1, k0 ^ k1 ^ THREEFRY_PARITY)
    x0 = (x0 + ks[0]) & _U32
    x1 = (x1 + ks[1]) & _U32
    for i in range(5):
        for r in THREEFRY_ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _U32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _U32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _U32
    return x0, x1


def _is_key(seed) -> bool:
    """Is ``seed`` a key's two words: a tuple or list of two ints, or a
    tensor of two integers? (The JAX package takes a typed PRNG key in
    place of a seed, ``_is_key``.)"""
    if isinstance(seed, torch.Tensor):
        return tuple(seed.shape) == (2,) and not seed.is_floating_point()
    return isinstance(seed, (tuple, list)) and len(seed) == 2


def threefry_key(seed) -> tuple[int, int]:
    """The key ``jax.random.key(seed)`` makes, as two Python ints; a key's
    two words (a tuple, list or tensor) are returned as they are.

    The JAX package runs with ``jax_enable_x64`` off, so the seed is cast
    to 32 bits before ``threefry_seed`` splits it into ``(seed >> 32,
    seed & 0xFFFFFFFF)``: the key is ``(0, seed mod 2^32)``. Seeds that
    ``jax.random.key`` refuses are refused the same way: a float or any
    other non-integer (``TypeError``), an int outside the C long range
    (``OverflowError``)."""
    if _is_key(seed):
        words = tuple(int(w) for w in seed)
        if not all(0 <= w <= _U32 for w in words):
            raise ValueError(f"a threefry key's words are uint32, got {words}")
        return words
    if isinstance(seed, torch.Tensor):
        if seed.dim() != 0:
            raise TypeError("key accepts a scalar seed, but was given a "
                            f"tensor of shape {tuple(seed.shape)}")
        if seed.is_floating_point() or seed.is_complex():
            raise TypeError(f"PRNG key seed must be an integer; got {seed!r}")
        seed = int(seed)
    elif hasattr(seed, "__index__"):       # int, bool, numpy integers
        seed = int(seed.__index__())
    else:
        raise TypeError(f"PRNG key seed must be an integer; got {seed!r}")
    if not _SEED_MIN <= seed <= _SEED_MAX:
        raise OverflowError("Python int too large to convert to C long")
    return 0, seed & _U32


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)`` on a key's two words:
    ``threefry2x32(key, (0, data))``, ``data`` taken mod 2^32."""
    return threefry2x32(key[0], key[1], 0, int(data) & _U32)


def threefry_bits(k0, k1, draw: int):
    """The 32 random bits of draw ``draw`` of ``jax.random.uniform(key,
    (n,))`` (``n > draw``): the counter is ``(0, draw)`` and the bits are
    ``y0 ^ y1`` of its block."""
    y0, y1 = threefry2x32(k0, k1, 0, draw)
    return y0 ^ y1


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform``'s float conversion: the top 23 bits as the
    mantissa of a float32 in [1, 2), minus 1, then ``* (1 - 0) + 0`` and
    ``max(0, ·)``, exact."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp_min((f - 1.0) * 1.0 + 0.0, 0.0)


def threefry_uniform(key: tuple[int, int], n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32)`` on the CPU."""
    bits = threefry_bits(key[0], key[1], torch.arange(n, dtype=torch.int64))
    return bits_to_uniform(bits)


def per_pixel_uniforms(key: tuple[int, int], pixel_ids: torch.Tensor,
                       n_draws: int) -> torch.Tensor:
    """Counter-based threefry uniforms keyed per pixel, ``(n_draws, N)``
    float32 on the ids' device (``spath_tpu/ops/rng.py::
    per_pixel_uniforms``): each pixel's key is ``fold_in(key, pixel id)``,
    its draws ``jax.random.uniform(pixel key, (n_draws,))``. ``key``
    already encodes (seed, sample, bounce) through ``fold_in``;
    ``pixel_ids`` are int64 global pixel ids, taken mod 2^32. The plain
    version of ``csrc/threefry.cu`` (``ops/kernels/threefry.py``)."""
    p0, p1 = threefry2x32(key[0], key[1], 0, pixel_ids & _U32)
    return torch.stack([bits_to_uniform(threefry_bits(p0, p1, d))
                        for d in range(n_draws)])


# ---------------------------------------------------------------------------
# The reference's table RNGs: glibc rand() (basic_dist) and the shuffled
# table of vec_dist (src/frand.h:26-50), numpy only
# ---------------------------------------------------------------------------


class GlibcRand:
    """Bit-exact glibc ``rand()``, the stream behind the reference's
    ``basic_dist`` (``src/frand.h:26-30``) on its gcc/Linux build target
    (``spath_tpu/ops/rng.py::GlibcRand``).

    glibc's TYPE_3 generator: an additive-feedback register over 31 int32
    words seeded by a Park–Miller LCG::

        r[0]     = seed                       (srand(0) acts as srand(1))
        r[1..30] = 16807 * r[i-1] mod 2^31-1
        r[31..33]= r[i-31]
        r[i>=34] = r[i-3] + r[i-31]  (mod 2^32)
        output_k = r[344 + k] >> 1            (the first 310 discarded)

    The process-default stream the reference consumes is seed 1."""

    RAND_MAX = 2147483647

    def __init__(self, seed: int = 1):
        seed = int(seed) & 0xFFFFFFFF
        if seed == 0:
            seed = 1
        r = [0] * 34
        # the seeding LCG runs on int32, by Schrage's method
        word = seed if seed < 0x80000000 else seed - 0x100000000
        r[0] = word & 0xFFFFFFFF
        for i in range(1, 31):
            hi, lo = divmod(word, 127773) if word >= 0 else (
                -((-word) // 127773), -((-word) % 127773))
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r[i] = word
        for i in range(31, 34):
            r[i] = r[i - 31]
        self._r = r
        self._i = 34
        for _ in range(310):
            self._step()

    def _step(self) -> int:
        r, i = self._r, self._i
        v = (r[i - 3] + r[i - 31]) & 0xFFFFFFFF
        r.append(v)
        self._i = i + 1
        if self._i > 400:               # keep the window bounded
            del r[: self._i - 34]
            self._i = 34
        return v >> 1

    def rand(self) -> int:
        """One ``std::rand()`` draw in [0, RAND_MAX]."""
        return self._step()

    def __call__(self) -> float:
        """One ``basic_dist`` draw: ``1.0 * rand() / RAND_MAX`` in double
        (``src/frand.h:28``)."""
        return self.rand() / float(self.RAND_MAX)


def vec_dist_table(max_values: int, rand: GlibcRand | None = None):
    """The ``vec_dist`` table (``src/frand.h:36-43``) as the reference's
    toolchain builds it: ``max_values`` evenly spaced doubles ``step*i``
    and a trailing 1.0, permuted by libstdc++'s ``std::random_shuffle``
    (forward Fisher–Yates drawing ``std::rand() % (i + 1)``). ``rand``
    defaults to the process-default glibc stream (seed 1). Returns a
    float64 numpy array of ``max_values + 1`` values."""
    rand = rand if rand is not None else GlibcRand(1)
    step = 1.0 / max_values
    vals = [step * i for i in range(max_values)] + [1.0]
    for i in range(1, len(vals)):
        j = rand.rand() % (i + 1)
        if i != j:
            vals[i], vals[j] = vals[j], vals[i]
    return np.asarray(vals, np.float64)


class TableRng:
    """The reference's ``vec_dist`` RNG (``src/frand.h:32-50``) on the
    host: ``max_values + 1`` evenly spaced values in [0, 1], shuffled
    once, then cycled. ``exact=True`` (default) is the libstdc++ table
    (``vec_dist_table``); ``exact=False`` a seeded numpy Philox shuffle,
    another permutation per seed. The device form is ``rng="table"``
    (``table_uniforms``)."""

    def __init__(self, max_values: int, seed: int = 1, exact: bool = True):
        if exact:
            self._values = vec_dist_table(max_values, GlibcRand(seed))
        else:
            step = 1.0 / max_values
            vals = np.arange(max_values + 1) * step
            vals[-1] = 1.0
            rng = np.random.Generator(np.random.Philox(seed))
            rng.shuffle(vals)
            self._values = vals
        self._next = 0

    def __call__(self) -> float:
        v = self._values[self._next]
        self._next = (self._next + 1) % len(self._values)
        return float(v)


@functools.lru_cache(maxsize=None)
def device_table(max_values: int) -> np.ndarray:
    """The float32 ``vec_dist`` table of the ``table`` stream, built once
    a size on the host (the libstdc++ permutation, seed-1 glibc
    stream)."""
    return vec_dist_table(int(max_values)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def table_tensor(max_values: int, device: torch.device) -> torch.Tensor:
    """``device_table(max_values)`` as a tensor on ``device``, copied
    there once."""
    return torch.from_numpy(device_table(max_values)).to(device)


def table_uniforms(table: torch.Tensor, pixel_ids: torch.Tensor,
                   sample: int, bounce: int, n_draws: int, max_bounces: int,
                   offset: int = 0) -> torch.Tensor:
    """The ``table`` stream's draws, ``(n_draws, N)`` float32: pixel
    ``p``'s k-th draw reads ``table[(p + offset + k) mod 2^32 mod
    len(table)]``, ``k = (sample * max_bounces + bounce) * n_draws + d``
    counting draws in walk order, every sum in uint32 as the JAX package
    adds them (``spath_tpu/ops/rng.py::table_uniforms``). Stateless in
    (pixel, counters); ``pixel_ids`` are int64 global pixel ids."""
    n = table.shape[0]
    k0 = ((sample * max_bounces + bounce) * n_draws) & _U32
    base = (pixel_ids + (int(offset) & _U32)) & _U32
    return torch.stack([
        table.index_select(0, ((base + k0 + d) & _U32) % n)
        for d in range(n_draws)])
