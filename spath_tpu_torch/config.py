"""Render configuration.

The same frozen dataclass, fields and defaults as the JAX package's
``spath_tpu/config.py``, copied rather than imported so the port never
pulls in JAX. Every stream is implemented: ``lcg``, ``hash``,
``threefry`` (``jax.random``'s, bit for bit) and ``table`` (the
reference's ``vec_dist``), with every sampler, NEE, MIS, Russian roulette
and stratification where the JAX package allows them. ``intersect`` names
the JAX package's nearest-hit implementations; every one of them is the
same exact sweep in the port (K5 on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

# Constants shared with the reference implementation (float32 there):
# EPSILON is the Möller–Trumbore bound, MAX_DIST the miss distance.
EPSILON = 1e-14
MAX_DIST = 1e12


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static knobs of a render (see ``spath_tpu.config.RenderConfig`` for
    the meaning of every field)."""

    width: int = 640
    height: int = 480
    spp: int = 128
    max_bounces: int = 5
    rng: Literal["lcg", "threefry", "hash", "table"] = "lcg"
    sampler: Literal["angle", "cosine", "uniform"] = "angle"
    intersect: Literal[
        "reference", "pluecker", "pallas", "pallas_fast"
    ] = "reference"
    nee: bool = False
    mis: bool = True
    rr_start: int = 0
    stratify: bool = False
    vis_grad: bool = False
    table_size: int = 1000
    remat: bool = True
    tri_block: int = 512
    ray_tile: int = 2048

    @property
    def n_pixels(self) -> int:
        return self.width * self.height

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


#: Conformance config: the reference's per-pixel LCG + angle sampler.
CONFORMANCE = RenderConfig(rng="lcg", sampler="angle", intersect="reference")

#: Quality config: threefry RNG + cosine-weighted sampling + NEE
#: (``spath_tpu/config.py``'s ``QUALITY``, letter for letter).
QUALITY = RenderConfig(
    rng="threefry", sampler="cosine", intersect="pluecker", nee=True
)
