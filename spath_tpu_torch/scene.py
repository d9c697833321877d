"""Scene representation: triangles and materials as float32 tensors.

The PyTorch counterpart of ``spath_tpu/scene.py``: a structure of arrays,
each field a ``(T, 3)`` (or ``(T, 3, 3)``) tensor on one device, so the
intersection sweeps broadcast over triangles. Flat normals are derived
from the vertices on demand, as in the reference's ``flat_normal``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spath_tpu_torch.ops.fp import sqrt_rn
from spath_tpu_torch.ops.sampling import cross3


@dataclasses.dataclass(frozen=True)
class Scene:
    """Scene parameters.

    Attributes:
      vertices: ``(T, 3, 3)`` float32, per-triangle ``[v0, v1, v2]``.
      albedo:   ``(T, 3)`` float32 reflectance colour.
      emission: ``(T, 3)`` float32 emittance colour.
      light_idx: static tuple of the indices of emissive triangles, or
        ``None`` when unknown.
    """

    vertices: torch.Tensor
    albedo: torch.Tensor
    emission: torch.Tensor
    light_idx: tuple[int, ...] | None = None

    @property
    def n_tris(self) -> int:
        return self.vertices.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vertices.device

    @property
    def v0(self) -> torch.Tensor:
        return self.vertices[:, 0]

    @property
    def v1(self) -> torch.Tensor:
        return self.vertices[:, 1]

    @property
    def v2(self) -> torch.Tensor:
        return self.vertices[:, 2]

    def normals(self) -> torch.Tensor:
        """Flat unit normals ``unit((v1-v0)×(v2-v0))``, ``(T, 3)``.

        Component arithmetic in the JAX package's order; zero-area
        triangles divide by the 1e-30 guard instead of by zero.
        """
        n = cross3(self.v1 - self.v0, self.v2 - self.v0)
        norm = sqrt_rn(n[:, 0] * n[:, 0] + n[:, 1] * n[:, 1]
                       + n[:, 2] * n[:, 2])
        return n / torch.clamp_min(norm, 1e-30)[:, None]


def make_scene(vertices, albedo, emission, device,
               light_idx: tuple[int, ...] | None = None) -> Scene:
    """Build a Scene on ``device`` from array-likes, cast to float32.

    ``light_idx`` defaults to the triangles whose emission sums above 0.
    """
    emission_np = np.asarray(emission, np.float32)
    if light_idx is None:
        light_idx = tuple(np.flatnonzero(emission_np.sum(-1) > 0).tolist())

    def tensor(x):
        return torch.from_numpy(np.array(x, np.float32)).to(device)

    return Scene(tensor(vertices), tensor(albedo), tensor(emission_np),
                 tuple(light_idx))


def default_scene(device) -> Scene:
    """The reference's hard-coded 7-triangle scene.

    Triangle 0: foreground red triangle. 1-2: green/blue floor at y=-1
    extending ±20. 3-4: white emissive area light at y=0.75. 5-6: white
    back wall at z=1.
    """
    p = 20.0  # floor plane half-size
    a = 0.75  # area-light half-size
    w = 1.0   # back-wall depth
    vertices = np.array(
        [
            [[0.0, 0.0, 1.0], [0.5, -0.5, 0.0], [-0.5, -0.5, 0.0]],
            [[p, -1.0, p], [-p, -1.0, -p], [-p, -1.0, p]],
            [[p, -1.0, p], [p, -1.0, -p], [-p, -1.0, -p]],
            [[a, 0.75, a], [-a, 0.75, a], [a, 0.75, -a]],
            [[-a, 0.75, a], [-a, 0.75, -a], [a, 0.75, -a]],
            [[1.25, 0.5, w], [1.25, -1.0, w], [-1.25, -1.0, w]],
            [[1.25, 0.5, w], [-1.25, -1.0, w], [-1.25, 0.5, w]],
        ],
        dtype=np.float32,
    )
    albedo = np.array(
        [
            [1.0, 0.0, 0.0],
            [0.0, 1.0, 0.0],
            [0.0, 0.0, 1.0],
            [1.0, 1.0, 1.0],
            [1.0, 1.0, 1.0],
            [1.0, 1.0, 1.0],
            [1.0, 1.0, 1.0],
        ],
        dtype=np.float32,
    )
    emission = np.zeros((7, 3), dtype=np.float32)
    emission[3] = emission[4] = [1.0, 1.0, 1.0]
    return make_scene(vertices, albedo, emission, device)


def procedural_scene(
    n_tris: int,
    seed: int = 0,
    extent: float = 3.0,
    tri_size: float = 0.12,
    emissive_fraction: float = 0.01,
    *,
    device,
) -> Scene:
    """Random small triangles in a box in front of the default camera,
    a fraction of them emissive.

    The same NumPy Philox draws as ``spath_tpu.scene.procedural_scene``,
    so both packages build identical arrays from one seed.
    """
    rng = np.random.Generator(np.random.Philox(seed))
    centers = rng.uniform(-extent, extent, size=(n_tris, 1, 3))
    centers[..., 2] = rng.uniform(0.0, 2.0 * extent, size=(n_tris, 1))
    offsets = rng.uniform(-tri_size, tri_size, size=(n_tris, 3, 3))
    vertices = (centers + offsets).astype(np.float32)
    albedo = rng.uniform(0.05, 1.0, size=(n_tris, 3)).astype(np.float32)
    emissive = rng.uniform(size=(n_tris,)) < emissive_fraction
    emission = np.where(
        emissive[:, None], rng.uniform(1.0, 4.0, size=(n_tris, 3)), 0.0
    ).astype(np.float32)
    return make_scene(vertices, albedo, emission, device)
