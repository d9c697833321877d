"""A one-axis mesh of ranks (``spath_tpu/parallel/mesh.py``).

The JAX package's ``Mesh`` is a grid of devices that one controller
drives through ``shard_map``. Here every rank is a process of its own
(SPMD over ``torch.distributed``): each one calls the same function with
the same scene, camera, config and seed, traces its own block of pixels
along the ``rays`` axis, and gets the whole frame back. A ``Mesh`` names
the process group, its member ranks in order, this rank, and this
rank's device.

``make_mesh(1)`` needs no process group: a world of one, whose
collectives are identities. A larger mesh needs ``init_multihost`` (or
``torch.distributed.init_process_group``) first. The triangle ring
(``parallel/ring.py``) takes a one-axis mesh, which the JAX package names
``"shard"`` (``make_mesh(n, axis="shard")``), and rotates its shards with
``Mesh.shift``; ``make_mesh_2d`` is the JAX package's ``(rays, tris)``
grid, whose ``tris`` row is such a mesh.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

AXIS = "rays"

#: Subgroups made so far, by (the default group, member ranks):
#: ``dist.new_group`` is collective and each group holds its own
#: communicator, so a mesh of the same ranks reuses its group.
_GROUPS: dict = {}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks that share a frame along one axis.

    Attributes:
      group: the ``torch.distributed`` process group of the members, or
        ``None`` for a world of one without a process group.
      ranks: the members' global ranks, in the order their blocks take.
      rank: this process's global rank.
      device: this rank's device.
      axis: the axis name, ``"rays"`` unless the caller names another
        (the ring's is ``"shard"``, the 2-D grid's rows ``"tris"``).
    """

    group: object | None
    ranks: tuple[int, ...]
    rank: int
    device: torch.device
    axis: str = AXIS

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def index(self) -> int | None:
        """This rank's place in the mesh, ``None`` outside it."""
        return self.ranks.index(self.rank) if self.rank in self.ranks \
            else None

    def member_index(self) -> int:
        """This rank's place; ``ValueError`` for a rank outside the
        mesh."""
        if self.index is None:
            raise ValueError(f"rank {self.rank} is not in the mesh of ranks "
                             f"{list(self.ranks)}: only its members render "
                             "on it")
        return self.index

    @property
    def backend(self) -> str | None:
        return None if self.group is None else dist.get_backend(self.group)

    def staged(self, t: torch.Tensor) -> bool:
        """Does a collective of ``t`` go through host memory? Yes for a
        CUDA tensor on a gloo group (two ranks sharing one card, which
        NCCL refuses): the tensor is copied to the host, gathered there
        and copied back. NCCL groups and CPU tensors gather in place."""
        return self.backend == "gloo" and t.device.type == "cuda"

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every member's ``t`` (equal shapes), in mesh order."""
        if self.group is None:
            return [t]
        src = t.detach().contiguous()
        staged = self.staged(src)
        if staged:
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in self.ranks]
        dist.all_gather(parts, src, group=self.group)
        return [p.to(t.device) for p in parts] if staged else parts

    def shift(self, t: torch.Tensor) -> torch.Tensor:
        """The previous member's ``t`` (equal shapes): every member sends
        its ``t`` to the next one in mesh order and receives from the
        previous one, the ring's rotation (``lax.ppermute`` with the pairs
        ``(i, (i + 1) % S)``). Both in one ``batch_isend_irecv``: two
        blocking calls in a fixed order can deadlock a ring. A world of
        one returns ``t``; a CUDA tensor on gloo is staged through host
        memory, as ``all_gather`` stages it."""
        if self.group is None or self.size == 1:
            return t
        src = t.detach().contiguous()
        staged = self.staged(src)
        if staged:
            src = src.cpu()
        out = torch.empty_like(src)
        i = self.member_index()
        nxt = self.ranks[(i + 1) % self.size]
        prev = self.ranks[(i - 1) % self.size]
        ops = [dist.P2POp(dist.isend, src, nxt, group=self.group),
               dist.P2POp(dist.irecv, out, prev, group=self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out.to(t.device) if staged else out

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)


def rank_device(rank: int, device=None) -> torch.device:
    """A rank's device: ``device`` if given; else ``cuda:{LOCAL_RANK}``
    (torchrun's variable), else ``cuda:{rank % device_count()}``. Without
    a CUDA device the caller must ask for the CPU (``device="cpu"``)."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            return rank_device(rank)
        return device
    if not torch.cuda.is_available():
        raise ValueError("no CUDA device: pass device='cpu' to put the "
                         "mesh on the CPU")
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None \
        else rank % torch.cuda.device_count()
    return torch.device("cuda", index)


def _group(ranks: tuple[int, ...]):
    if len(ranks) == dist.get_world_size():
        return dist.group.WORLD
    key = (id(dist.group.WORLD), ranks)
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(list(ranks))
    return _GROUPS[key]


def make_mesh(n_devices: int | None = None, axis: str = AXIS,
              device=None) -> Mesh:
    """A mesh of the first ``n_devices`` ranks of the default process
    group (default: all). Every rank of the default group must call it,
    members or not, because a subgroup is made collectively. Without a
    process group only ``n_devices`` of ``None`` or 1 is possible: a
    world of one. ``device`` as ``rank_device`` takes it."""
    if not (dist.is_available() and dist.is_initialized()):
        if n_devices not in (None, 1):
            raise ValueError(
                f"make_mesh({n_devices}) needs a process group of at least "
                f"{n_devices} ranks: call "
                "spath_tpu_torch.parallel.init_multihost first")
        return Mesh(None, (0,), 0, rank_device(0, device), axis)
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh({n_devices}): the process group has "
                         f"{world} ranks")
    ranks = tuple(range(n))
    return Mesh(_group(ranks), ranks, rank, rank_device(rank, device), axis)


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """A ``(rays, tris)`` grid of ranks (``make_mesh_2d``).

    Attributes:
      grid: ``grid[i][j]``, the rank of ray shard ``i`` and triangle shard
        ``j``.
      rays: this rank's column, the ranks of its triangle shard along the
        ``"rays"`` axis; ``None`` for a rank outside the grid.
      tris: this rank's row, the ranks of its ray shard along the
        ``"tris"`` axis, the mesh the triangle ring takes; ``None``
        outside the grid.
    """

    grid: tuple[tuple[int, ...], ...]
    rays: Mesh | None
    tris: Mesh | None
    axis_names = ("rays", "tris")

    @property
    def shape(self) -> tuple[int, int]:
        return len(self.grid), len(self.grid[0])


def make_mesh_2d(n_ray_shards: int, n_tri_shards: int,
                 device=None) -> Mesh2D:
    """The ``(rays, tris)`` grid of the first ``n_ray_shards *
    n_tri_shards`` ranks in row-major order, as the JAX package reshapes
    its devices (``spath_tpu/parallel/mesh.py::make_mesh_2d``). Every rank
    of the default group must call it: each row's and each column's
    subgroup is made collectively. Without a process group only the grid
    of one is possible. ``device`` as ``rank_device`` takes it."""
    n = n_ray_shards * n_tri_shards
    if n_ray_shards < 1 or n_tri_shards < 1:
        raise ValueError(f"make_mesh_2d({n_ray_shards}, {n_tri_shards}): "
                         "each axis needs at least one rank")
    grid = tuple(tuple(i * n_tri_shards + j for j in range(n_tri_shards))
                 for i in range(n_ray_shards))
    if not (dist.is_available() and dist.is_initialized()):
        if n != 1:
            raise ValueError(
                f"make_mesh_2d({n_ray_shards}, {n_tri_shards}) needs a "
                f"process group of at least {n} ranks: call "
                "spath_tpu_torch.parallel.init_multihost first")
        one = make_mesh(1, device=device)
        return Mesh2D(grid, dataclasses.replace(one, axis="rays"),
                      dataclasses.replace(one, axis="tris"))
    world, rank = dist.get_world_size(), dist.get_rank()
    if n > world:
        raise ValueError(f"make_mesh_2d({n_ray_shards}, {n_tri_shards}): "
                         f"the process group has {world} ranks")
    rows = [(r, _group(r)) for r in grid]
    cols = [(c, _group(c)) for c in zip(*grid)]
    if rank >= n:
        return Mesh2D(grid, None, None)
    dev = rank_device(rank, device)
    i, j = divmod(rank, n_tri_shards)
    return Mesh2D(grid, Mesh(cols[j][1], cols[j][0], rank, dev, "rays"),
                  Mesh(rows[i][1], rows[i][0], rank, dev, "tris"))


def default_mesh(device=None) -> Mesh:
    """A mesh of every rank."""
    return make_mesh(device=device)
