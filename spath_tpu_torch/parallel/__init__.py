"""Ray-sharded rendering and training over ``torch.distributed``
(``spath_tpu/parallel/``).

The JAX package runs ``shard_map`` over a one-axis ``Mesh``: pixels split
along ``"rays"``, the scene and camera replicated, ``psum`` for the scene
gradients and an all-gather for the image. Here a mesh is a group of
ranks, each a process with its device, and every rank runs the same
program (SPMD): it passes the same scene, camera, config and seed,
traces its block of pixels and gets the whole frame. Forward passes need
one collective, the all-gather of the frame; a gradient needs one more,
the rank-ordered sum of the replicated inputs' gradients.

The triangle ring (``parallel/ring.py``) shards the triangles too: each
rank holds one shard of the scene's table, and the shards rotate around
the mesh by point-to-point sends (``Mesh.shift``) while every rank sweeps
its block of rays against the shard it holds (K5 on the card). Its entry
points take a mesh as the JAX package's do: ``render_flat_ring``,
``render_pt_ring``, ``render_radiance_ring`` (differentiable, the
gradients to the scene whole on every rank) and ``ring_train_step``. On
the CPU the ranks run on gloo; on one card a world of one runs on NCCL,
and ranks sharing a card run on gloo, staged through host memory.
"""

from spath_tpu_torch.parallel.mesh import (
    Mesh, Mesh2D, default_mesh, make_mesh, make_mesh_2d,
)
from spath_tpu_torch.parallel.multihost import (
    init_multihost, scaling_efficiency,
)
from spath_tpu_torch.parallel.ring import (
    nearest_hit_ring, render_flat_ring, render_pt_ring, render_radiance_ring,
    ring_train_step,
)
from spath_tpu_torch.parallel.shard import (
    render_pt_sharded, render_radiance_sharded,
)
from spath_tpu_torch.parallel.shard_fast import (
    render_pt_fast_sharded, render_radiance_fast_sharded,
    render_radiance_fastgrad_sharded,
)

__all__ = [
    "Mesh",
    "Mesh2D",
    "default_mesh",
    "init_multihost",
    "make_mesh",
    "make_mesh_2d",
    "nearest_hit_ring",
    "render_flat_ring",
    "render_pt_fast_sharded",
    "render_pt_ring",
    "render_pt_sharded",
    "render_radiance_fast_sharded",
    "render_radiance_fastgrad_sharded",
    "render_radiance_ring",
    "render_radiance_sharded",
    "ring_train_step",
    "scaling_efficiency",
]
