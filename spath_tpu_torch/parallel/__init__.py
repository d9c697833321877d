"""Ray-sharded rendering and training over ``torch.distributed``
(``spath_tpu/parallel/``).

The JAX package runs ``shard_map`` over a one-axis ``Mesh``: pixels split
along ``"rays"``, the scene and camera replicated, ``psum`` for the scene
gradients and an all-gather for the image. Here a mesh is a group of
ranks, each a process with its device, and every rank runs the same
program (SPMD): it passes the same scene, camera, config and seed,
traces its block of pixels and gets the whole frame. Forward passes need
one collective, the all-gather of the frame; a gradient needs one more,
the rank-ordered sum of the replicated inputs' gradients. The triangle
ring (``parallel/ring.py``, ``nearest_hit_ring``) is not ported.
"""

from spath_tpu_torch.parallel.mesh import Mesh, default_mesh, make_mesh
from spath_tpu_torch.parallel.multihost import (
    init_multihost, scaling_efficiency,
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
    "default_mesh",
    "init_multihost",
    "make_mesh",
    "render_pt_fast_sharded",
    "render_pt_sharded",
    "render_radiance_fast_sharded",
    "render_radiance_fastgrad_sharded",
    "render_radiance_sharded",
    "scaling_efficiency",
]
