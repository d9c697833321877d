"""Process-group start-up and the scaling measurement
(``spath_tpu/parallel/multihost.py``).

- ``init_multihost()``: ``torch.distributed.init_process_group`` over
  ``tcp://``, NCCL for ranks on CUDA devices and gloo for ranks on the
  CPU; afterwards ``make_mesh`` spans every rank and the same code runs
  on each (SPMD). Nothing of a cluster is discovered: the address, the
  number of processes and this process's id come from the arguments or
  from torchrun's ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and
  ``RANK``.
- ``scaling_efficiency()``: BASELINE config 5's measure, ``t(1) / (n ·
  t(n))`` for the sharded forward render. It means something only with
  a card a rank; ranks sharing a card or CPU cores test the machinery.
"""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist

from spath_tpu_torch.parallel.mesh import make_mesh, rank_device
from spath_tpu_torch.parallel.shard import render_pt_sharded


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   backend: str | None = None) -> bool:
    """Start the default process group; returns whether it started one.

    ``coordinator_address`` is ``host:port`` (or ``tcp://host:port``) of
    rank 0. A second call, or a call with no arguments outside torchrun,
    does nothing, as the JAX package's does. ``backend`` defaults to
    ``"nccl"`` where CUDA is available, else ``"gloo"``; with NCCL the
    process's current device becomes its rank's (``rank_device``)."""
    if dist.is_initialized():
        return False
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    given = (coordinator_address, num_processes, process_id)
    if all(x is None for x in given):
        return False
    if any(x is None for x in given):
        raise ValueError("init_multihost needs the coordinator's address, "
                         "the number of processes and this process's id "
                         "(or torchrun's MASTER_ADDR, MASTER_PORT, "
                         "WORLD_SIZE and RANK)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank_device(process_id))
    url = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)
    return True


def _seconds(fn, device: torch.device) -> float:
    """Seconds of one call: CUDA events on a CUDA device, the host clock
    elsewhere."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t = time.perf_counter()
    fn()
    return time.perf_counter() - t


def scaling_efficiency(scene, camera, cfg, n_devices: int, seed: int = 0,
                       reps: int = 2):
    """``t(1) / (n · t(n))`` for ``render_pt_sharded``, each time the best
    of ``reps`` calls after one warm-up call. Every rank of the default
    group calls it; rank 0 alone renders on the one-rank mesh while the
    others wait, and every rank returns rank 0's numbers.

    Returns ``(efficiency, t1, tn)``, the times in seconds."""
    device = scene.device
    meshes = (make_mesh(1, device=device), make_mesh(n_devices,
                                                     device=device))

    def best(mesh):
        def call():
            with torch.no_grad():
                render_pt_sharded(scene, camera, cfg, seed, mesh)

        call()
        return min(_seconds(call, device) for _ in range(reps))

    times = [best(m) if m.index is not None else None for m in meshes]
    if dist.is_initialized():
        dist.broadcast_object_list(times, src=0)
    t1, tn = times
    return t1 / (n_devices * tn), t1, tn
