"""Whole-frame conformance path tracer for large scenes in one CUDA
launch (K6).

The port of ``spath_tpu/ops/pallas/megakernel_bigscene.py``
(``_bigscene_kernel``, ``bigscene_call``, ``render_radiance_bigscene``):
K1's walk (``ops/kernels/megakernel.py``) with the nearest-hit sweep
streamed through shared memory in blocks of 256 triangles, so the
scene may hold up to ``BIG_MAX_TRIS`` triangles. The kernel is in
``csrc/bigscene.cu``, its sweep in ``csrc/stream_sweep.cuh`` and its walk,
K1's, in ``csrc/megakernel_common.cuh``.

It takes K1's inputs: the ``(n, 3)`` rays and int64 seeds of
``megakernel.pack_rays`` and the ``(T, 18)`` table of
``megakernel.scene_table``, with ``1 <= T <= BIG_MAX_TRIS``; the output
is the ``(n, 3)`` mean radiance. The JAX kernel's Plücker feature blocks
and attribute rows (``bigscene_tables``) are a TPU layout; the port reads
the one table.

K6 computes the same function as K1 with the same arithmetic: it equals
K1 to the bit at T <= 1024 and ``megakernel.megakernel_plain``, its plain
version, at every T. (The JAX kernel's Plücker arithmetic differs from
the reference Möller–Trumbore in the last bits, so the JAX suite holds it
to its wavefront within a flip budget.)

``bigscene_call`` launches the kernel for CUDA tensors and counts each
launch in ``bigscene_call.launches``; for CPU tensors it computes the
same function with the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from spath_tpu_torch.camera import Camera
from spath_tpu_torch.config import RenderConfig
from spath_tpu_torch.models.pathtracer import is_conformance
from spath_tpu_torch.ops.kernels import megakernel
from spath_tpu_torch.ops.kernels.build import library
from spath_tpu_torch.scene import Scene

#: Largest scene the streamed kernels take (the JAX package's
#: ``BIG_MAX_TRIS``): a (2^20, 18) float32 table is 75 MB.
BIG_MAX_TRIS = 1 << 20


def supported(scene: Scene, cfg: RenderConfig) -> bool:
    """Does K6 render ``(scene, cfg)`` exactly? The conformance estimator
    (lcg + angle, no nee, ``rr_start == 0``, no stratify) up to
    ``BIG_MAX_TRIS`` triangles, as the JAX package's ``supported``. The
    intersection method is not read: only ``pallas_fast`` differs there,
    and it is an alias of the exact sweep."""
    return scene.n_tris <= BIG_MAX_TRIS and is_conformance(cfg)


def bigscene_call(origins, directions, seeds, tri, cfg: RenderConfig):
    """Mean radiance ``(n, 3)`` of ``n`` rays (K1's layouts, T up to
    ``BIG_MAX_TRIS``). Launches K6 on CUDA tensors, on PyTorch's current
    stream and without synchronising; a failed build or launch raises.
    CPU tensors take ``megakernel.megakernel_plain``."""
    megakernel._check(origins, directions, seeds, tri, cfg, BIG_MAX_TRIS)
    if origins.device.type == "cpu":
        return megakernel.megakernel_plain(origins, directions, seeds, tri,
                                           cfg)
    if origins.device.type != "cuda":
        raise ValueError(f"no streamed kernel for device {origins.device}")
    n = origins.shape[0]
    out = torch.empty((n, 3), dtype=torch.float32, device=origins.device)
    if n == 0:
        return out
    lib = library()
    with torch.cuda.device(origins.device):
        stream = torch.cuda.current_stream(origins.device).cuda_stream
        err = lib.spath_bigscene_forward(
            ctypes.c_void_p(origins.data_ptr()),
            ctypes.c_void_p(directions.data_ptr()),
            ctypes.c_void_p(seeds.data_ptr()),
            ctypes.c_void_p(tri.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            n, tri.shape[0], cfg.spp, cfg.max_bounces,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"streamed kernel launch failed: CUDA error {err} "
                           f"({lib.spath_error_string(err).decode()})")
    bigscene_call.launches += 1
    return out


bigscene_call.launches = 0


def render_radiance_bigscene(scene: Scene, camera: Camera, cfg: RenderConfig,
                             seed: int = 0) -> torch.Tensor:
    """Unclamped mean radiance ``(H, W, 3)`` through ``bigscene_call``."""
    if not supported(scene, cfg):
        raise ValueError("the streamed kernel supports lcg+angle, "
                         f"T <= {BIG_MAX_TRIS}")
    out = bigscene_call(*megakernel.pack_rays(camera, cfg, seed),
                        megakernel.scene_table(scene), cfg)
    return out.reshape(cfg.height, cfg.width, 3)
