"""Whole-frame conformance path tracer in one CUDA launch (K1).

The port of ``spath_tpu/ops/pallas/megakernel.py::_megakernel``: the
sample loop, the 5-bounce walk, Möller–Trumbore against every triangle,
the LCG, the angle sampler and the shading all run in one kernel, a lane
a pixel, so a ray's state stays in registers from camera ray to mean
radiance. Each lane walks its pixel's samples one bounce a step and takes
the next pixel from a queue when they are done (``csrc/megakernel_lanes.cuh``),
on a persistent grid of the kernel's own resident CTAs
(``bigscene.queue_grid``). Device memory sees 24 bytes of ray and 8 of
seed in and 12 bytes of radiance out per pixel; the triangle table is
read through the cache. The kernel is in ``csrc/megakernel.cu``.

Layouts, as the wrapper checks them (all contiguous):

- ``origins``, ``directions``: float32 ``(n, 3)``, as ``generate_rays``
  gives them;
- ``seeds``: int64 ``(n,)`` holding each ray's uint32 LCG seed;
- ``tri``: float32 ``(T, 18)``, rows v0, e1, e2, normal, albedo,
  emission, ``1 <= T <= MAX_TRIS``;
- output: float32 ``(n, 3)``, the mean radiance.

The JAX package pads rays to 1024-lane tiles and the table to 24
columns for the TPU's layout; one thread per ray needs neither.

``mega_call`` launches the kernel for CUDA tensors and counts each launch
in ``mega_call.launches``; for CPU tensors it computes the same function
with ``megakernel_plain``, the plain PyTorch version.
"""

from __future__ import annotations

import ctypes

import torch

from spath_tpu_torch.camera import Camera, pixel_rays
from spath_tpu_torch.config import RenderConfig
from spath_tpu_torch.models.pathtracer import (
    is_conformance, mean_radiance_geometry, require_conformance,
    scene_geometry,
)
from spath_tpu_torch.ops.intersect import plain_sweep
from spath_tpu_torch.ops.kernels.build import library
from spath_tpu_torch.ops.rng import lcg_seeds
from spath_tpu_torch.scene import Scene

#: Largest scene the kernel takes: a (1024, 18) float32 table is 72 KiB.
MAX_TRIS = 1024


def scene_table(scene: Scene) -> torch.Tensor:
    """``(T, 18)`` table: v0(3), e1(3), e2(3), n(3), albedo(3),
    emission(3)."""
    return torch.cat(scene_geometry(scene), dim=1).contiguous()


def supported(scene: Scene, cfg: RenderConfig) -> bool:
    """Does the kernel render ``(scene, cfg)`` exactly?"""
    return scene.n_tris <= MAX_TRIS and is_conformance(cfg)


def pack_rays(camera: Camera, cfg: RenderConfig, seed: int = 0):
    """Camera → ``(origins (n, 3), directions (n, 3), seeds (n,))`` on
    the camera's device."""
    o, d, ids = pixel_rays(camera, cfg.width, cfg.height)
    return o, d, lcg_seeds(seed, ids)


def megakernel_plain(origins, directions, seeds, tri, cfg: RenderConfig):
    """The plain PyTorch version of the kernel: the wavefront walk of
    ``models/pathtracer.py`` over the table's columns. Returns
    ``(n, 3)``. It takes a table of any size: it is also the plain
    version of the streamed kernel K6 (``ops/kernels/bigscene.py``).
    ``vis_grad`` changes no frame, so it is dropped, as the kernel
    ignores it. The sweeps are the plain ``_sweep`` on any device
    (``ops/intersect.py``: ``plain_sweep``)."""
    geom = tuple(tri[:, k:k + 3] for k in range(0, 18, 3))
    with plain_sweep():
        return mean_radiance_geometry(geom, origins, directions, seeds,
                                      cfg.replace(vis_grad=False))


def _check(origins, directions, seeds, tri, cfg: RenderConfig,
           max_tris: int = MAX_TRIS) -> None:
    """Raise ``ValueError`` for inputs outside the layouts of the module
    docstring, a table of more than ``max_tris`` rows included (the
    streamed kernels share these checks with their own cap)."""
    require_conformance(cfg)
    n = origins.shape[0] if origins.dim() == 2 else -1
    for name, rays in (("origins", origins), ("directions", directions)):
        if rays.dtype != torch.float32 or tuple(rays.shape) != (n, 3):
            raise ValueError(f"{name} must be float32 ({n}, 3), got "
                             f"{rays.dtype} {tuple(rays.shape)}")
    if seeds.dtype != torch.int64 or tuple(seeds.shape) != (n,):
        raise ValueError(f"seeds must be int64 ({n},), got {seeds.dtype} "
                         f"{tuple(seeds.shape)}")
    if tri.dtype != torch.float32 or tri.dim() != 2 or tri.shape[1] != 18:
        raise ValueError(f"tri must be float32 (T, 18), got {tri.dtype} "
                         f"{tuple(tri.shape)}")
    if not 1 <= tri.shape[0] <= max_tris:
        raise ValueError(f"T={tri.shape[0]} outside [1, {max_tris}]")
    if cfg.spp < 1 or cfg.max_bounces < 0:
        raise ValueError(f"spp={cfg.spp}, max_bounces={cfg.max_bounces}")
    if 3 * n >= 2**31:
        raise ValueError(f"{n} rays overflow the kernel's int32 indexing")
    if not (origins.device == directions.device == seeds.device
            == tri.device):
        raise ValueError("origins, directions, seeds and tri must be on "
                         "one device")
    if not all(t.is_contiguous() for t in (origins, directions, seeds, tri)):
        raise ValueError("origins, directions, seeds and tri must be "
                         "contiguous")


def mega_call(origins, directions, seeds, tri, cfg: RenderConfig):
    """Mean radiance ``(n, 3)`` of ``n`` rays (layouts in the module
    docstring). Launches the CUDA kernel on CUDA tensors, on PyTorch's
    current stream and without synchronising; a failed build or launch
    raises. CPU tensors take ``megakernel_plain``."""
    _check(origins, directions, seeds, tri, cfg)
    if origins.device.type == "cpu":
        return megakernel_plain(origins, directions, seeds, tri, cfg)
    if origins.device.type != "cuda":
        raise ValueError(f"no megakernel for device {origins.device}")
    from spath_tpu_torch.ops.kernels.bigscene import queue_grid

    n = origins.shape[0]
    out = torch.empty((n, 3), dtype=torch.float32, device=origins.device)
    if n == 0:
        return out
    lib = library()
    grid = queue_grid(n, origins.device, "K1")
    counter = torch.zeros(1, dtype=torch.int32, device=origins.device)
    with torch.cuda.device(origins.device):
        stream = torch.cuda.current_stream(origins.device).cuda_stream
        err = lib.spath_megakernel_forward(
            ctypes.c_void_p(origins.data_ptr()),
            ctypes.c_void_p(directions.data_ptr()),
            ctypes.c_void_p(seeds.data_ptr()),
            ctypes.c_void_p(tri.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(counter.data_ptr()),
            n, tri.shape[0], cfg.spp, cfg.max_bounces, grid,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"megakernel launch failed: CUDA error {err} "
                           f"({lib.spath_error_string(err).decode()})")
    mega_call.launches += 1
    return out


mega_call.launches = 0


def radiance_block(scene: Scene, origins, directions, pixel_ids,
                   cfg: RenderConfig, seed: int = 0) -> torch.Tensor:
    """Mean radiance ``(n, 3)`` through ``mega_call`` of camera rays with
    their pixel ids in the whole frame, which key the LCG streams: a
    block of a frame's rays gets the frame's bits."""
    if not supported(scene, cfg):
        raise ValueError(
            f"megakernel supports lcg+angle, T <= {MAX_TRIS}")
    return mega_call(origins, directions, lcg_seeds(seed, pixel_ids),
                     scene_table(scene), cfg)


def render_radiance_megakernel(scene: Scene, camera: Camera,
                               cfg: RenderConfig, seed: int = 0
                               ) -> torch.Tensor:
    """Unclamped mean radiance ``(H, W, 3)`` through ``mega_call``."""
    return radiance_block(scene, *pixel_rays(camera, cfg.width, cfg.height),
                          cfg, seed).reshape(cfg.height, cfg.width, 3)
