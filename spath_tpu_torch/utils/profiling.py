"""Profiling and render observability (``spath_tpu/utils/profiling.py``).

- ``FrameTimer``: the rays/s accounting (pixels·spp·bounces over
  wall-clock seconds, the BASELINE metric), each frame between two
  device synchronisations, so that an asynchronous launch cannot end a
  frame early.
- ``trace_to``: a ``torch.profiler`` trace of a region (the CPU, and the
  card where there is one), written as a Chrome trace.
- ``sync``: wait for the device work behind some tensors.
- ``bounce_stats``: each bounce's share of the wavefront's rays still
  alive after it (what stream compaction would reclaim).
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


def _sync_devices() -> None:
    """Wait for every CUDA device this process has used."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


class FrameTimer:
    """rays/s accounting over explicit frame marks.

    >>> ft = FrameTimer(cfg)
    >>> with ft.frame():
    ...     img = render(...)
    >>> ft.rays_per_s

    ``frame`` synchronises the CUDA devices on entry and on exit, so a
    frame's time is its device work's.
    """

    def __init__(self, cfg):
        self.n_rays_per_frame = (
            cfg.width * cfg.height * cfg.spp * cfg.max_bounces)
        self.times: list[float] = []

    @contextlib.contextmanager
    def frame(self):
        _sync_devices()
        t = time.perf_counter()
        yield
        _sync_devices()
        self.times.append(time.perf_counter() - t)

    @property
    def last_s(self) -> float:
        return self.times[-1]

    @property
    def rays_per_s(self) -> float:
        return self.n_rays_per_frame / min(self.times)


@contextlib.contextmanager
def trace_to(log_dir: str):
    """``torch.profiler`` trace of the enclosed region, the CPU's and,
    where there is a card, its kernels'; written to
    ``log_dir/trace.json`` (Chrome trace format) when the region ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _sync_devices()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def sync(x):
    """Wait until the device work behind the tensors of ``x`` (a tensor, or
    a list, tuple or dict of them) has finished. Returns ``x``."""
    for device in {t.device for t in _tensors(x)}:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return x


def bounce_stats(scene, camera, cfg, seed=0) -> np.ndarray:
    """Each bounce's share of rays still alive after it, for one sample of
    the wavefront: float32 ``(max_bounces,)``. The default scene keeps
    ~44% of its camera rays after bounce 1 (the rest miss). The stream
    starts as the JAX package's does: the LCG at the pixel seeds, the
    threefry stream at the key ``seed`` makes (not folded with a sample),
    the hash and table streams at ``seed``."""
    from spath_tpu_torch.camera import generate_rays
    from spath_tpu_torch.models.pathtracer import trace_radiance
    from spath_tpu_torch.ops.rng import pixel_seeds

    origins, dirs = generate_rays(camera, cfg.width, cfg.height)
    if cfg.rng == "lcg":
        state = pixel_seeds(origins.shape[0], seed, device=origins.device)
    else:
        state = seed
    with torch.no_grad():
        _, _, aux = trace_radiance(scene, origins, dirs, cfg, state,
                                   return_aux=True)
    return aux["alive_fraction"].cpu().numpy()
