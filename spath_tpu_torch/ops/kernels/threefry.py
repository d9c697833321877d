"""The threefry stream's draws on the card (``csrc/threefry.cu``).

``threefry_call(key, pixel_ids, n_draws)`` returns the ``(n_draws, N)``
float32 uniforms of one (sample, bounce) step of the wavefront: pixel
``p``'s draws are ``jax.random.uniform(fold_in(key, p), (n_draws,))``,
``key`` the step's two words (``ops/rng.py``: ``fold_in`` of the frame
key by the sample and the bounce, on the host). The JAX package computes
them with XLA (``spath_tpu/ops/rng.py:220``, ``per_pixel_uniforms``); no
Pallas kernel takes the threefry stream.

On CUDA tensors the wrapper launches the kernel on PyTorch's current
stream, without synchronisation, one thread a pixel, and counts the call
in ``threefry_call.launches``; a failed build or launch raises. CPU
tensors take ``ops/rng.py::per_pixel_uniforms``, which works on uint32 values
held in int64 and masks every step. The draws are constants of the
backward pass: the result has no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from spath_tpu_torch.ops.kernels.build import library
from spath_tpu_torch.ops.rng import per_pixel_uniforms

#: The most draws a pixel the kernel takes: the wavefront's are at most
#: 5 with NEE, 1 for the roulette and 2 for the visibility edge sample.
MAX_DRAWS = 8
#: Each id is a pixel's global index, taken mod 2^32.
_U32 = 0xFFFFFFFF


def _check(key, pixel_ids: torch.Tensor, n_draws: int) -> None:
    if len(key) != 2 or not all(0 <= int(w) <= _U32 for w in key):
        raise ValueError(f"key must be two uint32 words, got {key!r}")
    if pixel_ids.dtype != torch.int64 or pixel_ids.dim() != 1:
        raise ValueError(f"pixel_ids must be int64 (N,), got "
                         f"{pixel_ids.dtype} {tuple(pixel_ids.shape)}")
    if not 1 <= n_draws <= MAX_DRAWS:
        raise ValueError(f"n_draws must be 1 to {MAX_DRAWS}, got {n_draws}")
    if pixel_ids.shape[0] >= 1 << 31:
        raise ValueError(f"{pixel_ids.shape[0]} pixels overflow int32")


def threefry_call(key, pixel_ids: torch.Tensor,
                  n_draws: int) -> torch.Tensor:
    """``(n_draws, N)`` float32 threefry uniforms of the pixels
    ``pixel_ids`` under the step key ``key`` (two uint32 words), on the
    ids' device. Launches ``csrc/threefry.cu`` on CUDA tensors; CPU
    tensors take ``per_pixel_uniforms``."""
    pixel_ids = pixel_ids.detach()
    _check(key, pixel_ids, n_draws)
    k0, k1 = (int(w) for w in key)
    if pixel_ids.device.type == "cpu":
        return per_pixel_uniforms((k0, k1), pixel_ids, n_draws)
    if pixel_ids.device.type != "cuda":
        raise ValueError(f"no threefry kernel for device {pixel_ids.device}")
    pixel_ids = pixel_ids.contiguous()
    n = pixel_ids.shape[0]
    out = torch.empty((n_draws, n), dtype=torch.float32,
                      device=pixel_ids.device)
    lib = library()
    with torch.cuda.device(pixel_ids.device):
        stream = torch.cuda.current_stream(pixel_ids.device).cuda_stream
        err = lib.spath_threefry(
            k0, k1, ctypes.c_void_p(pixel_ids.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), n, n_draws,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"threefry kernel launch failed: CUDA error {err} "
                           f"({lib.spath_error_string(err).decode()})")
    threefry_call.launches += 1
    return out


threefry_call.launches = 0
