"""The light choice's distribution, built where the scene lives.

``light_cdf_call(emission, area)`` returns ``(cdf (T,), prob (T,))``: prob
∝ luminance·area and its cumulative sum, the detached columns of the
quality table (``megakernel_quality.quality_table``) that K3, K4 and the
wavefront's light sampling walk. An all-dark scene gets a uniform cdf and
a prob of zeros (callers mask by ``prob > 0``).

The choice is discrete, so a last-bit difference in the cdf picks another
light. Both versions compute in the JAX package's order on the CPU: the
luminance and the total summed left to right, the cumulative sum as XLA's
CPU scan does it (sequential within blocks of 16, the block totals
scanned the same way, then added). XLA's CPU reduction of more than 32
terms is not sequential; for such scenes the total may differ from the
JAX package's in the last bit.

On CUDA tensors the wrapper launches ``csrc/light_cdf.cu`` on PyTorch's
current stream, without synchronisation, and counts the call in
``light_cdf_call.launches``: one block up to ``SHARED_TRIS`` triangles,
above that a launch per step of the scan with its levels in a scratch
buffer, up to ``MAX_TRIS``. A CUDA scene's table never goes through the
host. CPU tensors take ``light_cdf_plain``, which sums in numpy: PyTorch's
CPU float32 ``cumsum`` accumulates in float64, not in XLA's order.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from spath_tpu_torch.ops.kernels.build import library

#: Largest table the kernel scans in one block, its levels in shared
#: memory; and the largest it takes (the streamed kernels' cap, 2^20).
SHARED_TRIS, MAX_TRIS = 8192, 1 << 20


def _scan(x: np.ndarray) -> np.ndarray:
    """Inclusive float32 prefix sum in XLA's CPU order: sequential within
    blocks of 16, plus the scanned totals of the blocks before."""
    n = x.shape[0]
    if n <= 16:
        return np.add.accumulate(x, dtype=np.float32)
    nb = -(-n // 16)
    blocks = np.zeros(nb * 16, np.float32)
    blocks[:n] = x
    inner = np.add.accumulate(blocks.reshape(nb, 16), axis=1,
                              dtype=np.float32)
    before = np.concatenate([np.zeros(1, np.float32),
                             _scan(inner[:, -1])[:-1]])
    return (inner + before[:, None]).reshape(-1)[:n]


def light_cdf_plain(emission: torch.Tensor, area: torch.Tensor):
    """The plain version: ``(cdf, prob)`` summed on the host, returned on
    the emission's device."""
    em = emission.detach().cpu().numpy()
    a = area.detach().cpu().numpy()
    w = ((em[:, 0] + em[:, 1]) + em[:, 2]) * a
    total = np.add.accumulate(w, dtype=np.float32)[-1]
    t = w.shape[0]
    if total > 0:
        prob = w / total
        cdf = _scan(prob)
    else:
        prob = np.zeros(t, np.float32)
        cdf = np.arange(1, t + 1, dtype=np.float32) / np.float32(t)
    return (torch.from_numpy(cdf).to(emission.device),
            torch.from_numpy(prob).to(emission.device))


def _check(emission: torch.Tensor, area: torch.Tensor) -> None:
    t = emission.shape[0] if emission.dim() == 2 else -1
    if emission.dtype != torch.float32 or tuple(emission.shape) != (t, 3):
        raise ValueError(f"emission must be float32 (T, 3), got "
                         f"{emission.dtype} {tuple(emission.shape)}")
    if area.dtype != torch.float32 or tuple(area.shape) != (t,):
        raise ValueError(f"area must be float32 ({t},), got {area.dtype} "
                         f"{tuple(area.shape)}")
    if t < 1:
        raise ValueError("a light choice needs at least one triangle")
    if area.device != emission.device:
        raise ValueError("emission and area must be on one device")


def light_cdf_call(emission: torch.Tensor, area: torch.Tensor):
    """``(cdf (T,), prob (T,))`` of the light choice over ``T`` triangles,
    detached, on the inputs' device. Launches the kernel on CUDA tensors
    (``T <= MAX_TRIS``; a failed build or launch raises); CPU tensors take
    ``light_cdf_plain``."""
    emission, area = emission.detach(), area.detach()
    _check(emission, area)
    if emission.device.type == "cpu":
        return light_cdf_plain(emission, area)
    if emission.device.type != "cuda":
        raise ValueError(f"no light-distribution kernel for device "
                         f"{emission.device}")
    t = emission.shape[0]
    if t > MAX_TRIS:
        raise ValueError(f"T={t} above the light-distribution kernel's "
                         f"{MAX_TRIS}")
    emission, area = emission.contiguous(), area.contiguous()
    cdf = torch.empty(t, dtype=torch.float32, device=emission.device)
    prob = torch.empty_like(cdf)
    lib = library()
    floats = lib.spath_light_cdf_scratch(t)
    scratch = torch.empty(floats, dtype=torch.float32,
                          device=emission.device) if floats else None
    with torch.cuda.device(emission.device):
        stream = torch.cuda.current_stream(emission.device).cuda_stream
        err = lib.spath_light_cdf(
            ctypes.c_void_p(emission.data_ptr()),
            ctypes.c_void_p(area.data_ptr()),
            ctypes.c_void_p(cdf.data_ptr()), ctypes.c_void_p(prob.data_ptr()),
            ctypes.c_void_p(None if scratch is None
                            else scratch.data_ptr()),
            t, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"light-distribution kernel launch failed: CUDA "
                           f"error {err} "
                           f"({lib.spath_error_string(err).decode()})")
    light_cdf_call.launches += 1
    return cdf, prob


light_cdf_call.launches = 0
