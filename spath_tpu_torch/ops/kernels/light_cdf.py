"""The light choice's distribution, built where the scene lives.

``light_cdf_call(emission, area)`` returns ``(cdf (T,), prob (T,))``: prob
∝ luminance·area and its cumulative sum, the detached columns of the
quality table (``megakernel_quality.quality_table``) that K3, K4 and the
wavefront's light sampling walk. An all-dark scene gets a uniform cdf and
a prob of zeros (callers mask by ``prob > 0``).

The choice is discrete, so a last-bit difference in the cdf picks another
light. Both versions compute in the JAX package's order on the CPU, which
is XLA's:

- the luminance ``(r + g) + b``, times the area;
- the total as XLA's CPU reduction sums (``_total``): its tree-reduction
  rewriter turns a sum of more than 32 terms into windows of 32, each
  summed in order from 0 (``reduce-window``, ``window={size=32 stride=32
  pad=lo_hi}`` in the HLO of ``jax.jit(jnp.sum).lower(x).compile()``, the
  padding split with its smaller half in front), level by level, and sums
  the last at most 32 in order from 0;
- the cumulative sum as XLA's CPU scan does it (``_scan``: sequential
  within blocks of 16, the block totals scanned the same way, then added).

On CUDA tensors the wrapper launches ``csrc/light_cdf.cu`` on PyTorch's
current stream, without synchronisation, and counts the call in
``light_cdf_call.launches``: one launch of one block up to
``SHARED_TRIS`` triangles, above that three launches with the levels in a
scratch buffer, up to ``MAX_TRIS``. A CUDA scene's table never goes
through the host. CPU tensors take ``light_cdf_plain``, which sums in
numpy: PyTorch's CPU float32 ``sum`` and ``cumsum`` do not sum in XLA's
order (``cumsum`` accumulates in float64).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from spath_tpu_torch.ops.kernels.build import library

#: Largest table the kernel takes in one block, its levels in shared
#: memory, and the largest it takes (the streamed kernels' cap, 2^20).
#: Above SHARED_TRIS the grid's three launches are faster: on an H100 (700
#: W) one block took 11.2 µs at 8,192 triangles and 13.0 at 10,240, the
#: grid 11.8 at both (``chip_smoke.py::light_crossover``). The one-block
#: route's shared memory stays under 48 KB up to CTA_MAX_TRIS.
SHARED_TRIS, MAX_TRIS = 8192, 1 << 20
#: The one-block route's largest table, and the grid route's smallest.
CTA_MAX_TRIS, GRID_MIN_TRIS = 10240, 4097


def _total(w: np.ndarray) -> np.float32:
    """The float32 sum of ``w`` in XLA's CPU order: windows of 32 with
    zero padding (``pad // 2`` in front), each summed in order from 0,
    until at most 32 values remain, which are summed in order from 0."""
    x = np.asarray(w, np.float32)
    while x.shape[0] > 32:
        n = x.shape[0]
        nw = -(-n // 32)
        lo = (nw * 32 - n) // 2
        win = np.zeros(nw * 32, np.float32)
        win[lo:lo + n] = x
        win = win.reshape(nw, 32)
        x = np.zeros(nw, np.float32)
        for j in range(32):
            x = x + win[:, j]
    s = np.float32(0)
    for v in x:
        s = np.float32(s + v)
    return s


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
    total = _total(w)
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
    (``T <= MAX_TRIS``; one block up to ``SHARED_TRIS``, the grid above; a
    failed build or launch raises); CPU tensors take ``light_cdf_plain``."""
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
    return launch(emission, area, grid=t > SHARED_TRIS)


def launch(emission: torch.Tensor, area: torch.Tensor, grid: bool):
    """One call of the kernel on checked CUDA inputs, on the route given:
    the grid's three launches (``GRID_MIN_TRIS <= T <= MAX_TRIS``) or one
    block (``T <= CTA_MAX_TRIS``). ``light_cdf_call`` routes by
    ``SHARED_TRIS``; ``chip_smoke.py`` times both routes to place it.
    Counts the call in ``light_cdf_call.launches``."""
    t = emission.shape[0]
    if not (GRID_MIN_TRIS <= t <= MAX_TRIS if grid else t <= CTA_MAX_TRIS):
        raise ValueError(f"T={t} outside the light-distribution kernel's "
                         f"{'grid' if grid else 'one-block'} route")
    emission, area = emission.contiguous(), area.contiguous()
    cdf = torch.empty(t, dtype=torch.float32, device=emission.device)
    prob = torch.empty_like(cdf)
    lib = library()
    floats = lib.spath_light_cdf_scratch(t, int(grid))
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
            t, int(grid), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"light-distribution kernel launch failed: CUDA "
                           f"error {err} "
                           f"({lib.spath_error_string(err).decode()})")
    light_cdf_call.launches += 1
    return cdf, prob


def kernel_launches() -> int:
    """CUDA kernels the library's light-distribution entry point has
    launched in this process: one a one-block call, three a grid call."""
    return int(library().spath_light_cdf_kernel_launches())


light_cdf_call.launches = 0
