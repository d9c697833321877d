"""The matmul-only intersection sweep (T1): the blocked Plücker product of
rays against triangles with its epilogue replaced by a bare min.

The port of ``tools/sweep_microbench.py``'s two Pallas kernels,
``_mm_only_kernel`` (K = 128) and ``_mm_sub64_kernel`` (K = 64), and of
the operand packing they read from
``spath_tpu/ops/pallas/intersect_pallas.py`` (``_ray_rows``, ``_split3``,
``pack_lhs`` in exact mode, ``pack_rhs``, ``_tri_features``,
``pack_tri_blocks``). With ``G`` the ``(4·T, K)`` bf16 triangle table and
``R`` the ``(K, N)`` bf16 ray table it computes, for every ray ``n``::

    out[n] = sum over blocks b of  min over rows r of b  sum_k G[r, k]·R[k, n]

a block being ``BLOCK_ROWS`` = 1,024 rows of ``G`` (the a, u·a, v·a and
d·a rows of ``TILE_T`` = 256 triangles), the block minima added in
float32 in block order. The bf16 products are exact; the sum over ``k``
is float32. It is a measurement, not a render path: it separates the
matrix unit's time from the epilogue's (``spath_tpu_torch/tools/
sweep_microbench.py`` times it beside the nearest hit K5).

The kernel is ``csrc/sweep_mm.cu`` (bf16 tensor cores: warpgroup
``wgmma`` fed by TMA through a ring of ``mbarrier`` stages), one template
over K in {64, 128}; ``launch_plan`` gives its launch in Python. The
K = 64 operands keep the 60 live columns (6 split-term groups of the 10
Plücker features) padded to 64 (``pack_k64``), in the K = 128 variant's
orientation: the JAX K = 64
variant contracts over the sublanes of K-major operands, a Mosaic layout
with no Hopper counterpart, and the function is the same.

Layouts, as the wrapper checks them (all contiguous, one device):

- ``gfeat``: bf16 ``(4·T, K)``, ``T`` a positive multiple of ``TILE_T``;
- ``rfeat``: bf16 ``(K, N)``, ``N >= 1``;
- output: float32 ``(N,)``.

Every block is summed (the JAX grid drops a tail beyond a multiple of
1,024 triangles; its tool never has one). ``sweep_mm_call`` launches the
kernel for CUDA tensors and counts each launch in
``sweep_mm_call.launches``; for CPU tensors it computes the same
function with ``sweep_mm_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from spath_tpu_torch.ops.fp import fma_rn
from spath_tpu_torch.ops.kernels.build import library

#: Triangles of a block, and the rows of ``G`` they take (a, u, v, d).
TILE_T = 256
BLOCK_ROWS = 4 * TILE_T
#: A Plücker feature slot: 10 features padded to 16; 8 slots in K = 128
#: (6 split-term groups and 2 of zeros).
FEAT, KP = 16, 128
#: Columns that carry a product: 6 split-term groups of 10 features.
LIVE_TERMS = 60
#: The contraction depths the kernel takes.
DEPTHS = (64, 128)
#: Peak rates of an H100 SXM (NVIDIA's data sheet): dense bf16 tensor-core
#: FLOP/s, float32 outside the tensor cores, device memory bytes/s.
PEAK_BF16, PEAK_FP32, PEAK_BYTES = 989e12, 67e12, 3.35e12
#: The agreement bound of the kernel (and of JAX's kernels) with the
#: float64 plain version, relative to ``sweep_mm_scale + |plain|``: the
#: products are exact, only the order of the float32 sums differs.
BOUND_REL = 2.0 ** -16
#: The share of that bound the kernel is held to besides. ``BOUND_REL``
#: is the worst case, every float32 rounding of one sign; roundings of
#: independent sign grow with the square root of their count, so the 256
#: block additions of the tool's shape leave ~16 ulps, not 256. A product
#: that drops the split's lo-term groups (``drop_lo``, a two-way 16-bit
#: split, 2^-16 of each product) lands above this share, the exact split
#: summed in float32 below it.
TIGHT_SHARE = 2.0 ** -4
#: Bytes of a float64 product block the plain version holds at once.
PLAIN_CHUNK_BYTES = 8 << 30
#: The kernel's launch (``csrc/sweep_mm.cu``, whose constants these
#: mirror): four consumer warpgroups of ``WG_RAYS`` rays (wgmma's N) and a
#: producer warpgroup; stages of ``TILE_ROWS`` rows of G (wgmma's M) in
#: 128-byte swizzle atoms of ``ATOM_K`` columns; ``STAGES`` a depth.
CONSUMERS, WG_RAYS, TILE_ROWS, ATOM_K = 4, 112, 64, 64
CTA_RAYS = CONSUMERS * WG_RAYS
THREADS = 128 * (1 + CONSUMERS)
STAGES = {64: 8, 128: 6}
#: The 1024-byte alignment of the swizzle atoms, taken out of the dynamic
#: shared memory; the most shared memory a block may have on an H100
#: (227 KB); the SMs of an H100 SXM, where the caller gives no count.
SMEM_ALIGN, SMEM_LIMIT, H100_SMS = 1024, 232_448, 132


def cross3_fma(a, b):
    """``a × b`` over the last axis as ``jnp.cross`` runs in the JAX
    package's CPU programs: each component ``x·y - z·w`` with the first
    product fused, ``fma(x, y, -(z·w))``, so the operands match JAX's to
    the bit."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([fma_rn(a1, b2, -(a2 * b1)),
                        fma_rn(a2, b0, -(a0 * b2)),
                        fma_rn(a0, b1, -(a1 * b0))], dim=-1)


def _ray_rows(o, d):
    """``(16, N)`` per-ray feature rows [dir, pos×dir, pos, 1, 0...]."""
    n = o.shape[0]
    ones = torch.ones((1, n), dtype=torch.float32, device=o.device)
    zeros = torch.zeros((FEAT - 10, n), dtype=torch.float32, device=o.device)
    return torch.cat([d.T, cross3_fma(o, d).T, o.T, ones, zeros], dim=0)


def _split3(x):
    """Exact 3-way bf16 split: ``x == hi + mid + lo`` in float32, each
    part rounded to nearest even (each residual is exact, Sterbenz)."""
    hi = x.to(torch.bfloat16)
    r1 = x - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def pack_lhs(x, axis: int = 1):
    """Ray-side features packed for the fp32-exact single bf16 pass:
    groups [xh, xh, xm, xh, xm, xl, 0, 0] along ``axis`` (the exact mode
    of ``intersect_pallas.pack_lhs``), against ``pack_rhs``'s [wh, wm,
    wh, wl, wm, wh]: the products hh + hm + mh + hl + mm + lh."""
    h, m, lo = _split3(x)
    z = torch.zeros_like(h)
    return torch.cat([h, h, m, h, m, lo, z, z], dim=axis)


def pack_rhs(w, axis: int = 0):
    """Triangle-side features: groups [wh, wm, wh, wl, wm, wh, 0, 0]."""
    h, m, lo = _split3(w)
    z = torch.zeros_like(h)
    return torch.cat([h, m, h, lo, m, h, z, z], dim=axis)


def _tri_features(v0, v1, v2):
    """Four ``(16, T)`` matrices giving a, u_num, v_num, d_num per
    triangle against ``_ray_rows``."""
    e1 = v1 - v0
    e2 = v2 - v0
    nrm = cross3_fma(e1, e2)
    c0 = cross3_fma(e2, v0)
    c1 = cross3_fma(v0, e1)
    k = (v0 * nrm).sum(dim=-1)
    t = v0.shape[0]
    z3 = torch.zeros_like(v0)
    zc = torch.zeros((t, 1), dtype=torch.float32, device=v0.device)
    zpad = torch.zeros((t, FEAT - 10), dtype=torch.float32, device=v0.device)

    def col(dir_part, m_part, pos_part, const_part):
        return torch.cat([dir_part, m_part, pos_part, const_part, zpad],
                         dim=1).T

    return (col(-nrm, z3, z3, zc), col(-c0, e2, z3, zc),
            col(-c1, -e1, z3, zc), col(z3, z3, nrm, -k[:, None]))


def pack_tri_blocks(v0, v1, v2, tile_t: int = TILE_T):
    """The ``(4·T, 128)`` bf16 triangle table (``T`` a multiple of
    ``tile_t``): block ``j`` is rows ``[4·tile_t·j, 4·tile_t·(j+1))``, the
    a, u_num, v_num and d_num rows of its ``tile_t`` triangles; the
    columns are ``pack_rhs``'s groups."""
    tp = v0.shape[0]
    quads = torch.stack(_tri_features(v0, v1, v2))        # (4, 16, T)
    packed = pack_rhs(quads, axis=1)                      # (4, 128, T)
    return (packed.reshape(4, KP, tp // tile_t, tile_t)
            .permute(2, 0, 3, 1).reshape(4 * tp, KP).contiguous())


def sweep_operands(origins, directions, v0, v1, v2):
    """``(gfeat (4·T, 128), rfeat (128, N))``: the K = 128 operands of
    ``N`` rays and ``T`` triangles, as ``tools/sweep_microbench.py`` packs
    them."""
    return (pack_tri_blocks(v0, v1, v2),
            pack_lhs(_ray_rows(origins, directions), axis=0).contiguous())


def pack_k64(gfeat, rfeat):
    """The K = 64 operands from the K = 128 ones: the 60 live columns
    (6 split-term groups × 10 features) padded with 4 zero columns, in the
    same orientation, ``(4·T, 64)`` and ``(64, N)``."""
    rows, n = gfeat.shape[0], rfeat.shape[1]
    g = gfeat.reshape(rows, 8, FEAT)[:, :6, :10].reshape(rows, LIVE_TERMS)
    r = rfeat.reshape(8, FEAT, n)[:6, :10, :].reshape(LIVE_TERMS, n)
    pad = 64 - LIVE_TERMS
    g = torch.cat([g, g.new_zeros((rows, pad))], dim=1)
    r = torch.cat([r, r.new_zeros((pad, n))], dim=0)
    return g.contiguous(), r.contiguous()


def drop_lo(gfeat, rfeat):
    """The control of the agreement check: the operands with the split's
    lo-term groups (``pack_lhs``/``pack_rhs`` groups 3 and 5, the hi·lo
    and lo·hi products) zeroed, a product good to 2^-16 where the exact
    split is good to float32."""
    k = gfeat.shape[1]
    width = FEAT if k == KP else 10
    g, r = gfeat.clone(), rfeat.clone()
    for grp in (3, 5):
        g[:, grp * width:(grp + 1) * width] = 0
        r[grp * width:(grp + 1) * width] = 0
    return g, r


def _blockwise(gfeat, rfeat, block_reduce):
    """Sum over blocks, in block order and in float64, of
    ``block_reduce(products (blocks, BLOCK_ROWS, N))`` → ``(blocks, N)``;
    the products are held ``PLAIN_CHUNK_BYTES`` at a time."""
    n = rfeat.shape[1]
    g = gfeat.double().reshape(-1, BLOCK_ROWS, gfeat.shape[1])
    r = rfeat.double()
    per = max(1, PLAIN_CHUNK_BYTES // (BLOCK_ROWS * n * 8))
    total = torch.zeros(n, dtype=torch.float64, device=gfeat.device)
    for b0 in range(0, g.shape[0], per):
        for part in block_reduce(g[b0:b0 + per], r):
            total += part
    return total


def sweep_mm_plain(gfeat, rfeat):
    """The plain PyTorch version: every block's product in float64 from
    the bf16 values, its minimum over the block's rows, the minima summed
    in block order; float32 ``(N,)``."""
    return _blockwise(gfeat, rfeat,
                      lambda g, r: torch.matmul(g, r).amin(dim=1)).float()


def sweep_mm_scale(gfeat, rfeat):
    """float64 ``(N,)``: ``sum_b max_{r in b} sum_k |G[r,k]|·|R[k,n]|``,
    the scale of a float32 sum's rounding in each ray's output."""
    return _blockwise(gfeat, rfeat, lambda g, r: torch.matmul(
        g.abs(), r.abs()).amax(dim=1))


def error_ratio(out, ref, scale) -> float:
    """The largest ``|out - ref| / (BOUND_REL · (scale + |ref|))`` over
    the rays: at most 1 within the agreement bound."""
    ref = ref.double()
    err = (out.double() - ref).abs()
    return (err / (BOUND_REL * (scale + ref.abs()))).max().item()


def bound(n_rays: int, n_tris: int, k: int = 64) -> dict:
    """The least time an H100 SXM could take for the sweep of ``n_rays``
    × ``n_tris``, ms: the larger of the function's tensor-core FLOP (the
    ``LIVE_TERMS`` products a quad) over ``PEAK_BF16`` and the bytes of
    operands ``k`` columns deep (each read once) and the output over
    ``PEAK_BYTES``. Also ``ceiling_ms``, the FLOP at depth ``k`` over
    ``PEAK_BF16`` (the variant's own ceiling), and ``min_ms``, the minima
    (one operation a quad) over ``PEAK_FP32``."""
    pairs = n_rays * n_tris
    flop = 2 * 4 * pairs * LIVE_TERMS
    nbytes = 2 * k * (4 * n_tris + n_rays) + 4 * n_rays
    t_ops, t_bytes = flop / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(ms=max(t_ops, t_bytes),
                by="operations" if t_ops >= t_bytes else "bytes",
                flop=flop, bytes=nbytes,
                ceiling_ms=2 * 4 * pairs * k / PEAK_BF16 * 1e3,
                min_ms=4 * pairs / PEAK_FP32 * 1e3)


def launch_plan(k: int, n_rays: int, n_tris: int | None = None,
                sms: int = H100_SMS) -> dict:
    """The kernel's launch for ``n_rays`` rays at depth ``k``: rays a CTA
    and a consumer warpgroup, threads, CTAs, cluster size (1: no
    multicast), stages and their bytes, the dynamic shared bytes (the
    rays' K-major copy, the ring, the block-end exchange, the barriers,
    the alignment) and the waves of one CTA an SM on ``sms`` SMs; with
    ``n_tris``, the bytes of G that the CTAs read through L2, counted
    from the launch (each CTA reads all of G), not read on a card."""
    if k not in DEPTHS or n_rays < 1:
        raise ValueError(f"no launch for K={k}, {n_rays} rays")
    stages = STAGES[k]
    stage_bytes = TILE_ROWS * k * 2
    ray_bytes = CTA_RAYS * k * 2
    xch_bytes = CONSUMERS * 4 * WG_RAYS * 4
    bar_bytes = 2 * stages * 8
    smem = SMEM_ALIGN + ray_bytes + stages * stage_bytes + xch_bytes \
        + bar_bytes
    ctas = -(-n_rays // CTA_RAYS)
    out = dict(k=k, cta_rays=CTA_RAYS, wg_rays=WG_RAYS, threads=THREADS,
               ctas=ctas, cluster=1, stages=stages, stage_bytes=stage_bytes,
               ray_bytes=ray_bytes, xch_bytes=xch_bytes, bar_bytes=bar_bytes,
               smem_bytes=smem, waves=ctas / sms)
    if n_tris is not None:
        out["l2_bytes_of_g"] = ctas * 4 * n_tris * k * 2
    return out


def compiled_plan(k: int) -> dict:
    """The launch as ``csrc/sweep_mm.cu`` was compiled
    (``spath_sweep_mm_plan``): rays a CTA, threads, stages, dynamic
    shared bytes and rays a consumer warpgroup, for ``launch_plan`` to be
    held to. Builds the library; only where ``nvcc`` is."""
    buf = (ctypes.c_int * 5)()
    lib = library()
    err = lib.spath_sweep_mm_plan(k, ctypes.cast(buf, ctypes.c_void_p))
    if err != 0:
        raise ValueError(f"no compiled plan for K={k}")
    return dict(zip(("cta_rays", "threads", "stages", "smem_bytes",
                     "wg_rays"), buf))


def _check(gfeat, rfeat) -> None:
    if gfeat.dtype != torch.bfloat16 or rfeat.dtype != torch.bfloat16:
        raise ValueError(f"gfeat and rfeat must be bfloat16, got "
                         f"{gfeat.dtype} and {rfeat.dtype}")
    if gfeat.dim() != 2 or rfeat.dim() != 2:
        raise ValueError(f"gfeat (4T, K) and rfeat (K, N) must be 2-D, got "
                         f"{tuple(gfeat.shape)} and {tuple(rfeat.shape)}")
    k = gfeat.shape[1]
    if k not in DEPTHS or rfeat.shape[0] != k:
        raise ValueError(f"K must be one of {DEPTHS} in both operands, got "
                         f"{tuple(gfeat.shape)} and {tuple(rfeat.shape)}")
    rows, n = gfeat.shape[0], rfeat.shape[1]
    if rows < BLOCK_ROWS or rows % BLOCK_ROWS:
        raise ValueError(f"gfeat has {rows} rows: T must be a positive "
                         f"multiple of {TILE_T} ({BLOCK_ROWS} rows a block)")
    if n < 1:
        raise ValueError("rfeat has no ray")
    if rows * k >= 2**31 or k * n >= 2**31:
        raise ValueError(f"{rows} rows or {n} rays overflow the kernel's "
                         "int32 indexing")
    if gfeat.device != rfeat.device:
        raise ValueError("gfeat and rfeat must be on one device")
    if not (gfeat.is_contiguous() and rfeat.is_contiguous()):
        raise ValueError("gfeat and rfeat must be contiguous")


def sweep_mm_call(gfeat, rfeat):
    """float32 ``(N,)``: the sweep of the ``(K, N)`` rays against the
    ``(4·T, K)`` triangle table (layouts in the module docstring). Launches
    the K = 64 or K = 128 kernel on CUDA tensors, on PyTorch's current
    stream and without synchronising; a failed build, tensor-map encoding
    or launch raises.
    CPU tensors take ``sweep_mm_plain``."""
    _check(gfeat, rfeat)
    if gfeat.device.type == "cpu":
        return sweep_mm_plain(gfeat, rfeat)
    if gfeat.device.type != "cuda":
        raise ValueError(f"no sweep kernel for device {gfeat.device}")
    k, n, dev = gfeat.shape[1], rfeat.shape[1], gfeat.device
    out = torch.empty(n, dtype=torch.float32, device=dev)
    lib = library()
    entry = lib.spath_sweep_mm_k64 if k == 64 else lib.spath_sweep_mm_k128
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entry(*(ctypes.c_void_p(t.data_ptr())
                      for t in (gfeat, rfeat, out)),
                    n, gfeat.shape[0] // BLOCK_ROWS, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"sweep kernel (K={k}) launch failed: CUDA error "
                           f"{err} ({lib.spath_error_string(err).decode()})")
    sweep_mm_call.launches += 1
    return out


sweep_mm_call.launches = 0
