"""The standalone nearest hit K5 (``spath_tpu_torch/ops/kernels/intersect.py``)
on the CPU: its plain version against the JAX package's Pallas kernel
``nearest_hit_pallas`` in interpret mode, its wrapper's routing, counting
and input checks, and the sweep's device dispatch (``ops/intersect.py``).
K5 itself runs on the card (``chip_smoke.py``), where it is held bit for
bit to the plain version on camera, bounce and edge-shaped rays.
"""

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from spath_tpu.ops.pallas.intersect_pallas import (  # noqa: E402
    nearest_hit_pallas,
)
from spath_tpu_torch.ops import intersect  # noqa: E402
from spath_tpu_torch.ops.kernels import intersect as k5  # noqa: E402

CPU = torch.device("cpu")


def _rays_and_scene(n_rays=64, n_tris=40, seed=0):
    """tests/test_intersect.py's random rays and triangles, with sources."""
    rng = np.random.Generator(np.random.Philox(seed))
    o = rng.uniform(-2, 2, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    verts = rng.uniform(-2, 2, (n_tris, 3, 3)).astype(np.float32)
    src = rng.integers(-1, n_tris, size=n_rays).astype(np.int32)
    return o, d, verts, src


@pytest.fixture(scope="module")
def pallas_case():
    """JAX's K5 in interpret mode, forward and VJP, at 64 rays x 40
    triangles, computed once."""
    o, d, verts, src = _rays_and_scene()
    args = [jnp.asarray(o), jnp.asarray(d), *(jnp.asarray(verts[:, k])
                                              for k in range(3))]
    cot = np.random.default_rng(1).uniform(0.5, 1.5, o.shape[0]).astype(
        np.float32)
    with pltpu.force_tpu_interpret_mode():
        (dist, idx), vjp = jax.vjp(
            lambda *a: nearest_hit_pallas(*a, jnp.asarray(src)), *args)
        grads = vjp((jnp.asarray(cot), np.zeros(o.shape[0],
                                                jax.dtypes.float0)))
    return dict(o=o, d=d, verts=verts, src=src, cot=cot,
                dist=np.asarray(dist), idx=np.asarray(idx),
                grads=[np.asarray(g) for g in grads])


def _port(case):
    o, d = torch.from_numpy(case["o"]), torch.from_numpy(case["d"])
    v = torch.from_numpy(case["verts"])
    src = torch.from_numpy(case["src"].astype(np.int64))
    return o, d, v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0], src


def test_plain_version_matches_pallas_kernel(pallas_case):
    """Indices exact; distances within rtol=1e-5 (tests/test_intersect.py)
    above the absolute floor 1e-6 that tests/test_pallas.py pins for the
    Pallas kernel's Plücker distances near zero (one hit here lies at
    0.002, where its distance differs by 4.9e-7)."""
    o, d, v0, e1, e2, src = _port(pallas_case)
    dist, idx = k5.nearest_hit_plain(o, d, k5.pack_triangles(v0, e1, e2),
                                     src)
    np.testing.assert_array_equal(idx.numpy(), pallas_case["idx"])
    hit = pallas_case["idx"] >= 0
    assert 10 <= hit.sum() < hit.size, hit.sum()     # not vacuous
    np.testing.assert_allclose(dist.numpy()[hit], pallas_case["dist"][hit],
                               rtol=1e-5, atol=1e-6)
    assert (dist.numpy()[~hit] == intersect.BIG).all()


def test_source_exclusion_matches_pallas_kernel(pallas_case):
    """Each ray's source triangle is never its hit: with every ray's
    source set to the triangle it hits without one, both packages exclude
    it and agree on the next one."""
    o, d, v0, e1, e2, src = _port(pallas_case)
    tri = k5.pack_triangles(v0, e1, e2)
    _, idx = k5.nearest_hit_plain(o, d, tri, src)
    assert not ((idx == src) & (src >= 0)).any()
    _, first = k5.nearest_hit_plain(o, d, tri, torch.full_like(src, -1))
    assert (first >= 0).sum() >= 10
    _, idx2 = k5.nearest_hit_plain(o, d, tri, first)
    assert not ((idx2 == first) & (first >= 0)).any()
    args = [jnp.asarray(pallas_case[k]) for k in ("o", "d")] + [
        jnp.asarray(pallas_case["verts"][:, k]) for k in range(3)]
    with pltpu.force_tpu_interpret_mode():
        _, j2 = nearest_hit_pallas(*args, jnp.asarray(first.numpy(),
                                                      jnp.int32))
    np.testing.assert_array_equal(idx2.numpy(), np.asarray(j2))


def test_backward_matches_pallas_vjp(pallas_case):
    """The O(N) backward of the selected triangle's distance
    (``_NearestHit``), against the Pallas kernel's custom VJP on the same
    cotangent: each group within 1e-5 of its max (misses give zero in
    both)."""
    o, d, _, _, _, src = _port(pallas_case)
    verts = torch.from_numpy(pallas_case["verts"]).requires_grad_()
    o, d = o.requires_grad_(), d.requires_grad_()
    dist, _ = intersect.nearest_hit(o, d, verts[:, 0], verts[:, 1],
                                    verts[:, 2], src)
    cot = torch.from_numpy(pallas_case["cot"])
    got = torch.autograd.grad((dist * cot).sum(), [o, d, verts])
    want = pallas_case["grads"]
    got = [got[0], got[1], *(got[2][:, k] for k in range(3))]
    for g, w in zip(got, want):
        scale = np.abs(w).max()
        assert scale > 0.0
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * scale, rtol=0)


def test_call_on_cpu_takes_plain_without_counting():
    o, d, verts, src = _rays_and_scene(n_rays=32, n_tris=9, seed=4)
    v = torch.from_numpy(verts)
    tri = k5.pack_triangles(v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    args = (torch.from_numpy(o), torch.from_numpy(d), tri,
            torch.from_numpy(src.astype(np.int64)))
    before = k5.nearest_hit_call.launches
    got = k5.nearest_hit_call(*args)
    assert k5.nearest_hit_call.launches == before
    want = k5.nearest_hit_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1].dtype == torch.int64


@pytest.mark.parametrize("bad", ["rays", "src", "tri", "empty", "strided"])
def test_call_checks_inputs(bad):
    o, d, verts, src = _rays_and_scene(n_rays=8, n_tris=3, seed=5)
    v = torch.from_numpy(verts)
    args = [torch.from_numpy(o), torch.from_numpy(d),
            k5.pack_triangles(v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]),
            torch.from_numpy(src.astype(np.int64))]
    if bad == "rays":
        args[0] = args[0].double()
    elif bad == "src":
        args[3] = args[3].int()
    elif bad == "tri":
        args[2] = args[2][:, :6].contiguous()
    elif bad == "empty":
        args[2] = args[2][:0]
    else:
        args[1] = torch.from_numpy(np.repeat(d, 2, axis=0))[::2]
    with pytest.raises(ValueError):
        k5.nearest_hit_call(*args)


def test_sweep_dispatch_by_device(monkeypatch):
    """CPU tensors take the plain sweep; a CUDA tensor takes K5 (the
    wrapper recorded here), for every intersect method, unless inside
    ``plain_sweep()``."""
    o, d, verts, src = _rays_and_scene(n_rays=16, n_tris=5, seed=6)
    v = torch.from_numpy(verts)
    v0, e1, e2 = v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    calls = []
    plain = intersect._sweep

    def kernel(o_, d_, tri, src_):
        calls.append(("K5", tuple(tri.shape)))
        return plain(torch.Tensor(o_), d_, tri[:, 0:3], tri[:, 3:6],
                     tri[:, 6:9], src_, 512)

    def recorded_plain(o_, *rest):
        calls.append("plain")
        return plain(torch.Tensor(o_), *rest)

    monkeypatch.setattr(k5, "nearest_hit_call", kernel)
    monkeypatch.setattr(intersect, "_sweep", recorded_plain)
    args = (torch.from_numpy(o), torch.from_numpy(d), v0, e1, e2,
            torch.from_numpy(src.astype(np.int64)), 512)
    want = intersect.sweep(*args)
    assert calls == ["plain"]

    class FakeCuda:
        type = "cuda"

    class Rays(torch.Tensor):
        @property
        def device(self):
            return FakeCuda()

    cuda_o = torch.from_numpy(o).as_subclass(Rays)
    got = intersect.sweep(cuda_o, *args[1:])
    assert calls == ["plain", ("K5", (5, 9))]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with intersect.plain_sweep():
        intersect.sweep(cuda_o, *args[1:])
    assert calls == ["plain", ("K5", (5, 9)), "plain"]


# ---- K5's grid: ray tiles times ranges of row blocks, merged in order ----


@pytest.mark.parametrize("n, n_tris, tile, per_sm, sms", [
    (262_144, 10_000, 256, 8, 132), (4096, 1 << 20, 256, 8, 132),
    (230_400, 65_536, 256, 8, 132), (1920 * 1080, 7, 256, 8, 132),
    (1, 1, 256, 1, 1), (300, 700, 128, 5, 7), (129, 513, 128, 2, 3)])
def test_sweep_plan_covers_every_row_once_in_order(n, n_tris, tile, per_sm,
                                                    sms):
    """The plan's splits cut the rows into ranges of whole blocks (the
    last one ragged), in increasing order, that cover each row once."""
    tiles, splits = k5.sweep_plan(n, n_tris, tile, per_sm, sms)
    blocks = -(-n_tris // k5.TILE_ROWS)
    assert tiles == -(-n // tile)
    assert 1 <= splits <= min(blocks, k5.MAX_SPLITS)
    ranges = k5.split_rows(n_tris, splits)
    assert len(ranges) == splits
    rows = [r for start, stop in ranges for r in range(start, stop)]
    assert rows == list(range(n_tris))
    for start, stop in ranges:
        assert start < stop and start % k5.TILE_ROWS == 0
        assert stop % k5.TILE_ROWS == 0 or stop == n_tris


def test_sweep_plan_fills_whole_waves():
    """The fewest splits whose CTAs make WAVES waves of the resident
    CTAs, unless the row blocks or MAX_SPLITS cap them: on 132 SMs of 9
    CTAs (K5 on an H100) a residual slice, the last slice of a 1080p
    frame and the microbenchmark's 900 tiles split 28, 31 and 32 ways,
    64x64 rays against 2^20 triangles MAX_SPLITS ways, and a 1080p frame
    of 7 triangles (one block) keeps one range."""
    for per_sm in (8, 9):
        slots = k5.WAVES * per_sm * 132
        for n, n_tris in ((262_144, 10_000), (238_592, 10_000),
                          (230_400, 65_536), (4096, 1 << 20),
                          (1920 * 1080, 7), (1, 10_000), (1, 7)):
            tiles, splits = k5.sweep_plan(n, n_tris, 256, per_sm, 132)
            blocks = -(-n_tris // k5.TILE_ROWS)
            assert tiles == -(-n // 256)
            assert (tiles * splits >= slots
                    or splits == min(blocks, k5.MAX_SPLITS))
            assert splits == 1 or tiles * (splits - 1) < slots
    for (n, n_tris), plan in (((262_144, 10_000), (1024, 28)),
                              ((238_592, 10_000), (932, 31)),
                              ((230_400, 65_536), (900, 32)),
                              ((4096, 1 << 20), (16, k5.MAX_SPLITS)),
                              ((1920 * 1080, 7), (8100, 1))):
        assert k5.sweep_plan(n, n_tris, 256, 9, 132) == plan
    with pytest.raises(ValueError):
        k5.split_rows(300, 3)
    with pytest.raises(ValueError):
        k5.sweep_plan(0, 10, 256, 8, 132)


def test_merge_takes_the_earlier_split_on_a_tie():
    """The merge's plain model: the nearest partial, the earliest split
    on equal distances, a miss (BIG, -1) never over a hit."""
    big = intersect.BIG
    part_dist = torch.tensor([[2.0, big, 1.0, big],
                              [2.0, 3.0, 0.5, big],
                              [1.0, 3.0, 0.5, big]])
    part_idx = torch.tensor([[4, -1, 9, -1],
                             [300, 301, 302, -1],
                             [600, 601, 602, -1]], dtype=torch.int32)
    dist, idx = k5.merge_hits_plain(part_dist, part_idx)
    assert dist.tolist() == [1.0, 3.0, 0.5, big]
    assert idx.tolist() == [600, 301, 302, -1] and idx.dtype == torch.int64


def _tie_scene(n_rays=64, n_tris=600, seed=7):
    """One large triangle at rows 10, 300 and 550 (three blocks of 256
    rows, so three splits), in front of and behind small ones; rays toward
    it, some bent, each excluding one copy (or none) in turn: the copies
    tie to the bit, so the lowest index not excluded must win."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform([-2, -2, -3], [2, 2, 3], (n_tris, 1, 3))
    verts = (centres + rng.uniform(-0.3, 0.3, (n_tris, 3, 3))).astype(
        np.float32)
    for t in (10, 300, 550):
        verts[t] = [[-3, -3, 0], [3, -3, 0], [0, 3, 0]]
    o = np.concatenate([rng.uniform(-1, 1, (n_rays, 2)),
                        np.full((n_rays, 1), -5.0)], 1).astype(np.float32)
    d = np.tile(np.array([0, 0, 1], np.float32), (n_rays, 1))
    d[:n_rays // 2] += rng.normal(scale=0.3, size=(n_rays // 2, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    src = np.array([(-1, 10, 300, 550)[i % 4] for i in range(n_rays)],
                   np.int32)
    return o, d, verts, src


@pytest.fixture(scope="module")
def tie_case():
    """``_tie_scene`` through JAX's K5 in interpret mode, computed once."""
    o, d, verts, src = _tie_scene()
    with pltpu.force_tpu_interpret_mode():
        dist, idx = nearest_hit_pallas(
            jnp.asarray(o), jnp.asarray(d),
            *(jnp.asarray(verts[:, k]) for k in range(3)), jnp.asarray(src))
    return dict(o=o, d=d, verts=verts, src=src, dist=np.asarray(dist),
                idx=np.asarray(idx))


@pytest.mark.parametrize("splits", [1, 2, 3])
def test_split_sweep_matches_plain_and_pallas_on_ties(tie_case, splits):
    """The split sweep's plain model (each range swept alone, the partials
    merged in range order) equals the plain sweep to the bit and picks
    the Pallas kernel's triangle on every ray, where three copies of a
    triangle in three splits tie exactly and the source copy is
    excluded."""
    v = torch.from_numpy(tie_case["verts"])
    args = (torch.from_numpy(tie_case["o"]), torch.from_numpy(tie_case["d"]),
            k5.pack_triangles(v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]),
            torch.from_numpy(tie_case["src"].astype(np.int64)))
    want = k5.nearest_hit_plain(*args)
    got = k5.split_hits_plain(*args, splits)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    np.testing.assert_array_equal(got[1].numpy(), tie_case["idx"])
    idx, src = got[1].numpy(), tie_case["src"]
    # every copy is the hit of some ray, and the lowest one not excluded
    for excluded, expected in ((-1, 10), (10, 300), (300, 10), (550, 10)):
        on_big = (src == excluded) & np.isin(idx, (10, 300, 550))
        assert on_big.sum() >= 3 and (idx[on_big] == expected).all()
    assert ((idx >= 0) & ~np.isin(idx, (10, 300, 550))).any()


# ---- K5's cull before the division: it never rejects an accepted pair ----


def _pair_tests(o, d, v0, e1, e2):
    """``(a, sh, accepted)`` of ray k against triangle k, for each k, with
    the arithmetic of ``ops/intersect.py::_mt_block`` (the source test
    and the nearest-so-far test aside)."""
    hx = d[:, 1] * e2[:, 2] - d[:, 2] * e2[:, 1]
    hy = d[:, 2] * e2[:, 0] - d[:, 0] * e2[:, 2]
    hz = d[:, 0] * e2[:, 1] - d[:, 1] * e2[:, 0]
    a = e1[:, 0] * hx + e1[:, 1] * hy + e1[:, 2] * hz
    nondeg = torch.abs(a) >= intersect.EPS
    f = 1.0 / torch.where(nondeg, a, torch.ones_like(a))
    sx, sy, sz = (o[:, k] - v0[:, k] for k in range(3))
    sh = sx * hx + sy * hy + sz * hz
    u = f * sh
    qx = sy * e1[:, 2] - sz * e1[:, 1]
    qy = sz * e1[:, 0] - sx * e1[:, 2]
    qz = sx * e1[:, 1] - sy * e1[:, 0]
    v = f * (d[:, 0] * qx + d[:, 1] * qy + d[:, 2] * qz)
    dist = f * (e2[:, 0] * qx + e2[:, 1] * qy + e2[:, 2] * qz)
    accepted = (nondeg & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
                & (u + v <= 1.0) & (dist > intersect.EPS)
                & (dist < intersect.INV_EPS))
    return a, sh, accepted


def _cull_pairs(n, seed):
    """Random pairs, and rays aimed at their triangle: inside it, on its
    edges and vertices, just outside them, from near and far, and nearly
    parallel to its plane; triangles from 1e-3 to 1e3 across."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    scale = 10.0 ** rng.uniform(-3, 3, (n, 1))
    v0 = rng.uniform(-4, 4, (n, 3)) * scale
    e1 = rng.uniform(-1, 1, (n, 3)) * scale
    e2 = rng.uniform(-1, 1, (n, 3)) * scale
    d = rng.normal(size=(n, 3))
    aimed = rng.random(n) < 0.75
    # barycentric targets: inside, on an edge or vertex, a hair outside
    b = rng.random((n, 2))
    b = np.where(b.sum(1, keepdims=True) > 1, 1 - b, b)
    kind = rng.integers(0, 6, n)
    b[kind == 1, 0] = 0
    b[kind == 2, 1] = 0
    b[kind == 3, 1] = 1 - b[kind == 3, 0]
    b[kind == 4] = np.eye(3, 2)[rng.integers(0, 3, (kind == 4).sum())]
    b[kind == 5] += rng.choice([-1, 1], ((kind == 5).sum(), 2)) * 1e-7
    # a sixth of the aimed rays nearly in the triangle's plane
    flat = aimed & (rng.random(n) < 1 / 6)
    normal = np.cross(e1, e2)
    in_plane = e1 * rng.normal(size=(n, 1)) + e2 * rng.normal(size=(n, 1))
    tilt = 10.0 ** rng.uniform(-9, -2, (n, 1))
    d[flat] = (in_plane / np.linalg.norm(in_plane, axis=1, keepdims=True)
               + tilt * normal / np.linalg.norm(normal, axis=1,
                                                keepdims=True))[flat]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    target = v0 + b[:, :1] * e1 + b[:, 1:] * e2
    far = 10.0 ** rng.uniform(-3, 3, (n, 1)) * scale
    o = np.where(aimed[:, None], target - far * d,
                 rng.uniform(-4, 4, (n, 3)) * scale)
    return tuple(torch.from_numpy(x.astype(f32)) for x in (o, d, v0, e1, e2))


def test_cull_never_rejects_an_accepted_pair():
    """Over 1.5 million pairs (half of them accepted by the test), the
    cull's plain model passes every pair the Möller–Trumbore arithmetic
    accepts, and rejects most of the rest."""
    rejected_wrongly = accepted_all = culled = total = 0
    for seed in range(3):
        a, sh, accepted = _pair_tests(*_cull_pairs(500_000, seed))
        may = k5.may_pass_plain(a, sh)
        rejected_wrongly += int((accepted & ~may).sum())
        accepted_all += int(accepted.sum())
        culled += int((~may).sum())
        total += a.numel()
    assert rejected_wrongly == 0
    assert accepted_all > 0.4 * total
    assert culled > 0.5 * (total - accepted_all)


def test_cull_edge_cases():
    """The cull at its bounds: a degenerate or NaN ``a`` is rejected;
    a NaN or zero ``sh`` and an infinite ``a`` pass; u = 1 exactly, and a
    hair above where rounding could still give 1, pass; u clearly below 0
    or above 1 is rejected; a negative u so small that ``f * sh`` could
    round to -0 (which passes ``u >= 0``) passes."""
    big = float(np.float32(3e38))
    cases = [  # (a, sh, may pass)
        (0.0, 0.5, False), (1e-15, 1e-15, False), (float("nan"), 0.5, False),
        (1.0, float("nan"), True), (float("inf"), 1.0, True),
        (-float("inf"), 1.0, True), (1.0, 0.0, True), (1.0, -0.0, True),
        (-1.0, 0.0, True), (1.0, 1.0, True), (-1.0, -1.0, True),
        (1.0, 1.0 + 2.0 ** -23, True), (-1.0, -(1.0 + 2.0 ** -22), True),
        (1.0, 1.0 + 2.0 ** -20, False), (-1.0, -(1.0 + 2.0 ** -20), False),
        (1.0, 2.0, False), (1.0, -1.0, False), (-2.0, 1.0, False),
        (1.0, -1e-38, True), (1.0, -1e-29, False), (1e10, -1e-44, True),
        (1e-14, -1e-44, False),
        (big, big, True), (big, -big, False), (1e-14, 2e-14, False),
    ]
    a = torch.tensor([c[0] for c in cases], dtype=torch.float32)
    sh = torch.tensor([c[1] for c in cases], dtype=torch.float32)
    assert k5.may_pass_plain(a, sh).tolist() == [c[2] for c in cases]


def test_sass_loop_counts_a_pair_on_each_path():
    """``tools/sass_loop.py`` on a listing of one culled test: the full
    path runs the reciprocal's fast path (its slow path's MOV, CALL and
    BRA do not run), the culled path branches past the rest of the
    test."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / "sass_loop.py"
    spec = importlib.util.spec_from_file_location("sass_loop", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    body = ["LDS.128 R4, [R0]", "FMUL R5, R4, R4", "VOTE.ANY P0, P0",
            "@!P0 BRA 0xa0", "@P1 BRA 0x90", "MOV R2, 0x80",
            "CALL.REL.NOINC 0x200", "BRA 0xa0", "MUFU.RCP R3, R3",
            "@!P2 BRA 0x10"]
    listing = "\t\tFunction : _ZN4spath11nearest_hitEPKf\n" + "".join(
        f"        /*{16 * k:04x}*/  {text} ;  /* 0x0 */\n"
        for k, text in enumerate(["MOV R1, R2", *body, "EXIT"]))
    code = tool.functions(listing)["_ZN4spath11nearest_hitEPKf"]
    assert len(code) == 12
    assert tool.loops(code) == [dict(start="0x10", end="0xa0",
                                     instructions=10, pairs=1, per_pair=7.0,
                                     culled_per_pair=5.0)]
    plain = [(a, t) for a, t in code if "VOTE" not in t]
    assert tool.loops(plain)[0]["pairs"] == 1
    assert "culled_per_pair" not in tool.loops(plain)[0]
