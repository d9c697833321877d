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
