"""The port's LCG, angle sampler and nearest-hit sweep against the JAX
package, on the same numpy inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from spath_tpu.ops import rng as jrng  # noqa: E402
from spath_tpu.ops.intersect import nearest_hit as j_nearest_hit  # noqa: E402
from spath_tpu.ops.sampling import angle_sample as j_angle_sample  # noqa: E402
from spath_tpu.scene import default_scene as j_default_scene  # noqa: E402
from spath_tpu.scene import procedural_scene as j_procedural  # noqa: E402
from spath_tpu_torch.ops import rng  # noqa: E402
from spath_tpu_torch.ops.intersect import nearest_hit  # noqa: E402
from spath_tpu_torch.ops.sampling import angle_sample  # noqa: E402

CPU = torch.device("cpu")


def test_lcg_stream_bit_exact():
    gen = np.random.Generator(np.random.Philox(11))
    seeds = gen.integers(0, 2**32, size=257, dtype=np.uint64).astype(
        np.uint32)
    seeds[:3] = [0, 2**32 - 1, 2**31]
    js = jnp.asarray(seeds)
    ts = torch.from_numpy(seeds.astype(np.int64))
    for _ in range(10):
        js, ju = jrng.lcg_next(js)
        ts, tu = rng.lcg_next(ts)
        np.testing.assert_array_equal(ts.numpy().astype(np.uint32),
                                      np.asarray(js))
        assert ts.dtype == torch.int64 and int(ts.max()) < 2**32
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
        assert tu.dtype == torch.float32


@pytest.mark.parametrize("offset", [0, 12345, 2**32 - 5])
def test_pixel_seeds_match(offset):
    got = rng.pixel_seeds(64, offset, device=CPU).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32),
                                  np.asarray(jrng.pixel_seeds(64, offset)))
    assert got.max() < 2**32


def test_angle_sample_matches():
    gen = np.random.Generator(np.random.Philox(5))
    n = gen.normal(size=(512, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    u1, u2 = gen.uniform(size=(2, 512)).astype(np.float32)
    jd, jw = j_angle_sample(jnp.asarray(n), jnp.asarray(u1), jnp.asarray(u2))
    td, tw = angle_sample(torch.from_numpy(n), torch.from_numpy(u1),
                          torch.from_numpy(u2))
    # cos/sin from two libraries: equal to the last bit or two
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)
    assert ((td.numpy() * n).sum(-1) >= 0).all()


def _rays(scene_np_v, n, seed):
    """Rays from the box the scenes live in, with random source indices."""
    gen = np.random.Generator(np.random.Philox(seed))
    o = gen.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    o[:, 2] = gen.uniform(-3.0, 1.0, n).astype(np.float32)
    d = gen.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    src = gen.integers(-1, scene_np_v.shape[0], size=n).astype(np.int32)
    return o, d, src


@pytest.mark.parametrize("which,tri_block", [
    ("default", 512),
    ("procedural600", 256),
])
def test_nearest_hit_matches(which, tri_block):
    js = j_default_scene() if which == "default" else j_procedural(600,
                                                                   seed=1)
    verts = np.array(js.vertices)
    o, d, src = _rays(verts, 2048, seed=9)
    jd, ji = j_nearest_hit(jnp.asarray(o), jnp.asarray(d),
                           js.v0, js.v1, js.v2, jnp.asarray(src),
                           method="reference", tri_block=tri_block)
    tv = torch.from_numpy(verts)
    td, ti = nearest_hit(torch.from_numpy(o), torch.from_numpy(d),
                         tv[:, 0], tv[:, 1], tv[:, 2],
                         torch.from_numpy(src.astype(np.int64)),
                         tri_block=tri_block)
    ji, jd = np.asarray(ji), np.asarray(jd)
    np.testing.assert_array_equal(ti.numpy(), ji)
    hit = ji >= 0
    assert 50 <= hit.sum() < hit.size, hit.sum()      # not vacuous
    np.testing.assert_allclose(td.numpy()[hit], jd[hit], rtol=1e-6)


def test_nearest_hit_methods_and_source_exclusion():
    o = torch.zeros((8, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(8, 1)
    v0 = torch.tensor([[-1.0, -1.0, 1.0]])
    v1 = torch.tensor([[1.0, -1.0, 1.0]])
    v2 = torch.tensor([[0.0, 2.0, 1.0]])
    none = torch.full((8,), -1, dtype=torch.int64)
    dist, idx = nearest_hit(o, d, v0, v1, v2, none)
    assert (idx == 0).all() and torch.allclose(dist, torch.ones(8))
    _, idx = nearest_hit(o, d, v0, v1, v2, torch.zeros(8, dtype=torch.int64))
    assert (idx == -1).all()
    # every method runs the reference sweep: "pallas" names K5, whose
    # plain version is that sweep on CPU tensors, "pallas_fast" is an
    # alias of it; an unknown method raises
    for method in ("pluecker", "pallas", "pallas_fast"):
        dp, ip = nearest_hit(o, d, v0, v1, v2, none, method=method)
        assert torch.equal(dp, dist) and (ip == 0).all()
    with pytest.raises(ValueError, match="unknown intersect"):
        nearest_hit(o, d, v0, v1, v2, none, method="bvh")
