"""The quality estimator's building blocks on the CPU, against the JAX
package on the same numpy inputs: the hash streams (bit-exact, seeds at
and above 2^31, pixel ids beyond 1080p), the cosine and uniform samplers,
and next-event estimation (``ops/nee.py``) on the default scene, a scene
with two lights and an all-dark scene. The JAX functions run op by op
(``jax.disable_jit``), as the port does."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spath_tpu.config import RenderConfig as JConfig  # noqa: E402
from spath_tpu.ops import nee as jnee  # noqa: E402
from spath_tpu.ops import rng as jrng  # noqa: E402
from spath_tpu.ops import sampling as jsampling  # noqa: E402
from spath_tpu.scene import default_scene as j_default_scene  # noqa: E402
from spath_tpu.scene import make_scene as j_make_scene  # noqa: E402
from spath_tpu.scene import procedural_scene as j_procedural  # noqa: E402
from spath_tpu_torch.camera import Camera, generate_rays  # noqa: E402
from spath_tpu_torch.config import RenderConfig  # noqa: E402
from spath_tpu_torch.convert import scene_from_numpy  # noqa: E402
from spath_tpu_torch.ops import nee, rng, sampling  # noqa: E402
from spath_tpu_torch.ops.intersect import nearest_hit  # noqa: E402
from spath_tpu_torch.ops.kernels import light_cdf  # noqa: E402

CPU = torch.device("cpu")
SEEDS = [0, 7, 2**31 - 1, 2**31, 2**31 + 12345, 2**32 - 1]
#: pixel ids past 1920·1080 and past 2^21
PIXELS = np.concatenate([np.arange(0, 64), 1920 * 1080 - 1 + np.arange(3),
                         2**21 + np.arange(5), [2**24 + 3, 2**32 - 1]])


@pytest.mark.parametrize("seed", SEEDS)
def test_hash_streams_bit_exact(seed):
    """``hash_u32``, ``hash_uniform`` and ``hash_uniforms`` equal JAX's
    for draws 0-5, bounces 0-15 and samples 0, 1, 63, to the bit."""
    pix = jnp.asarray(PIXELS.astype(np.uint32))
    ids = torch.from_numpy(PIXELS.astype(np.int64))
    js = jnp.asarray(np.uint32(seed))
    for sample in (0, 1, 63):
        for bounce in range(16):
            got = rng.hash_uniforms(seed, ids, sample, bounce, 6).numpy()
            want = np.asarray(jrng.hash_uniforms(js, pix, sample, bounce, 6))
            np.testing.assert_array_equal(got, want)
        for draw in range(6):
            got = rng.hash_u32(seed, ids, sample, 15, draw).numpy()
            want = np.asarray(jrng.hash_u32(
                js, pix, jnp.uint32(sample), jnp.uint32(15),
                jnp.uint32(draw)))
            np.testing.assert_array_equal(got.astype(np.uint32), want)
            assert got.min() >= 0 and got.max() < 2**32
            np.testing.assert_array_equal(
                rng.hash_uniform(seed, ids, sample, 15, draw).numpy(),
                np.asarray(jrng.hash_uniform(
                    js, pix, jnp.uint32(sample), jnp.uint32(15),
                    jnp.uint32(draw))))


def test_mul32_does_not_overflow():
    """``x·c mod 2^32`` for the murmur constants at the top of the uint32
    range, where the plain int64 product would overflow."""
    x = np.array([0, 1, 2**16 - 1, 2**31, 2**32 - 1, 0xDEADBEEF],
                 dtype=np.uint64)
    for c in (rng.M1, rng.M2, rng.GOLD, rng.C1, rng.C2, rng.C3):
        got = rng.mul32(torch.from_numpy(x.astype(np.int64)), c).numpy()
        want = (x * np.uint64(c)) & np.uint64(0xFFFFFFFF)   # wraps mod 2^64
        np.testing.assert_array_equal(got.astype(np.uint64), want)


def test_sqrt_rn_is_correctly_rounded():
    """``sqrt_rn`` gives the correctly rounded float32 root, numpy's and
    JAX's, to the bit, over uniforms, small and large values, powers of
    two (subnormals included), zero and infinity: once under PyTorch's
    CPU grain (32768 elements, one thread) and once over 10^6 elements,
    many threads, where the float64 root rounded once was one ulp off in
    rare elements; its correction step makes it exact at any size. (JAX's
    CPU programs flush subnormal inputs to zero, so they are held to
    numpy alone.)"""
    from spath_tpu_torch.ops.fp import sqrt_rn

    g = np.random.Generator(np.random.Philox(11))
    small = np.concatenate([g.uniform(size=20_000),
                            g.uniform(size=1000) * 1e-20,
                            2.0 ** np.arange(-60, 60), [0.0, 1.0, 1e-20]]
                           ).astype(np.float32)
    large = np.concatenate([g.uniform(size=1_200_000),
                            g.uniform(size=100_000) * 1e-20,
                            g.uniform(size=100_000) * 1e30,
                            2.0 ** np.arange(-149, 128), [np.inf]]
                           ).astype(np.float32)
    for x in (small, large):
        got = sqrt_rn(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, np.sqrt(x))
        normal = (x == 0) | (x >= np.finfo(np.float32).tiny)
        np.testing.assert_array_equal(
            got[normal], np.asarray(jnp.sqrt(jnp.asarray(x[normal]))))


def _normals_and_uniforms(n=4096):
    """Unit normals (some on the z = 0 boundary of the frame's branch) and
    uniforms, from Philox(5)."""
    g = np.random.Generator(np.random.Philox(5))
    nrm = g.normal(size=(n, 3)).astype(np.float32)
    nrm[:8, 2] = 0.0
    nrm[8:16] = [0.0, 0.0, -1.0]
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(
        np.float32)
    u1, u2 = g.uniform(size=(2, n)).astype(np.float32)
    return nrm, u1, u2


def test_orthonormal_basis_bit_exact():
    nrm, _, _ = _normals_and_uniforms()
    t, bt = sampling.orthonormal_basis(torch.from_numpy(nrm))
    jt, jbt = jsampling._orthonormal_basis(jnp.asarray(nrm))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(jbt))


@pytest.mark.parametrize("mode", ["cosine", "uniform", "angle"])
def test_samplers_match_jax(mode):
    """Directions and weights within 2 float32 ulps of 1 (the two
    libraries' ``sin``/``cos`` differ in the last bit on some angles);
    observed: bit-exact."""
    nrm, u1, u2 = _normals_and_uniforms()
    got_d, got_w = sampling.hemisphere_sample(
        mode, torch.from_numpy(nrm), torch.from_numpy(u1),
        torch.from_numpy(u2))
    with jax.disable_jit():
        want_d, want_w = jsampling.hemisphere_sample(
            mode, jnp.asarray(nrm), jnp.asarray(u1), jnp.asarray(u2))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=0,
                               atol=2.4e-7)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=0,
                               atol=2.4e-7)


def _scenes():
    """The default scene; with a second light (the red triangle glows); all
    dark."""
    base = j_default_scene()
    v, a, e = (np.asarray(base.vertices), np.asarray(base.albedo),
               np.asarray(base.emission))
    two = e.copy()
    two[0] = [3.0, 0.5, 0.25]
    return {"default": (v, a, e), "two_lights": (v, a, two),
            "dark": (v, a, np.zeros_like(e))}


SCENES = _scenes()


def _both(name):
    v, a, e = SCENES[name]
    return j_make_scene(v, a, e), scene_from_numpy(v, a, e, device=CPU)


@pytest.mark.parametrize("name", [*SCENES, "procedural1024",
                                  "procedural10k"])
def test_areas_and_light_cdf_bit_exact(name):
    """``triangle_areas`` and ``light_cdf`` equal the op-by-op JAX
    functions to the bit (the cdf is a discrete choice), the 1024-triangle
    procedural scene (10 lights) and ``procedural_scene(10_000, seed=0)``
    (its total summed in XLA's windows of 32) included."""
    if name.startswith("procedural"):
        js = (j_procedural(1024, seed=1) if name == "procedural1024"
              else j_procedural(10_000, seed=0))
        ps = scene_from_numpy(np.asarray(js.vertices), np.asarray(js.albedo),
                              np.asarray(js.emission), device=CPU)
    else:
        js, ps = _both(name)
    with jax.disable_jit():
        j_area = np.asarray(jnee.triangle_areas(js))
        j_cdf, j_prob = (np.asarray(x) for x in jnee.light_cdf(js))
    cdf, prob = nee.light_cdf(ps)
    np.testing.assert_array_equal(nee.triangle_areas(ps).detach().numpy(),
                                  j_area)
    np.testing.assert_array_equal(prob.numpy(), j_prob)
    np.testing.assert_array_equal(cdf.numpy(), j_cdf)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1023, 1024, 1025, 8192, 8193,
                               32769, 100_000, 1 << 20])
def test_total_is_xla_sum(n):
    """The light distribution's total equals the JAX package's ``jnp.sum``
    run op by op (XLA's CPU tree of windows of 32) to the bit, on seeded
    float32 weights over twelve decades with a third of them zero; at and
    above 33 terms a left-to-right sum is a different function."""
    g = np.random.Generator(np.random.Philox(n))
    w = (np.exp(g.uniform(-14.0, 14.0, size=n))
         * (g.uniform(size=n) < 2 / 3)).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jnp.sum(jnp.asarray(w)))
    got = light_cdf._total(w)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if n > 32:
        assert np.add.accumulate(w, dtype=np.float32)[-1] != want


def test_cdf_scan_order():
    """The cdf's prefix sum in blocks of 16 equals XLA's CPU ``cumsum`` on
    random float32 data, below, at and above one, two and three levels
    of blocks."""
    g = np.random.Generator(np.random.Philox(2))
    for n in (1, 15, 16, 17, 40, 255, 256, 257, 300, 1024, 4096, 4097):
        x = (g.uniform(size=n) * (g.uniform(size=n) < 0.5)).astype(
            np.float32)
        with jax.disable_jit():
            want = np.asarray(jnp.cumsum(jnp.asarray(x)))
        np.testing.assert_array_equal(light_cdf._scan(x), want)


def _surface_points(ps, seed):
    """First hits of a 24×16 camera frame: points, flipped normals, hit
    triangles (0 on a miss), hit mask, and 3 uniforms per ray."""
    o, d = generate_rays(Camera.default(CPU), 24, 16)
    src = torch.full((o.shape[0],), -1, dtype=torch.int64)
    dist, idx = nearest_hit(o, d, ps.v0, ps.v1, ps.v2, src)
    hit = idx >= 0
    safe = idx.clamp_min(0)
    p = o + dist[:, None] * d
    nrm = ps.normals()[safe]
    n_s = torch.where((sampling.dot3(nrm, d) > 0)[:, None], -nrm, nrm)
    g = np.random.Generator(np.random.Philox(seed))
    us = g.uniform(size=(3, o.shape[0])).astype(np.float32)
    return p, n_s, safe, hit, us


@pytest.mark.parametrize("name", list(SCENES))
def test_sample_light_points_match_jax(name):
    js, ps = _both(name)
    _, _, _, _, us = _surface_points(ps, 3)
    lights, _ = nee.make_lights(ps.v0, ps.v1 - ps.v0, ps.v2 - ps.v0,
                                ps.emission)
    got = nee.sample_light_points(lights,
                                  *(torch.from_numpy(u) for u in us))
    with jax.disable_jit():
        want = jnee.sample_light_points(js, *(jnp.asarray(u) for u in us))
    for k in ("idx", "y", "normal", "emission", "area", "prob"):
        np.testing.assert_array_equal(got[k].detach().numpy(),
                                      np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("name", list(SCENES))
@pytest.mark.parametrize("mis", [False, True])
def test_direct_light_matches_jax(name, mis):
    """The direct-light estimate at the frame's first hits, with and
    without the MIS weight, to the bit; lit where the scene has light."""
    js, ps = _both(name)
    p, n_s, safe, hit, us = _surface_points(ps, 4)
    cfg = RenderConfig(rng="hash", sampler="cosine", nee=True, mis=mis)
    alb = ps.albedo[safe]
    lights, _ = nee.make_lights(ps.v0, ps.v1 - ps.v0, ps.v2 - ps.v0,
                                ps.emission)
    got = nee.direct_light(lights, p, n_s, safe,
                           *(torch.from_numpy(u) for u in us), cfg,
                           hit_albedo=alb).detach().numpy()
    jcfg = JConfig(rng="hash", sampler="cosine", nee=True, mis=mis,
                   intersect="reference")
    with jax.disable_jit():
        want = np.asarray(jnee.direct_light(
            js, jnp.asarray(p.numpy()), jnp.asarray(n_s.numpy()),
            jnp.asarray(safe.numpy().astype(np.int32)),
            *(jnp.asarray(u) for u in us), jcfg,
            hit_albedo=jnp.asarray(alb.numpy())))
    np.testing.assert_array_equal(got, want)
    lit = got[hit.numpy()].max()
    assert (lit > 0) == (name != "dark")


def test_bsdf_pdf_and_nee_pdf_of_hit_match_jax():
    g = np.random.Generator(np.random.Philox(6))
    cos = g.uniform(-1, 1, 64).astype(np.float32)
    prob, area = g.uniform(0, 1, (2, 64)).astype(np.float32)
    area[:4] = 0.0
    dist = np.concatenate([g.uniform(0, 10, 60), [1e12] * 4]).astype(
        np.float32)
    for sampler in ("cosine", "uniform"):
        np.testing.assert_array_equal(
            nee.bsdf_pdf(sampler, torch.from_numpy(cos)).numpy(),
            np.asarray(jnee.bsdf_pdf(sampler, jnp.asarray(cos))))
    with pytest.raises(ValueError):
        nee.bsdf_pdf("angle", torch.from_numpy(cos))
    args = [prob, area, dist, np.abs(cos)]
    got = nee.nee_pdf_of_hit(*(torch.from_numpy(x) for x in args)).numpy()
    with jax.disable_jit():
        want = np.asarray(jnee.nee_pdf_of_hit(*(jnp.asarray(x)
                                                for x in args)))
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all()
