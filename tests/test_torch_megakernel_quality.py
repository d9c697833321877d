"""The quality kernels' wrappers (K3 forward, K4 backward) on the CPU: the
table, the plain versions ``quality_plain`` and ``quality_bwd_plain``
against the JAX package's eager kernel bodies (``_make_ctx`` and
``_sample_walk``, ``_bwd_tile_quality(unroll_samples=True)``) and against
autograd of the port's own forward, the autograd Function, the input
checks, and the routing, which never hands a CUDA scene to a plain
version. The CUDA kernels themselves run only on the card
(``chip_smoke.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spath_tpu.camera import Camera as JCamera  # noqa: E402
from spath_tpu.config import RenderConfig as JConfig  # noqa: E402
from spath_tpu.ops.pallas import megakernel as jmk  # noqa: E402
from spath_tpu.ops.pallas import megakernel_quality as jmq  # noqa: E402
from spath_tpu.ops.pallas import megakernel_quality_grad as jmqg  # noqa: E402
from spath_tpu.scene import default_scene as j_default_scene  # noqa: E402
from spath_tpu.scene import make_scene as j_make_scene  # noqa: E402
from spath_tpu.scene import procedural_scene as j_procedural  # noqa: E402
from spath_tpu_torch.camera import Camera  # noqa: E402
from spath_tpu_torch.config import RenderConfig  # noqa: E402
from spath_tpu_torch.convert import scene_from_numpy  # noqa: E402
from spath_tpu_torch.models import pathtracer, renderer  # noqa: E402
from spath_tpu_torch.models.pathtracer import (  # noqa: E402
    render_pt_fast, render_radiance_fastgrad,
)
from spath_tpu_torch.ops import nee  # noqa: E402
from spath_tpu_torch.ops.kernels import light_cdf  # noqa: E402
from spath_tpu_torch.ops.kernels import megakernel_quality as mq  # noqa: E402
from spath_tpu_torch.ops.kernels import (  # noqa: E402
    megakernel_quality_grad as mqg,
)
from spath_tpu_torch.scene import Scene, default_scene, make_scene  # noqa
from spath_tpu_torch.scene import procedural_scene  # noqa: E402

CPU = torch.device("cpu")
#: a small frame of the JAX exactness tests: 128 rays, 2 samples of 4
#: bounces (rr_start=2 needs a 4th bounce to roulette at)
SIZE = dict(width=16, height=8, spp=2, max_bounces=4, rng="hash",
            sampler="cosine")
#: (nee, mis, rr_start, stratify) of tests/test_megakernel_quality_grad.py
GRID = [(False, False, 0, False), (True, False, 0, False),
        (True, True, 0, False), (True, True, 1, False), (True, True, 2, True)]
#: the adjoint's column groups and their columns in the (T, 21) table
GROUPS = {"v0": (0, 3), "e1": (3, 6), "e2": (6, 9), "n": (9, 12),
          "alb": (12, 15), "emi": (15, 18), "area": (19, 20)}
KEY_SEED = 5


def _port_scene(js):
    return scene_from_numpy(np.asarray(js.vertices), np.asarray(js.albedo),
                            np.asarray(js.emission), js.light_idx,
                            device=CPU)


def _two_lights():
    """The default scene with its red triangle glowing: two lights of
    different power."""
    js = j_default_scene()
    e = np.asarray(js.emission).copy()
    e[0] = [3.0, 0.5, 0.25]
    return j_make_scene(np.asarray(js.vertices), np.asarray(js.albedo), e)


def _inputs(cfg_kw):
    """The JAX kernel's packed rays and keys for the frame, and the port's
    (n, 3) rays and int64 keys holding the same values."""
    jcfg = JConfig(**cfg_kw, intersect="pluecker")
    rays, pix, n = jmk.pack_rays(JCamera.default(), jcfg, 0)
    rays, pix = rays[:, :n], pix[:, :n]
    keys = jnp.uint32(KEY_SEED) * jmq._GOLD + pix
    o = torch.from_numpy(np.asarray(rays[0:3]).T.copy())
    d = torch.from_numpy(np.asarray(rays[3:6]).T.copy())
    k = torch.from_numpy(np.asarray(keys)[0].astype(np.int64))
    ids = torch.arange(n, dtype=torch.int64)
    assert torch.equal(mq.pack_rays(Camera.default(CPU), RenderConfig(
        **cfg_kw), KEY_SEED)[2], k)
    assert torch.equal(k, (KEY_SEED * 0x9E3779B9 + ids) & 0xFFFFFFFF)
    return jcfg, rays, keys, o, d, k


def _cfg(nee, mis, rr, strat):
    return dict(SIZE, nee=nee, mis=mis, rr_start=rr, stratify=strat)


def _weights(n):
    """The cotangent of tests/test_megakernel_quality_grad.py: (3, n)
    uniform in [0.1, 1) from Philox(9)."""
    rng = np.random.Generator(np.random.Philox(9))
    return rng.uniform(0.1, 1.0, (3, n)).astype(np.float32)


@pytest.mark.parametrize("name", ["default", "two_lights", "procedural1024"])
def test_quality_table_matches_jax(name):
    """Column by column, to the bit, against the JAX table built op by op:
    the cdf and prob columns decide which light a draw picks."""
    js = {"default": j_default_scene, "two_lights": _two_lights,
          "procedural1024": lambda: j_procedural(1024, seed=1)}[name]()
    table = mq.quality_table(_port_scene(js))
    with jax.disable_jit():
        want = np.asarray(jmq.quality_table(js))
    assert table.shape == (js.n_tris, mq.COLS) and table.is_contiguous()
    assert not want[:, mq.COLS:].any()
    for col in range(mq.COLS):
        np.testing.assert_array_equal(table[:, col].detach().numpy(),
                                      want[:, col], err_msg=f"column {col}")


@pytest.mark.parametrize("nee,mis,rr,strat", [GRID[0], GRID[2], GRID[4]])
def test_plain_matches_jax_sample_walk(nee, mis, rr, strat):
    """``quality_plain`` against the JAX kernel body run eagerly on the
    same rays, keys and table. The same program op by op, so the bound is
    the kernel-vs-wavefront flip budget (tests/test_megakernel_quality.py)
    only for the two libraries' last-bit trig differences; observed:
    bit-exact without stratification, 6e-8 with it."""
    js = j_default_scene()
    jcfg, rays, keys, o, d, k = _inputs(_cfg(nee, mis, rr, strat))
    with jax.disable_jit():
        tri = jmq.quality_table(js)
        ctx = jmq._make_ctx(rays, keys, tri, jcfg, js.n_tris, js.light_idx)
        acc = jnp.zeros((3, o.shape[0]), jnp.float32)
        for s in range(jcfg.spp):
            acc = acc + jnp.concatenate(
                jmq._sample_walk(jnp.int32(s), ctx)[:3], axis=0)
        want = np.asarray(acc * (np.float32(1) / np.float32(jcfg.spp))).T
    ps = _port_scene(js)
    got = mq.quality_plain(o, d, k, mq.quality_table(ps), mq.light_rows(ps),
                           RenderConfig(**_cfg(nee, mis, rr, strat))).numpy()
    assert want.max() > 0.1
    diff = np.abs(got - want)
    flipped = (diff > 1e-4).any(-1)
    assert flipped.mean() < 0.01
    assert diff[~flipped].max() <= 1e-6


def test_light_idx_none_walks_every_row_bit_equal():
    """Walking every row of the cdf picks the same lights as walking the
    emissive rows alone, on a scene whose two lights lie far apart in the
    table."""
    base = procedural_scene(80, seed=2, device=CPU)
    emission = torch.zeros_like(base.emission)
    emission[3] = torch.tensor([4.0, 3.0, 2.0])
    emission[70] = torch.tensor([1.0, 1.0, 5.0])
    light = default_scene(CPU)
    scene = make_scene(*(torch.cat([a, b]).numpy() for a, b in (
        (base.vertices, light.vertices), (base.albedo, light.albedo),
        (emission, light.emission))), CPU)
    assert scene.light_idx == (3, 70, 83, 84)
    cfg = RenderConfig(width=16, height=12, spp=2, max_bounces=3,
                       rng="hash", sampler="cosine", nee=True)
    o, d, k = mq.pack_rays(Camera.default(CPU), cfg, 1)
    tri = mq.quality_table(scene)
    rows = mq.light_rows(scene)
    picks = [mq._select_light(tri[:, mq.COL_CDF], mq._rows(r, 87, CPU),
                              torch.linspace(0, 0.998, 500))
             for r in (rows, None)]
    assert torch.equal(*picks) and set(picks[0].tolist()) == {3, 70, 83, 84}
    assert torch.equal(mq.quality_plain(o, d, k, tri, rows, cfg),
                       mq.quality_plain(o, d, k, tri, None, cfg))


@pytest.mark.parametrize("nee,mis,rr,strat", GRID)
def test_bwd_plain_matches_jax_bwd_tile(nee, mis, rr, strat):
    """``quality_bwd_plain`` against JAX's per-tile adjoint run eagerly
    (``unroll_samples=True``) on the same rays, keys, table and cotangent,
    each column group and the camera-ray adjoint within
    tests/test_megakernel_quality_grad.py's 2e-6·max; observed at most
    1.5e-7 (the port sums the table in float64, JAX in float32)."""
    js = j_default_scene()
    jcfg, rays, keys, o, d, k = _inputs(_cfg(nee, mis, rr, strat))
    n = o.shape[0]
    wts = _weights(n)
    gbar = jnp.concatenate([jnp.asarray(wts), jnp.zeros((1, n))], axis=0)
    with jax.disable_jit():
        rows, grays = jmqg._bwd_tile_quality(
            rays, keys, jmq.quality_table(js), gbar, cfg=jcfg,
            n_tris=js.n_tris, unroll_samples=True, light_rows=js.light_idx)
    want = np.asarray(jnp.sum(rows, axis=1))[:js.n_tris * 19].reshape(-1, 19)
    want_rays = np.asarray(grays)[:6].T
    ps = _port_scene(js)
    gtab, gray = mqg.quality_bwd_plain(
        o, d, k, mq.quality_table(ps), mq.light_rows(ps),
        torch.from_numpy(wts.T.copy()), RenderConfig(**_cfg(nee, mis, rr,
                                                            strat)))
    got = mqg.grad_table_from_gtab19(gtab).numpy()
    want = np.asarray(jmqg.grad_table_from_gtab19(jnp.asarray(want),
                                                  js.n_tris))[:, :mq.COLS]
    scale = np.abs(want).max()
    assert scale > 0
    for name, (a, b) in GROUPS.items():
        np.testing.assert_allclose(got[:, a:b], want[:, a:b], rtol=0,
                                   atol=2e-6 * scale, err_msg=name)
    assert not got[:, mq.COL_PROB].any() and not got[:, mq.COL_CDF].any()
    rscale = np.abs(want_rays).max()
    np.testing.assert_allclose(gray.numpy(), want_rays, rtol=0,
                               atol=2e-6 * max(rscale, 1e-12))
    if nee:   # the position chain is live
        assert np.abs(got[:, 0:9]).max() > 0 and rscale > 0


@pytest.mark.parametrize("nee,mis,rr,strat", [GRID[2], GRID[4]])
def test_bwd_plain_matches_autograd_of_plain(nee, mis, rr, strat):
    """Against ``torch.autograd`` of ``quality_plain`` on the same inputs,
    table and rays: the replay is the same program, so only the sum order
    differs (JAX's exact bound, 2e-6·max)."""
    js = _two_lights()
    cfg = RenderConfig(**_cfg(nee, mis, rr, strat))
    _, _, _, o, d, k = _inputs(_cfg(nee, mis, rr, strat))
    ps = _port_scene(js)
    tri = mq.quality_table(ps).detach().requires_grad_()
    o.requires_grad_()
    d.requires_grad_()
    gbar = torch.from_numpy(_weights(o.shape[0]).T.copy())
    out = mq.quality_plain(o, d, k, tri, mq.light_rows(ps), cfg)
    g_tri, g_o, g_d = torch.autograd.grad((out * gbar).sum(), [tri, o, d])
    gtab, gray = mqg.quality_bwd_plain(o.detach(), d.detach(), k,
                                       tri.detach(), mq.light_rows(ps), gbar,
                                       cfg)
    got = mqg.grad_table_from_gtab19(gtab)
    scale = g_tri.abs().max().item()
    assert scale > 0 and g_tri[:, mq.COL_PROB].abs().max() == 0
    torch.testing.assert_close(got, g_tri, rtol=0, atol=2e-6 * scale)
    want_rays = torch.cat([g_o, g_d], 1)
    torch.testing.assert_close(gray, want_rays, rtol=0,
                               atol=2e-6 * want_rays.abs().max().item())


def test_quality_rows_gives_the_wavefront_gradient():
    """``render_radiance_quality_grad`` on CPU tensors (K3/K4's plain
    versions under ``QualityRows``) against autograd of the wavefront
    ``render_radiance``: the same frame, and gradients to vertices,
    albedo, emission and the camera's position within 1e-4·max (two
    programs of the same estimator, summed in other orders)."""
    base = default_scene(CPU)
    cfg = RenderConfig(width=16, height=12, spp=2, rng="hash",
                       sampler="cosine", nee=True)
    wts = torch.from_numpy(np.random.Generator(np.random.Philox(7)).uniform(
        0.1, 1.0, (12, 16, 3)).astype(np.float32))

    def grads(render):
        leaves = [t.clone().requires_grad_() for t in
                  (base.vertices, base.albedo, base.emission)]
        cam = Camera.default(CPU)
        cam = Camera(cam.pos.requires_grad_(), cam.angle, cam.focal)
        img = render(Scene(*leaves, base.light_idx), cam, cfg, 0)
        return img.detach(), torch.autograd.grad((img * wts).sum(),
                                                 leaves + [cam.pos])

    img, got = grads(mqg.render_radiance_quality_grad)
    want_img, want = grads(pathtracer.render_radiance)
    assert torch.equal(img, want_img)
    for g, w in zip(got, want):
        assert w.abs().max() > 0
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * w.abs().max())


def test_calls_on_cpu_take_plain_without_counting():
    scene = default_scene(CPU)
    cfg = RenderConfig(width=8, height=4, spp=2, rng="hash",
                       sampler="cosine", nee=True)
    o, d, k = mq.pack_rays(Camera.default(CPU), cfg)
    tri, rows = mq.quality_table(scene), mq.light_rows(scene)
    gbar = torch.ones((32, 3)).T.contiguous().T      # not contiguous
    before = mq.quality_call.launches, mqg.quality_bwd_call.launches
    out = mq.quality_call(o, d, k, tri, rows, cfg)
    gtab, gray = mqg.quality_bwd_call(o, d, k, tri, rows, gbar, cfg)
    assert (mq.quality_call.launches, mqg.quality_bwd_call.launches) == before
    assert out.shape == (32, 3) and gtab.shape == (7, 19)
    assert gray.shape == (32, 6)
    assert torch.equal(out, mq.quality_plain(o, d, k, tri, rows, cfg))
    want = mqg.quality_bwd_plain(o, d, k, tri, rows, gbar.contiguous(), cfg)
    assert torch.equal(gtab, want[0]) and torch.equal(gray, want[1])


def test_calls_reject_bad_inputs():
    cfg = RenderConfig(width=8, height=4, spp=1, rng="hash",
                       sampler="cosine", nee=True)
    o, d, k = mq.pack_rays(Camera.default(CPU), cfg)
    scene = default_scene(CPU)
    tri, rows = mq.quality_table(scene), mq.light_rows(scene)
    gbar = torch.ones((32, 3))
    bad = [
        (o.double(), d, k, tri, rows),
        (o, d[:-1], k, tri, rows),
        (o, d, k.int(), tri, rows),
        (o, d, k, tri[:, :18], rows),
        (o, d, k, tri[:0], rows),
        (o, d, k, tri, rows.long()),
        (o, d, k, tri, rows.flip(0)),                # not ascending
        (o, d, k, tri, torch.tensor([3, 9], dtype=torch.int32)),
        (o.T.contiguous().T, d, k, tri, rows),       # not contiguous
    ]
    for args in bad:
        with pytest.raises(ValueError):
            mq.quality_call(*args, cfg)
    with pytest.raises(ValueError):
        mq.quality_call(o, d, k, tri, rows, cfg.replace(spp=0))
    for args in [(gbar[:-1], cfg), (gbar.double(), cfg),
                 (gbar, cfg.replace(max_bounces=mqg.MAX_BOUNCES + 1))]:
        with pytest.raises(ValueError):
            mqg.quality_bwd_call(o, d, k, tri, rows, *args)
    for other in (cfg.replace(rng="lcg", sampler="angle", nee=False),
                  cfg.replace(rng="threefry"), cfg.replace(sampler="uniform")):
        with pytest.raises(NotImplementedError):
            mq.quality_call(o, d, k, tri, rows, other)



def test_light_cdf_call_on_cpu_is_the_plain_version_uncounted():
    """On CPU tensors ``light_cdf_call`` sums on the host and counts no
    launch; the same light rows come back on every call (they are copied
    to a device once); a device with no kernel raises rather than summing
    elsewhere."""
    scene = default_scene(CPU)
    area = nee.triangle_areas(scene)
    before = light_cdf.light_cdf_call.launches
    got = light_cdf.light_cdf_call(scene.emission, area)
    want = light_cdf.light_cdf_plain(scene.emission, area)
    assert light_cdf.light_cdf_call.launches == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not any(t.requires_grad for t in got)
    assert mq.light_rows(scene) is mq.light_rows(default_scene(CPU))
    with pytest.raises(ValueError, match="no light-distribution kernel"):
        light_cdf.light_cdf_call(scene.emission.to("meta"), area.to("meta"))


@pytest.mark.parametrize("case", ["dtype", "columns", "length", "empty",
                                  "devices"])
def test_light_cdf_call_rejects_bad_inputs(case):
    scene = default_scene(CPU)
    e, a = scene.emission, nee.triangle_areas(scene)
    e, a = {"dtype": (e, a.double()), "columns": (e[:, :2], a),
            "length": (e, a[:-1]), "empty": (e[:0], a[:0]),
            "devices": (e, a.to("meta"))}[case]
    with pytest.raises(ValueError):
        light_cdf.light_cdf_call(e, a)

def test_guardrails():
    scene = default_scene(CPU)
    q = RenderConfig(rng="hash", sampler="cosine", nee=True)
    assert mq.supported(scene, q) and mqg.supported_grad(scene, q)
    assert mq.supported(scene, q.replace(nee=False, rr_start=2,
                                         stratify=True))
    for bad in (q.replace(rng="threefry"), q.replace(sampler="uniform"),
                q.replace(rng="lcg")):
        assert not mq.supported(scene, bad)
    # vis_grad changes no frame: K3 renders it, as the JAX kernel does,
    # and only the gradient refuses it (VisGradFusedRenderer's residual)
    assert mq.supported(scene, q.replace(vis_grad=True))
    assert not mqg.supported_grad(scene, q.replace(vis_grad=True))
    assert not mqg.supported_grad(scene, q.replace(
        max_bounces=mqg.MAX_BOUNCES + 1))
    big = procedural_scene(mq.MAX_TRIS + 1, device=CPU)
    assert not mq.supported(big, q) and not mqg.supported_grad(big, q)
    assert mq.MAX_TRIS == mqg.GRAD_MAX_TRIS == jmq.MAX_TRIS
    with pytest.raises(ValueError):
        mqg.render_radiance_quality_grad(scene, Camera.default(CPU),
                                         q.replace(rng="threefry"), 0)


def _as_if_on_cuda(monkeypatch):
    """Scenes and cameras report a CUDA device; the plain versions may not
    be reached, and the fused renders only record their calls."""
    cuda = torch.device("cuda", 0)
    monkeypatch.setattr(Scene, "device", property(lambda self: cuda))
    monkeypatch.setattr(Camera, "device", property(lambda self: cuda))

    def forbidden(*args, **kw):
        raise AssertionError("plain version reached for a CUDA scene")

    for module, name in ((mq, "quality_plain"), (mqg, "quality_bwd_plain")):
        monkeypatch.setattr(module, name, forbidden)
    from spath_tpu_torch.ops.kernels import bigscene_quality as bq
    from spath_tpu_torch.ops.kernels import bigscene_quality_grad as bqg
    calls = []

    def kernel(tag):
        def render(scene, camera, cfg, seed=0):
            calls.append((tag, scene.n_tris))
            return torch.zeros((cfg.height, cfg.width, 3), requires_grad=True)
        return render

    # the wavefront on the card (its sweeps on K5) and the vis residual
    monkeypatch.setattr(pathtracer, "render_radiance", kernel("wavefront"))
    monkeypatch.setattr(pathtracer, "render_vis_residual",
                        kernel("residual"))

    monkeypatch.setattr(mq, "render_radiance_quality_megakernel",
                        kernel("K3"))
    monkeypatch.setattr(mqg, "render_radiance_quality_grad",
                        kernel("K3+K4"))
    monkeypatch.setattr(bq, "render_radiance_bigscene_quality", kernel("K9"))
    monkeypatch.setattr(bqg, "render_radiance_bigscene_quality_grad",
                        kernel("K9+K10"))
    return calls


@pytest.mark.parametrize("n_tris", [7, 200, mq.MAX_TRIS])
@pytest.mark.parametrize("kw", [dict(nee=True), dict(nee=False, rr_start=2),
                                dict(nee=True, stratify=True, mis=False)])
def test_quality_routing_sends_cuda_scenes_to_k3_k4(monkeypatch, n_tris, kw):
    """Every quality config of a scene the fused kernels hold goes to K3
    to be served and to K3+K4 to be differentiated up to the crossovers
    measured on the H100 (``QUALITY_ROUTE_MAX_TRIS``,
    ``QUALITY_GRAD_ROUTE_MAX_TRIS``), and to the streamed K9 (K9+K10)
    above them."""
    scene = (default_scene(CPU) if n_tris == 7
             else procedural_scene(n_tris, seed=1, device=CPU))
    calls = _as_if_on_cuda(monkeypatch)
    cfg = RenderConfig(width=8, height=4, spp=1, rng="hash",
                       sampler="cosine", **kw)
    cam = Camera.default(CPU)
    fused = n_tris <= renderer.QUALITY_ROUTE_MAX_TRIS
    fused_grad = n_tris <= renderer.QUALITY_GRAD_ROUTE_MAX_TRIS
    assert renderer.forward_renderer(scene, cfg).name == (
        "quality" if fused else "quality_bigscene")
    assert renderer.grad_renderer(scene, cfg).name == (
        "quality" if fused_grad else "quality_bigscene")
    assert render_pt_fast(scene, cam, cfg).shape == (4, 8, 3)
    assert render_radiance_fastgrad(scene, cam, cfg).shape == (4, 8, 3)
    assert calls == [("K3" if fused else "K9", n_tris),
                     ("K3+K4" if fused_grad else "K9+K10", n_tris)]


def test_quality_routing_raises_for_cuda_scenes_without_a_kernel(
        monkeypatch):
    """No silent render or gradient past a cap on a CUDA device: above
    2^20 triangles the streamed quality kernels' cap is named. The
    threefry stream, which no kernel takes, goes to the wavefront on the
    card (its draws from the threefry kernel), in both directions.
    vis_grad renders through K3 and differentiates through K3+K4 with the
    residual; a path longer than K4's and K10's saved state (64 bounces)
    and a sampler no kernel takes go to the wavefront on the card."""
    from spath_tpu_torch.ops.kernels import bigscene_quality as bq

    big = Scene(torch.zeros((bq.BIGQ_MAX_TRIS + 1, 3, 3)),
                torch.zeros((bq.BIGQ_MAX_TRIS + 1, 3)),
                torch.zeros((bq.BIGQ_MAX_TRIS + 1, 3)), (0,))
    small, cam = default_scene(CPU), Camera.default(CPU)
    calls = _as_if_on_cuda(monkeypatch)
    q = RenderConfig(width=8, height=4, spp=1, rng="hash", sampler="cosine",
                     nee=True)
    with pytest.raises(NotImplementedError, match="K9 take T <= 1048576"):
        render_pt_fast(big, cam, q)
    with pytest.raises(NotImplementedError, match="K9 and K10 take T <= "):
        render_radiance_fastgrad(big, cam, q)
    assert calls == []
    for fn in (render_pt_fast, render_radiance_fastgrad):
        fn(small, cam, q.replace(rng="threefry"))
    assert calls == [("wavefront", 7)] * 2
    del calls[:]
    for fn in (render_pt_fast, render_radiance_fastgrad):
        fn(small, cam, q.replace(vis_grad=True))
        fn(small, cam, q.replace(sampler="uniform"))
    render_radiance_fastgrad(small, cam, q.replace(
        max_bounces=mqg.MAX_BOUNCES + 1))
    assert calls == [("K3", 7), ("wavefront", 7), ("K3+K4", 7),
                     ("residual", 7), ("wavefront", 7), ("wavefront", 7)]


def test_quality_routing_keeps_cpu_tensors_on_the_wavefront(monkeypatch):
    scene, cam = default_scene(CPU), Camera.default(CPU)
    cfg = RenderConfig(width=8, height=4, spp=1, rng="hash",
                       sampler="cosine", nee=True)
    assert renderer.forward_renderer(scene, cfg).name == "wavefront"
    assert renderer.grad_renderer(scene, cfg).name == "wavefront"

    def forbidden(*args, **kw):
        raise AssertionError("a fused path reached with CPU tensors")

    monkeypatch.setattr(mq, "quality_call", forbidden)
    monkeypatch.setattr(mqg, "quality_bwd_call", forbidden)
    assert render_pt_fast(scene, cam, cfg).shape == (4, 8, 3)
    assert render_radiance_fastgrad(scene, cam, cfg).shape == (4, 8, 3)


# ---- K3's and K4's lane schedules, counted by hand ----


def _schedule_totals():
    """64 pixels (two warps) of 2 samples: every sample 1 sweep after its
    camera sweep, but pixel 0's first (5), pixel 1's second (5) and pixel
    33's second (4)."""
    totals = np.ones((64, 3), dtype=np.int64)
    totals[0, 1] = totals[1, 2] = 5
    totals[33, 2] = 4
    return totals


def test_k3_schedules_counted_by_hand():
    """Lockstep: warp 0 sweeps its camera rays, then 5 steps a sample
    (1 + 5 + 5), warp 1 1 + 1 + 4: 17 steps. Regeneration, and runs of
    one chunk: each warp its busiest lane, 7 and 6. Runs of two chunks
    (one warp, 64 pixels) and a queue of one warp: lanes 0 and 1 busy to
    step 7, lanes 2-31 take pixels 32-61 at step 3 (lane 3 pixel 33, to
    step 9), lanes 2 and 4 pixels 62 and 63 at step 6: 9 steps."""
    totals = _schedule_totals()
    useful = 61 * 3 + 7 + 7 + 6
    got = mq.warp_schedules(totals, runs=(1, 2), queue_warps=1)
    want = {"lockstep": 17, "regeneration": 13, "runs_1": 13, "runs_2": 9,
            "queue": 9}
    assert got["useful_lane_steps"] == useful
    for name, steps in want.items():
        assert got[name]["warp_steps"] == steps, name
        assert got[name]["idle_lane_share"] == pytest.approx(
            1.0 - useful / (steps * 32))


def test_list_schedule_gives_ties_to_the_lowest_lane():
    lane, start = mq.bs.list_schedule([4, 3, 1, 4], 2)
    assert lane.tolist() == [0, 1, 1, 0]
    assert start.tolist() == [0, 0, 3, 4]


@pytest.mark.parametrize("n, run, warps", [(1000, 64, 3), (100, 256, 8),
                                           (7, 1, 2), (2_073_600, 256,
                                                       2_640)])
def test_run_sequences_cover_every_pixel_once_as_the_kernel_maps_them(
        n, run, warps):
    """Every pixel in exactly one warp's sequence, ascending; the sequence
    is ``PixelSource::at`` (csrc/pixel_source.cuh) of positions 0, 1, ...
    until it passes n."""
    seqs = mq.bs.run_sequences(n, run, warps)
    assert len(seqs) == warps
    every = np.concatenate(seqs)
    assert np.array_equal(np.sort(every), np.arange(n))
    for w in (0, warps // 2, warps - 1):
        seq = seqs[w]
        assert np.all(np.diff(seq) > 0)
        q = np.arange(seq.size + 1)
        r = q // run
        at = (w + r * warps) * run + (q - r * run)
        assert np.array_equal(at[:-1], seq) and at[-1] >= n


def test_lane_grid_one_run_a_warp_or_persistent():
    assert mqg.lane_grid(1920 * 1080, 256, 4) == 2025
    assert mqg.lane_grid(1920 * 1080, 256, 4, cap=660) == 660
    assert mqg.lane_grid(1, 256, 4, cap=660) == 1
    assert mqg.lane_grid(300, 32, 2) == 5
    with pytest.raises(ValueError):
        mqg.lane_grid(0, 256, 4)


def test_k4_epochs_counted_by_hand():
    """Two lanes, 4 pixels ((camera, sample 0, sample 1) sweeps: (1, 2, 1),
    (1, 1, 1), (1, 0, 0), (1, 3, 0)), E = 3 and 3 bounces, so the ring
    holds 5 (the kernel's E is MAX_BOUNCES: 68 records at 5 bounces). Lane 0 runs pixel 0 (steps 0-3) and pixel 3 (4-7),
    lane 1 pixel 1 (0-2) and pixel 2 (3): 8 forward steps. Epochs [0, 2],
    [3, 5], [6, 7]: lane 0 finishes 2, 1 and 3 records in them, lane 1 2,
    0 and 0, so 2 + 1 + 3 reverse steps."""
    totals = np.array([[1, 2, 1], [1, 1, 1], [1, 0, 0], [1, 3, 0]])
    assert mqg.ring_size(3, epoch=3) == 5 and mqg.ring_size(5) == 68
    assert mqg.EPOCH == mqg.MAX_BOUNCES
    with pytest.raises(ValueError, match="shorter than"):
        mqg.ring_size(3, epoch=2)
    got = mqg.epoch_schedule(totals, 3, 3, run=4, warps=1, lanes=2,
                             reverse_cost=1.15)
    assert got["forward_steps"] == 8 and got["reverse_steps"] == 6
    assert got["cost"] == pytest.approx(8 + 1.15 * 6)
    assert got["useful_cost"] == pytest.approx((12 + 1.15 * 8) / 2)
    # lockstep: (1 + 2 + 1) and (1 + 3 + 0) forward, 3 and 3 reverse
    lock = mqg.lockstep_cost(totals, lanes=2, reverse_cost=1.15)
    assert (lock["forward_steps"], lock["reverse_steps"]) == (8, 6)


def test_k4_lane_reverses_finished_samples_in_order_last_bounce_first():
    """Lane 0 of the test above: the reverse epochs and what each runs."""
    got = mqg.reverse_order([(0, [2, 1]), (3, [3, 0])], 3, 3)
    assert got == [(3, [(0, 0, 1), (0, 0, 0)]), (3, [(0, 1, 0)]),
                   (2, [(3, 0, 2), (3, 0, 1), (3, 0, 0)])]
    # a sample in flight at an epoch's end waits for the epoch it ends in
    got = mqg.reverse_order([(5, [4])], 4, 4)
    assert got == [(4, []), (1, [(5, 0, 3), (5, 0, 2), (5, 0, 1),
                                 (5, 0, 0)])]


def test_k4_grid_is_persistent_on_its_own_occupancy(monkeypatch):
    """K4's grid: its resident CTAs at T triangles times the SMs (its
    shared memory grows with T), runs of RUN_CHUNKS chunks, 128 threads
    (64 above T = 704)."""
    import contextlib
    import types

    calls = []

    class Lib:
        def spath_quality_backward_occupancy(self, n_tris):
            calls.append(n_tris)
            return 5 if n_tris <= 704 else 1

        def spath_quality_backward_threads(self, n_tris):
            return 128 if n_tris <= 704 else 64

    monkeypatch.setattr(mqg, "library", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda index: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda index: types.SimpleNamespace(
                            multi_processor_count=132))
    mqg.k4_resident.cache_clear()
    try:
        cuda = torch.device("cuda", 0)
        run = mqg.RUN_CHUNKS * 32
        assert mqg.k4_grid(1920 * 1080, 7, cuda) == (660, run, 128)
        assert mqg.k4_grid(1920 * 1080, 1024, cuda) == (132, run, 64)
        assert mqg.k4_grid(64 * 48, 7, cuda) == (
            -(-(-(-64 * 48 // run)) // 4), run, 128)
        mqg.k4_grid(320 * 240, 7, cuda)
        assert calls == [7, 1024]  # asked once a size
    finally:
        mqg.k4_resident.cache_clear()
