"""Camera-ray compaction on the CPU (``models/compact_fast.py``, the
compacted wavefront, the registry's compacted renderers): the plan's
live set against the JAX package's first-hit set run op by op and inside
its relaxed set; compacted frames bit-equal to the full launch's on the
four kernel routes' plain versions and to the whole wavefront's; the
compacted renders against JAX's ``render_radiance_compact`` run op by
op; gradients, the two permutation transposes, the plan cache, the
all-miss view and the routing. The CUDA kernels themselves run on the
card only (``chip_smoke.py`` phase 51)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from spath_tpu.camera import Camera as JCamera  # noqa: E402
from spath_tpu.camera import generate_rays as j_generate_rays  # noqa: E402
from spath_tpu.config import RenderConfig as JConfig  # noqa: E402
from spath_tpu.models import compact_fast as jcf  # noqa: E402
from spath_tpu.models import pathtracer as jpt  # noqa: E402
from spath_tpu.models import renderer as jrenderer  # noqa: E402
from spath_tpu.scene import default_scene as j_default_scene  # noqa: E402
from spath_tpu.scene import make_scene as j_make_scene  # noqa: E402
from spath_tpu.scene import procedural_scene as j_procedural  # noqa: E402
from spath_tpu_torch.camera import Camera  # noqa: E402
from spath_tpu_torch.config import QUALITY as PRESET  # noqa: E402
from spath_tpu_torch.config import RenderConfig  # noqa: E402
from spath_tpu_torch.convert import (  # noqa: E402
    camera_from_numpy, scene_from_numpy,
)
from spath_tpu_torch.models import compact_fast as cf  # noqa: E402
from spath_tpu_torch.models import inverse, pathtracer, renderer  # noqa
from spath_tpu_torch.models.pathtracer import (  # noqa: E402
    render_radiance, render_radiance_compact, render_radiance_fastgrad,
)
from spath_tpu_torch.parallel import ring, shard_fast  # noqa: E402
from spath_tpu_torch.scene import Scene, default_scene  # noqa: E402

CPU = torch.device("cpu")
FIELDS = ("vertices", "albedo", "emission")
#: the frames: at most 32x16, spp <= 2
SIZE = dict(width=16, height=8, spp=2, max_bounces=5)
BIG = dict(width=16, height=8, spp=1, max_bounces=3)
QUALITY = dict(rng="hash", sampler="cosine", nee=True, mis=True)
#: three cameras about the default one, drawn from default_rng(0)
_RNG = np.random.default_rng(0)
CAMERAS = [((0.0, 0.0, -3.0) + _RNG.uniform(-0.4, 0.4, 3),
            (_RNG.uniform(-0.25, 0.25), _RNG.uniform(-0.35, 0.35), 0.0),
            2.0 + _RNG.uniform(-0.5, 0.5)) for _ in range(3)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tiny frames: under ``-n 6``
    eight threads a worker contend for the cores on ops of a few hundred
    rays, and the streamed routes' plain versions ran ~300x slower than
    alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _combined_scene():
    """tests/test_bigscene.py's 1150-triangle scene: the default scene and
    1143 procedural triangles, 5% emissive, above the port's crossovers
    (1024 for K1, 64 for K3), so both estimators take the streamed
    kernels."""
    base = j_default_scene()
    proc = j_procedural(1143, seed=0, emissive_fraction=0.05)
    js = j_make_scene(*(np.concatenate([np.asarray(getattr(base, k)),
                                        np.asarray(getattr(proc, k))])
                        for k in FIELDS))
    return scene_from_numpy(*(np.asarray(getattr(js, k)) for k in FIELDS),
                            js.light_idx, device=CPU)


@pytest.fixture(scope="module")
def big():
    return _combined_scene()


def _j_camera(pos, angle, focal):
    return JCamera(pos=np.asarray(pos, np.float32),
                   angle=np.asarray(angle, np.float32),
                   focal=np.float32(focal))


def _assert_conforms(got, want):
    """tests/test_torch_pathtracer.py's bounds, the port's wavefront
    against JAX's ``render_pt`` op by op: under 1% of pixels off by more
    than 1e-4, the mean within 5%."""
    assert got.shape == want.shape
    flipped = (np.abs(got - want) > 1e-4).any(-1)
    assert flipped.mean() < 0.01, f"{flipped.mean():.4f} flipped"
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=5e-2)


@pytest.fixture(scope="module")
def jax_live():
    """For each of CAMERAS, JAX's first-hit live set run op by op
    (``_first_hit_jit`` under ``jax.disable_jit()``) and its relaxed set
    (``_any_hit_relaxed``), on the default scene at 32x16."""
    js, cfg = j_default_scene(), JConfig(width=32, height=16)
    out = []
    for pose in CAMERAS:
        jcam = _j_camera(*pose)
        o, d = j_generate_rays(jcam, cfg.width, cfg.height)
        with jax.disable_jit():
            _, idx = jpt._first_hit_jit(js, o, d, cfg)
        relaxed = jcf._any_hit_relaxed(o, d, js.v0, js.v1, js.v2,
                                       cfg.tri_block)
        out.append((np.asarray(idx) >= 0, np.asarray(relaxed)))
    return out


@pytest.fixture(scope="module")
def jax_compact():
    """JAX's ``render_radiance_compact`` on the default scene and camera
    at 16x8x2, seed 0, run op by op: what its ``render_any`` renders on
    the CPU, clamped."""
    with jax.disable_jit():
        return np.asarray(jpt.render_radiance_compact(
            j_default_scene(), JCamera.default(), JConfig(**SIZE), 0))


@pytest.mark.parametrize("k", range(len(CAMERAS)))
def test_live_set_is_jax_first_hit_set_inside_the_relaxed_one(jax_live, k):
    """The exact live set: JAX's op-by-op first-hit set, a subset of its
    relaxed classifier's; ``sel`` and ``inv`` are inverse permutations,
    the live pixels first in pixel order, then the misses, as JAX's
    ``_classify`` orders them."""
    cam = camera_from_numpy(*CAMERAS[k], device=CPU)
    cfg = RenderConfig(width=32, height=16)
    plan = cf.make_compact_plan(default_scene(CPU), cam, cfg)
    exact, relaxed = jax_live[k]
    n = exact.size
    live = np.zeros(n, bool)
    live[plan.sel[:plan.n_live].numpy()] = True
    np.testing.assert_array_equal(live, exact)
    assert 0 < plan.n_live < n
    assert not (live & ~relaxed).any()
    ar = torch.arange(n)
    assert torch.equal(plan.sel[plan.inv], ar)
    assert torch.equal(plan.inv[plan.sel], ar)
    assert torch.equal(plan.sel[:plan.n_live],
                       torch.from_numpy(np.flatnonzero(exact)))
    assert torch.equal(plan.sel[plan.n_live:],
                       torch.from_numpy(np.flatnonzero(~exact)))
    assert torch.equal(plan.pix_p, plan.sel)
    assert torch.equal(plan.take, plan.inv.clamp(max=plan.n_live))


def _route_cases(big_scene):
    """(route, scene, cfg, full forward, full gradient) of the four
    kernel routes, each by its plain version on CPU tensors."""
    from spath_tpu_torch.ops.kernels import (
        bigscene, bigscene_grad, bigscene_quality, bigscene_quality_grad,
        megakernel, megakernel_grad, megakernel_quality,
        megakernel_quality_grad,
    )

    d = default_scene(CPU)
    return [
        ("conformance", d, RenderConfig(**SIZE),
         megakernel.render_radiance_megakernel,
         megakernel_grad.render_radiance_mega),
        ("quality", d, RenderConfig(**SIZE, **QUALITY),
         megakernel_quality.render_radiance_quality_megakernel,
         megakernel_quality_grad.render_radiance_quality_grad),
        ("bigscene", big_scene, RenderConfig(**BIG),
         bigscene.render_radiance_bigscene,
         bigscene_grad.render_radiance_bigscene_grad),
        ("bigscene_quality", big_scene, RenderConfig(**BIG, **QUALITY),
         bigscene_quality.render_radiance_bigscene_quality,
         bigscene_quality_grad.render_radiance_bigscene_quality_grad),
    ]


@pytest.mark.parametrize("route", ["conformance", "quality", "bigscene",
                                   "bigscene_quality"])
def test_compacted_frame_is_the_full_launch_bit_for_bit(big, route):
    case = {c[0]: c for c in _route_cases(big)}[route]
    _, scene, cfg, full, _ = case
    cam = Camera.default(CPU)
    assert cf._select_kernel(scene, cfg) == route
    plan = cf.make_compact_plan(scene, cam, cfg)
    assert 0 < plan.n_live < cfg.width * cfg.height
    got = cf.render_radiance_compact_fused(scene, cam, cfg, 3, plan=plan)
    want = full(scene, cam, cfg, 3)
    assert got.shape == (cfg.height, cfg.width, 3)
    assert torch.equal(got, want)
    assert want.max() > 0.0


@pytest.mark.parametrize("cfg", [
    RenderConfig(**SIZE), RenderConfig(**SIZE, **QUALITY),
    PRESET.replace(**SIZE), RenderConfig(**SIZE, rng="table"),
], ids=["conformance", "quality", "QUALITY", "table"])
def test_compacted_wavefront_is_the_wavefront_bit_for_bit(cfg):
    scene, cam = default_scene(CPU), Camera.default(CPU)
    got = render_radiance_compact(scene, cam, cfg, 5)
    assert not got.requires_grad
    assert torch.equal(got, render_radiance(scene, cam, cfg, 5))


def test_compacted_renders_match_jax_render_radiance_compact(jax_compact):
    """The compacted wavefront, ``render_radiance_compact_fused`` (K1's
    plain version) and ``render_any`` on the CPU, against JAX's
    ``render_radiance_compact`` op by op."""
    scene, cam, cfg = default_scene(CPU), Camera.default(CPU), \
        RenderConfig(**SIZE)
    wave = render_radiance_compact(scene, cam, cfg, 0)
    fused = cf.render_radiance_compact_fused(scene, cam, cfg, 0)
    _assert_conforms(wave.numpy(), jax_compact)
    _assert_conforms(fused.numpy(), jax_compact)
    _assert_conforms(renderer.render_any(scene, cam, cfg, 0).numpy(),
                     np.clip(jax_compact, 0.0, 1.0))
    assert jax_compact.max() > 0.0


def _grads(render, scene, cam, cfg):
    leaves = [t.detach().clone().requires_grad_() for t in (
        scene.vertices, scene.albedo, scene.emission, cam.pos, cam.angle,
        cam.focal)]
    img = render(Scene(*leaves[:3], scene.light_idx), Camera(*leaves[3:]),
                 cfg, 1)
    w = torch.from_numpy(np.random.default_rng(5).uniform(
        0.5, 1.5, tuple(img.shape)).astype(np.float32))
    got = torch.autograd.grad((img * w).sum(), leaves, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for g, t in zip(got, leaves)]


@pytest.mark.parametrize("route", ["conformance", "quality", "bigscene",
                                   "bigscene_quality"])
def test_compacted_gradients_match_the_full_launch(big, route):
    """Scene and camera gradients within 1e-5 of each group's max of the
    full-frame kernel pair's, and bitwise equal over two calls."""
    case = {c[0]: c for c in _route_cases(big)}[route]
    _, scene, cfg, _, full = case
    cam = Camera.default(CPU)
    assert cf._select_kernel_grad(scene, cfg) == route
    got = _grads(cf.render_radiance_compact_grad, scene, cam, cfg)
    again = _grads(cf.render_radiance_compact_grad, scene, cam, cfg)
    want = _grads(full, scene, cam, cfg)
    for group, g, g2, w in zip(("vertices",) + FIELDS[1:] + (
            "pos", "angle", "focal"), got, again, want):
        assert torch.equal(g, g2), group
        scale = w.abs().max().item()
        assert (g - w).abs().max().item() <= 1e-5 * scale, group
    assert want[1].abs().max() > 0.0
    if route in ("quality", "bigscene_quality"):
        assert want[3].abs().max() > 0.0        # the ray adjoint's


def test_permutation_transposes_pass_gradcheck():
    n, n_live = 12, 7
    g = torch.Generator().manual_seed(3)
    live = torch.zeros(n, dtype=torch.bool)
    live[torch.randperm(n, generator=g)[:n_live]] = True
    livei = live.long()
    ahead = livei.cumsum(0)
    inv = torch.where(live, ahead - 1, n_live + (1 - livei).cumsum(0) - 1)
    sel = torch.empty_like(inv)
    sel[inv] = torch.arange(n)
    take = inv.clamp(max=n_live)
    x = torch.randn(n, 3, dtype=torch.float64, generator=g,
                    requires_grad=True)
    rows = torch.randn(n_live, 3, dtype=torch.float64, generator=g,
                       requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda t: cf._TakePrefix.apply(t, sel, take, n_live), (x,))
    assert torch.autograd.gradcheck(
        lambda t: cf._UnpackRows.apply(t, sel, take, n_live), (rows,))
    out = cf._UnpackRows.apply(rows, sel, take, n_live)
    assert torch.equal(out[~live], torch.zeros(n - n_live, 3,
                                               dtype=torch.float64))
    assert torch.equal(cf._TakePrefix.apply(out, sel, take, n_live), rows)


def test_plan_cache_hits_by_value_rebuilds_after_add_and_stays_small():
    cf._PLAN_CACHE.clear()
    cfg = RenderConfig(width=16, height=8)
    scene, cam = default_scene(CPU), Camera.default(CPU)
    plan = cf._cached_plan(scene, cam, cfg)
    assert cf._cached_plan(scene, cam, cfg) is plan
    # a rebuilt, equal Scene and Camera: a value hit, which the plan's
    # one entry keys by the new tensors from then on
    rebuilt, cam2 = default_scene(CPU), Camera.default(CPU)
    assert not cf.has_plan(rebuilt, cam2, cfg)
    assert cf._cached_plan(rebuilt, cam2, cfg) is plan
    assert cf.has_plan(rebuilt, cam2, cfg) and len(cf._PLAN_CACHE) == 1
    # an in-place change to the geometry: a new plan, of the new geometry
    scene.vertices.add_(torch.tensor([0.0, 0.0, 50.0]))
    assert not cf.has_plan(scene, cam, cfg)
    moved = cf._cached_plan(scene, cam, cfg)
    assert moved is not plan
    assert moved.n_live == cf.make_compact_plan(scene, cam, cfg).n_live
    assert moved.n_live != plan.n_live
    for k in range(12):
        cam_k = camera_from_numpy((0.01 * k, 0.0, -3.0), (0.0, 0.0, 0.0),
                                  2.0, device=CPU)
        cf._cached_plan(default_scene(CPU), cam_k, cfg)
        assert len(cf._PLAN_CACHE) <= cf._PLAN_CACHE_MAX
    # eight plans, the newest, each in one entry
    assert len(cf._PLAN_CACHE) == cf._PLAN_CACHE_MAX
    assert len({id(e[3]) for e in cf._PLAN_CACHE}) == cf._PLAN_CACHE_MAX


def test_all_miss_view_is_zeros_with_no_kernel_call(monkeypatch):
    from spath_tpu_torch.ops.kernels import megakernel, megakernel_grad

    def forbidden(*args, **kw):
        raise AssertionError("a kernel called on an all-miss view")

    monkeypatch.setattr(megakernel, "mega_call", forbidden)
    monkeypatch.setattr(megakernel_grad, "MegaRows", forbidden)
    monkeypatch.setattr(pathtracer, "trace_mean_radiance", forbidden)
    scene = default_scene(CPU)
    away = camera_from_numpy((0.0, 0.0, -50.0), (0.0, np.pi, 0.0), 2.0,
                             device=CPU)
    cfg = RenderConfig(**SIZE)
    zeros = torch.zeros(cfg.height, cfg.width, 3)
    assert cf.make_compact_plan(scene, away, cfg).n_live == 0
    assert torch.equal(cf.render_radiance_compact_fused(scene, away, cfg),
                       zeros)
    assert torch.equal(render_radiance_compact(scene, away, cfg), zeros)
    albedo = scene.albedo.clone().requires_grad_()
    img = cf.render_radiance_compact_grad(
        Scene(scene.vertices, albedo, scene.emission, scene.light_idx),
        away, cfg)
    assert torch.equal(img.detach(), zeros)
    (g,) = torch.autograd.grad(img.sum(), [albedo])
    assert torch.equal(g, torch.zeros_like(albedo))


def _as_if_on_cuda(monkeypatch):
    cuda = torch.device("cuda", 0)
    monkeypatch.setattr(Scene, "device", property(lambda self: cuda))
    monkeypatch.setattr(Camera, "device", property(lambda self: cuda))


def test_registry_follows_jax_order_and_names():
    """The JAX package's names in its order (less its native renderer,
    item 13), its ``visgrad_fused`` the port's ``visgrad``; its
    attributes; ``get_renderer`` names the registered renderers."""
    names = {"visgrad_fused": "visgrad"}
    want = [names.get(r.name, r.name) for r in jrenderer.REGISTRY
            if r.name != "native"]
    assert [r.name for r in renderer.REGISTRY] == want
    for r in renderer.REGISTRY:
        j = jrenderer.get_renderer({v: k for k, v in names.items()}.get(
            r.name, r.name))
        assert r.jittable == j.jittable, r.name
        assert r.describe()
    assert renderer.get_renderer("compact_fused").name == "compact_fused"
    with pytest.raises(KeyError, match="compact_fused.*wavefront"):
        renderer.get_renderer("nope")


def test_available_renderers_and_render_any_on_the_cpu():
    """As the JAX package's on the CPU: the compacted and plain
    wavefronts are available (JAX's native renderer aside), and
    ``render_any`` renders the wavefront's frame, by name too."""
    want = [r.name for r in jrenderer.REGISTRY
            if r.name != "native" and r.available()]
    assert [r.name for r in renderer.available_renderers()] == want
    scene, cam, cfg = default_scene(CPU), Camera.default(CPU), \
        RenderConfig(**SIZE)
    frame = render_radiance(scene, cam, cfg, 2).clamp(0.0, 1.0)
    assert torch.equal(renderer.render_any(scene, cam, cfg, 2), frame)
    for name in ("compact", "wavefront", "compact_fused", "megakernel"):
        assert torch.equal(
            renderer.render_any(scene, cam, cfg, 2, backend=name), frame)


def test_routing_of_eager_calls_train_steps_and_shards(monkeypatch):
    """With the card's rule switched on for every route and the scene on
    a CUDA device: eager ``render_pt_fast`` and
    ``render_radiance_fastgrad`` take ``compact_fused`` only where their
    camera's plan is cached (no plan, an equal rebuilt camera, a moved
    scene, a scene above the cap: the kernel renderer); a train step and
    the sharded paths never take a compacted renderer; the ring routes
    nothing."""
    import inspect

    cf._PLAN_CACHE.clear()
    scene, cam = default_scene(CPU), Camera.default(CPU)
    cfg = RenderConfig(**SIZE)
    plan = cf._cached_plan(scene, cam, cfg)
    _as_if_on_cuda(monkeypatch)
    routes = frozenset(cf.KERNELS)
    monkeypatch.setattr(renderer, "COMPACT_ROUTES", routes)
    monkeypatch.setattr(renderer, "COMPACT_GRAD_ROUTES", routes)
    monkeypatch.setattr(renderer, "COMPACT_MIN_PIXELS", 1)
    calls = []

    def record(tag):
        def render(scene, camera, cfg, seed=0):
            calls.append(tag)
            return (scene.albedo.sum() * torch.zeros(
                (cfg.height, cfg.width, 3)))
        return render

    from spath_tpu_torch.ops.kernels import megakernel, megakernel_grad

    monkeypatch.setattr(cf, "render_radiance_compact_fused",
                        record("compact"))
    monkeypatch.setattr(cf, "render_radiance_compact_grad",
                        record("compact grad"))
    monkeypatch.setattr(megakernel, "render_radiance_megakernel",
                        record("K1"))
    monkeypatch.setattr(megakernel_grad, "render_radiance_mega",
                        record("K1+K2"))

    def routes_of(scene, camera):
        return (renderer.forward_renderer(scene, cfg, False, camera).name,
                renderer.grad_renderer(scene, cfg, False, camera).name)

    full = ("megakernel", "megakernel")
    assert renderer.forward_renderer(scene, cfg).name == "megakernel"
    assert renderer.forward_renderer(
        scene, cfg, require_jittable=False).name == "megakernel"
    assert renderer.grad_renderer(scene, cfg).name == "megakernel"
    assert routes_of(scene, cam) == ("compact_fused", "compact_fused")
    assert routes_of(scene, Camera.default(CPU)) == full
    assert routes_of(default_scene(CPU), cam) == full
    monkeypatch.setattr(renderer, "COMPACT_MAX_TRIS", scene.n_tris - 1)
    assert routes_of(scene, cam) == full
    monkeypatch.setattr(renderer, "COMPACT_MAX_TRIS", scene.n_tris)
    pathtracer.render_pt_fast(scene, cam, cfg)
    render_radiance_fastgrad(scene, cam, cfg)
    pathtracer.render_pt_fast(scene, Camera.default(CPU), cfg)
    assert calls == ["compact", "compact grad", "K1"]
    del calls[:]
    params = inverse.InverseParams.init(scene, cam)
    state = inverse.init_state(
        lambda p: torch.optim.Adam(list(p.tensors().values()), lr=1e-2),
        params)
    inverse.make_train_step(scene, cfg, 0)(
        state, torch.zeros(cfg.height, cfg.width, 3))
    assert calls == ["K1+K2"]
    taken = []
    monkeypatch.setattr(shard_fast, "sharded_frame",
                        lambda r, *a, **kw: taken.append(r.name))
    for fn in (shard_fast.render_radiance_fast_sharded,
               shard_fast.render_radiance_fastgrad_sharded):
        fn(scene, cam, cfg, 0, mesh=object())
    assert taken == ["megakernel", "megakernel"]
    src = inspect.getsource(ring)
    assert "forward_renderer" not in src and "grad_renderer" not in src
    # an in-place change to the geometry drops the call off the plan
    scene.vertices.add_(0.0)
    assert routes_of(scene, cam) == full
    assert plan.n_live > 0
