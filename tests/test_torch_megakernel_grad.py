"""The backward kernel's wrapper (K2) on the CPU: its plain version
``mega_bwd_plain`` against the JAX package's per-tile adjoint
``_bwd_tile`` and against autograd of the port's own forward, the
autograd Function ``MegaRows``, the input checks, and the gradient
routing, which never hands a CUDA scene to the plain version. The CUDA
kernel itself runs only on the card (``chip_smoke.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from spath_tpu.camera import Camera as JCamera  # noqa: E402
from spath_tpu.config import RenderConfig as JConfig  # noqa: E402
from spath_tpu.ops.pallas import megakernel as jmk  # noqa: E402
from spath_tpu.ops.pallas import megakernel_grad as jmg  # noqa: E402
from spath_tpu.scene import default_scene as j_default_scene  # noqa: E402
from spath_tpu.scene import procedural_scene as j_procedural  # noqa: E402
from spath_tpu_torch.camera import Camera  # noqa: E402
from spath_tpu_torch.config import RenderConfig  # noqa: E402
from spath_tpu_torch.convert import scene_from_numpy  # noqa: E402
from spath_tpu_torch.models import pathtracer, renderer  # noqa: E402
from spath_tpu_torch.models.pathtracer import (  # noqa: E402
    render_radiance_fastgrad,
)
from spath_tpu_torch.ops.kernels import bigscene_grad as bg  # noqa: E402
from spath_tpu_torch.ops.kernels import megakernel as mk  # noqa: E402
from spath_tpu_torch.ops.kernels import megakernel_grad as mg  # noqa: E402
from spath_tpu_torch.scene import Scene, default_scene  # noqa: E402
from spath_tpu_torch.scene import procedural_scene  # noqa: E402

CPU = torch.device("cpu")
#: the frames of tests/test_megakernel_grad.py's exact adjoint tests
SMALL = dict(width=16, height=12, spp=3, max_bounces=5)
SCATTER = dict(width=16, height=12, spp=2, max_bounces=3)


def _port_scene(js):
    return scene_from_numpy(np.asarray(js.vertices), np.asarray(js.albedo),
                            np.asarray(js.emission), js.light_idx,
                            device=CPU)


def _weights(n):
    """The cotangent of tests/test_megakernel_grad.py: (3, n) uniform in
    [0.1, 1) from Philox(3)."""
    rng = np.random.Generator(np.random.Philox(3))
    return rng.uniform(0.1, 1.0, (3, n)).astype(np.float32)


def _jax_adjoint(js, size):
    """JAX's ``_bwd_tile`` (position_chain=False, the kernel's) run
    eagerly on its own packing's first n lanes → (T, 18)."""
    jcfg = JConfig(**size)
    rays, seeds, n = jmk.pack_rays(JCamera.default(), jcfg, 0)
    wts = _weights(n)
    gbar = jnp.concatenate([jnp.asarray(wts), jnp.zeros((1, n))], axis=0)
    t = js.n_tris
    rows, grays = jmg._bwd_tile(rays[:, :n], seeds[:, :n],
                                jmk._scene_table(js), gbar, cfg=jcfg,
                                n_tris=t)
    assert not np.asarray(grays).any()
    if t > jmg.GRAD_UNROLL_TRIS:        # scatter mode: triangle-major
        return np.asarray(rows)[:18, :t].T, wts
    return np.asarray(jnp.sum(rows, axis=1))[:t * 18].reshape(t, 18), wts


@pytest.mark.parametrize("scene_name", ["default", "procedural80"])
def test_plain_matches_jax_bwd_tile(scene_name):
    """Against the JAX package's adjoint on the same rays, seeds, table
    and cotangent. JAX's jitted sample loop can flip a path against the
    port's op-by-op replay, so the bound is the cross-program one of
    tests/test_megakernel_grad.py, 0.03·max|grad|; observed: default
    scene 6.7e-8·max (no path flipped), T=80 scatter mode 0."""
    if scene_name == "default":
        js, size = j_default_scene(), SMALL
    else:
        js, size = j_procedural(mg.GRAD_UNROLL_TRIS + 16, seed=2), SCATTER
    want, wts = _jax_adjoint(js, size)
    cfg = RenderConfig(**size)
    o, d, seeds = mk.pack_rays(Camera.default(CPU), cfg, 0)
    got = mg.mega_bwd_plain(o, d, seeds, mk.scene_table(_port_scene(js)),
                            torch.from_numpy(wts.T.copy()), cfg).numpy()
    scale = np.abs(want).max()
    assert scale > 0
    assert not got[:, :9].any() and not want[:, :9].any()
    np.testing.assert_allclose(got, want, rtol=0, atol=0.03 * scale)


@pytest.mark.parametrize("n_tris", [7, 25])
def test_plain_matches_autograd_of_forward(n_tris):
    """Against ``torch.autograd`` of the port's own forward
    ``megakernel_plain`` on the same inputs: the replay is the same
    program, so only the sum order differs (JAX's exact bound,
    1e-6·max|grad|). The camera rays' cotangents are exactly zero."""
    scene = (default_scene(CPU) if n_tris == 7 else
             Scene(*(torch.cat([getattr(default_scene(CPU), k),
                                getattr(procedural_scene(18, seed=2,
                                                         device=CPU), k)])
                     for k in ("vertices", "albedo", "emission"))))
    cfg = RenderConfig(**SMALL)
    o, d, seeds = mk.pack_rays(Camera.default(CPU), cfg, 0)
    o.requires_grad_()
    d.requires_grad_()
    tri = mk.scene_table(scene).detach().requires_grad_()
    gbar = torch.from_numpy(_weights(o.shape[0]).T.copy())
    out = mk.megakernel_plain(o, d, seeds, tri, cfg)
    g_tri, g_o, g_d = torch.autograd.grad((out * gbar).sum(), [tri, o, d],
                                          allow_unused=True,
                                          materialize_grads=True)
    got = mg.mega_bwd_plain(o.detach(), d.detach(), seeds, tri.detach(),
                            gbar, cfg)
    scale = g_tri.abs().max().item()
    assert scale > 0
    torch.testing.assert_close(got, g_tri, rtol=0, atol=1e-6 * scale)
    assert not g_tri[:, :9].any()
    assert not g_o.any() and not g_d.any()


def test_megarows_emission_is_exactly_linear():
    """Radiance is linear in emission, so ``<grad, dir>`` through
    ``MegaRows`` (K1 forward, K2 backward; their plain versions here)
    equals ``L(e + dir) - L(e)`` to float32 rounding."""
    scene, cam = default_scene(CPU), Camera.default(CPU)
    cfg = RenderConfig(width=32, height=24, spp=2)
    e = scene.emission.clone().requires_grad_()

    def loss(emission):
        return mg.render_radiance_mega(
            Scene(scene.vertices, scene.albedo, emission), cam, cfg, 0).mean()

    f0 = loss(e)
    (g,) = torch.autograd.grad(f0, [e])
    rng = np.random.Generator(np.random.Philox(11))
    direction = torch.from_numpy(
        rng.normal(size=tuple(e.shape)).astype(np.float32))
    with torch.no_grad():
        want = (loss(e + direction) - f0).item()
    got = (g * direction).sum().item()
    assert abs(got - want) <= 1e-4 * max(abs(want), 1e-6), (got, want)


def test_megarows_gives_the_wavefront_gradient():
    """``render_radiance_mega`` on CPU tensors against autograd of the
    wavefront ``render_radiance``: the same value, and gradients within
    sum-order noise, zero for the camera."""
    base, cfg = default_scene(CPU), RenderConfig(width=16, height=12, spp=2)
    wts = torch.from_numpy(np.random.Generator(np.random.Philox(7)).uniform(
        0.1, 1.0, (12, 16, 3)).astype(np.float32))

    def grads(render):
        leaves = [t.clone().requires_grad_() for t in
                  (base.vertices, base.albedo, base.emission)]
        cam = Camera.default(CPU)
        cam = Camera(cam.pos.requires_grad_(), cam.angle, cam.focal)
        img = render(Scene(*leaves), cam, cfg, 0)
        return img.detach(), torch.autograd.grad(
            (img * wts).sum(), leaves + [cam.pos], allow_unused=True,
            materialize_grads=True)

    img, got = grads(mg.render_radiance_mega)
    want_img, want = grads(pathtracer.render_radiance)
    assert torch.equal(img, want_img)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-5 * max(w.abs().max(), 1e-3))
    assert not got[-1].any()


def test_guardrails():
    scene, cam = default_scene(CPU), Camera.default(CPU)
    cfg = RenderConfig(width=8, height=4, spp=1)
    for bad in (cfg.replace(rng="threefry"), cfg.replace(sampler="cosine"),
                cfg.replace(max_bounces=mg.MAX_BOUNCES + 1)):
        with pytest.raises(ValueError):
            mg.render_radiance_mega(scene, cam, bad, 0)
    assert mg.supported_grad(scene, cfg)
    assert not mg.supported_grad(
        procedural_scene(mg.GRAD_MAX_TRIS + 1, device=CPU), cfg)
    assert mg.GRAD_UNROLL_TRIS == jmg.GRAD_UNROLL_TRIS
    assert mg.GRAD_MAX_TRIS == jmg.GRAD_MAX_TRIS == mk.MAX_TRIS


def test_mega_bwd_call_cpu_takes_plain_without_counting():
    cfg = RenderConfig(width=8, height=4, spp=2)
    o, d, seeds = mk.pack_rays(Camera.default(CPU), cfg)
    tri = mk.scene_table(default_scene(CPU))
    gbar = torch.ones((32, 3)).T.contiguous().T      # not contiguous
    before = mg.mega_bwd_call.launches
    got = mg.mega_bwd_call(o, d, seeds, tri, gbar, cfg)
    assert mg.mega_bwd_call.launches == before
    assert got.shape == (7, 18)
    assert torch.equal(got, mg.mega_bwd_plain(o, d, seeds, tri,
                                              gbar.contiguous(), cfg))


def test_mega_bwd_call_rejects_bad_inputs():
    cfg = RenderConfig(width=8, height=4, spp=1)
    o, d, seeds = mk.pack_rays(Camera.default(CPU), cfg)
    tri = mk.scene_table(default_scene(CPU))
    gbar = torch.ones((32, 3))
    for args in [(o, d, seeds, tri, gbar[:-1], cfg),
                 (o, d, seeds, tri, gbar.double(), cfg),
                 (o, d, seeds, tri, gbar[:, :2], cfg),
                 (o, d, seeds, tri[:, :12], gbar, cfg),
                 (o, d, seeds[:-1], tri, gbar, cfg),
                 (o, d, seeds, tri, gbar,
                  cfg.replace(max_bounces=mg.MAX_BOUNCES + 1))]:
        with pytest.raises(ValueError):
            mg.mega_bwd_call(*args)
    with pytest.raises(NotImplementedError):
        mg.mega_bwd_call(o, d, seeds, tri, gbar, cfg.replace(rng="hash"))


def _as_if_on_cuda(monkeypatch):
    """Scenes and cameras report a CUDA device; the CPU-only plain
    versions may not be reached, and the fused differentiable render and
    the wavefront (on the card, its sweeps on K5) only record their calls,
    the wavefront's as ``("wavefront", T)``."""
    cuda = torch.device("cuda", 0)
    monkeypatch.setattr(Scene, "device", property(lambda self: cuda))
    monkeypatch.setattr(Camera, "device", property(lambda self: cuda))

    def forbidden(*args, **kw):
        raise AssertionError("plain version reached for a CUDA scene")

    monkeypatch.setattr(mg, "mega_bwd_plain", forbidden)
    monkeypatch.setattr(mk, "megakernel_plain", forbidden)
    calls = []
    monkeypatch.setattr(pathtracer, "render_radiance",
                        lambda scene, camera, cfg, seed=0: calls.append(
                            ("wavefront", scene.n_tris))
                        or torch.zeros((cfg.height, cfg.width, 3),
                                       requires_grad=True))

    def kernel(scene, camera, cfg, seed=0):
        calls.append(scene.n_tris)
        return torch.zeros((cfg.height, cfg.width, 3), requires_grad=True)

    monkeypatch.setattr(mg, "render_radiance_mega", kernel)
    monkeypatch.setattr(bg, "render_radiance_bigscene_grad",
                        lambda scene, *a, **kw: calls.append(-scene.n_tris)
                        or torch.zeros((4, 8, 3), requires_grad=True))
    return calls


@pytest.mark.parametrize("n_tris", [7, 100, mg.GRAD_MAX_TRIS])
def test_grad_routing_sends_cuda_scenes_to_the_kernels(monkeypatch, n_tris):
    """On a CUDA device a scene goes to K1+K2 up to the crossover
    measured on the H100 (``GRAD_ROUTE_MAX_TRIS``; the JAX package's
    was 64 triangles, on a TPU) and to the streamed K6+K8+K7 above it,
    though K2 takes up to 1024 (recorded as -T)."""
    scene = (default_scene(CPU) if n_tris == 7
             else procedural_scene(n_tris, seed=1, device=CPU))
    calls = _as_if_on_cuda(monkeypatch)
    cfg = RenderConfig(width=8, height=4, spp=1)
    fused = n_tris <= renderer.GRAD_ROUTE_MAX_TRIS
    assert renderer.grad_renderer(scene, cfg).name == (
        "megakernel" if fused else "bigscene")
    out = render_radiance_fastgrad(scene, Camera.default(CPU), cfg)
    assert out.shape == (4, 8, 3)
    assert calls == [n_tris if fused else -n_tris]


def test_grad_routing_raises_for_cuda_scenes_without_a_kernel(monkeypatch):
    """No silent gradient past a cap on a CUDA device: a scene above every
    backward kernel's cap (K2's 1024 triangles, the streamed K8's 2^20)
    names K8's, which the wavefront on the card keeps. A path longer than
    the kernels' saved state (64 bounces) and an estimator no fused kernel
    takes go to the wavefront on the card."""
    big = procedural_scene(bg.GRAD_MAX_TRIS + 1, seed=1, device=CPU)
    small, cam = default_scene(CPU), Camera.default(CPU)
    calls = _as_if_on_cuda(monkeypatch)
    cfg = RenderConfig(width=8, height=4, spp=1)
    with pytest.raises(NotImplementedError, match="K8"):
        render_radiance_fastgrad(big, cam, cfg)
    assert calls == []
    deep = cfg.replace(max_bounces=mg.MAX_BOUNCES + 1)
    assert renderer.grad_renderer(small, deep).name == "wavefront"
    render_radiance_fastgrad(small, cam, deep)
    render_radiance_fastgrad(small, cam, cfg.replace(rng="hash"))
    assert calls == [("wavefront", 7)] * 2
    # up to 64 bounces the kernels take the gradient
    assert renderer.grad_renderer(
        small, cfg.replace(max_bounces=mg.MAX_BOUNCES)).name == "megakernel"


def test_grad_routing_keeps_cpu_tensors_on_the_wavefront(monkeypatch):
    scene, cam = default_scene(CPU), Camera.default(CPU)
    cfg = RenderConfig(width=8, height=4, spp=1)
    assert renderer.grad_renderer(scene, cfg).name == "wavefront"

    def forbidden(*args, **kw):
        raise AssertionError("the fused path reached with CPU tensors")

    monkeypatch.setattr(mg, "render_radiance_mega", forbidden)
    assert render_radiance_fastgrad(scene, cam, cfg).shape == (4, 8, 3)


# ---- K2's lane loop: the order it reverses in, its runs' rows, its grid ----


def test_k2_lane_reverses_finished_samples_in_order_last_bounce_first():
    """One lane, E = 3 and 3 bounces (a ring of 5 records): pixel 0's
    samples of 2 and 1 hits (2 and 1 sweeps), pixel 3's of 3 and 3 (2
    sweeps each: the last bounce needs none after it), pixel 5's camera
    ray missed. Steps 0-2: pixel 0's camera, sample 0's two sweeps (it
    ends at step 2, sample 1 starts there). Steps 3-5: sample 1 ends at 3;
    pixel 3's camera at 4. Steps 6-8: its sample 0 ends at 6 with 3
    records, and sample 1 (3 + 3 > 5) waits. Steps 9-11: it resumes and
    ends at 10; at 11 pixel 5's camera, whose sample 0 waits for room too
    (the ring holds 3 finished records). Step 12 resumes it: its samples
    have no hit and end at once."""
    got = mg.reverse_order([(0, [2, 1]), (3, [3, 3]), (5, [0, 0])], 3, 3)
    assert got == [(3, [(0, 0, 1), (0, 0, 0)]), (3, [(0, 1, 0)]),
                   (3, [(3, 0, 2), (3, 0, 1), (3, 0, 0)]),
                   (3, [(3, 1, 2), (3, 1, 1), (3, 1, 0)]), (1, [])]
    # at one bounce every sample of a pixel ends in its camera step, and
    # the ring (E records) stops the lane after E of them, until the
    # epoch's end; the rest end in the next epoch's first step
    got = mg.reverse_order([(7, [1, 1, 1, 1, 1])], 3, 1)
    assert got == [(3, [(7, 0, 0), (7, 1, 0), (7, 2, 0)]),
                   (1, [(7, 3, 0), (7, 4, 0)])]
    # an epoch shorter than a path: the ring (E + max_bounces - 1) still
    # holds a whole sample, which the lane waits for room to start
    got = mg.reverse_order([(1, [3]), (2, [1])], 2, 3)
    assert got == [(2, []), (2, [(1, 0, 2), (1, 0, 1), (1, 0, 0)]),
                   (1, [(2, 0, 0)])]
    with pytest.raises(ValueError, match="an epoch of 0 steps"):
        mg.reverse_order([(0, [1])], 0, 3)


def test_k2_run_rows_give_one_sum_whatever_order_the_queue_hands_runs_out():
    """K2's table adjoint on the CPU (``run_rows_model``): 12 runs of 1-3
    reverse epochs of float32 adds to 5 triangles, taken in ascending
    order and in two shuffled ones, give the same float64 sum to the bit,
    within float32 rounding of the exact sum; a sum over all events in
    one float32 slice moves with the order."""
    rng = np.random.default_rng(0)
    runs = [[[(int(rng.integers(5)),
                (rng.standard_normal(9) * 10.0 ** rng.integers(-3, 3))
                .astype(np.float32))
               for _ in range(int(rng.integers(1, 40)))]
              for _ in range(int(rng.integers(1, 4)))]
             for _ in range(12)]
    want = mg.run_rows_model(runs, 5, range(12))
    for order in (rng.permutation(12), rng.permutation(12)[::-1]):
        assert np.array_equal(mg.run_rows_model(runs, 5, order), want)
    exact = np.zeros((5, 9))
    for epochs in runs:
        for epoch in epochs:
            for tri, vals in epoch:
                exact[tri] += vals.astype(np.float64)
    np.testing.assert_allclose(want, exact, rtol=1e-5,
                               atol=1e-6 * np.abs(exact).max())
    sums = set()
    for order in (range(12), rng.permutation(12), rng.permutation(12)):
        acc = np.zeros((5, 9), dtype=np.float32)
        for r in order:
            for epoch in runs[r]:
                for tri, vals in epoch:
                    acc[tri] = acc[tri] + vals
        sums.add(acc.tobytes())
    assert len(sums) > 1


def test_k2_grid_is_persistent_on_its_own_occupancy(monkeypatch):
    """K2's grid: its resident CTAs at T triangles (its shared memory grows
    with T) times the SMs, asked once a size, with RUNS_PER_WARP runs a
    warp, but no run of fewer than 32 pixels, nor more CTAs than the runs
    fill at one a warp."""
    import contextlib
    import types

    calls = []

    class Lib:
        def spath_megakernel_backward_occupancy(self, n_tris):
            calls.append(n_tris)
            return 8 if n_tris <= 8 else 1

    monkeypatch.setattr(mg, "library", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda index: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda index: types.SimpleNamespace(
                            multi_processor_count=132))
    mg.k2_resident.cache_clear()
    try:
        cuda = torch.device("cuda", 0)
        k = mg.RUNS_PER_WARP
        assert mg.k2_grid(1920 * 1080, 7, cuda) == (8 * 132, k * 32 * 132)
        assert mg.k2_grid(1920 * 1080, 1024, cuda) == (132, k * 4 * 132)
        assert mg.k2_grid(64 * 48, 7, cuda) == (24, 96)
        assert mg.k2_grid(40, 7, cuda) == (1, 1)
        mg.k2_grid(320 * 240, 7, cuda)
        assert calls == [7, 1024]  # asked once a size
    finally:
        mg.k2_resident.cache_clear()
    with pytest.raises(ValueError):
        mg.k2_plan(0, 8, 132)
