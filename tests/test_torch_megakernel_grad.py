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
