"""Visibility gradients on the CPU: ``ops/warp.py``, the wavefront's
``vis_grad`` and ``vis_residual`` branches, ``render_vis_residual`` with
and without the hit export, ``VisGradFusedRenderer``'s routing, the
wavefront on the card's routing, and the plain backward versions at 17
and 32 bounces, each against the JAX package run op by op
(``jax.disable_jit``, or its eager kernel bodies) on the same numpy
inputs.

The scene is tests/test_vis_residual.py's blocker arrangement (a floor, a
two-triangle area light and a blocker between them), so both visibility
terms are live. The JAX suite runs it with ``intersect="pluecker"``, whose
distances differ from the reference sweep's by up to 1e-3 relative
(tests/test_intersect.py); the port is held to ``intersect="reference"``.
Each JAX reference is computed once per module.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spath_tpu.camera import Camera as JCamera  # noqa: E402
from spath_tpu.config import RenderConfig as JConfig  # noqa: E402
from spath_tpu.models.pathtracer import (  # noqa: E402
    render_radiance as j_render_radiance,
    render_vis_residual as j_render_vis_residual,
)
from spath_tpu.ops import warp as jwarp  # noqa: E402
from spath_tpu.ops.pallas import megakernel as jmk  # noqa: E402
from spath_tpu.ops.pallas import megakernel_grad as jmg  # noqa: E402
from spath_tpu.ops.pallas import megakernel_quality as jmq  # noqa: E402
from spath_tpu.ops.pallas import megakernel_quality_grad as jmqg  # noqa
from spath_tpu.scene import Scene as JScene  # noqa: E402
from spath_tpu.scene import default_scene as j_default_scene  # noqa: E402
from spath_tpu_torch.camera import Camera, generate_rays  # noqa: E402
from spath_tpu_torch.config import RenderConfig  # noqa: E402
from spath_tpu_torch.models import pathtracer, renderer  # noqa: E402
from spath_tpu_torch.models.pathtracer import (  # noqa: E402
    render_pt, render_pt_fast, render_radiance, render_radiance_fastgrad,
    render_vis_residual, trace_mean_radiance,
)
from spath_tpu_torch.ops import nee, warp  # noqa: E402
from spath_tpu_torch.ops.kernels import bigscene_grad as bg  # noqa: E402
from spath_tpu_torch.ops.kernels import bigscene_quality as bq  # noqa: E402
from spath_tpu_torch.ops.kernels import (  # noqa: E402
    bigscene_quality_grad as bqg,
)
from spath_tpu_torch.ops.kernels import megakernel as mk  # noqa: E402
from spath_tpu_torch.ops.kernels import megakernel_grad as mg  # noqa: E402
from spath_tpu_torch.ops.kernels import megakernel_quality as mq  # noqa
from spath_tpu_torch.ops.kernels import (  # noqa: E402
    megakernel_quality_grad as mqg,
)
from spath_tpu_torch.scene import Scene, default_scene, make_scene  # noqa
from spath_tpu_torch.scene import procedural_scene  # noqa: E402

CPU = torch.device("cpu")
VERTS = np.array([
    [[-20, -1, -20], [20, -1, -20], [0, -1, 40]],
    [[-20, -1, 20], [20, -1, -20], [20, -1, 20]],
    [[-0.5, 0.75, -0.5], [0.5, 0.75, -0.5], [-0.5, 0.75, 0.5]],
    [[0.5, 0.75, 0.5], [0.5, 0.75, -0.5], [-0.5, 0.75, 0.5]],
    [[-0.35, 0.0, -0.25], [0.35, 0.0, -0.25], [0.0, 0.0, 0.45]],
], np.float32)
ALBEDO = np.array([[0.7] * 3, [0.7] * 3, [0] * 3, [0] * 3, [0.3] * 3],
                  np.float32)
EMISSION = np.array([[0] * 3, [0] * 3, [2] * 3, [2] * 3, [0] * 3],
                    np.float32)
#: 16x8, 2 samples of 3 bounces, the hash stream and cosine sampler
SIZE = dict(width=16, height=8, spp=2, max_bounces=3, rng="hash",
            sampler="cosine", intersect="reference", vis_grad=True)
ESTIMATORS = {"nee": dict(nee=True, mis=True),
              "bsdf": dict(nee=False, mis=False)}
SEED = 1
WTS = np.random.Generator(np.random.Philox(11)).uniform(
    0.1, 1.0, (8, 16, 3)).astype(np.float32)
#: gradients of one program: sum-order noise, relative to each max
GRAD_RTOL = 1e-5


def _port_scene():
    return make_scene(VERTS, ALBEDO, EMISSION, CPU)


def _jax_grads(render, est):
    """``jax.grad`` of sum(render · WTS) in vertices, albedo and camera
    position, op by op."""
    jcam = JCamera.default()
    jcfg = JConfig(**SIZE, **ESTIMATORS[est])

    def loss(vertices, albedo, pos):
        img = render(JScene(vertices, albedo, jnp.asarray(EMISSION)),
                     JCamera(pos, jcam.angle, jcam.focal), jcfg, SEED)
        return jnp.sum(img * WTS)

    with jax.disable_jit():
        grads = jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(VERTS), jnp.asarray(ALBEDO), jcam.pos)
    return [np.asarray(g) for g in grads]


def _port_grads(render, cfg, seed=SEED, wts=WTS):
    """The port's gradients of the same loss, zeros where unused."""
    base, cam = _port_scene(), Camera.default(CPU)
    leaves = [t.clone().requires_grad_() for t in
              (base.vertices, base.albedo, cam.pos)]
    img = render(Scene(leaves[0], leaves[1], base.emission, base.light_idx),
                 Camera(leaves[2], cam.angle, cam.focal), cfg, seed)
    grads = torch.autograd.grad((img * torch.from_numpy(wts)).sum(), leaves,
                                allow_unused=True, materialize_grads=True)
    return [g.numpy() for g in grads]


def _cfg(est, **kw):
    return RenderConfig(**{**SIZE, **ESTIMATORS[est], **kw})


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's residual gradients with and without NEE and its whole
    wavefront's with NEE, computed once."""
    return {("residual", "nee"): _jax_grads(j_render_vis_residual, "nee"),
            ("residual", "bsdf"): _jax_grads(j_render_vis_residual, "bsdf"),
            ("wavefront", "nee"): _jax_grads(j_render_radiance, "nee")}


def _assert_grads(got, want, what):
    for name, g, w in zip(("vertices", "albedo", "camera"), got, want):
        scale = np.abs(w).max()
        if scale == 0.0:
            assert not g.any(), (what, name)
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_RTOL * scale,
                                   err_msg=f"{what}: {name}")


# ---- ops/warp.py ----


def _factor_inputs():
    """Rays from random origins toward random points on the light's two
    triangles, with the hit triangle's rows, a sampling axis and a hit
    mask (a quarter of the lanes off)."""
    rng = np.random.Generator(np.random.Philox(21))
    n = 64
    o = rng.uniform([-1.0, -0.9, -1.0], [1.0, 0.5, 1.0], (n, 3))
    tri = rng.integers(2, 4, n)
    b = rng.uniform(0.05, 0.45, (n, 2))
    v0, v1, v2 = (VERTS[tri, k].astype(np.float64) for k in range(3))
    y = v0 + b[:, :1] * (v1 - v0) + b[:, 1:] * (v2 - v0)
    d = (y - o) / np.linalg.norm(y - o, axis=1, keepdims=True)
    prev = d + rng.normal(0, 0.3, (n, 3))
    prev /= np.linalg.norm(prev, axis=1, keepdims=True)
    e1, e2 = v1 - v0, v2 - v0
    nh = np.cross(e1, e2)
    hit = rng.uniform(size=n) > 0.25
    f32 = [a.astype(np.float32) for a in (o, d, v0, e1, e2, nh, prev)]
    return f32, hit


def test_reparam_emitter_factor_matches_jax():
    """Exactly 1 forward on every lane; its gradients in the origin and
    the hit triangle's rows within 1e-5 of each max of JAX's."""
    (o, d, v0, e1, e2, nh, prev), hit = _factor_inputs()
    w = np.random.default_rng(3).uniform(0.5, 1.5, o.shape[0]).astype(
        np.float32)
    diff = (o, v0, e1, e2, nh)

    def jloss(*args):
        return jnp.sum(jwarp.reparam_emitter_factor(
            args[0], jnp.asarray(d), *args[1:], jnp.asarray(prev),
            jnp.asarray(hit)) * w)

    with jax.disable_jit():
        jval = jwarp.reparam_emitter_factor(
            *(jnp.asarray(a) for a in (o, d, v0, e1, e2, nh, prev)),
            jnp.asarray(hit))
        want = jax.grad(jloss, argnums=tuple(range(5)))(
            *(jnp.asarray(a) for a in diff))
    leaves = [torch.from_numpy(a).requires_grad_() for a in diff]
    val = warp.reparam_emitter_factor(
        leaves[0], torch.from_numpy(d), *leaves[1:], torch.from_numpy(prev),
        torch.from_numpy(hit))
    assert (val == 1.0).all() and (np.asarray(jval) == 1.0).all()
    got = torch.autograd.grad((val * torch.from_numpy(w)).sum(), leaves)
    for g, want_g in zip(got, want):
        want_g = np.asarray(want_g)
        scale = np.abs(want_g).max()
        assert scale > 0
        np.testing.assert_allclose(g.numpy(), want_g, rtol=0,
                                   atol=GRAD_RTOL * scale)
    # no sampling axis at bounce 0: cos_p is 1, the factor still exactly 1
    first = warp.reparam_emitter_factor(
        leaves[0], torch.from_numpy(d), *leaves[1:], None,
        torch.from_numpy(hit))
    assert (first == 1.0).all()


def test_nee_boundary_term_matches_jax():
    """Exactly 0 forward; its gradients in the scene's vertices and the
    shading points within 1e-5 of each max of JAX's, on floor points under
    the blocker (enough edge samples land on a visible shadow boundary)."""
    rng = np.random.Generator(np.random.Philox(22))
    n = 512
    p = np.stack([rng.uniform(-1.2, 1.2, n), np.full(n, -1.0),
                  rng.uniform(-1.2, 1.2, n)], axis=1).astype(np.float32)
    n_s = np.tile(np.float32([0.0, 1.0, 0.0]), (n, 1))
    alb = np.tile(ALBEDO[0], (n, 1))
    hit_idx = np.zeros(n, np.int64)
    u = rng.uniform(size=(3, n)).astype(np.float32)
    hit = rng.uniform(size=n) > 0.1
    w = rng.uniform(0.5, 1.5, (n, 3)).astype(np.float32)
    kw = dict(SIZE, **ESTIMATORS["nee"])
    jcfg = JConfig(**kw)

    def jloss(vertices, pts):
        scene = JScene(vertices, jnp.asarray(ALBEDO), jnp.asarray(EMISSION))
        term = jwarp.nee_boundary_term(
            scene, pts, jnp.asarray(n_s), jnp.asarray(alb),
            jnp.asarray(hit_idx, jnp.int32), *(jnp.asarray(x) for x in u),
            jcfg, jnp.asarray(hit))
        return jnp.sum(term * w), term

    with jax.disable_jit():
        (_, jterm), want = jax.value_and_grad(jloss, argnums=(0, 1),
                                              has_aux=True)(
            jnp.asarray(VERTS), jnp.asarray(p))
    verts = torch.from_numpy(VERTS.copy()).requires_grad_()
    pts = torch.from_numpy(p).requires_grad_()
    v0, v1, v2 = verts[:, 0], verts[:, 1], verts[:, 2]
    lights, _ = nee.make_lights(v0, v1 - v0, v2 - v0,
                                torch.from_numpy(EMISSION))
    term = warp.nee_boundary_term(
        (v0, v1, v2), lights, pts, torch.from_numpy(n_s),
        torch.from_numpy(alb), torch.from_numpy(hit_idx),
        *(torch.from_numpy(x) for x in u), RenderConfig(**kw),
        torch.from_numpy(hit))
    assert (term == 0.0).all() and (np.asarray(jterm) == 0.0).all()
    got = torch.autograd.grad((term * torch.from_numpy(w)).sum(),
                              [verts, pts])
    for g, want_g in zip(got, want):
        want_g = np.asarray(want_g)
        scale = np.abs(want_g).max()
        assert scale > 0
        np.testing.assert_allclose(g.numpy(), want_g, rtol=0,
                                   atol=GRAD_RTOL * scale)


# ---- the residual and the wavefront with vis_grad ----


@pytest.mark.parametrize("est", ["nee", "bsdf"])
def test_residual_forward_is_exactly_zero(est):
    """The residual walk's radiance is exactly zero (not only the
    autograd Function's, which returns zeros by construction)."""
    cfg = _cfg(est)
    scene, cam = _port_scene(), Camera.default(CPU)
    o, d = generate_rays(cam, cfg.width, cfg.height)
    out = trace_mean_radiance(scene, o, d, cfg, SEED, vis_residual=True)
    assert out.shape == (cfg.width * cfg.height, 3)
    assert (out == 0.0).all()
    img = render_vis_residual(scene, cam, cfg, SEED)
    assert img.shape == (cfg.height, cfg.width, 3) and (img == 0.0).all()
    with pytest.raises(ValueError, match="vis_grad"):
        render_vis_residual(scene, cam, cfg.replace(vis_grad=False), SEED)


@pytest.mark.parametrize("est", ["nee", "bsdf"])
def test_residual_grads_match_jax(jax_refs, est):
    """Vertex and camera gradients of ``render_vis_residual`` within
    1e-5·max of ``jax.grad`` of JAX's; the albedo gradient is zero in
    both (the visibility terms detach it)."""
    got = _port_grads(render_vis_residual, _cfg(est))
    want = jax_refs[("residual", est)]
    assert np.abs(want[0]).max() > 0 and not want[1].any()
    _assert_grads(got, want, f"residual {est}")


def test_wavefront_vis_grads_match_jax(jax_refs):
    """The wavefront with ``vis_grad`` and NEE: vertex, albedo and camera
    gradients within 1e-5·max of JAX's."""
    got = _port_grads(render_radiance, _cfg("nee"))
    _assert_grads(got, jax_refs[("wavefront", "nee")], "wavefront")


@pytest.mark.parametrize("est,size", [("nee", "16x8"), ("bsdf", "16x8"),
                                      ("nee", "64x48")])
def test_decomposition_is_exact(est, size):
    """grad(interior) + grad(residual) == grad(wavefront with vis_grad),
    within 1e-5·max: all three replay the same paths (the edge draws sit
    after every other draw slot), and the residual's O(1) distance is the
    sweep's to the bit, so its edge samples start where the wavefront's
    do. At 64x48 (the port alone, no JAX reference) the JAX package's
    division order for that distance moves the vertex and camera
    gradients by 13% and 9% of their max (edge samples flip their
    validity on a few lanes). The residual is not trivial."""
    width, height = (int(x) for x in size.split("x"))
    cfg = _cfg(est, width=width, height=height)
    wts = np.random.Generator(np.random.Philox(12)).uniform(
        0.1, 1.0, (height, width, 3)).astype(np.float32)
    total = _port_grads(render_radiance, cfg, wts=wts)
    interior = _port_grads(render_radiance, cfg.replace(vis_grad=False),
                           wts=wts)
    residual = _port_grads(render_vis_residual, cfg, wts=wts)
    _assert_grads([i + r for i, r in zip(interior, residual)], total,
                  f"decomposition {est}")
    assert np.abs(residual[0]).max() > 1e-3 * np.abs(total[0]).max()


def test_residual_slices_give_the_unsliced_gradient(monkeypatch):
    """The residual's backward in slices of VIS_CHUNK rays (patched to 40,
    so the 128-ray frame takes 4 slices, the last ragged), keyed by their
    global pixel ids, gives the unsliced gradient within sum-order noise."""
    cfg = _cfg("nee")
    whole = _port_grads(render_vis_residual, cfg)
    monkeypatch.setattr(pathtracer, "VIS_CHUNK", 40)
    sliced = _port_grads(render_vis_residual, cfg)
    _assert_grads(sliced, whole, "sliced")


def test_hits_replay_gives_the_same_residual_gradients():
    """``quality_hits_plain``'s export (K11's plain version) replayed by
    the residual gives its own sweeps' gradients to the bit; lanes whose
    path ended hold (BIG, -1)."""
    scene, cam = _port_scene(), Camera.default(CPU)
    for est in ("nee", "bsdf"):
        cfg = _cfg(est, rr_start=1)
        o, d, keys = mq.pack_rays(cam, cfg, SEED)
        out, dist, idx = bq.quality_hits_plain(
            o, d, keys, mq.quality_table(scene), mq.light_rows(scene),
            cfg.replace(vis_grad=False))
        assert dist.shape == idx.shape == (cfg.spp, cfg.max_bounces,
                                           o.shape[0])
        assert idx.dtype == torch.int32
        ended = idx < 0
        assert ended.any() and (~ended).any()
        assert (dist[ended] == bq.BIG).all()
        # the bounce after a miss or the roulette's end is a miss too
        assert not (ended[:, :-1] & ~ended[:, 1:]).any()
        own = _port_grads(render_vis_residual, cfg)
        replay = _port_grads(
            lambda s, c, f, seed: render_vis_residual(s, c, f, seed,
                                                      hits=(dist, idx)),
            cfg)
        for a, b in zip(own, replay):
            np.testing.assert_array_equal(a, b)
        assert np.abs(own[0]).max() > 0


def test_forward_with_vis_grad_is_bit_equal():
    """``vis_grad`` changes no frame: the wavefront and the kernels' plain
    versions (K1, K3) give the frame without it, bit for bit."""
    scene, cam = _port_scene(), Camera.default(CPU)
    for est in ("nee", "bsdf"):
        cfg = _cfg(est)
        assert torch.equal(render_pt(scene, cam, cfg),
                           render_pt(scene, cam, cfg.replace(vis_grad=False)))
        o, d, keys = mq.pack_rays(cam, cfg, SEED)
        tri = mq.quality_table(scene)
        assert torch.equal(mq.quality_plain(o, d, keys, tri, None, cfg),
                           mq.quality_plain(o, d, keys, tri, None,
                                            cfg.replace(vis_grad=False)))
    conf = RenderConfig(width=16, height=8, spp=2, vis_grad=True)
    o, d, seeds = mk.pack_rays(cam, conf, 0)
    tri = mk.scene_table(scene)
    assert torch.equal(mk.megakernel_plain(o, d, seeds, tri, conf),
                       mk.megakernel_plain(o, d, seeds, tri,
                                           conf.replace(vis_grad=False)))
    assert torch.equal(render_pt_fast(scene, cam, conf),
                       render_pt_fast(scene, cam,
                                      conf.replace(vis_grad=False)))


def test_wavefront_checkpoints_samples_above_eight():
    """Above 8 samples with ``cfg.remat`` each sample is checkpointed;
    the gradient is the unchecked one, to the bit."""
    cfg = _cfg("nee", spp=9, max_bounces=2, width=16, height=8)
    a = _port_grads(render_radiance, cfg)
    b = _port_grads(render_radiance, cfg.replace(remat=False))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# ---- routing, with a faked CUDA device ----


def _as_if_on_cuda(monkeypatch):
    """Scenes and cameras report a CUDA device; the CPU-only plain
    versions may not be reached; the kernels' differentiable renders, the
    hit export, the residual and the wavefront only record their calls."""
    cuda = torch.device("cuda", 0)
    monkeypatch.setattr(Scene, "device", property(lambda self: cuda))
    monkeypatch.setattr(Camera, "device", property(lambda self: cuda))

    def forbidden(*args, **kw):
        raise AssertionError("plain version reached for a CUDA scene")

    for module, name in ((mk, "megakernel_plain"), (mg, "mega_bwd_plain"),
                         (mq, "quality_plain"), (mqg, "quality_bwd_plain"),
                         (bq, "quality_hits_plain")):
        monkeypatch.setattr(module, name, forbidden)
    calls = []

    def kernel(tag):
        def render(scene, camera, cfg, seed=0, **kw):
            calls.append((tag, scene.n_tris, cfg.vis_grad,
                          kw.get("hits") is not None))
            img = torch.zeros((cfg.height, cfg.width, 3), requires_grad=True)
            return (img, ("dist", "idx")) if tag == "K11+K10" else img
        return render

    for module, name, tag in (
            (mg, "render_radiance_mega", "K1+K2"),
            (bg, "render_radiance_bigscene_grad", "K6+K8"),
            (mqg, "render_radiance_quality_grad", "K3+K4"),
            (bqg, "render_radiance_bigscene_quality_grad", "K9+K10"),
            (bqg, "render_bigscene_quality_with_hits", "K11+K10"),
            (pathtracer, "render_vis_residual", "residual"),
            (pathtracer, "render_radiance", "wavefront")):
        monkeypatch.setattr(module, name, kernel(tag))
    return calls


@pytest.mark.parametrize("case", [
    ("conformance", 7, 2, "K1+K2"), ("conformance", 1100, 2, "K6+K8"),
    ("quality", 7, 2, "K3+K4"), ("quality", 200, 8, "K11+K10"),
    ("quality", 200, 9, "K9+K10")])
def test_routing_sends_vis_grad_to_the_kernel_interiors(monkeypatch, case):
    """On a CUDA device a ``vis_grad`` gradient goes to
    ``VisGradFusedRenderer``: the interior on K1+K2, K6+K8, K3+K4 or, above
    64 triangles, the streamed quality kernels, at up to 8 samples through
    K11, whose hits the residual replays; the residual without
    ``vis_grad`` in the interior's config. The frame goes to the forward
    kernel."""
    est, n_tris, spp, interior = case
    scene = (default_scene(CPU) if n_tris == 7
             else procedural_scene(n_tris, seed=1, device=CPU))
    calls = _as_if_on_cuda(monkeypatch)
    kw = (dict(rng="hash", sampler="cosine", nee=True) if est == "quality"
          else {})
    cfg = RenderConfig(width=8, height=4, spp=spp, vis_grad=True, **kw)
    assert renderer.grad_renderer(scene, cfg).name == "visgrad"
    assert renderer.grad_renderer(
        scene, cfg.replace(vis_grad=False)).name != "visgrad"
    render_radiance_fastgrad(scene, Camera.default(CPU), cfg)
    assert calls == [(interior, n_tris, False, False),
                     ("residual", n_tris, True, interior == "K11+K10")]


def test_routing_sends_what_no_kernel_takes_to_the_wavefront(monkeypatch):
    """On a CUDA device the wavefront (its sweeps on K5) takes the
    estimators no fused kernel takes (hash with the uniform or angle
    sampler), gradients deeper than the backward kernels' 64 bounces, and
    ``vis_grad`` over such an interior; the frames of the kernels'
    estimators stay on the kernels at any depth."""
    scene, cam = default_scene(CPU), Camera.default(CPU)
    calls = _as_if_on_cuda(monkeypatch)
    base = RenderConfig(width=8, height=4, spp=1)
    quality = base.replace(rng="hash", sampler="cosine", nee=True)
    cases = [(base.replace(rng="hash", sampler="uniform", nee=True), True),
             (base.replace(rng="hash"), True),
             (base.replace(max_bounces=65), False),
             (quality.replace(max_bounces=65), False),
             (quality.replace(sampler="uniform", vis_grad=True), True),
             (quality.replace(max_bounces=65, vis_grad=True), False)]
    for cfg, forward_too in cases:
        assert renderer.grad_renderer(scene, cfg).name == "wavefront", cfg
        assert (renderer.forward_renderer(scene, cfg).name
                == "wavefront") == forward_too, cfg
        render_radiance_fastgrad(scene, cam, cfg)
    assert [c[0] for c in calls] == ["wavefront"] * len(cases)
    assert renderer.grad_renderer(
        scene, quality.replace(max_bounces=64)).name == "quality"


# ---- the plain backward versions deeper than 16 bounces ----


DEEP = dict(width=8, height=4, spp=1)


@pytest.mark.parametrize("bounces", [17, 32])
def test_conformance_plain_backward_deep_matches_jax(bounces):
    """``mega_bwd_plain`` at 17 and 32 bounces against JAX's ``_bwd_tile``
    run op by op on the same rays, seeds, table and cotangent, within
    tests/test_torch_megakernel_grad.py's cross-program bound,
    0.03·max|grad|; K2 and K8 take these depths on the card."""
    size = dict(DEEP, max_bounces=bounces)
    js = j_default_scene()
    jcfg = JConfig(**size)
    rays, seeds, n = jmk.pack_rays(JCamera.default(), jcfg, 0)
    wts = np.random.Generator(np.random.Philox(3)).uniform(
        0.1, 1.0, (3, n)).astype(np.float32)
    gbar = jnp.concatenate([jnp.asarray(wts), jnp.zeros((1, n))], axis=0)
    with jax.disable_jit():
        rows, _ = jmg._bwd_tile(rays[:, :n], seeds[:, :n],
                                jmk._scene_table(js), gbar, cfg=jcfg,
                                n_tris=js.n_tris)
    want = np.asarray(jnp.sum(rows, axis=1))[:js.n_tris * 18].reshape(-1, 18)
    cfg = RenderConfig(**size)
    assert mg.supported_grad(default_scene(CPU), cfg)
    o, d, s = mk.pack_rays(Camera.default(CPU), cfg, 0)
    got = mg.mega_bwd_plain(o, d, s, mk.scene_table(default_scene(CPU)),
                            torch.from_numpy(wts.T.copy()), cfg).numpy()
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=0.03 * scale)


@pytest.mark.parametrize("bounces", [17, 32])
def test_quality_plain_backward_deep_matches_jax(bounces):
    """``quality_bwd_plain`` at 17 and 32 bounces (NEE, MIS, roulette from
    bounce 3) against JAX's ``_bwd_tile_quality(unroll_samples=True)`` run
    op by op, each column group and the ray adjoint within
    tests/test_torch_megakernel_quality.py's 2e-6·max; K4 and K10 take
    these depths on the card."""
    size = dict(DEEP, max_bounces=bounces, rng="hash", sampler="cosine",
                nee=True, mis=True, rr_start=3)
    js = j_default_scene()
    jcfg = JConfig(**size, intersect="pluecker")
    rays, pix, n = jmk.pack_rays(JCamera.default(), jcfg, 0)
    rays, pix = rays[:, :n], pix[:, :n]
    keys = jnp.uint32(5) * jmq._GOLD + pix
    wts = np.random.Generator(np.random.Philox(9)).uniform(
        0.1, 1.0, (3, n)).astype(np.float32)
    gbar = jnp.concatenate([jnp.asarray(wts), jnp.zeros((1, n))], axis=0)
    with jax.disable_jit():
        rows, grays = jmqg._bwd_tile_quality(
            rays, keys, jmq.quality_table(js), gbar, cfg=jcfg,
            n_tris=js.n_tris, unroll_samples=True, light_rows=js.light_idx)
    want = np.asarray(jnp.sum(rows, axis=1))[:js.n_tris * 19].reshape(-1, 19)
    cfg = RenderConfig(**size)
    ps = default_scene(CPU)
    assert mqg.supported_grad(ps, cfg)
    o, d, k = mq.pack_rays(Camera.default(CPU), cfg, 5)
    gtab, gray = mqg.quality_bwd_plain(
        o, d, k, mq.quality_table(ps), mq.light_rows(ps),
        torch.from_numpy(wts.T.copy()), cfg)
    got, want_rays = gtab.numpy(), np.asarray(grays)[:6].T
    scale = np.abs(want).max()
    assert scale > 0
    for a, b in ((0, 9), (9, 12), (12, 15), (15, 18), (18, 19)):
        np.testing.assert_allclose(got[:, a:b], want[:, a:b], rtol=0,
                                   atol=2e-6 * scale)
    np.testing.assert_allclose(gray.numpy(), want_rays, rtol=0,
                               atol=2e-6 * np.abs(want_rays).max())
