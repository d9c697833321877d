"""The port's slice as a whole on the CPU: the flat view, the wavefront
and the serving path ``render_pt_fast`` against the JAX package; the
routing, which never takes the CUDA kernel for CPU tensors; configs that
are not ported; and the CLI."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spath_tpu.camera import Camera as JCamera  # noqa: E402
from spath_tpu.config import RenderConfig as JConfig  # noqa: E402
from spath_tpu.models.flat import render_flat as j_render_flat  # noqa: E402
from spath_tpu.models.pathtracer import (  # noqa: E402
    render_pt_jit as j_render_pt, trace_radiance as j_trace_radiance,
)
from spath_tpu.camera import generate_rays as j_generate_rays  # noqa: E402
from spath_tpu.scene import default_scene as j_default_scene  # noqa: E402
from spath_tpu.utils.image import to_rgb_u8 as j_to_rgb_u8  # noqa: E402
from spath_tpu_torch import cli  # noqa: E402
from spath_tpu_torch.camera import Camera, generate_rays  # noqa: E402
from spath_tpu_torch.config import RenderConfig  # noqa: E402
from spath_tpu_torch.convert import camera_from_numpy  # noqa: E402
from spath_tpu_torch.models import pathtracer, renderer  # noqa: E402
from spath_tpu_torch.models.flat import render_flat  # noqa: E402
from spath_tpu_torch.models.pathtracer import (  # noqa: E402
    render_pt, render_pt_fast, render_radiance, trace_radiance,
)
from spath_tpu_torch.ops.kernels import bigscene, megakernel  # noqa: E402
from spath_tpu_torch.ops.rng import pixel_seeds  # noqa: E402
from spath_tpu_torch.scene import Scene, default_scene  # noqa: E402
from spath_tpu_torch.scene import procedural_scene  # noqa: E402
from spath_tpu_torch.utils.image import read_png, to_rgb_u8  # noqa: E402

CPU = torch.device("cpu")
#: the frame of tests/test_pallas.py's kernel-vs-wavefront check
SIZE = dict(width=48, height=32, spp=3, max_bounces=5)


def _j_camera(pos, angle, focal):
    return JCamera(pos=jnp.asarray(pos, jnp.float32),
                   angle=jnp.asarray(angle, jnp.float32),
                   focal=jnp.float32(focal))


@pytest.mark.parametrize("pose", [
    ((0.0, 0.0, -3.0), (0.0, 0.0, 0.0), 2.0),
    ((0.3, 0.1, -2.0), (0.1, -0.2, 0.0), 1.5),
])
def test_render_flat_u8_exact(pose):
    """Against the JAX function run op by op: under ``jax.jit`` XLA fuses
    the sweep and rounds some multiply-adds once, which moves a few edge
    pixels."""
    cfg = dict(width=40, height=30, spp=1)
    want = j_to_rgb_u8(np.asarray(j_render_flat(
        j_default_scene(), _j_camera(*pose), JConfig(**cfg))))
    got = to_rgb_u8(render_flat(default_scene(CPU),
                                camera_from_numpy(*pose, device=CPU),
                                RenderConfig(**cfg)).numpy())
    np.testing.assert_array_equal(got, want)
    assert (got == [255, 0, 0]).all(-1).any()          # red triangle
    assert (got == [0, 0, 0]).all(-1).any()            # background


@pytest.fixture(scope="module")
def jax_pt():
    """JAX ``render_pt`` of the default scene and camera, seed 3."""
    return np.asarray(j_render_pt(j_default_scene(), JCamera.default(),
                                  JConfig(**SIZE), 3))


def _assert_conforms(got, want):
    """The kernel-vs-wavefront bounds of tests/test_pallas.py: under 1% of
    pixels off by more than 1e-4 (trig-ulp path flips), mean within 5%."""
    assert got.shape == want.shape
    flipped = (np.abs(got - want) > 1e-4).any(-1)
    assert flipped.mean() < 0.01, f"{flipped.mean():.4f} flipped"
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=5e-2)


def test_render_pt_fast_cpu_matches_jax_render_pt(jax_pt):
    """The slice as a whole: the serving entry point on CPU tensors."""
    got = render_pt_fast(default_scene(CPU), Camera.default(CPU),
                         RenderConfig(**SIZE), 3)
    assert got.dtype == torch.float32 and got.shape == (32, 48, 3)
    assert 0.0 <= got.min() and got.max() <= 1.0 and got.max() > 0.1
    _assert_conforms(got.numpy(), jax_pt)


def test_render_pt_and_radiance_match(jax_pt):
    scene, cam, cfg = default_scene(CPU), Camera.default(CPU), \
        RenderConfig(**SIZE)
    pt = render_pt(scene, cam, cfg, 3)
    _assert_conforms(pt.numpy(), jax_pt)
    assert torch.equal(pt, render_radiance(scene, cam, cfg, 3).clamp(0, 1))


def test_trace_radiance_one_sample_matches():
    """One sample: radiance and the LCG state after it (advanced twice
    per hit), against JAX on the same rays and seeds."""
    cfg = dict(width=32, height=16, spp=1, max_bounces=5)
    jo, jd = j_generate_rays(JCamera.default(), 32, 16)
    trace = jax.jit(j_trace_radiance, static_argnames=("cfg",))
    j_rad, j_state = trace(
        j_default_scene(), jo, jd, JConfig(**cfg),
        jnp.arange(512, dtype=jnp.uint32) + jnp.uint32(9))
    o, d = generate_rays(Camera.default(CPU), 32, 16)
    rad, state = trace_radiance(default_scene(CPU), o, d, RenderConfig(**cfg),
                                pixel_seeds(512, 9, device=CPU))
    same = state.numpy().astype(np.uint32) == np.asarray(j_state)
    assert same.mean() > 0.99 and (state.numpy() != np.arange(512) + 9).any()
    _assert_conforms(rad.numpy(), np.asarray(j_rad))


@pytest.mark.parametrize("kw", [
    dict(rng="threefry"), dict(rng="threefry", sampler="cosine", nee=True),
    dict(rng="table"), dict(rng="table", sampler="cosine"),
    dict(rng="threefry", rr_start=2), dict(vis_grad=True),
    dict(rng="hash", sampler="cosine", nee=True, vis_grad=True),
    dict(rng="table", nee=True),
])
def test_unported_configs_raise(kw):
    """The configs this test once held to ``NotImplementedError`` (its
    name is theirs): every stream is ported now. The threefry and table
    streams render through the serving path and the wavefront on the CPU,
    and match the JAX package's ``render_pt`` run op by op within
    ``_assert_conforms``' bounds; table with NEE raises the JAX package's
    ``ValueError``, as the JAX function does. Visibility gradients change
    no frame: with ``vis_grad`` both render the frame without it, bit for
    bit."""
    scene, cam = default_scene(CPU), Camera.default(CPU)
    cfg = RenderConfig(width=8, height=4, spp=1, **kw)
    if cfg.nee and cfg.rng == "table":
        for fn in (render_pt_fast, render_pt):
            with pytest.raises(ValueError, match="nee requires"):
                fn(scene, cam, cfg)
        with pytest.raises(ValueError, match="nee requires"), \
                jax.disable_jit():
            j_render_pt(j_default_scene(), JCamera.default(),
                        JConfig(width=8, height=4, spp=1, **kw), 0)
        return
    for fn in (render_pt_fast, render_pt):
        if cfg.vis_grad:
            assert torch.equal(fn(scene, cam, cfg),
                               fn(scene, cam, cfg.replace(vis_grad=False)))
            continue
        got = fn(scene, cam, cfg).numpy()
        with jax.disable_jit():
            want = np.asarray(j_render_pt(
                j_default_scene(), JCamera.default(),
                JConfig(width=8, height=4, spp=1, **kw), 0))
        _assert_conforms(got, want)
        assert got.max() > 0.0


def test_routing_keeps_cpu_tensors_off_the_kernel(monkeypatch):
    scene, cam = default_scene(CPU), Camera.default(CPU)
    cfg = RenderConfig(width=8, height=4, spp=1)
    mega = renderer.MegakernelRenderer()
    assert not mega.available(scene) and not mega.supports(scene, cfg)
    assert renderer.forward_renderer(scene, cfg).name == "wavefront"
    assert [r.name for r in renderer.REGISTRY] == [
        "compact_fused", "megakernel", "quality", "quality_bigscene",
        "bigscene", "visgrad", "compact", "wavefront"]

    def forbidden(*args, **kw):
        raise AssertionError("mega_call reached with CPU tensors")

    monkeypatch.setattr(megakernel, "mega_call", forbidden)
    render_pt_fast(scene, cam, cfg)


def _as_if_on_cuda(monkeypatch):
    """Scenes and cameras report a CUDA device; the kernel's entry point
    and the wavefront (on the card, its sweeps on K5) only record their
    calls, the wavefront's as ``("wavefront", T)``."""
    cuda = torch.device("cuda", 0)
    monkeypatch.setattr(Scene, "device", property(lambda self: cuda))
    monkeypatch.setattr(Camera, "device", property(lambda self: cuda))
    calls = []

    def wavefront(scene, camera, cfg, seed=0):
        calls.append(("wavefront", scene.n_tris))
        return torch.zeros((cfg.height, cfg.width, 3))

    monkeypatch.setattr(pathtracer, "render_radiance", wavefront)

    def kernel(scene, camera, cfg, seed=0):
        calls.append(scene.n_tris)
        return torch.zeros((cfg.height, cfg.width, 3))

    monkeypatch.setattr(megakernel, "render_radiance_megakernel", kernel)
    return calls


@pytest.mark.parametrize("n_tris", [7, 129, 512,
                                    renderer.SMEM_ROUTE_MAX_TRIS])
def test_routing_sends_cuda_scenes_to_the_kernel(monkeypatch, n_tris):
    """Every scene up to the K1/K6 crossover measured on the H100
    (``renderer.SMEM_ROUTE_MAX_TRIS``, K1's own cap since K1's lane loop)
    goes to the kernel on a CUDA device, above the JAX package's
    128-triangle crossover as well."""
    scene = (default_scene(CPU) if n_tris == 7
             else procedural_scene(n_tris, seed=1, device=CPU))
    cam = Camera.default(CPU)
    calls = _as_if_on_cuda(monkeypatch)
    cfg = RenderConfig(width=8, height=4, spp=1)
    # the wavefront runs on the card too, last, behind every kernel
    assert renderer.REGISTRY[-1].name == "wavefront"
    assert renderer.forward_renderer(scene, cfg).name == "megakernel"
    assert render_pt_fast(scene, cam, cfg).shape == (4, 8, 3)
    assert calls == [n_tris]


def test_routing_raises_for_cuda_scenes_without_a_kernel(monkeypatch):
    """No silent render past a cap on a CUDA device: a scene too big for
    every kernel (the fused K1 takes 1024 triangles, the streamed K6 2^20)
    names the streamed kernel's cap, which the wavefront on the card keeps.
    An estimator no fused kernel takes (hash with the angle sampler) goes
    to the wavefront on the card."""
    big = procedural_scene(bigscene.BIG_MAX_TRIS + 1, seed=1, device=CPU)
    small, cam = default_scene(CPU), Camera.default(CPU)
    calls = _as_if_on_cuda(monkeypatch)
    cfg = RenderConfig(width=8, height=4, spp=1)
    with pytest.raises(NotImplementedError, match="K6"):
        render_pt_fast(big, cam, cfg)
    assert calls == []
    assert renderer.forward_renderer(
        small, cfg.replace(rng="hash")).name == "wavefront"
    render_pt_fast(small, cam, cfg.replace(rng="hash"))
    assert calls == [("wavefront", 7)]


def test_cli_device_cuda_without_card_exits_nonzero(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "frame.png"
    with pytest.raises(SystemExit) as exc:
        cli.main(["render", "--size", "16x8", "--spp", "1", "--device",
                  "cuda", "--out", str(out)])
    assert exc.value.code not in (0, None)
    assert not out.exists()


def test_cli_renders_on_cpu(tmp_path):
    flat = tmp_path / "flat.png"
    assert cli.main(["render", "--size", "40x30", "--flat", "--device",
                     "cpu", "--out", str(flat)]) == 0
    img = read_png(str(flat))
    assert img.shape == (30, 40, 3)
    for colour in ([255, 0, 0], [255, 255, 255], [0, 0, 0]):
        assert (img == colour).all(-1).any(), colour
    frame = tmp_path / "pt.ppm"
    assert cli.main(["render", "--size", "16x8", "--spp", "2", "--device",
                     "cpu", "--camera-angle", "0.05,0,0", "--out",
                     str(frame)]) == 0
    assert frame.read_bytes().startswith(b"P6\n16 8\n255\n")
