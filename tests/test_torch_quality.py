"""The quality estimator's wavefront on the CPU (``rng="hash"``,
``sampler="cosine"``): frames and gradients against the JAX package's
``render_radiance`` run op by op (``jax.disable_jit``; jitted, JAX's CPU
programs round some multiply-adds otherwise and flip paths), and the
CLI's ``--mode quality``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spath_tpu.camera import Camera as JCamera  # noqa: E402
from spath_tpu.config import RenderConfig as JConfig  # noqa: E402
from spath_tpu.models.pathtracer import (  # noqa: E402
    render_radiance as j_render_radiance,
)
from spath_tpu.scene import Scene as JScene  # noqa: E402
from spath_tpu.scene import default_scene as j_default_scene  # noqa: E402
from spath_tpu_torch import cli  # noqa: E402
from spath_tpu_torch.camera import Camera, generate_rays  # noqa: E402
from spath_tpu_torch.config import RenderConfig  # noqa: E402
from spath_tpu_torch.models.pathtracer import (  # noqa: E402
    render_pt_fast, render_radiance, trace_radiance,
)
from spath_tpu_torch.scene import Scene, default_scene  # noqa: E402
from spath_tpu_torch.utils.image import read_png, to_rgb_u8  # noqa: E402

CPU = torch.device("cpu")
SIZE = dict(width=16, height=12, spp=2, max_bounces=4, rng="hash",
            sampler="cosine")
SEED = 3


@pytest.mark.parametrize("nee,mis,rr,strat", [
    (False, False, 0, False), (True, False, 0, False),
    (True, True, 0, False), (False, False, 2, False),
    (True, True, 2, False), (True, True, 0, True), (True, True, 1, True),
])
def test_wavefront_matches_jax(nee, mis, rr, strat):
    """The grid of tests/test_megakernel_quality.py against JAX's
    wavefront on the same scene, camera and seed, to the bit (both run op
    by op; the two libraries' trig may differ in the last bit, so the
    stated bound is the flip budget, under 1% of pixels off by 1e-4, and
    1e-6 elsewhere); observed: bit-exact."""
    kw = dict(SIZE, nee=nee, mis=mis, rr_start=rr, stratify=strat)
    with jax.disable_jit():
        want = np.asarray(j_render_radiance(
            j_default_scene(), JCamera.default(),
            JConfig(**kw, intersect="reference"), SEED))
    got = render_radiance(default_scene(CPU), Camera.default(CPU),
                          RenderConfig(**kw), SEED).numpy()
    assert want.max() > 0.1
    diff = np.abs(got - want)
    flipped = (diff > 1e-4).any(-1)
    assert flipped.mean() < 0.01
    assert diff[~flipped].max() <= 1e-6


def test_trace_radiance_keys_streams_by_pixel_id():
    """One sample traced with explicit global pixel ids draws the streams
    of those pixels: a frame traced in two halves equals the whole."""
    cfg = RenderConfig(**SIZE, nee=True)
    o, d = generate_rays(Camera.default(CPU), 16, 12)
    scene = default_scene(CPU)
    whole, state = trace_radiance(scene, o, d, cfg, 2**31 + 5,
                                  sample_idx=1)
    ids = torch.arange(192)
    halves = [trace_radiance(scene, o[sl], d[sl], cfg, 2**31 + 5, ids[sl],
                             sample_idx=1)[0]
              for sl in (slice(0, 100), slice(100, 192))]
    assert state == 2**31 + 5
    assert torch.equal(whole, torch.cat(halves))
    assert whole.max() > 0.1


def test_wavefront_grads_match_jax():
    """Vertex, albedo, emission and camera-position gradients of a
    weighted NEE+MIS frame (16×12, 2 spp) against ``jax.grad`` of JAX's
    ``render_radiance`` run op by op: the same program, so the bound is
    sum-order noise, 1e-5·max|grad|. NEE makes the vertex and camera
    gradients smooth and non-zero."""
    kw = dict(SIZE, nee=True, max_bounces=3)
    wts = np.random.Generator(np.random.Philox(7)).uniform(
        0.1, 1.0, (12, 16, 3)).astype(np.float32)
    js = j_default_scene()
    jcam = JCamera.default()

    def loss(vertices, albedo, emission, pos):
        img = j_render_radiance(JScene(vertices, albedo, emission),
                                JCamera(pos, jcam.angle, jcam.focal),
                                JConfig(**kw, intersect="reference"), SEED)
        return jnp.sum(img * wts)

    with jax.disable_jit():
        want = jax.grad(loss, argnums=(0, 1, 2, 3))(
            js.vertices, js.albedo, js.emission, jcam.pos)
    base, cam = default_scene(CPU), Camera.default(CPU)
    leaves = [t.clone().requires_grad_() for t in
              (base.vertices, base.albedo, base.emission, cam.pos)]
    img = render_radiance(Scene(*leaves[:3], base.light_idx),
                          Camera(leaves[3], cam.angle, cam.focal),
                          RenderConfig(**kw), SEED)
    got = torch.autograd.grad((img * torch.from_numpy(wts)).sum(), leaves)
    for name, g, w in zip(("vertices", "albedo", "emission", "camera"), got,
                          want):
        w = np.asarray(w)
        scale = np.abs(w).max()
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * scale,
                                   err_msg=name)


def test_pose_recovery_on_silhouette_free_scene():
    """The port's counterpart of tests/test_inverse.py::test_pose_recovery
    in the hash stream, cut to 3 steps: on tests/test_nee.py's scene with
    no silhouette in view, the camera 0.4 behind the truth and only the
    pose group free, every step lowers the loss and moves the camera
    toward the truth."""
    from spath_tpu_torch.convert import scene_from_numpy
    from spath_tpu_torch.models.inverse import (
        InverseParams, init_state, make_train_step, param_group_optimizer,
    )
    from tests.test_nee import _wall_and_light_scene

    js = _wall_and_light_scene()
    scene = scene_from_numpy(*(np.asarray(a) for a in
                               (js.vertices, js.albedo, js.emission)),
                             device=CPU)
    cfg = RenderConfig(width=32, height=24, spp=4, max_bounces=2,
                       rng="hash", sampler="cosine", nee=True)
    cam = Camera.default(CPU)
    target = render_radiance(scene, cam, cfg, 100)
    start = cam.pos + torch.tensor([0.0, 0.0, -0.4])
    state = init_state(
        param_group_optimizer(freeze_pose=False, freeze_albedo=True,
                              pose_lr=1e-2),
        InverseParams(start, cam.angle, cam.focal, scene.albedo))
    step = make_train_step(scene, cfg, fixed_seed=100)
    losses, z_err = [], [0.4]
    for _ in range(3):
        state, aux = step(state, target)
        losses.append(float(aux["loss"]))
        z_err.append(abs(state.params.cam_pos[2].item() + 3.0))
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    assert all(b < a for a, b in zip(z_err, z_err[1:])), z_err



def test_a_camera_move_from_the_truth_changes_edge_pixels_as_in_jax():
    """Why a pose step from the true camera raises the loss on the default
    scene whatever the rate: at the true camera the paths of some pixels
    run exactly along edges two triangles share (scene and camera are
    symmetric), and moving the camera by 1e-6 along x sends them onto the
    other triangle. The JAX package's frames (op by op) change in the same
    pixels as the port's, and the frames agree within
    test_wavefront_matches_jax's bounds."""
    kw = dict(SIZE, spp=1, max_bounces=2, nee=True, mis=True)
    pos = np.array([1e-6, 0.0, -3.0], np.float32)
    jcam, cam = JCamera.default(), Camera.default(CPU)
    with jax.disable_jit():
        want = [np.asarray(j_render_radiance(
            j_default_scene(), c, JConfig(**kw, intersect="reference"), SEED))
            for c in (jcam, JCamera(jnp.asarray(pos), jcam.angle,
                                    jcam.focal))]
    got = [render_radiance(default_scene(CPU), c, RenderConfig(**kw),
                           SEED).numpy()
           for c in (cam, Camera(torch.from_numpy(pos), cam.angle,
                                 cam.focal))]
    for g, w in zip(got, want):
        diff = np.abs(g - w)
        flipped = (diff > 1e-4).any(-1)
        assert flipped.mean() < 0.01 and diff[~flipped].max() <= 1e-6
    changed = (np.abs(got[1] - got[0]) > 1e-3).any(-1)
    assert changed.any() and changed.mean() < 0.05
    np.testing.assert_array_equal(
        changed, (np.abs(want[1] - want[0]) > 1e-3).any(-1))


@pytest.mark.parametrize("pose_lr", [0.0, 1e-5, 1e-3])
def test_pose_steps_from_the_true_camera(pose_lr):
    """Three quality train steps through the wavefront's autograd (no
    fused kernel) with the albedo perturbed as the CLI does and the pose
    group at ``pose_lr`` (1e-3 is the JAX package's default), from the
    true camera. At rate 0 the loss falls; at any other rate the first
    pose step raises it, by about as much at 1e-5 as at 1e-3: the jump of
    the edge pixels above, which the gradient without vis_grad does not
    see, not a step too long. chip_smoke.py's quality training runs at
    rate 0 for this reason."""
    from spath_tpu_torch.models.inverse import (
        InverseParams, init_state, make_train_step, param_group_optimizer,
    )

    cfg = RenderConfig(**dict(SIZE, width=24, height=16, spp=4,
                              max_bounces=3, nee=True, mis=True))
    scene, cam = default_scene(CPU), Camera.default(CPU)
    target = render_radiance(scene, cam, cfg, 0)
    albedo = scene.albedo.numpy()
    bad = np.clip(albedo + np.random.default_rng(1).uniform(
        -0.4, 0.4, albedo.shape).astype(np.float32), 0.05, 1.0)
    state = init_state(param_group_optimizer(pose_lr=pose_lr),
                       InverseParams(cam.pos, cam.angle, cam.focal,
                                     torch.from_numpy(bad)))
    step = make_train_step(scene, cfg, fixed_seed=0)
    losses = []
    for _ in range(3):
        state, aux = step(state, target)
        losses.append(float(aux["loss"]))
    moved = (state.params.cam_pos - cam.pos).abs().max().item()
    if pose_lr == 0.0:
        assert moved == 0.0
        assert losses[2] < losses[1] < losses[0], losses
    else:
        assert 0.0 < moved <= 3 * pose_lr * 1.01
        assert losses[1] > 1.5 * losses[0], losses

def test_cli_render_quality_on_cpu(tmp_path):
    out = tmp_path / "q.png"
    assert cli.main(["render", "--mode", "quality", "--size", "16x12",
                     "--spp", "2", "--bounces", "3", "--rr-start", "1",
                     "--stratify", "--device", "cpu", "--out",
                     str(out)]) == 0
    img = read_png(str(out))
    assert img.shape == (12, 16, 3) and img.max() > 100
    cfg = RenderConfig(width=16, height=12, spp=2, max_bounces=3,
                       rng="hash", sampler="cosine", nee=True, rr_start=1,
                       stratify=True)
    want = render_pt_fast(default_scene(CPU), Camera.default(CPU), cfg, 0)
    np.testing.assert_array_equal(img, to_rgb_u8(want.numpy()))


def test_cli_invert_quality_on_cpu(capsys):
    assert cli.main(["invert", "--mode", "quality", "--size", "16x12",
                     "--spp", "2", "--bounces", "3", "--steps", "3",
                     "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    err0, err1 = (float(x) for x in
                  line.split("albedo error ")[1].split(";")[0].split(" -> "))
    assert err1 < err0


@pytest.mark.parametrize("argv, error", [
    (["--mode", "quality", "--rng", "table"], SystemExit),
    (["--rr-start", "2"], SystemExit),
    (["--stratify"], SystemExit),
    (["--mode", "quality", "--rng", "threefry"], None),
    (["--rng", "table"], None),
])
def test_cli_refusals(argv, error, tmp_path):
    """The JAX CLI's refusals, nothing written. The threefry and table
    streams, which this test once held to ``NotImplementedError``, render:
    the PNG is the serving path's frame of the config the JAX CLI builds
    (``--mode quality --rng threefry``: threefry, cosine, NEE; ``--rng
    table``: table, angle sampler), u8 for u8."""
    out = tmp_path / "x.png"
    run = ["render", "--size", "8x4", "--spp", "1", "--device", "cpu",
           "--out", str(out), *argv]
    if error is not None:
        with pytest.raises(error):
            cli.main(run)
        assert not out.exists()
        return
    assert cli.main(run) == 0
    quality = "quality" in argv
    cfg = RenderConfig(width=8, height=4, spp=1, intersect="pluecker",
                       rng=argv[-1], sampler="cosine" if quality else
                       "angle", nee=quality)
    want = render_pt_fast(default_scene(CPU), Camera.default(CPU), cfg, 0)
    np.testing.assert_array_equal(read_png(str(out)),
                                  to_rgb_u8(want.numpy()))
