"""Inverse rendering in the port (BASELINE config 5) on the CPU: the train
step against the JAX package's on the same parameters and target, the
clip's gradient at its bounds, checkpoint round-trip, resume and
rollback, a conformance-mode albedo recovery, the multi-view loss, the
metrics log and the CLI's ``invert``."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spath_tpu.camera import Camera as JCamera  # noqa: E402
from spath_tpu.config import RenderConfig as JConfig  # noqa: E402
from spath_tpu.models import inverse as jinv  # noqa: E402
from spath_tpu.models.pathtracer import (  # noqa: E402
    render_radiance as j_render_radiance,
)
from spath_tpu.scene import default_scene as j_default_scene  # noqa: E402
from spath_tpu_torch import cli, convert  # noqa: E402
from spath_tpu_torch.camera import Camera  # noqa: E402
from spath_tpu_torch.config import RenderConfig  # noqa: E402
from spath_tpu_torch.models import inverse as inv  # noqa: E402
from spath_tpu_torch.models.pathtracer import render_radiance  # noqa: E402
from spath_tpu_torch.scene import default_scene  # noqa: E402
from spath_tpu_torch.utils.checkpoint import Checkpointer  # noqa: E402
from spath_tpu_torch.utils.logging import (  # noqa: E402
    JsonlLogger, global_norm,
)

CPU = torch.device("cpu")
#: conformance estimator at tests/test_grad.py's size
SIZE = dict(width=24, height=16, spp=4, rng="lcg", sampler="angle")
SMALL = dict(width=16, height=12, spp=2)
SEED = 100


def _perturbed(albedo):
    """The CLI's perturbation: uniform ±0.4 from ``default_rng(1)``,
    clipped to [0.05, 1]."""
    rng = np.random.default_rng(1)
    return np.clip(albedo + rng.uniform(-0.4, 0.4, albedo.shape)
                   .astype(np.float32), 0.05, 1.0)


def adam():
    """Adam over every parameter at one learning rate."""
    return inv.param_group_optimizer(pose_lr=1e-2, albedo_lr=1e-2)


def _start(size=SMALL):
    scene, cam = default_scene(CPU), Camera.default(CPU)
    target = render_radiance(scene, cam, RenderConfig(**size), SEED)
    return scene, cam, target


def test_train_step_matches_jax():
    """Three steps of ``make_train_step`` against the JAX package's, from
    the same perturbed parameters carried across by ``convert``, with
    ``param_group_optimizer(freeze_pose=True)`` and a fixed seed. The JAX
    step runs op by op (``jax.disable_jit``): jitted, it flips paths
    against the op-by-op target and its first loss comes out 2.5×
    larger. Bounds: losses 1e-5 relative, albedo 1e-5 absolute
    (observed 2.3e-6 and 6.6e-7 after the third step)."""
    js, jcam = j_default_scene(), JCamera.default()
    jcfg = JConfig(**SIZE)
    bad = _perturbed(np.asarray(js.albedo))
    with jax.disable_jit():
        target = np.asarray(j_render_radiance(js, jcam, jcfg, SEED))
        jparams = jinv.InverseParams(cam_pos=jcam.pos, cam_angle=jcam.angle,
                                     cam_focal=jcam.focal,
                                     albedo=jnp.asarray(bad))
        opt = jinv.param_group_optimizer(freeze_pose=True)
        jstate = jinv.init_state(opt, jparams)
        jstep = jinv.make_train_step(opt, js, jcfg, fixed_seed=SEED)
        want = []
        for _ in range(3):
            jstate, aux = jstep(jstate, jnp.asarray(target))
            want.append((float(aux["loss"]),
                         np.asarray(jstate.params.albedo)))

    params = convert.inverse_params_from_numpy(
        *(np.asarray(getattr(jparams, f))
          for f in ("cam_pos", "cam_angle", "cam_focal", "albedo")),
        device=CPU)
    state = inv.init_state(inv.param_group_optimizer(freeze_pose=True),
                           params)
    step = inv.make_train_step(default_scene(CPU), RenderConfig(**SIZE),
                               fixed_seed=SEED)
    pose = [t.clone() for t in (params.cam_pos, params.cam_angle,
                                params.cam_focal)]
    for want_loss, want_albedo in want:
        state, aux = step(state, torch.from_numpy(target.copy()))
        np.testing.assert_allclose(float(aux["loss"]), want_loss, rtol=1e-5)
        got = convert.inverse_params_to_numpy(state.params)
        np.testing.assert_allclose(got[3], want_albedo, rtol=0, atol=1e-5)
        assert float(aux["grad_norm"]) > 0
    assert state.step == 3
    for before, after in zip(pose, convert.inverse_params_to_numpy(
            state.params)[:3]):
        np.testing.assert_array_equal(after, before.numpy())


def test_clip_gradient_at_the_bounds_is_half():
    """``apply_params`` clips as ``jnp.clip`` differentiates: gradient
    0.5 at 0.0 and at 1.0 (``torch.clamp`` gives 1.0 there), 1 inside,
    0 outside."""
    values = np.array([[0.0, 1.0, 0.5], [-0.2, 1.3, 1.0], [0.0, 0.25, 0.0]],
                      np.float32)
    scene, cam = default_scene(CPU), Camera.default(CPU)
    x = torch.from_numpy(values.copy()).requires_grad_()
    params = inv.InverseParams(cam.pos, cam.angle, cam.focal, x)
    clipped, _ = inv.apply_params(params, scene)
    (g,) = torch.autograd.grad(clipped.albedo.sum(), [x])
    want = jax.grad(lambda a: jnp.sum(jnp.clip(a, 0.0, 1.0)))(
        jnp.asarray(values))
    np.testing.assert_array_equal(g.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        g.numpy(), [[0.5, 0.5, 1.0], [0.0, 0.0, 0.5], [0.5, 1.0, 0.5]])
    np.testing.assert_array_equal(clipped.albedo.detach().numpy(),
                                  np.clip(values, 0.0, 1.0))


def test_frozen_group_gets_no_update():
    """A frozen group is left out of the optimizer. (The conformance
    estimator gives the pose an exactly zero gradient, so only the albedo
    can move here.)"""
    scene, cam, target = _start()
    params = inv.InverseParams(cam.pos, cam.angle, cam.focal,
                               torch.from_numpy(_perturbed(
                                   scene.albedo.numpy())))
    step = inv.make_train_step(scene, RenderConfig(**SMALL), SEED)
    for kw, names in ((dict(freeze_pose=True), ["albedo"]),
                      (dict(freeze_albedo=True), ["pose"]),
                      ({}, ["pose", "albedo"])):
        state = inv.init_state(inv.param_group_optimizer(**kw), params)
        assert [g["name"] for g in state.optimizer.param_groups] == names
        state, aux = step(state, target)
        assert float(aux["grad_norm"]) > 0
        moved = not torch.equal(state.params.albedo, params.albedo)
        assert moved == ("albedo" in names), kw
        for name in ("cam_pos", "cam_angle", "cam_focal"):
            assert torch.equal(getattr(state.params, name),
                               getattr(params, name))
    with pytest.raises(ValueError):
        inv.param_group_optimizer(freeze_pose=True, freeze_albedo=True)


def test_checkpoint_roundtrip(tmp_path):
    scene, cam, target = _start()
    opt = adam()
    params = inv.InverseParams.init(scene, cam)
    state = inv.init_state(opt, params)
    step = inv.make_train_step(scene, RenderConfig(**SMALL))
    for _ in range(3):
        state, _ = step(state, target)

    ckpt = Checkpointer(str(tmp_path / "ck"))
    ckpt.save(state.step, state)
    assert ckpt.latest_step() == 3
    restored = ckpt.restore_latest(inv.init_state(opt, params))
    assert restored.step == 3
    for a, b in zip(restored.params.tensors().values(),
                    state.params.tensors().values()):
        assert torch.equal(a, b)
    for a, b in zip(restored.optimizer.state.values(),
                    state.optimizer.state.values()):
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a[k], b[k])
    # the restored state trains on exactly as the saved one
    s1, _ = step(state, target)
    s2, _ = step(restored, target)
    assert torch.equal(s1.params.albedo, s2.params.albedo)


def test_checkpointer_keeps_the_newest_and_writes_atomically(tmp_path):
    scene, cam, _ = _start()
    state = inv.init_state(adam(), inv.InverseParams.init(scene,
                                                                  cam))
    ckpt = Checkpointer(str(tmp_path), keep=3)
    assert ckpt.restore_latest(state) is None and ckpt.latest_step() is None
    for k in range(1, 6):
        ckpt.save(k, state._replace(step=k))
    assert ckpt.steps() == [3, 4, 5]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000003.pt", "step_00000004.pt", "step_00000005.pt"]


def _quiet(msg):
    pass


def test_recover_resumes_from_checkpoint(tmp_path):
    scene, cam, target = _start()
    params = inv.InverseParams.init(scene, cam)
    ckdir = str(tmp_path / "ck")
    cfg = RenderConfig(**SMALL)
    inv.recover(scene, target, params, cfg, adam(), steps=4,
                checkpoint_dir=ckdir, checkpoint_every=2, log_fn=_quiet)
    assert Checkpointer(ckdir).steps() == [2, 4]
    state2, losses2 = inv.recover(scene, target, params, cfg,
                                  adam(), steps=6, checkpoint_every=2,
                                  checkpoint_dir=ckdir, log_fn=_quiet)
    assert state2.step == 6
    assert len(losses2) == 2          # only the remaining steps ran


def test_elastic_recovery_from_injected_failure(tmp_path, monkeypatch):
    """A step that raises mid-run rolls back to the last checkpoint and
    the loop completes."""
    scene, cam, target = _start()
    params = inv.InverseParams.init(scene, cam)
    real_make = inv.make_train_step
    calls = {"n": 0}

    def flaky_make(*args, **kw):
        real_step = real_make(*args, **kw)

        def step(state, target):
            calls["n"] += 1
            if calls["n"] == 4:
                raise RuntimeError("injected device loss")
            return real_step(state, target)

        return step

    monkeypatch.setattr(inv, "make_train_step", flaky_make)
    log = []
    state, losses = inv.recover(
        scene, target, params, RenderConfig(**SMALL), adam(),
        steps=6, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2,
        max_retries=2, log_fn=log.append)
    assert state.step == 6
    # steps 1-3, the failed call, then steps 3-6 again from step 2
    assert calls["n"] == 8
    assert [m.split(":")[0] for m in log] == [
        "step 0", "step failed; rolled back to step 2 (1 retries left)",
        "step 5"]
    with pytest.raises(ValueError):
        inv.recover(scene, target, params, RenderConfig(**SMALL),
                    adam(), steps=1, max_retries=1)


def test_albedo_recovery_conformance():
    """Perturb the red triangle's and the back wall's albedo; 40 steps of
    descent through the conformance estimator at least halve the error
    (observed 0.611 → 0.114). The loss is logged at steps 0, 20 and 39."""
    size = dict(width=32, height=24, spp=4)
    scene, cam, target = _start(size)
    true = scene.albedo.numpy()
    bad = true.copy()
    bad[0] = [0.2, 0.6, 0.9]          # foreground triangle: truth (1,0,0)
    bad[5] = bad[6] = [0.3, 0.9, 0.2]  # wall: truth (1,1,1)
    log = []
    state, losses = inv.recover(
        scene, target, inv.InverseParams(cam.pos, cam.angle, cam.focal,
                                         torch.from_numpy(bad)),
        RenderConfig(**size),
        inv.param_group_optimizer(freeze_pose=True, albedo_lr=3e-2),
        steps=40, fixed_seed=SEED, log_fn=log.append)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    got = state.params.albedo.detach().numpy()
    err0 = np.abs(bad[[0, 5, 6]] - true[[0, 5, 6]]).mean()
    err1 = np.abs(got[[0, 5, 6]] - true[[0, 5, 6]]).mean()
    assert err1 < 0.5 * err0, (err0, err1)
    assert [m.split(":")[0] for m in log] == ["step 0", "step 20",
                                              "step 39"]
    assert log[-1] == f"step 39: loss {losses[-1]:.6f}"


def test_jsonl_logger(tmp_path):
    """One JSON object a line, flushed as written, appended across
    loggers."""
    path = str(tmp_path / "metrics.jsonl")
    first = JsonlLogger(path)
    first.log("train_step", step=0, loss=0.5)
    assert json.loads(open(path).read())["loss"] == 0.5
    first.close()
    second = JsonlLogger(path)
    second.log("eval", psnr=30.0)
    second.close()
    lines = [json.loads(x) for x in open(path).read().splitlines()]
    assert [x["event"] for x in lines] == ["train_step", "eval"]
    assert lines[0]["step"] == 0 and lines[1]["psnr"] == 30.0
    assert all(x["t"] >= 0 for x in lines)


def test_multiview_loss_matches_jax_and_trains():
    """The multi-view loss (view v rendered with seed + v) against the
    JAX package's run op by op, then two steps of the multi-view train
    step lower it."""
    offsets = ([0.0, 0.0, 0.0], [0.3, 0.1, 0.2])
    size = dict(width=16, height=12, spp=2)
    js = j_default_scene()
    jcams = [JCamera(pos=jnp.asarray(np.add([0.0, 0.0, -3.0], o),
                                     jnp.float32),
                     angle=jnp.zeros(3, jnp.float32), focal=jnp.float32(2.0))
             for o in offsets]
    bad = _perturbed(np.asarray(js.albedo))
    with jax.disable_jit():
        jcfg = JConfig(**size)
        targets = jnp.stack([j_render_radiance(js, c, jcfg, SEED + v)
                             for v, c in enumerate(jcams)])
        jparams = jinv.InverseParams(jcams[0].pos, jcams[0].angle,
                                     jcams[0].focal, jnp.asarray(bad))
        want = float(jinv.multiview_render_loss(
            jparams, js, jinv.stack_cameras(jcams), targets, jcfg, SEED))

    cams = [convert.camera_from_numpy(np.asarray(c.pos), np.zeros(3), 2.0,
                                      device=CPU) for c in jcams]
    batch = inv.stack_cameras(cams)
    params = convert.inverse_params_from_numpy(
        np.asarray(jcams[0].pos), np.zeros(3), 2.0, bad, device=CPU)
    tgt = torch.from_numpy(np.asarray(targets).copy())
    scene, cfg = default_scene(CPU), RenderConfig(**size)
    got = inv.multiview_render_loss(params, scene, batch, tgt, cfg, SEED)
    assert got.item() == pytest.approx(want, rel=1e-5)

    state = inv.init_state(inv.param_group_optimizer(freeze_pose=True),
                           params)
    step = inv.make_multiview_train_step(scene, batch, cfg, fixed_seed=SEED)
    losses = []
    for _ in range(3):
        state, aux = step(state, tgt)
        losses.append(float(aux["loss"]))
    assert losses[0] == pytest.approx(want, rel=1e-5)
    assert losses[-1] < losses[0]


def test_global_norm():
    ts = [torch.tensor([3.0, 4.0]), torch.tensor([[12.0]])]
    assert global_norm(ts).item() == pytest.approx(13.0)
    assert global_norm({"a": ts[0], "b": None}).item() == pytest.approx(5.0)
    assert global_norm([]).item() == 0.0


def test_inverse_params_carry_over_both_ways():
    arrays = (np.array([0.1, 0.2, -3.0], np.float32), np.zeros(3, np.float32),
              np.float32(2.0), np.full((7, 3), 0.5, np.float32))
    params = convert.inverse_params_from_numpy(*arrays, device=CPU)
    assert params.albedo.dtype == torch.float32
    for got, want in zip(convert.inverse_params_to_numpy(params), arrays):
        np.testing.assert_array_equal(got, want)


def test_cli_invert_on_cpu(tmp_path, capsys):
    ck = tmp_path / "ck"
    assert cli.main(["invert", "--size", "16x12", "--spp", "2", "--steps",
                     "4", "--device", "cpu", "--checkpoint-dir",
                     str(ck)]) == 0
    out = capsys.readouterr().out
    err0, err1 = map(float, out.split("albedo error ")[1].split(";")[0]
                     .split(" -> "))
    assert err1 < err0
    assert Checkpointer(str(ck)).latest_step() == 4


def test_cli_invert_without_card_exits_nonzero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        cli.main(["invert", "--size", "16x12", "--spp", "1", "--steps", "1"])
    assert exc.value.code not in (0, None)
