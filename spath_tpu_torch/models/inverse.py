"""Inverse rendering: recover camera pose and per-triangle albedo from
target images by gradient descent through the renderer
(``spath_tpu/models/inverse.py``, BASELINE config 5).

The parameters are four tensors (camera position, angles, focal length
and the albedo field); the loss is the mean squared error between the
differentiable render ``render_radiance_fastgrad`` (on a CUDA device K1
forward and K2 backward for the conformance estimator, K3 and K4 for the
quality estimator in its hash form, on large scenes K6 and K8 or K9 and
K10, each with the scatter K7; for the threefry stream of
``config.QUALITY`` and the table stream autograd of the wavefront on K5,
its draws from the threefry kernel; autograd of the wavefront on the CPU)
and the target;
``recover``, ``make_train_step`` and ``make_multiview_train_step`` take a
config with ``vis_grad`` as it is, and the gradient then adds the
visibility residual (``VisGradFusedRenderer``, whose sweeps are K5 and,
on large quality scenes at up to 8 spp, whose interior's forward is
K11), so a pose step sees light silhouettes and shadow boundaries;
the optimizer is ``torch.optim.Adam`` (``recover``'s default at
``learning_rate``, or with a pose and an albedo parameter group), in
place of the JAX package's optax transforms. The conformance
estimator's camera gradient is exactly zero; the quality estimator's
next-event term makes it smooth and non-zero (K4's or K10's camera-ray
adjoint, carried to the pose by ``generate_rays``' autograd).

What differs from the JAX package, and why:

- An optimizer is a factory, ``params -> torch.optim.Optimizer``
  (``param_group_optimizer``): a torch optimizer holds its
  parameters, so ``TrainState`` carries the optimizer itself where the
  JAX package carries its state. A frozen group is left out of the
  optimizer, so it gets no update, as under ``optax.set_to_zero``.
- ``make_train_step`` takes no optimizer: the state brings it. The step
  updates the parameter tensors in place and returns the state with its
  step advanced.
- ``apply_params`` clips the albedo with ``torch.minimum``/``maximum``
  against 0-d tensors, whose gradient at a bound is 0.5, as
  ``jnp.clip``'s; ``torch.clamp``'s is 1.0 there, and the default
  scene's albedo lies on the bounds.
- ``recover`` takes the optimizer as its fifth positional argument and
  ``steps`` after it (the JAX package takes ``steps`` fifth); by keyword
  every option is the JAX package's, with its defaults and meaning.
- With a ``mesh`` (``spath_tpu_torch.parallel``) every rank of it runs
  the same loop (SPMD): it renders its block of pixels, computes the same
  loss from the whole frame and gets the gradients summed over the ranks
  in rank order, so every rank's parameters stay bitwise equal from step
  to step. Checkpoints and metrics are written by the mesh's first rank
  only; every rank reads the checkpoints back.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from spath_tpu_torch.camera import Camera
from spath_tpu_torch.config import RenderConfig
from spath_tpu_torch.scene import Scene
from spath_tpu_torch.utils.logging import global_norm


@dataclasses.dataclass(frozen=True)
class InverseParams:
    """The optimizable unknowns."""

    cam_pos: torch.Tensor
    cam_angle: torch.Tensor
    cam_focal: torch.Tensor
    albedo: torch.Tensor

    @classmethod
    def init(cls, scene: Scene, camera: Camera) -> "InverseParams":
        return cls(cam_pos=camera.pos, cam_angle=camera.angle,
                   cam_focal=camera.focal, albedo=scene.albedo)

    def tensors(self) -> dict[str, torch.Tensor]:
        """The parameters by field name, in field order."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    def leaves(self) -> "InverseParams":
        """Fresh copies that require grad: the tensors an optimizer owns."""
        return InverseParams(**{k: t.detach().clone().requires_grad_()
                                for k, t in self.tensors().items()})


def _clip01(x: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, 0, 1)`` with its gradient 0.5 at either bound."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, zero), one)


def apply_params(params: InverseParams, base_scene: Scene):
    """Materialise ``(scene, camera)`` from the parameters and the fixed
    geometry."""
    cam = Camera(pos=params.cam_pos, angle=params.cam_angle,
                 focal=params.cam_focal)
    scene = dataclasses.replace(base_scene, albedo=_clip01(params.albedo))
    return scene, cam


def render_loss(params: InverseParams, base_scene: Scene,
                target: torch.Tensor, cfg: RenderConfig,
                seed: int, mesh=None,
                require_jittable: bool = False) -> torch.Tensor:
    """MSE between the (HDR, unclamped) render and the target image; with
    a ``mesh`` the render is sharded over its ranks. ``require_jittable``
    keeps the compacted kernels off, as ``render_radiance_fastgrad``
    takes it."""
    from spath_tpu_torch.models.pathtracer import render_radiance_fastgrad

    scene, cam = apply_params(params, base_scene)
    img = render_radiance_fastgrad(scene, cam, cfg, seed, mesh,
                                   require_jittable)
    return ((img - target) ** 2).mean()


Optimizer = Callable[[InverseParams], torch.optim.Optimizer]


def param_group_optimizer(pose_lr: float = 1e-3, albedo_lr: float = 2e-2,
                          freeze_pose: bool = False,
                          freeze_albedo: bool = False) -> Optimizer:
    """Adam with a ``pose`` and an ``albedo`` parameter group; a frozen
    group is left out, so it gets no update."""
    if freeze_pose and freeze_albedo:
        raise ValueError("both parameter groups frozen: nothing to optimize")

    def make(p: InverseParams) -> torch.optim.Optimizer:
        groups = []
        if not freeze_pose:
            groups.append(dict(params=[p.cam_pos, p.cam_angle, p.cam_focal],
                               lr=pose_lr, name="pose"))
        if not freeze_albedo:
            groups.append(dict(params=[p.albedo], lr=albedo_lr,
                               name="albedo"))
        return torch.optim.Adam(groups)

    return make


def stack_cameras(cameras) -> Camera:
    """Stack a list of Cameras into one batched Camera."""
    return Camera(pos=torch.stack([c.pos for c in cameras]),
                  angle=torch.stack([c.angle for c in cameras]),
                  focal=torch.stack([c.focal for c in cameras]))


def multiview_render_loss(params: InverseParams, base_scene: Scene,
                          cameras: Camera, targets: torch.Tensor,
                          cfg: RenderConfig, seed: int,
                          require_jittable: bool = False) -> torch.Tensor:
    """Mean MSE across V known views (``cameras``/``targets`` batched on
    the leading axis), view ``v`` rendered with seed ``seed + v``. The
    camera parameters in ``params`` are ignored: the views' poses are the
    knowns. ``require_jittable`` as ``render_loss`` takes it."""
    from spath_tpu_torch.models.pathtracer import render_radiance_fastgrad

    scene = dataclasses.replace(base_scene, albedo=_clip01(params.albedo))
    losses = []
    for v in range(targets.shape[0]):
        cam = Camera(pos=cameras.pos[v], angle=cameras.angle[v],
                     focal=cameras.focal[v])
        img = render_radiance_fastgrad(scene, cam, cfg, seed + v,
                                       require_jittable=require_jittable)
        losses.append(((img - targets[v]) ** 2).mean())
    return torch.stack(losses).mean()


class TrainState(NamedTuple):
    params: InverseParams
    optimizer: torch.optim.Optimizer
    step: int

    def state_dict(self) -> dict[str, Any]:
        return {"params": {k: t.detach().cpu()
                           for k, t in self.params.tensors().items()},
                "optimizer": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, saved: dict[str, Any]) -> "TrainState":
        """Copy a ``state_dict`` into this state's tensors and optimizer;
        returns the state at the saved step."""
        with torch.no_grad():
            for k, t in self.params.tensors().items():
                t.copy_(saved["params"][k])
        self.optimizer.load_state_dict(saved["optimizer"])
        return self._replace(step=int(saved["step"]))


def init_state(optimizer: Optimizer, params: InverseParams) -> TrainState:
    """A state at step 0 that owns copies of ``params``."""
    leaves = params.leaves()
    return TrainState(leaves, optimizer(leaves), 0)


def _apply(state: TrainState, loss: torch.Tensor):
    tensors = list(state.params.tensors().values())
    grads = torch.autograd.grad(loss, tensors, allow_unused=True,
                                materialize_grads=True)
    for t, g in zip(tensors, grads):
        t.grad = g
    state.optimizer.step()
    for t in tensors:
        t.grad = None
    aux = {"loss": loss.detach(), "grad_norm": global_norm(grads)}
    return state._replace(step=state.step + 1), aux


def make_train_step(base_scene: Scene, cfg: RenderConfig,
                    fixed_seed: int | None = None, mesh=None):
    """The train step ``(state, target) -> (state, aux)``, its gradient
    from ``render_radiance_fastgrad``: with ``cfg.vis_grad`` the kernels'
    interior gradient plus the visibility residual's; with a ``mesh``
    sharded over its ranks, the gradients summed in rank order.

    ``fixed_seed``: render every step with this seed (common random
    numbers); when the target was rendered with the same seed, the loss
    at the true parameters is exactly zero. Default (None) renders step
    ``k`` with seed ``k``.

    The step never takes a compacted renderer (``require_jittable``), as
    the JAX package's jitted step cannot: a plan syncs a host scalar, and
    with the pose free the camera moves every step, so its plan would be
    built again each time.
    """

    def step_fn(state: TrainState, target: torch.Tensor):
        seed = state.step if fixed_seed is None else fixed_seed
        return _apply(state, render_loss(state.params, base_scene, target,
                                         cfg, seed, mesh,
                                         require_jittable=True))

    return step_fn


def make_multiview_train_step(base_scene: Scene, cameras: Camera,
                              cfg: RenderConfig,
                              fixed_seed: int | None = None):
    """The multi-view train step ``(state, targets) -> (state, aux)``."""

    def step_fn(state: TrainState, targets: torch.Tensor):
        seed = state.step if fixed_seed is None else fixed_seed
        return _apply(state, multiview_render_loss(
            state.params, base_scene, cameras, targets, cfg, seed,
            require_jittable=True))

    return step_fn


def recover(base_scene: Scene, target: torch.Tensor,
            init_params: InverseParams, cfg: RenderConfig,
            optimizer: Optimizer | None = None, steps: int = 200,
            learning_rate: float = 5e-3, fixed_seed: int | None = None,
            checkpoint_dir: str | None = None, checkpoint_every: int = 50,
            log_every: int = 20, log_fn=print,
            metrics_path: str | None = None, max_retries: int = 0,
            mesh=None):
    """The optimization loop, with checkpoint and resume
    (``spath_tpu/models/inverse.py::recover``).

    Returns ``(state, losses)``. ``optimizer`` (a factory,
    ``param_group_optimizer``) defaults to Adam at ``learning_rate`` on
    every parameter. If ``checkpoint_dir`` holds a previous run, resumes
    from its latest step; saves every ``checkpoint_every`` steps and at
    the end. Logs the loss through ``log_fn`` at step 0, every
    ``log_every`` steps and at the last (``log_every=0``: never).
    ``metrics_path``: append a ``train_step`` record (step, loss,
    grad_norm) a step to that JSONL file (``utils/logging.py``).
    ``max_retries``: if a step raises, roll back to the last checkpoint and
    go on, up to this many times; needs ``checkpoint_dir``.
    ``mesh``: every rank of it calls ``recover`` with the same arguments;
    each renders its block of pixels, and the first rank alone writes the
    checkpoints and the metrics.
    """
    if optimizer is None:
        def optimizer(p: InverseParams) -> torch.optim.Optimizer:
            return torch.optim.Adam(list(p.tensors().values()),
                                    lr=learning_rate)
    if max_retries and checkpoint_dir is None:
        raise ValueError("max_retries requires checkpoint_dir")
    state = init_state(optimizer, init_params)

    ckpt = None
    if checkpoint_dir is not None:
        from spath_tpu_torch.utils.checkpoint import Checkpointer

        ckpt = Checkpointer(checkpoint_dir)
        restored = ckpt.restore_latest(state)
        if restored is not None:
            state = restored
            log_fn(f"resumed from step {state.step}")

    writer = mesh is None or mesh.index == 0
    metrics = None
    if metrics_path is not None and writer:
        from spath_tpu_torch.utils.logging import JsonlLogger

        metrics = JsonlLogger(metrics_path)

    def save(step):
        if writer:
            ckpt.save(step, state)
        if mesh is not None:
            mesh.barrier()

    train_step = make_train_step(base_scene, cfg, fixed_seed, mesh)
    losses = []
    retries_left = max_retries
    while state.step < steps:
        try:
            state, aux = train_step(state, target)
        except Exception:  # noqa: BLE001 — elastic recovery boundary
            if retries_left <= 0:
                raise
            retries_left -= 1
            fresh = init_state(optimizer, init_params)
            state = ckpt.restore_latest(fresh) or fresh
            log_fn(f"step failed; rolled back to step {state.step} "
                   f"({retries_left} retries left)")
            continue
        i = state.step
        loss = float(aux["loss"])
        losses.append(loss)
        if metrics is not None:
            metrics.log("train_step", step=i - 1, loss=loss,
                        grad_norm=float(aux["grad_norm"]))
        if log_every and ((i - 1) % log_every == 0 or i == steps):
            log_fn(f"step {i - 1}: loss {loss:.6f}")
        if ckpt is not None and i % checkpoint_every == 0:
            save(i)
    if ckpt is not None:
        save(state.step)
    if metrics is not None:
        metrics.close()
    return state, losses
