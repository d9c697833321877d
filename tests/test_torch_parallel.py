"""Ray-sharded rendering and training in the port
(``spath_tpu_torch/parallel/``) on the CPU, and the wavefront's light cap
on the card.

- The repair: on a CUDA device a scene of more than ``LIGHT_MAX`` lights
  with NEE goes to the wavefront, forward and gradient; above 2^20
  triangles every route still raises (routing only, no render).
- One rank in this process (``make_mesh(1)``, no process group): frames
  bit-equal to the one-device frames.
- Two gloo ranks, spawned once for the module (``two_ranks``): every case
  runs in the one spawn and comes back through files. Frames of the four
  streams and a ragged frame bit-equal to the one-device frames; the four
  kernel packs reached through their kernels' plain versions (the kernel
  renderers take CPU scenes, so the routes are a CUDA device's);
  gradients of all six groups within 1e-5 of each group's max of the
  one-device gradients (``tests/test_shard_fast.py``'s bound), bitwise
  equal across the ranks and across two runs; three ``recover`` steps;
  ``init_multihost`` twice; ``scaling_efficiency``; no JAX imported.
- Held to JAX: the wall-and-light scene's frame against JAX's
  ``render_radiance_sharded`` on two devices of the conftest's fake CPU
  mesh, under ``_assert_conforms``, and its albedo gradient within
  ``tests/test_parallel.py``'s bounds.
"""

import json
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spath_tpu.camera import Camera as JCamera  # noqa: E402
from spath_tpu.config import RenderConfig as JConfig  # noqa: E402
from spath_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from spath_tpu.parallel import (  # noqa: E402
    render_radiance_sharded as j_render_radiance_sharded,
)
from spath_tpu.scene import Scene as JScene  # noqa: E402
from spath_tpu_torch import parallel  # noqa: E402
from spath_tpu_torch.camera import Camera  # noqa: E402
from spath_tpu_torch.config import RenderConfig  # noqa: E402
from spath_tpu_torch.models import inverse, renderer  # noqa: E402
from spath_tpu_torch.models.pathtracer import (  # noqa: E402
    render_pt_fast, render_radiance_fastgrad,
)
from spath_tpu_torch.ops.kernels import bigscene  # noqa: E402
from spath_tpu_torch.ops.kernels import bigscene_quality as bq  # noqa: E402
from spath_tpu_torch.parallel import shard_fast  # noqa: E402
from spath_tpu_torch.scene import Scene, default_scene  # noqa: E402
from tests.test_nee import _wall_and_light_scene  # noqa: E402
from tests.test_torch_pathtracer import _assert_conforms  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
#: the frames of the two-rank cases: 16x8, 2 spp
SIZE = dict(width=16, height=8, spp=2)
STREAMS = {
    "lcg": dict(),
    "hash": dict(rng="hash", sampler="cosine", nee=True),
    "threefry": dict(rng="threefry", sampler="cosine", nee=True),
    "table": dict(rng="table"),
}
QUALITY = dict(rng="hash", sampler="cosine", nee=True, mis=True)
#: the renderers of the kernels, and the crossovers between the fused and
#: the streamed ones
KERNEL_ROUTES = ("megakernel", "bigscene", "quality", "quality_bigscene")
CROSSOVERS = ("SMEM_ROUTE_MAX_TRIS", "GRAD_ROUTE_MAX_TRIS",
              "QUALITY_ROUTE_MAX_TRIS", "QUALITY_GRAD_ROUTE_MAX_TRIS")
#: kernel → (estimator, streamed): the route on a CUDA device of the
#: default scene, with the crossovers at 0 when streamed
PACKS = {"K1": ({}, False), "K3": (QUALITY, False),
         "K6": ({}, True), "K9": (QUALITY, True)}
#: gradient → (estimator, streamed, route); "wavefront" on CPU tensors
GRADS = {"K2": ({}, False, "megakernel"),
         "K4": (QUALITY, False, "quality"),
         "K8": ({}, True, "bigscene"),
         "K10": (QUALITY, True, "quality_bigscene"),
         "wavefront": (QUALITY, False, "wavefront")}
#: tests/test_parallel.py::test_sharded_gradients_match's config
WALL = dict(width=24, height=16, spp=2, rng="threefry", sampler="cosine",
            nee=True, max_bounces=2)
GROUPS = ("vertices", "albedo", "emission", "pos", "angle", "focal")
#: tests/test_shard_fast.py: the sharded gradient against the one-device
#: one, float32 sum-order noise only
GRAD_RTOL = 1e-5
SEED = 3


def _weights(cfg: RenderConfig) -> torch.Tensor:
    rng = np.random.Generator(np.random.Philox(11))
    return torch.from_numpy(rng.uniform(
        0.5, 1.5, (cfg.height, cfg.width, 3)).astype(np.float32))


# ---- the repair: the wavefront's light cap on the card ----

def _fake_cuda(monkeypatch):
    cuda = torch.device("cuda", 0)
    monkeypatch.setattr(Scene, "device", property(lambda self: cuda))
    monkeypatch.setattr(Camera, "device", property(lambda self: cuda))


def _as_if_kernels_run(monkeypatch, streamed: bool):
    """The kernel renderers take CPU scenes: the routes of a CUDA device,
    each kernel wrapper computing its plain version on the CPU tensors;
    ``streamed``: the crossovers at 0, so the streamed kernels' routes
    take the default scene."""
    for r in renderer.REGISTRY:
        if r.name in KERNEL_ROUTES:
            monkeypatch.setattr(r, "available", lambda scene: True,
                                raising=False)
    if streamed:
        for k in CROSSOVERS:
            monkeypatch.setattr(renderer, k, 0)


def _stub_scene(n_tris, n_lights=1):
    """A scene of ``n_tris`` triangles, its first ``n_lights`` lights,
    without drawing them (the routing reads sizes and the light set)."""
    z = torch.zeros((n_tris, 3))
    return Scene(torch.zeros((n_tris, 3, 3)), z, z, tuple(range(n_lights)))


def test_routing_sends_scenes_above_light_max_to_the_wavefront(
        monkeypatch):
    """More than ``LIGHT_MAX`` lights with NEE: K9 and K10 decline, and
    the wavefront on the card takes the scene, forward and gradient, as
    the JAX package's wavefront does; without NEE K9 keeps it."""
    scene = _stub_scene(bq.LIGHT_MAX + 10, n_lights=bq.LIGHT_MAX + 1)
    _fake_cuda(monkeypatch)
    for est in (QUALITY, dict(rng="threefry", sampler="cosine", nee=True)):
        cfg = RenderConfig(width=8, height=4, spp=1, **est)
        assert renderer.forward_renderer(scene, cfg).name == "wavefront"
        assert renderer.grad_renderer(scene, cfg).name == "wavefront"
    no_nee = RenderConfig(width=8, height=4, spp=1, rng="hash",
                          sampler="cosine")
    assert renderer.forward_renderer(scene, no_nee).name == \
        "quality_bigscene"


def test_routing_still_raises_above_2_20_triangles(monkeypatch):
    """The wavefront on the card keeps the streamed kernels' 2^20 cap, for
    one device and for a mesh, and the message names only that cap."""
    scene = _stub_scene(bigscene.BIG_MAX_TRIS + 1)
    _fake_cuda(monkeypatch)
    cam, mesh = Camera.default(CPU), parallel.make_mesh(1, device="cpu")
    for est in (QUALITY, dict(rng="threefry", sampler="cosine", nee=True),
                dict()):
        cfg = RenderConfig(width=8, height=4, spp=1, **est)
        for fn in (render_pt_fast, render_radiance_fastgrad):
            for kw in (dict(), dict(mesh=mesh)):
                with pytest.raises(NotImplementedError,
                                   match=r"T <= 1048576 \(2\^20\)") as e:
                    fn(scene, cam, cfg, **kw)
                assert "LIGHT_MAX" not in str(e.value)
    with pytest.raises(NotImplementedError, match="wavefront on the card"):
        parallel.render_radiance_sharded(scene, cam, RenderConfig(
            width=8, height=4, spp=1, rng="threefry"), 0, mesh)


# ---- one rank in this process ----

def test_mesh_of_one_needs_no_process_group():
    mesh = parallel.make_mesh(1, device="cpu")
    assert (mesh.size, mesh.index, mesh.group, mesh.axis) == \
        (1, 0, None, "rays")
    assert parallel.default_mesh("cpu").ranks == (0,)
    with pytest.raises(ValueError, match="init_multihost"):
        parallel.make_mesh(2, device="cpu")
    assert parallel.init_multihost() is False       # no torchrun: no-op
    assert not shard_fast.fused_available("cpu")


@pytest.mark.parametrize("stream", ["lcg", "hash", "threefry"])
def test_one_rank_frame_bit_equal_to_one_device(stream):
    scene, cam = default_scene(CPU), Camera.default(CPU)
    cfg = RenderConfig(**SIZE, **STREAMS[stream])
    mesh = parallel.make_mesh(1, device="cpu")
    want = render_pt_fast(scene, cam, cfg, SEED)
    assert torch.equal(render_pt_fast(scene, cam, cfg, SEED, mesh=mesh),
                       want)
    assert torch.equal(parallel.render_pt_sharded(scene, cam, cfg, SEED,
                                                  mesh), want)


def test_entry_points_take_a_mesh():
    import inspect

    for fn in (render_pt_fast, render_radiance_fastgrad,
               inverse.render_loss, inverse.make_train_step,
               inverse.recover):
        assert "mesh" in inspect.signature(fn).parameters, fn.__name__
    assert set(parallel.__all__) >= {
        "make_mesh", "default_mesh", "render_pt_sharded",
        "render_radiance_sharded", "render_pt_fast_sharded",
        "render_radiance_fast_sharded", "render_radiance_fastgrad_sharded",
        "init_multihost", "scaling_efficiency"}


# ---- two gloo ranks, one spawn for the module ----

_WORKER = textwrap.dedent('''
    import json, sys
    import numpy as np
    import torch

    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(2)
    from spath_tpu_torch import parallel
    from spath_tpu_torch.camera import Camera
    from spath_tpu_torch.config import RenderConfig
    from spath_tpu_torch.convert import scene_from_numpy
    from spath_tpu_torch.models import inverse, renderer
    from spath_tpu_torch.models.pathtracer import (
        render_pt_fast, render_radiance_fastgrad)
    from spath_tpu_torch.scene import Scene, default_scene

    spec = json.loads(open(f"{out}/spec.json").read())
    KERNEL_ROUTES, CROSSOVERS = spec["kernel_routes"], spec["crossovers"]
    res = {"jax": sorted(m for m in sys.modules
                         if m == "jax" or m.startswith(("jax.", "spath_tpu."))
                         or m == "spath_tpu")}
    res["started"] = parallel.init_multihost(f"localhost:{port}", 2, rank)
    res["again"] = parallel.init_multihost(f"localhost:{port}", 2, rank)
    mesh = parallel.make_mesh(2, device="cpu")
    res["backend"] = mesh.backend
    cpu = torch.device("cpu")
    cam = Camera.default(cpu)
    size, seed = spec["size"], spec["seed"]

    for name, est in spec["streams"].items():
        cfg = RenderConfig(**size, **est)
        res[f"frame/{name}"] = render_pt_fast(default_scene(cpu), cam, cfg,
                                              seed, mesh=mesh)
    res["ragged"] = render_pt_fast(default_scene(cpu), cam, RenderConfig(
        **spec["ragged"]), seed, mesh=mesh)

    def grads(scene, cfg, weights):
        leaves = [t.detach().clone().requires_grad_() for t in (
            scene.vertices, scene.albedo, scene.emission, cam.pos,
            cam.angle, cam.focal)]
        sc = Scene(*leaves[:3], scene.light_idx)
        img = render_radiance_fastgrad(sc, Camera(*leaves[3:]), cfg, seed,
                                       mesh=mesh)
        return list(torch.autograd.grad((img * weights).sum(), leaves))

    kernels = [r for r in renderer.REGISTRY if r.name in KERNEL_ROUTES]
    saved = {k: getattr(renderer, k) for k in CROSSOVERS}
    traced = []                 # the renderers whose trace_block ran

    def recorded(r):
        trace_block = r.trace_block

        def trace(*args, **kw):
            traced.append(r.name)
            return trace_block(*args, **kw)
        return trace

    for r in renderer.REGISTRY:
        r.trace_block = recorded(r)

    def as_if(kernels_run, streamed):
        """The parent's ``_as_if_kernels_run``, and its undoing."""
        for r in kernels:
            if kernels_run:
                r.available = lambda scene: True
            else:
                r.__dict__.pop("available", None)
        for k in CROSSOVERS:
            setattr(renderer, k, 0 if streamed else saved[k])

    weights = torch.load(f"{out}/weights.pt")
    scene = default_scene(cpu)
    for kernel, (est, streamed) in spec["packs"].items():
        as_if(True, streamed)
        cfg = RenderConfig(**size, **est)
        traced.clear()
        res[f"pack/{kernel}"] = render_pt_fast(scene, cam, cfg, seed,
                                               mesh=mesh)
        res[f"route/{kernel}"] = list(traced)
    for kernel, (est, streamed, route) in spec["grads"].items():
        as_if(route != "wavefront", streamed)
        cfg = RenderConfig(**size, **est)
        traced.clear()
        res[f"grad/{kernel}"] = grads(scene, cfg, weights)
        res[f"groute/{kernel}"] = list(traced)
        res[f"grad2/{kernel}"] = grads(scene, cfg, weights)
    as_if(False, False)

    wall = np.load(f"{out}/wall.npz")
    ws = scene_from_numpy(wall["v"], wall["a"], wall["e"], device=cpu)
    wcfg = RenderConfig(**spec["wall"])
    albedo = ws.albedo.clone().requires_grad_()
    wimg = parallel.render_radiance_sharded(
        Scene(ws.vertices, albedo, ws.emission, ws.light_idx), cam, wcfg, 0,
        mesh)
    res["wall"] = wimg.detach()
    res["wall_albedo_grad"] = torch.autograd.grad(wimg.sum(), albedo)[0]

    scene = default_scene(cpu)
    cfg = RenderConfig(**size)
    target = render_pt_fast(scene, cam, cfg, 0, mesh=mesh)
    pert = torch.from_numpy(np.asarray(spec["albedo0"], np.float32))
    init = inverse.InverseParams(cam.pos, cam.angle, cam.focal, pert)
    state, losses = inverse.recover(
        scene, target, init, cfg,
        inverse.param_group_optimizer(freeze_pose=True), steps=3,
        fixed_seed=0, checkpoint_dir=f"{out}/ckpt", checkpoint_every=1,
        log_every=0, metrics_path=f"{out}/metrics.jsonl", mesh=mesh)
    res["losses"] = losses
    res["params"] = {k: t.detach() for k, t in
                     state.params.tensors().items()}

    one = parallel.make_mesh(1, device="cpu")
    try:
        render_pt_fast(default_scene(cpu), cam, cfg, 0, mesh=one)
        res["outside"] = "rendered"
    except ValueError as e:
        res["outside"] = str(e)
    res["scaling"] = parallel.scaling_efficiency(
        default_scene(cpu), cam, RenderConfig(width=8, height=4, spp=1), 2,
        reps=1)
    torch.save(res, f"{out}/rank{rank}.pt")
    print("WORKER_OK", rank)
''')


def _perturbed(albedo: np.ndarray) -> np.ndarray:
    """The CLI's perturbation: uniform ±0.4 from ``default_rng(1)``,
    clipped to [0.05, 1]."""
    rng = np.random.default_rng(1)
    return np.clip(albedo + rng.uniform(-0.4, 0.4, albedo.shape)
                   .astype(np.float32), 0.05, 1.0)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' results ``[rank0, rank1]``, the output folder, and
    ``_jax_wall``'s reference, computed while the ranks run."""
    out = tmp_path_factory.mktemp("two_ranks")
    wall = _wall_and_light_scene()
    np.savez(out / "wall.npz", v=np.asarray(wall.vertices),
             a=np.asarray(wall.albedo), e=np.asarray(wall.emission))
    torch.save(_weights(RenderConfig(**SIZE)), out / "weights.pt")
    spec = dict(size=SIZE, seed=SEED, streams=STREAMS, packs=PACKS,
                grads=GRADS, wall=WALL, kernel_routes=KERNEL_ROUTES,
                crossovers=CROSSOVERS,
                ragged=dict(width=15, height=7, spp=2),
                albedo0=_perturbed(default_scene(CPU).albedo.numpy()).tolist())
    (out / "spec.json").write_text(json.dumps(spec))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(port), str(out)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    jax_ref = _jax_wall(wall)           # while the ranks run
    for p in procs:
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0 and "WORKER_OK" in log, log[-3000:]
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(2)], out, jax_ref


def test_two_ranks_start_on_gloo_and_import_no_jax(two_ranks):
    res = two_ranks[0]
    for r in res:
        assert r["jax"] == []
        assert (r["started"], r["again"], r["backend"]) == \
            (True, False, "gloo")


@pytest.mark.parametrize("stream", list(STREAMS))
def test_two_ranks_frame_bit_equal_to_one_device(two_ranks, stream):
    res = two_ranks[0]
    cfg = RenderConfig(**SIZE, **STREAMS[stream])
    want = render_pt_fast(default_scene(CPU), Camera.default(CPU), cfg,
                          SEED)
    for r in res:
        assert torch.equal(r[f"frame/{stream}"], want)


def test_two_ranks_ragged_frame(two_ranks):
    """15x7 = 105 pixels: the second rank's block ends in a padded ray."""
    res = two_ranks[0]
    cfg = RenderConfig(width=15, height=7, spp=2)
    want = render_pt_fast(default_scene(CPU), Camera.default(CPU), cfg,
                          SEED)
    for r in res:
        assert r["ragged"].shape == (7, 15, 3)
        assert torch.equal(r["ragged"], want)


@pytest.mark.parametrize("kernel", list(PACKS))
def test_two_ranks_kernel_packs_bit_equal(two_ranks, kernel, monkeypatch):
    """Each rank traced its block once through the one-device router's
    kernel renderer (``trace_block``), and the frame, the kernel's plain
    version on each rank's block, equals the one-device frame through the
    same route."""
    res = two_ranks[0]
    est, streamed = PACKS[kernel]
    scene = default_scene(CPU)
    cfg = RenderConfig(**SIZE, **est)
    _as_if_kernels_run(monkeypatch, streamed)
    name = renderer.forward_renderer(scene, cfg).name
    assert name == {"K1": "megakernel", "K3": "quality", "K6": "bigscene",
                    "K9": "quality_bigscene"}[kernel]
    want = render_pt_fast(scene, Camera.default(CPU), cfg, SEED)
    for r in res:
        assert r[f"route/{kernel}"] == [name]
        assert torch.equal(r[f"pack/{kernel}"], want)


def _one_device_grads(scene, cfg):
    cam = Camera.default(CPU)
    leaves = [t.detach().clone().requires_grad_() for t in (
        scene.vertices, scene.albedo, scene.emission, cam.pos, cam.angle,
        cam.focal)]
    sc = Scene(*leaves[:3], scene.light_idx)
    img = render_radiance_fastgrad(sc, Camera(*leaves[3:]), cfg, SEED)
    return torch.autograd.grad((img * _weights(cfg)).sum(), leaves)


@pytest.mark.parametrize("kernel", list(GRADS))
def test_two_ranks_gradients(two_ranks, kernel, monkeypatch):
    """All six groups within 1e-5 of each group's max of the one-device
    gradient, bitwise equal on both ranks and over two runs."""
    res = two_ranks[0]
    est, streamed, route = GRADS[kernel]
    scene = default_scene(CPU)
    cfg = RenderConfig(**SIZE, **est)
    if route != "wavefront":
        _as_if_kernels_run(monkeypatch, streamed)
    assert renderer.grad_renderer(scene, cfg).name == route
    want = _one_device_grads(scene, cfg)
    for r in res:
        assert r[f"groute/{kernel}"] == [route]
        for name, got, again, w in zip(GROUPS, r[f"grad/{kernel}"],
                                       r[f"grad2/{kernel}"], want):
            assert torch.equal(got, again), f"{name}: two runs differ"
            scale = float(w.abs().max()) + 1e-12
            np.testing.assert_allclose(got.numpy(), w.numpy(),
                                       atol=GRAD_RTOL * scale,
                                       err_msg=f"{kernel}, {name}")
    for a, b in zip(res[0][f"grad/{kernel}"], res[1][f"grad/{kernel}"]):
        assert torch.equal(a, b)
    assert float(res[0][f"grad/{kernel}"][1].abs().max()) > 0


def test_two_ranks_recover(two_ranks):
    """Three sharded ``recover`` steps lower the loss and leave both
    ranks' parameters bitwise equal; the first rank alone wrote the
    checkpoints and the metrics, which every rank's run saw."""
    res, out, _ = two_ranks
    for r in res:
        assert len(r["losses"]) == 3 and r["losses"][-1] < r["losses"][0]
    assert res[0]["losses"] == res[1]["losses"]
    for k, t in res[0]["params"].items():
        assert torch.equal(t, res[1]["params"][k]), k
    assert sorted(p.name for p in (out / "ckpt").iterdir()) == [
        "step_00000001.pt", "step_00000002.pt", "step_00000003.pt"]
    lines = (out / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 3


def test_two_ranks_outside_a_mesh_and_scaling(two_ranks):
    res = two_ranks[0]
    assert "rendered" not in res[1]["outside"]
    assert "not in the mesh" in res[1]["outside"]
    assert res[0]["outside"] == "rendered"
    for r in res:
        eff, t1, tn = r["scaling"]
        assert np.isfinite([eff, t1, tn]).all() and min(eff, t1, tn) > 0
    assert res[0]["scaling"] == res[1]["scaling"]


# ---- held to JAX ----

def _jax_wall(scene):
    """JAX's sharded frame and albedo gradient of the wall-and-light scene
    on two devices of the fake CPU mesh (``tests/test_parallel.py``), in
    one program: the frame is the value the gradient differentiates."""
    cam, cfg, mesh = JCamera.default(), JConfig(**WALL), j_make_mesh(2)

    def loss(albedo):
        s = JScene(scene.vertices, albedo, scene.emission)
        img = j_render_radiance_sharded(s, cam, cfg, 0, mesh)
        return jnp.sum(img), img

    (_, img), grad = jax.value_and_grad(loss, has_aux=True)(scene.albedo)
    return np.asarray(img), np.asarray(grad)


def test_two_ranks_frame_held_to_jax_sharded(two_ranks):
    res, _, jax_wall = two_ranks
    for r in res:
        _assert_conforms(r["wall"].numpy(), jax_wall[0])
    assert torch.equal(res[0]["wall"], res[1]["wall"])


def test_two_ranks_albedo_gradient_held_to_jax_sharded(two_ranks):
    res, _, jax_wall = two_ranks
    for r in res:
        np.testing.assert_allclose(r["wall_albedo_grad"].numpy(),
                                   jax_wall[1], rtol=1e-4, atol=1e-5)
