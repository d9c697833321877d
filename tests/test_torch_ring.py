"""The triangle ring in the port (``spath_tpu_torch/parallel/ring.py``) on
the CPU, held to the JAX package's ring (``spath_tpu/parallel/ring.py``)
and to the port's one-device wavefront.

- One rank in this process (``make_mesh(1)``, no process group): frames
  bit-equal to the wavefront's, gradients within 1e-5 of each group's max,
  the refusals (NEE on the LCG stream, the 2^20 cap on the card).
- Three gloo ranks, spawned once for the module (``ring_ranks``); every
  case runs in the one spawn and comes back through files. On the first
  two ranks (``make_mesh(2, axis="shard")``): the primitives
  ``nearest_hit_ring_rows`` and ``nearest_and_select_ring`` on 64 rays x
  64 rows, forward and backward, and ``nearest_hit_ring``,
  ``ring_gather_rows``, ``ring_light_select`` and
  ``ring_light_select_rows`` beside them; the frames of
  ``render_flat_ring`` and of ``render_pt_ring`` in three estimators; the
  six gradients of ``render_radiance_ring`` twice; remat against no remat
  at 9 spp; three ``ring_train_step`` steps on the wall-and-light scene
  (``_wall``). On all three (``make_mesh(3)``), the
  7-triangle scene, whose table pads to 9 rows, so that the light
  fallback's row 6 is owned by the last rank. ``make_mesh_2d``'s grids;
  no JAX imported.
- Held to JAX, whose ring runs on a named axis of two
  (``jax.vmap(axis_name="shard")``, which binds its ``ppermute`` and
  ``axis_index`` as a 2-device ``shard_map`` does) op by op, as the
  port's other tests hold it to op-by-op JAX: jitted JAX contracts
  products into FMAs, so a jitted ``shard_map`` of the primitives gives
  distances an ulp off (19 of 64 here) and flips a few paths of the
  frames (2 of 128 pixels in the LCG frame, 4 in the hash frame), and an
  eager ``shard_map`` takes minutes. The primitives against JAX's on
  ``tests/test_ring_grad.py:206-245``'s kind of inputs: forward bit for
  bit, backward within that test's rtol 1e-5 and 1e-6 of each array's
  max (``_assert_tree_close``'s form of the file's atol: the port's
  distance VJP is torch autodiff of its own cross products and its table
  sums are float64, JAX's sequential float32, so an element that sums
  large cancelling terms differs by float32 rounding of the terms: 2.1e-5
  on 0.75, its array's max 14.2). Frames under
  ``tests/test_parallel.py::_assert_images_match`` with the budgets JAX
  pins for its ring (0 for LCG and threefry, 0.01 with MIS), the scene
  gradient within ``tests/test_ring_grad.py``'s rtol 3e-4, atol 1e-6 of
  each group's max. Each JAX reference is computed once, while the ranks
  run.
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
from spath_tpu.camera import generate_rays as j_generate_rays  # noqa: E402
from spath_tpu.config import RenderConfig as JConfig  # noqa: E402
from spath_tpu.parallel import ring as JR  # noqa: E402
from spath_tpu.scene import Scene as JScene  # noqa: E402
from spath_tpu.scene import default_scene as j_default_scene  # noqa: E402
from spath_tpu_torch import parallel  # noqa: E402
from spath_tpu_torch.camera import Camera  # noqa: E402
from spath_tpu_torch.config import RenderConfig  # noqa: E402
from spath_tpu_torch.models.flat import render_flat  # noqa: E402
from spath_tpu_torch.models.pathtracer import (  # noqa: E402
    render_pt, render_radiance,
)
from spath_tpu_torch.parallel import ring  # noqa: E402
from spath_tpu_torch.scene import Scene, default_scene  # noqa: E402
from tests.test_nee import _wall_and_light_scene  # noqa: E402
from tests.test_parallel import _assert_images_match  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
#: the frames: 16x8, 2 spp, 3 bounces (``tests/test_ring_grad.py``'s depth)
SIZE = dict(width=16, height=8, spp=2, max_bounces=3)
#: estimator → (config, JAX's flip budget for its ring, tests/
#: test_parallel.py:164-216)
FRAMES = {
    "lcg": (dict(), 0.0),
    "hash": (dict(rng="hash", sampler="cosine", nee=True, mis=True,
                  rr_start=2), 0.01),
    "threefry": (dict(rng="threefry", sampler="cosine", nee=True), 0.0),
}
#: the estimators whose six gradients the ranks take (twice each)
GRADS = ("lcg", "hash")
#: remat against no remat: 9 samples (above the 8 that ``cfg.remat`` needs)
REMAT = dict(width=8, height=4, spp=9, max_bounces=2, rng="hash",
             sampler="cosine", nee=True)
GROUPS = ("vertices", "albedo", "emission", "pos", "angle", "focal")
#: the ring against the one-device wavefront: float32 summation order
GRAD_RTOL = 1e-5
#: tests/test_ring_grad.py: the ring against the replicated path, and the
#: primitives' custom VJP against autodiff (atol a share of the max)
RING_RTOL, RING_ATOL = 3e-4, 1e-6
PRIM_RTOL, PRIM_ATOL = 1e-5, 1e-6
#: the primitives' inputs: rays x table rows, and the light choice's rows
#: (the last two are padding: prob 0, cdf 2.0)
PRIM_RAYS, PRIM_ROWS, PRIM_LIGHTS = 64, 64, 62
SEED = 3
TRAIN_LR, TRAIN_STEPS = 1.0, 3


def _weights(shape) -> np.ndarray:
    return np.random.Generator(np.random.Philox(11)).uniform(
        0.5, 1.5, shape).astype(np.float32)


def _primitive_inputs() -> dict:
    """``tests/test_ring_grad.py::test_ring_primitive_vjp_matches_autodiff``'s
    inputs, the table widened to 17 columns with a light choice, some rays
    with a source triangle, and the cotangents of every output."""
    rng = np.random.default_rng(7)
    n, t = PRIM_RAYS, PRIM_ROWS
    table = rng.standard_normal((t, 17)).astype(np.float32)
    prob = rng.uniform(0.0, 1.0, t).astype(np.float32)
    prob[rng.uniform(size=t) < 0.3] = 0.0
    prob[PRIM_LIGHTS:] = 0.0
    prob /= prob.sum()
    cdf = np.cumsum(prob).astype(np.float32)
    cdf[PRIM_LIGHTS:] = 2.0
    table[:, 15], table[:, 16] = prob, cdf
    o = np.zeros((n, 3), np.float32)
    o[:, 2] = -3.0
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    src = np.where(rng.uniform(size=n) < 0.5, -1,
                   rng.integers(0, t, n)).astype(np.int32)
    u = rng.uniform(0.0, 1.0, n).astype(np.float32)
    u[:4] = [0.0, float(cdf[PRIM_LIGHTS - 1]), 0.999999, 1.0 - 2.0**-24]
    return dict(table=table, o=o, d=d, src=src, u=u,
                gw=rng.standard_normal((n, 17)).astype(np.float32),
                gl=rng.standard_normal((n, 17)).astype(np.float32),
                gd=rng.standard_normal(n).astype(np.float32))


# ---- one rank in this process ----

@pytest.mark.parametrize("stream", list(FRAMES))
def test_one_rank_frame_bit_equal_to_one_device(stream):
    scene, cam = default_scene(CPU), Camera.default(CPU)
    cfg = RenderConfig(**SIZE, **FRAMES[stream][0])
    mesh = parallel.make_mesh(1, axis="shard", device="cpu")
    assert mesh.axis == "shard"
    assert torch.equal(ring.render_pt_ring(scene, cam, cfg, mesh, SEED),
                       render_pt(scene, cam, cfg, SEED))
    flat = RenderConfig(width=16, height=8)
    assert torch.equal(ring.render_flat_ring(scene, cam, flat, mesh),
                       render_flat(scene, cam, flat))


def _six(fn, scene, cam, cfg):
    """The six gradients of ``sum(weights * fn(scene, camera))``, zeros
    where a group gets none (the LCG frame is flat in the camera's
    position)."""
    leaves = [t.detach().clone().requires_grad_() for t in (
        scene.vertices, scene.albedo, scene.emission, cam.pos, cam.angle,
        cam.focal)]
    img = fn(Scene(*leaves[:3], scene.light_idx), Camera(*leaves[3:]))
    w = torch.from_numpy(_weights(tuple(img.shape)))
    grads = torch.autograd.grad((img * w).sum(), leaves, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for g, x in zip(grads, leaves)]


def _one_device_grads(scene, cfg):
    return _six(lambda s, c: render_radiance(s, c, cfg, SEED), scene,
                Camera.default(CPU), cfg)


def _assert_grads_close(got, want, what):
    for name, g, w in zip(GROUPS, got, want):
        scale = float(w.abs().max()) + 1e-12
        np.testing.assert_allclose(g.numpy(), w.numpy(),
                                   atol=GRAD_RTOL * scale,
                                   err_msg=f"{what}, {name}")


def test_one_rank_gradients_match_one_device():
    scene, cfg = default_scene(CPU), RenderConfig(**SIZE, **FRAMES["hash"][0])
    mesh = parallel.make_mesh(1, axis="shard", device="cpu")
    got = _six(lambda s, c: ring.render_radiance_ring(s, c, cfg, mesh, SEED),
               scene, Camera.default(CPU), cfg)
    _assert_grads_close(got, _one_device_grads(scene, cfg), "one rank")


def test_refusals():
    """NEE on the LCG or table stream raises the JAX package's
    ``ValueError``; above 2^20 triangles on the card the ring raises
    ``NotImplementedError``, as every route on the card does."""
    scene, cam = default_scene(CPU), Camera.default(CPU)
    mesh = parallel.make_mesh(1, axis="shard", device="cpu")
    for rng in ("lcg", "table"):
        cfg = RenderConfig(width=8, height=4, spp=1, rng=rng, nee=True)
        for fn in (ring.render_pt_ring, ring.render_radiance_ring):
            with pytest.raises(ValueError, match="cfg.nee requires"):
                fn(scene, cam, cfg, mesh)
    big = Scene(torch.zeros(((1 << 20) + 1, 3, 3)),
                torch.zeros(((1 << 20) + 1, 3)),
                torch.zeros(((1 << 20) + 1, 3)), (0,))
    cuda = torch.device("cuda", 0)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(Scene, "device", property(lambda self: cuda))
        m.setattr(Camera, "device", property(lambda self: cuda))
        with pytest.raises(NotImplementedError, match="2\\^20"):
            ring.render_pt_ring(big, cam, RenderConfig(width=8, height=4,
                                                       spp=1), mesh)


def test_exports():
    assert set(parallel.__all__) >= {
        "nearest_hit_ring", "render_flat_ring", "render_pt_ring",
        "render_radiance_ring", "ring_train_step", "make_mesh_2d"}
    grid = parallel.make_mesh_2d(1, 1, device="cpu")
    assert grid.grid == ((0,),) and grid.tris.axis == "tris" \
        and grid.rays.axis == "rays" and grid.tris.size == 1
    with pytest.raises(ValueError, match="init_multihost"):
        parallel.make_mesh_2d(1, 2, device="cpu")


# ---- three gloo ranks, one spawn for the module ----

_WORKER = textwrap.dedent('''
    import json, sys
    import numpy as np
    import torch

    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    from spath_tpu_torch import parallel
    from spath_tpu_torch.camera import Camera
    from spath_tpu_torch.config import RenderConfig
    from spath_tpu_torch.parallel import ring
    from spath_tpu_torch.scene import Scene, default_scene, make_scene

    spec = json.loads(open(f"{out}/spec.json").read())
    res = {"jax": sorted(m for m in sys.modules
                         if m == "jax" or m.startswith(("jax.", "spath_tpu."))
                         or m == "spath_tpu")}
    parallel.init_multihost(f"localhost:{port}", 3, rank)
    mesh2 = parallel.make_mesh(2, axis="shard", device="cpu")
    mesh3 = parallel.make_mesh(3, axis="shard", device="cpu")
    res["backend"] = mesh3.backend
    res["grids"] = {}
    for shape in ([1, 3], [3, 1], [1, 2]):
        g = parallel.make_mesh_2d(*shape, device="cpu")
        res["grids"][str(shape)] = (g.grid, g.shape, None if g.tris is None
                                    else (g.tris.ranks, g.tris.axis,
                                          g.rays.ranks, g.rays.axis))
    cpu = torch.device("cpu")
    cam = Camera.default(cpu)
    size, seed = spec["size"], spec["seed"]
    weights = torch.load(f"{out}/weights.pt")

    def six(scene, cfg, mesh, w):
        leaves = [t.detach().clone().requires_grad_() for t in (
            scene.vertices, scene.albedo, scene.emission, cam.pos,
            cam.angle, cam.focal)]
        img = ring.render_radiance_ring(Scene(*leaves[:3], scene.light_idx),
                                        Camera(*leaves[3:]), cfg, mesh, seed)
        grads = torch.autograd.grad((img * w).sum(), leaves,
                                    allow_unused=True)
        return [torch.zeros_like(x) if g is None else g
                for g, x in zip(grads, leaves)]

    def primitives(mesh):
        p = np.load(f"{out}/prim.npz")
        n, t = p["o"].shape[0] // mesh.size, p["table"].shape[0] // mesh.size
        me = mesh.member_index()
        rays, rows = slice(me * n, (me + 1) * n), slice(me * t, (me + 1) * t)
        got = {}
        for name in ("rows", "sweepsel"):
            table = torch.from_numpy(p["table"][rows]).requires_grad_()
            o = torch.from_numpy(p["o"][rays]).requires_grad_()
            d = torch.from_numpy(p["d"][rays]).requires_grad_()
            src = torch.from_numpy(p["src"][rays]).long()
            cfg = RenderConfig(intersect="reference")
            if name == "rows":
                dist, idx, r = ring.nearest_hit_ring_rows(
                    o, d, table[:, :15], src, cfg, mesh)
                outs = (dist, idx, r)
                loss = (r * torch.from_numpy(p["gw"][rays, :15])).sum()
            else:
                u = torch.from_numpy(p["u"][rays])
                dist, idx, r, li, lr = ring.nearest_and_select_ring(
                    o, d, table, src, u, spec["prim_lights"], cfg, mesh)
                outs = (dist, idx, r, li, lr)
                loss = (r * torch.from_numpy(p["gw"][rays])).sum() \\
                    + (lr * torch.from_numpy(p["gl"][rays])).sum()
            loss = loss + (torch.where(idx >= 0, dist, 0.0)
                           * torch.from_numpy(p["gd"][rays])).sum()
            grads = torch.autograd.grad(loss, [table, o, d])
            got[name] = ([x.detach() for x in outs], list(grads))
        table = torch.from_numpy(p["table"][rows])
        o, d = torch.from_numpy(p["o"][rays]), torch.from_numpy(p["d"][rays])
        u = torch.from_numpy(p["u"][rays])
        dist, idx = ring.nearest_hit_ring(
            o, d, table[:, 0:3], table[:, 3:6], table[:, 6:9],
            torch.from_numpy(p["src"][rays]).long(), None, mesh)
        tg, ts = table.clone().requires_grad_(), table.clone().requires_grad_()
        gathered = ring.ring_gather_rows(tg, idx.clamp_min(0), mesh)
        li, lrows = ring.ring_light_select_rows(ts, u, spec["prim_lights"],
                                                mesh)
        loss = (gathered * torch.from_numpy(p["gw"][rays])).sum() \
            + (lrows * torch.from_numpy(p["gl"][rays])).sum()
        got["companions"] = (
            [dist, idx, gathered.detach(), li, lrows.detach(),
             ring.ring_light_select(table[:, 16], u, spec["prim_lights"],
                                    mesh)],
            list(torch.autograd.grad(loss, [tg, ts])))
        return got

    if rank < 2:
        res["primitives"] = primitives(mesh2)
        scene = default_scene(cpu)
        flat = RenderConfig(width=size["width"], height=size["height"])
        res["flat"] = ring.render_flat_ring(scene, cam, flat, mesh2)
        for name, est in spec["frames"].items():
            cfg = RenderConfig(**size, **est)
            res[f"frame/{name}"] = ring.render_pt_ring(scene, cam, cfg,
                                                       mesh2, seed)
        for name in spec["grads"]:
            cfg = RenderConfig(**size, **spec["frames"][name])
            res[f"grad/{name}"] = six(scene, cfg, mesh2, weights)
            res[f"again/{name}"] = six(scene, cfg, mesh2, weights)
        rcfg = RenderConfig(**spec["remat"])
        w = torch.ones((rcfg.height, rcfg.width, 3))
        res["remat"] = six(scene, rcfg, mesh2, w)
        res["no_remat"] = six(scene, rcfg.replace(remat=False), mesh2, w)
        wall = make_scene(*(np.asarray(spec["wall"][k], np.float32)
                            for k in ("v", "a", "e")), cpu)
        cfg = RenderConfig(**size)
        target = ring.render_radiance_ring(wall, cam, cfg, mesh2, seed)
        state = Scene(wall.vertices, torch.from_numpy(np.asarray(
            spec["albedo0"], np.float32)), wall.emission, wall.light_idx)
        losses = []
        for _ in range(spec["train_steps"]):
            loss, state = ring.ring_train_step(state, cam, cfg, mesh2,
                                               target, seed,
                                               spec["train_lr"])
            losses.append(float(loss))
        res["losses"] = losses
        res["trained_albedo"] = state.albedo
    scene = default_scene(cpu)
    for name in ("lcg", "hash"):
        cfg = RenderConfig(**size, **spec["frames"][name])
        res[f"frame3/{name}"] = ring.render_pt_ring(scene, cam, cfg, mesh3,
                                                    seed)
    cfg = RenderConfig(**size, **spec["frames"]["hash"])
    res["grad3"] = six(scene, cfg, mesh3, weights)
    res["again3"] = six(scene, cfg, mesh3, weights)
    torch.save(res, f"{out}/rank{rank}.pt")
    print("WORKER_OK", rank)
''')


def _wall() -> dict:
    """``tests/test_nee.py``'s silhouette-free scene, a wall far wider than
    the view and an area light behind the camera: ``ring_train_step``
    steps every leaf, and on the 7-triangle scene any vertex step flips
    its edge-tie pixels (``tests/test_ring_grad.py:248-262``; measured
    here: the loss rises at every lr from 0.5 to 8)."""
    scene = _wall_and_light_scene()
    return {k: np.asarray(x).tolist() for k, x in (
        ("v", scene.vertices), ("a", scene.albedo), ("e", scene.emission))}


def _perturbed(albedo: np.ndarray) -> np.ndarray:
    """Appearance only: the albedo raised by 0.25, clipped to 1."""
    return np.clip(albedo + 0.25, 0.0, 1.0)


def _j_ring(scene, o, d, seed, cfg, n_shards, w=None):
    """JAX's ring, ``ring_radiance_from_rays``'s shards on a named axis of
    ``n_shards`` (``jax.vmap(axis_name="shard")``, which binds
    ``ppermute`` and ``axis_index`` as ``shard_map`` does), op by op.
    Returns the ``(N, 3)`` radiance and, given weights ``w``, the scene's
    gradients of ``sum(w * radiance)``: the table adjoint comes out
    sharded, as from ``shard_map``'s transpose, and goes through
    ``_ring_table``'s VJP."""
    n = o.shape[0]
    ids = jnp.arange(n, dtype=jnp.uint32)
    leaves = (scene.vertices, scene.albedo, scene.emission)
    with jax.disable_jit():
        table, back = jax.vjp(lambda v, a, e: JR._ring_table(
            JScene(v, a, e), cfg, n_shards), *leaves)
        k = table.shape[1]

        def shard(tt, oo, dd, pp, ww):
            def loss(t):
                rad = JR._trace_ring(t, oo, dd, pp, cfg, jnp.asarray(seed),
                                     "shard", scene.n_tris)
                return jnp.sum(rad * ww), rad
            if w is None:
                return loss(tt)[1]
            return jax.value_and_grad(loss, has_aux=True)(tt)

        split = [x.reshape(n_shards, -1, *x.shape[1:]) for x in (
            table, o, d, ids, jnp.ones((n, 3)) if w is None else w)]
        out = jax.vmap(shard, axis_name="shard")(*split)
        if w is None:
            return np.asarray(out).reshape(n, 3), None
        (_, rad), g = out
        grads = back(g.reshape(-1, k))
        return np.asarray(rad).reshape(n, 3), [np.asarray(x) for x in grads]


def _j_primitives(p: dict) -> dict:
    """JAX's ``nearest_hit_ring_rows`` and ``nearest_and_select_ring`` on
    two shards of ``tests/test_ring_grad.py:206-245``'s kind of inputs, on
    a named axis of two, op by op (``_j_ring``): the outputs, and the
    gradients of the workers' loss (a ``psum`` of the shards' parts in a
    ``shard_map``) in the table, ``o`` and ``d``."""
    cfg = JConfig(intersect="reference")
    keys = ("table", "o", "d", "src", "u", "gw", "gl", "gd")
    args = [jnp.asarray(p[k]).reshape(2, -1, *p[k].shape[1:]) for k in keys]
    got = {}
    for name in ("rows", "sweepsel"):
        def shard(tbl, o, d, src, u, gw, gl, gd):
            def loss(tbl, o, d):
                if name == "rows":
                    res = JR.nearest_hit_ring_rows(o, d, tbl[:, :15], src,
                                                   cfg, "shard")
                    val = jnp.sum(res[2] * gw[:, :15])
                else:
                    res = JR.nearest_and_select_ring(
                        o, d, tbl, src, u, PRIM_LIGHTS, cfg, "shard")
                    val = jnp.sum(res[2] * gw) + jnp.sum(res[4] * gl)
                val = val + jnp.sum(jnp.where(res[1] >= 0, res[0], 0.0) * gd)
                return val, res
            (_, res), grads = jax.value_and_grad(
                loss, argnums=(0, 1, 2), has_aux=True)(tbl, o, d)
            return res, grads

        with jax.disable_jit():
            res, grads = jax.vmap(shard, axis_name="shard")(*args)
        got[name] = ([np.asarray(x).reshape(-1, *x.shape[2:]) for x in res],
                     [np.asarray(g).reshape(-1, *g.shape[2:])
                      for g in grads])
    return got


def _jax_references(prim: dict) -> dict:
    jcam, scene = JCamera.default(), j_default_scene()
    with jax.disable_jit():
        o, d = j_generate_rays(jcam, SIZE["width"], SIZE["height"])
    w = jnp.asarray(_weights((SIZE["height"] * SIZE["width"], 3)))
    ref = {"primitives": _j_primitives(prim)}
    for name, (est, _) in FRAMES.items():
        cfg = JConfig(**SIZE, **est)
        ref[name] = _j_ring(scene, o, d, SEED, cfg, 2,
                            w if name == "hash" else None)
    return ref


@pytest.fixture(scope="module")
def ring_ranks(tmp_path_factory):
    """The three ranks' results ``[rank0, rank1, rank2]`` and the JAX
    references, computed while the ranks run."""
    out = tmp_path_factory.mktemp("ring_ranks")
    prim = _primitive_inputs()
    np.savez(out / "prim.npz", **prim)
    torch.save(torch.from_numpy(_weights((SIZE["height"], SIZE["width"],
                                          3))), out / "weights.pt")
    spec = dict(size=SIZE, seed=SEED, grads=GRADS, remat=REMAT,
                frames={k: v[0] for k, v in FRAMES.items()},
                prim_lights=PRIM_LIGHTS, train_lr=TRAIN_LR,
                train_steps=TRAIN_STEPS, wall=_wall(),
                albedo0=_perturbed(np.asarray(_wall()["a"])).tolist())
    (out / "spec.json").write_text(json.dumps(spec))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(port), str(out)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(3)]
    ref = _jax_references(prim)         # while the ranks run
    for p in procs:
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0 and "WORKER_OK" in log, log[-3000:]
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(3)], ref


def test_ranks_start_on_gloo_and_import_no_jax(ring_ranks):
    for r in ring_ranks[0]:
        assert r["jax"] == [] and r["backend"] == "gloo"


def test_make_mesh_2d_grids(ring_ranks):
    """The JAX package's row-major ``(rays, tris)`` grid of the first
    ``n * m`` ranks; each rank's ``tris`` row is the ring's mesh, and a
    rank outside the grid has neither axis."""
    for rank, r in enumerate(ring_ranks[0]):
        g = r["grids"]
        assert g["[1, 3]"] == (((0, 1, 2),), (1, 3),
                               ((0, 1, 2), "tris", (rank,), "rays"))
        assert g["[3, 1]"] == (((0,), (1,), (2,)), (3, 1),
                               ((rank,), "tris", (0, 1, 2), "rays"))
        want = None if rank == 2 else ((0, 1), "tris", (rank,), "rays")
        assert g["[1, 2]"] == (((0, 1),), (1, 2), want)


@pytest.mark.parametrize("name", ["rows", "sweepsel"])
def test_primitives_held_to_jax(ring_ranks, name):
    """``nearest_hit_ring_rows`` (distance, index, rows) and
    ``nearest_and_select_ring`` (and the light's index and rows) equal
    JAX's on the same shards bit for bit; their backwards (the table's
    shards, ``o``, ``d``) within rtol 1e-5 and 1e-6 of each one's max."""
    res, ref = ring_ranks
    j_outs, j_grads = ref["primitives"][name]
    outs = [torch.cat([r["primitives"][name][0][i] for r in res[:2]])
            for i in range(len(j_outs))]
    grads = [torch.cat([r["primitives"][name][1][i] for r in res[:2]])
             for i in range(3)]
    for got, want in zip(outs, j_outs):
        np.testing.assert_array_equal(got.numpy(), want.astype(
            got.numpy().dtype))
    hits = int((outs[1] >= 0).sum())
    assert 0 < hits < PRIM_RAYS
    if name == "sweepsel":
        li = outs[3].numpy()
        assert (li == PRIM_LIGHTS - 1).any() and len(set(li)) > 3
    j_grads[0] = j_grads[0][:, :15] if name == "rows" else j_grads[0]
    for got, want in zip(grads, j_grads):
        got = got.numpy()[:, :want.shape[1]]
        np.testing.assert_allclose(got, want, rtol=PRIM_RTOL,
                                   atol=PRIM_ATOL * np.abs(want).max())
    assert np.abs(grads[0].numpy()).max() > 0


def test_companion_primitives(ring_ranks):
    """``nearest_hit_ring`` then ``ring_gather_rows(max(idx, 0))`` give the
    fused sweep's distance, index and rows, and ``ring_light_select`` and
    ``ring_light_select_rows`` its light index and rows, bit for bit (the
    JAX package's equivalences); the two gathers' table adjoints are the
    float64 scatter of their row cotangents to within two roundings (one
    K7 sum a ring step)."""
    res, ref = ring_ranks
    prim = _primitive_inputs()
    outs, grads = ([torch.cat([r["primitives"]["companions"][k][i]
                               for r in res[:2]]) for i in range(n)]
                   for k, n in ((0, 6), (1, 2)))
    dist, idx, rows, li, lrows, li_cdf = (x.numpy() for x in outs)
    j_dist, j_idx, j_rows, j_li, j_lrows = ref["primitives"]["sweepsel"][0]
    for got, want in ((dist, j_dist), (idx, j_idx), (rows, j_rows),
                      (li, j_li), (lrows, j_lrows), (li_cdf, j_li)):
        np.testing.assert_array_equal(got, want.astype(got.dtype))
    for g, at, cot in ((grads[0], np.maximum(idx, 0), prim["gw"]),
                       (grads[1], li, prim["gl"])):
        want = np.zeros((PRIM_ROWS, 17))
        np.add.at(want, at, cot.astype(np.float64))
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-6,
                                   atol=1e-7 * np.abs(want).max())


def test_flat_bit_equal_to_one_device(ring_ranks):
    cfg = RenderConfig(width=SIZE["width"], height=SIZE["height"])
    want = render_flat(default_scene(CPU), Camera.default(CPU), cfg)
    for r in ring_ranks[0][:2]:
        assert torch.equal(r["flat"], want)


@pytest.mark.parametrize("name", list(FRAMES))
def test_frames_bit_equal_to_one_device_and_held_to_jax(ring_ranks, name):
    """Both ranks' frames equal the one-device wavefront's to the bit, and
    JAX's ring frame under ``_assert_images_match`` with JAX's budget."""
    res, ref = ring_ranks
    est, budget = FRAMES[name]
    cfg = RenderConfig(**SIZE, **est)
    want = render_pt(default_scene(CPU), Camera.default(CPU), cfg, SEED)
    for r in res[:2]:
        assert torch.equal(r[f"frame/{name}"], want)
    j_frame = np.clip(ref[name][0], 0.0, 1.0).reshape(want.shape)
    _assert_images_match(res[0][f"frame/{name}"].numpy(), j_frame, budget)
    assert float(want.max()) > 0.1


@pytest.mark.parametrize("name", GRADS)
def test_gradients_match_one_device(ring_ranks, name):
    """The six gradients within 1e-5 of each group's max of the one-device
    wavefront's, bitwise equal on both ranks and over two runs."""
    res = ring_ranks[0]
    cfg = RenderConfig(**SIZE, **FRAMES[name][0])
    want = _one_device_grads(default_scene(CPU), cfg)
    for r in res[:2]:
        for a, b in zip(r[f"grad/{name}"], r[f"again/{name}"]):
            assert torch.equal(a, b)
        _assert_grads_close(r[f"grad/{name}"], want, f"two ranks, {name}")
    for a, b in zip(res[0][f"grad/{name}"], res[1][f"grad/{name}"]):
        assert torch.equal(a, b)
    assert float(res[0][f"grad/{name}"][1].abs().max()) > 0


def test_scene_gradient_held_to_jax(ring_ranks):
    """The scene's gradients against JAX's ring within tests/
    test_ring_grad.py:112's bounds."""
    res, ref = ring_ranks
    for got, want in zip(res[0]["grad/hash"][:3], ref["hash"][1]):
        scale = max(np.abs(want).max(), 1e-12)
        np.testing.assert_allclose(got.numpy(), want, rtol=RING_RTOL,
                                   atol=RING_ATOL * scale)


def test_remat_equals_no_remat(ring_ranks):
    """Nine samples checkpointed one by one (their rotations run again in
    the backward pass, in the same order on every rank) give the
    gradients of the uncheckpointed trace, bit for bit."""
    res = ring_ranks[0]
    for r in res[:2]:
        for a, b in zip(r["remat"], r["no_remat"]):
            assert torch.equal(a, b)
        assert float(r["remat"][0].abs().max()) > 0
    for a, b in zip(res[0]["remat"], res[1]["remat"]):
        assert torch.equal(a, b)


def test_train_step_lowers_the_loss(ring_ranks):
    """Three ``ring_train_step`` steps (every leaf steps, lr 1) on the
    wall-and-light scene from a perturbed albedo lower the loss, the same
    on both ranks."""
    res = ring_ranks[0]
    losses = res[0]["losses"]
    assert len(losses) == TRAIN_STEPS and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert losses == res[1]["losses"]
    assert torch.equal(res[0]["trained_albedo"], res[1]["trained_albedo"])


def test_three_ranks(ring_ranks):
    """The 7-triangle scene on three ranks: the table pads to 9 rows, the
    light fallback's row 6 lies with rank 2. Frames bit-equal to one
    device's, gradients within 1e-5 of each group's max, bitwise equal
    across the ranks and over two runs."""
    res = ring_ranks[0]
    scene, cam = default_scene(CPU), Camera.default(CPU)
    for name in ("lcg", "hash"):
        cfg = RenderConfig(**SIZE, **FRAMES[name][0])
        want = render_pt(scene, cam, cfg, SEED)
        for r in res:
            assert torch.equal(r[f"frame3/{name}"], want)
    cfg = RenderConfig(**SIZE, **FRAMES["hash"][0])
    want = _one_device_grads(scene, cfg)
    for r in res:
        for a, b in zip(r["grad3"], r["again3"]):
            assert torch.equal(a, b)
        _assert_grads_close(r["grad3"], want, "three ranks")
        for a, b in zip(r["grad3"], res[0]["grad3"]):
            assert torch.equal(a, b)
