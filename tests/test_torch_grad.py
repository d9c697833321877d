"""Gradients of the port's wavefront on the CPU (BASELINE config 3):
``render_radiance`` against ``jax.grad`` of the JAX package's
``render_radiance`` on the same scene, camera and seeds, against central
finite differences of the port's own render, and the nearest-hit
Function's distance VJP. Detached sampling: the render is a
deterministic function of the parameters for a fixed seed, and sampled
directions are constants of the backward pass (tests/test_grad.py)."""

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
from spath_tpu.ops.intersect import nearest_hit as j_nearest_hit  # noqa: E402
from spath_tpu.scene import Scene as JScene  # noqa: E402
from spath_tpu.scene import default_scene as j_default_scene  # noqa: E402
from spath_tpu_torch.camera import Camera  # noqa: E402
from spath_tpu_torch.config import RenderConfig  # noqa: E402
from spath_tpu_torch.models.pathtracer import render_radiance  # noqa: E402
from spath_tpu_torch.ops.intersect import (  # noqa: E402
    nearest_hit, nearest_hit_edges,
)
from spath_tpu_torch.scene import Scene, default_scene  # noqa: E402

CPU = torch.device("cpu")
#: tests/test_grad.py's CFG
SIZE = dict(width=24, height=16, spp=4, rng="lcg", sampler="angle")
FIELDS = ("vertices", "albedo", "emission")


def _port_loss(values: dict) -> float:
    base = default_scene(CPU)
    fields = {k: torch.as_tensor(np.asarray(values.get(k, getattr(base, k)),
                                            np.float32)) for k in FIELDS}
    with torch.no_grad():
        return render_radiance(Scene(**fields), Camera.default(CPU),
                               RenderConfig(**SIZE)).sum().item()


def _port_grads():
    base = default_scene(CPU)
    leaves = [getattr(base, k).clone().requires_grad_() for k in FIELDS]
    img = render_radiance(Scene(*leaves), Camera.default(CPU),
                          RenderConfig(**SIZE))
    return [g.numpy() for g in torch.autograd.grad(img.sum(), leaves)]


def _fd_grad(f, x, eps):
    """Central finite differences of scalar ``f`` at array ``x``
    (tests/test_grad.py)."""
    x = np.asarray(x, np.float64)
    g = np.zeros_like(x)
    flat, xf = g.reshape(-1), x.reshape(-1)
    for i in range(xf.size):
        xp, xm = xf.copy(), xf.copy()
        xp[i] += eps
        xm[i] -= eps
        flat[i] = (f(xp.reshape(x.shape)) - f(xm.reshape(x.shape))) \
            / (2 * eps)
    return g


def test_render_radiance_grads_match_jax():
    """Vertex, albedo and emission gradients of the summed frame against
    ``jax.grad`` of the JAX package's ``render_radiance`` run op by op
    (``jax.disable_jit``): the same program, so the bound is sum-order
    noise, 1e-5·max|grad|; observed 1.1e-7 (vertices), 8e-10 (albedo),
    0 (emission). Jitted, the JAX program rounds some multiply-adds
    otherwise and flips 3 of these 384 pixels, which moves the albedo
    gradient by 7.9% of its max, beyond tests/test_grad.py's 0.03 bound."""
    js = j_default_scene()

    def loss(vertices, albedo, emission):
        return jnp.sum(j_render_radiance(JScene(vertices, albedo, emission),
                                         JCamera.default(), JConfig(**SIZE)))

    with jax.disable_jit():
        want = jax.grad(loss, argnums=(0, 1, 2))(
            js.vertices, js.albedo, js.emission)
    for name, g, w in zip(FIELDS, _port_grads(), want):
        w = np.asarray(w)
        scale = np.abs(w).max()
        assert scale > 0, name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * scale,
                                   err_msg=name)


def test_grad_albedo_matches_fd():
    base = default_scene(CPU).albedo.numpy()
    fd = _fd_grad(lambda a: _port_loss({"albedo": a}), base, eps=1e-2)
    scale = np.abs(fd).max()
    assert scale > 0
    np.testing.assert_allclose(_port_grads()[1], fd, rtol=0,
                               atol=3e-2 * scale)


def test_grad_emission_matches_fd():
    """Radiance is linear in emission: FD matches to float precision."""
    base = default_scene(CPU).emission.numpy()
    fd = _fd_grad(lambda e: _port_loss({"emission": e}), base, eps=1e-2)
    np.testing.assert_allclose(_port_grads()[2], fd, rtol=0,
                               atol=1e-3 * max(np.abs(fd).max(), 1))


def test_grad_vertices_finite_and_nonzero():
    g = _port_grads()[0]
    assert np.isfinite(g).all() and np.abs(g).max() > 0


def _hit_problem():
    o = np.array([[0.1, 0.2, -1.0], [0.0, -0.1, -2.0]], np.float32)
    d = np.array([[0.05, -0.02, 1.0], [0.0, 0.1, 1.0]], np.float32)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    verts = np.array([[[-2.0, -2.0, 1.0], [2.0, -2.0, 1.0],
                       [0.0, 2.5, 1.0]]], np.float64)
    return o, d, verts


def _port_dist_sum(o, d, verts, grad=False):
    v = torch.tensor(np.asarray(verts, np.float32), requires_grad=grad)
    dist, _ = nearest_hit(torch.from_numpy(o), torch.from_numpy(d),
                          v[:, 0], v[:, 1], v[:, 2],
                          torch.full((2,), -1, dtype=torch.int64),
                          method="reference")
    return dist.sum(), v


def test_hit_distance_vjp_matches_jax_and_fd():
    """The geometric core of vertex gradients: the nearest-hit distance's
    VJP, against the JAX package's custom VJP and against FD
    (tests/test_grad.py's bounds)."""
    o, d, verts = _hit_problem()
    total, v = _port_dist_sum(o, d, verts, grad=True)
    (g,) = torch.autograd.grad(total, [v])
    g = g.numpy()

    def j_dist_sum(vv):
        dist, _ = j_nearest_hit(jnp.asarray(o), jnp.asarray(d), vv[:, 0],
                                vv[:, 1], vv[:, 2],
                                jnp.asarray([-1, -1], jnp.int32),
                                method="reference")
        return jnp.sum(dist)

    want = np.asarray(jax.grad(j_dist_sum)(jnp.asarray(verts, jnp.float32)))
    np.testing.assert_allclose(g, want, rtol=0, atol=1e-5 * np.abs(want).max())
    fd = _fd_grad(lambda vv: _port_dist_sum(o, d, vv)[0].item(), verts,
                  eps=1e-3)
    np.testing.assert_allclose(g, fd, rtol=0, atol=2e-3 * np.abs(fd).max())


def test_hit_distance_vjp_of_rays_matches_jax():
    """The same VJP with respect to the rays, misses included: a miss has
    distance 1e12 and no gradient."""
    o, d, verts = _hit_problem()
    o = np.concatenate([o, [[5.0, 5.0, -1.0]]]).astype(np.float32)
    d = np.concatenate([d, [[0.0, 0.0, 1.0]]]).astype(np.float32)
    ot = torch.from_numpy(o).requires_grad_()
    dt = torch.from_numpy(d).requires_grad_()
    v = torch.from_numpy(verts.astype(np.float32))
    dist, idx = nearest_hit(ot, dt, v[:, 0], v[:, 1], v[:, 2],
                            torch.full((3,), -1, dtype=torch.int64))
    assert idx.tolist() == [0, 0, -1]
    go, gd = torch.autograd.grad(dist.sum(), [ot, dt])

    def j_dist_sum(oo, dd):
        dist, _ = j_nearest_hit(oo, dd, verts[:, 0].astype(np.float32),
                                verts[:, 1].astype(np.float32),
                                verts[:, 2].astype(np.float32),
                                jnp.full((3,), -1, jnp.int32))
        return jnp.sum(dist)

    jo, jd = jax.grad(j_dist_sum, argnums=(0, 1))(jnp.asarray(o),
                                                  jnp.asarray(d))
    for got, want in ((go, jo), (gd, jd)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        assert not got[2].any()


def test_nearest_hit_saves_only_o_n_tensors():
    """The Function keeps ``(o, d, v0, e1, e2, idx)``: O(N + T), never the
    sweep's (N, B) blocks; a whole differentiable render keeps nothing
    larger than a frame of 3-vectors either."""
    n = 16 * 12
    cam = Camera.default(CPU)
    scene = default_scene(CPU)
    verts = scene.vertices.clone().requires_grad_()
    tri = Scene(verts, scene.albedo, scene.emission)
    o = torch.zeros((n, 3), requires_grad=True)
    d = torch.ones((n, 3)) / 3 ** 0.5
    dist, _ = nearest_hit_edges(o, d, tri.v0, tri.v1 - tri.v0,
                                tri.v2 - tri.v0,
                                torch.full((n,), -1, dtype=torch.int64))
    shapes = [tuple(t.shape) for t in dist.grad_fn.saved_tensors]
    assert shapes == [(n, 3), (n, 3), (7, 3), (7, 3), (7, 3), (n,)]

    sizes = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: sizes.append(t.numel()) or t, lambda t: t):
        img = render_radiance(tri, cam, RenderConfig(width=16, height=12,
                                                     spp=2))
    torch.autograd.grad(img.sum(), [verts])
    assert sizes and max(sizes) <= 3 * n
