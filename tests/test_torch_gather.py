"""``spath_tpu_torch/ops/gather.py`` on the CPU: the row gather whose
backward adds in a fixed order, against ``index_select`` and
``index_add_`` and against the JAX package's ``fused_row_gather``
(``spath_tpu/ops/gather.py``, a one-hot matmul) on the same numpy inputs;
the stacked-column path that the card's backward takes (K7, whose plain
version runs on CPU tensors) and its padding to K7's widths."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spath_tpu.ops.gather import fused_row_gather  # noqa: E402
from spath_tpu_torch.ops import gather  # noqa: E402
from spath_tpu_torch.ops.kernels import stream_scatter as ss  # noqa: E402

#: the backward against index_add_ and jax.grad, relative to the max
BWD_RTOL = 1e-6


def _inputs(seed: int, t: int = 7, n: int = 300, widths=(3, 3, 3, 1)):
    rng = np.random.default_rng(seed)
    tables = [rng.normal(size=(t, w)).astype(np.float32) for w in widths]
    idx = rng.integers(0, t, size=n).astype(np.int64)
    idx[: n // 3] = 2                       # a hot row, as a camera hit is
    cot = [rng.normal(size=(n, w)).astype(np.float32) for w in widths]
    return tables, idx, cot


def _grads(tables, idx, cot, fn):
    leaves = [torch.from_numpy(t).requires_grad_() for t in tables]
    out = fn(torch.from_numpy(idx), *leaves)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(out, cot))
    return out, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_bit_equal_to_index_select_and_jax(seed):
    tables, idx, _ = _inputs(seed)
    got = gather.gather_rows(torch.from_numpy(idx),
                             *map(torch.from_numpy, tables))
    jgot = fused_row_gather([jnp.asarray(t) for t in tables],
                            jnp.asarray(idx, dtype=jnp.int32))
    for g, t, j in zip(got, tables, jgot):
        want = torch.from_numpy(t).index_select(0, torch.from_numpy(idx))
        assert torch.equal(g, want)
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))


@pytest.mark.parametrize("seed", [0, 1])
def test_backward_matches_index_add_and_jax_grad(seed):
    tables, idx, cot = _inputs(seed)
    _, got = _grads(tables, idx, cot, gather.gather_rows)
    _, want = _grads(tables, idx, cot, lambda i, *ts: tuple(
        t.index_select(0, i) for t in ts))

    def jloss(ts):
        rows = fused_row_gather(ts, jnp.asarray(idx, dtype=jnp.int32))
        return sum((r * c).sum() for r, c in zip(rows, cot))

    with jax.disable_jit():
        jgrad = jax.grad(jloss)([jnp.asarray(t) for t in tables])
    for g, w, j in zip(got, want, jgrad):
        scale = w.abs().max().item()
        assert (g - w).abs().max().item() <= BWD_RTOL * scale
        assert np.abs(g.numpy() - np.asarray(j)).max() <= BWD_RTOL * scale


def test_backward_skips_tables_without_grad():
    tables, idx, cot = _inputs(2)
    leaves = [torch.from_numpy(t) for t in tables]
    leaves[0].requires_grad_()
    out = gather.gather_rows(torch.from_numpy(idx), *leaves)
    (g,) = torch.autograd.grad((out[0] * torch.from_numpy(cot[0])).sum(),
                               [leaves[0]])
    want = torch.zeros(7, 3).index_add_(0, torch.from_numpy(idx),
                                        torch.from_numpy(cot[0]))
    assert torch.equal(g, want)


@pytest.mark.parametrize("cols, width", [(1, 9), (9, 9), (10, 19), (13, 19),
                                         (19, 19)])
def test_stacked_columns_pad_to_k7_widths(cols, width):
    assert gather.k7_width(cols) == width
    assert width in ss.WIDTHS


def test_more_columns_than_k7_takes_are_refused():
    with pytest.raises(ValueError, match="more than K7"):
        gather.k7_width(20)


@pytest.mark.parametrize("widths", [(3, 3, 3), (3, 3, 3, 3, 1), (9, 1),
                                    (2,), (19,)])
def test_stacked_columns_through_k7_plain_match_index_add(widths):
    """The card's path on CPU tensors: the rows stacked, zero padded to
    K7's width, added by ``stream_scatter_call`` (its float64 plain
    version here) and cut apart, equal to each table's ``index_add_``
    within BWD_RTOL of its max; the padding adds nothing."""
    t, n = 11, 500
    rng = np.random.default_rng(len(widths))
    idx = torch.from_numpy(rng.integers(0, t, size=n).astype(np.int64))
    grads = [torch.from_numpy(rng.normal(size=(n, w)).astype(np.float32))
             for w in widths]
    calls = ss.stream_scatter_call.launches
    got = gather.scatter_backward(idx, grads, t)
    assert ss.stream_scatter_call.launches == calls  # CPU: no launch
    for g, v in zip(got, grads):
        want = torch.zeros(t, v.shape[1]).index_add_(0, idx, v)
        assert g.shape == want.shape
        scale = want.abs().max().item()
        assert (g - want).abs().max().item() <= BWD_RTOL * scale


def test_rows_of_one_count():
    with pytest.raises(ValueError, match="one row count"):
        gather.gather_rows(torch.zeros(3, dtype=torch.int64),
                           torch.zeros(4, 3), torch.zeros(5, 3))


def test_plain_sweep_gathers_with_index_select_itself():
    """Inside ``plain_sweep()``, where the kernels' plain versions run,
    ``gather_rows`` is ``index_select`` with its own backward (no K7 on
    the card), the same bits forward and backward as index_select's."""
    from spath_tpu_torch.ops.intersect import plain_sweep

    tables, idx, cot = _inputs(3)
    with plain_sweep():
        out, got = _grads(tables, idx, cot, gather.gather_rows)
    assert all(type(o.grad_fn).__name__.startswith("IndexSelectBackward")
               for o in out)
    want_out, want = _grads(tables, idx, cot, lambda i, *ts: tuple(
        t.index_select(0, i) for t in ts))
    for o, w in zip(out, want_out):
        assert torch.equal(o, w)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    out = gather.gather_rows(torch.from_numpy(idx), *(
        torch.from_numpy(t).requires_grad_() for t in tables))
    assert not any(type(o.grad_fn).__name__.startswith("IndexSelect")
                   for o in out)


def test_vis_grad_hit_rows_are_one_gather_of_19_columns(monkeypatch):
    """With ``vis_grad`` the walk gathers the hit's normal, albedo,
    emission, v0, e1 and e2 in one call a bounce (18 columns: one K7
    launch of 19 on the card); without it, three tables."""
    from spath_tpu_torch.camera import Camera
    from spath_tpu_torch.config import RenderConfig
    from spath_tpu_torch.models import pathtracer
    from spath_tpu_torch.scene import default_scene

    calls = []
    inner = pathtracer.gather_rows

    def record(index, *tables):
        calls.append(sum(t[:1].numel() for t in tables))
        return inner(index, *tables)

    monkeypatch.setattr(pathtracer, "gather_rows", record)
    cpu = torch.device("cpu")
    scene, cam = default_scene(cpu), Camera.default(cpu)
    cfg = RenderConfig(width=8, height=4, spp=1, max_bounces=2,
                       vis_grad=True)
    leaves = [scene.vertices.clone().requires_grad_()]
    img = pathtracer.render_radiance(
        type(scene)(leaves[0], scene.albedo, scene.emission,
                    scene.light_idx), cam, cfg, 0)
    assert calls and set(calls) == {18}
    assert gather.k7_width(calls[0]) == 19
    torch.autograd.grad(img.sum(), leaves)
    calls.clear()
    pathtracer.render_radiance(scene, cam, cfg.replace(vis_grad=False), 0)
    assert calls and set(calls) == {9}


def test_sweep_and_light_rows_gather_through_gather_rows(monkeypatch):
    """The wavefront's gathers of the light samples
    (``nee.sample_light_points``) and, in the sweep's backward, of the
    selected triangles (``intersect._dist_selected``) are ``gather_rows``,
    whose backward adds in a fixed order on the card (``index_select``'s
    adds with float atomics there); on the CPU the gradients are the bits
    of ``index_select``'s backward, which ``plain_sweep()`` keeps."""
    from spath_tpu_torch.camera import Camera
    from spath_tpu_torch.config import RenderConfig
    from spath_tpu_torch.models import pathtracer
    from spath_tpu_torch.ops import nee
    from spath_tpu_torch.ops.intersect import plain_sweep
    from spath_tpu_torch.scene import Scene, default_scene

    calls = []

    def recorder(tag, inner):
        def record(index, *tables):
            calls.append(tag)
            return inner(index, *tables)
        return record

    monkeypatch.setattr(gather, "gather_rows",
                        recorder("sweep", gather.gather_rows))
    monkeypatch.setattr(nee, "gather_rows", recorder("light", nee.gather_rows))
    cpu = torch.device("cpu")
    scene, cam = default_scene(cpu), Camera.default(cpu)
    cfg = RenderConfig(width=8, height=4, spp=1, max_bounces=2, rng="hash",
                       sampler="cosine", nee=True)

    def grads():
        leaves = [scene.vertices.clone().requires_grad_(),
                  scene.emission.clone().requires_grad_()]
        img = pathtracer.render_radiance(
            Scene(leaves[0], scene.albedo, leaves[1], scene.light_idx), cam,
            cfg, 0)
        return torch.autograd.grad(img.sum(), leaves)

    got = grads()
    assert "light" in calls and "sweep" in calls
    with plain_sweep():
        want = grads()
    for g, w in zip(got, want):
        assert torch.equal(g, w) and float(g.abs().max()) > 0
