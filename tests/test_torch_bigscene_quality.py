"""The streamed quality kernels' wrappers on the CPU: K9 (forward), K10
(backward, through the stream scatter K7 at 19 columns) and the light
distribution beyond one block. Their plain versions against the JAX
package on the same numpy inputs (the wavefront run op by op, and the
streamed Pallas kernels in interpret mode), the binary-search light
choice against ``np.searchsorted``, the events of K10's layout summed by
K7's plain version, the JAX kernel's light choice at the top of the cdf,
the routing, which never hands a CUDA scene to a plain version, and the
wrappers' checks. The CUDA kernels themselves run only on the card
(``chip_smoke.py``)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from spath_tpu.camera import Camera as JCamera  # noqa: E402
from spath_tpu.config import RenderConfig as JConfig  # noqa: E402
from spath_tpu.models.pathtracer import (  # noqa: E402
    render_radiance as j_render_radiance,
)
from spath_tpu.ops import nee as jnee  # noqa: E402
from spath_tpu.ops.pallas import megakernel_bigscene_quality as jbq  # noqa
from spath_tpu.ops.pallas import megakernel_quality as jmq  # noqa: E402
from spath_tpu.scene import Scene as JScene  # noqa: E402
from spath_tpu.scene import default_scene as j_default_scene  # noqa: E402
from spath_tpu.scene import make_scene as j_make_scene  # noqa: E402
from spath_tpu.scene import procedural_scene as j_procedural  # noqa: E402
from spath_tpu_torch.camera import Camera, pixel_rays  # noqa: E402
from spath_tpu_torch.config import RenderConfig  # noqa: E402
from spath_tpu_torch.convert import scene_from_numpy  # noqa: E402
from spath_tpu_torch.models import pathtracer, renderer  # noqa: E402
from spath_tpu_torch.models.pathtracer import (  # noqa: E402
    render_pt_fast, render_radiance_fastgrad,
)
from spath_tpu_torch.ops import nee  # noqa: E402
from spath_tpu_torch.ops.kernels import bigscene as bs  # noqa: E402
from spath_tpu_torch.ops.kernels import bigscene_quality as bq  # noqa: E402
from spath_tpu_torch.ops.kernels import (  # noqa: E402
    bigscene_quality_grad as bqg,
)
from spath_tpu_torch.ops.kernels import light_cdf  # noqa: E402
from spath_tpu_torch.ops.kernels import megakernel_quality as mq  # noqa
from spath_tpu_torch.ops.kernels import (  # noqa: E402
    megakernel_quality_grad as mqg,
)
from spath_tpu_torch.ops.kernels import stream_scatter as ss  # noqa: E402
from spath_tpu_torch.scene import Scene, default_scene  # noqa: E402
from spath_tpu_torch.scene import procedural_scene  # noqa: E402

CPU = torch.device("cpu")
QUALITY = dict(rng="hash", sampler="cosine", nee=True, mis=True)
#: tests/test_bigscene_quality.py's forward frame: 512 rays, 1 sample of
#: 2 bounces
FWD = dict(width=32, height=16, spp=1, max_bounces=2, **QUALITY)
#: the backward frame (tests/test_bigscene_quality.py's gradient frame,
#: fewer samples): 384 rays, 1 sample of 3 bounces
BWD = dict(width=24, height=16, spp=1, max_bounces=3, **QUALITY)
FIELDS = ("vertices", "albedo", "emission")


def _combined_scene(n_extra=1143):
    """tests/test_bigscene_quality.py's scene: the default scene and
    procedural clutter, 5% emissive, n_extra + 7 triangles."""
    base = j_default_scene()
    proc = j_procedural(n_extra, seed=0, emissive_fraction=0.05)
    return j_make_scene(*(np.concatenate([np.asarray(getattr(base, k)),
                                          np.asarray(getattr(proc, k))])
                          for k in FIELDS))


@pytest.fixture(scope="module")
def combined():
    return _combined_scene()


@pytest.fixture(scope="module")
def combined256():
    """The 256-triangle cut of the same scene, built once a module."""
    return _combined_scene(249)


def _port_scene(js):
    return scene_from_numpy(np.asarray(js.vertices), np.asarray(js.albedo),
                            np.asarray(js.emission), js.light_idx,
                            device=CPU)


def _plain_image(js, cfg, seed=0):
    """The port's K9 entry on CPU tensors (its plain version), with the
    scene's light rows as the route passes them."""
    ps = _port_scene(js)
    out = bq.bigq_call(*mq.pack_rays(Camera.default(CPU), cfg, seed),
                       mq.quality_table(ps), bq.light_rows(ps), cfg)
    return out.reshape(cfg.height, cfg.width, 3).numpy()


# ---- the light choice and the light distribution ----


def _cdf_with_dark_runs(rng, n_rows):
    """A nondecreasing float32 cdf over ``n_rows`` light rows: a running
    float32 sum of probabilities with zero runs (dark rows repeat the value
    before them: ties), whose last value may lie below one."""
    p = rng.uniform(size=n_rows) * (rng.uniform(size=n_rows) < 0.7)
    p[rng.integers(0, n_rows)] += 0.1
    return np.add.accumulate((p / p.sum()).astype(np.float32),
                             dtype=np.float32)


def _light_choice_inputs(n_rows, lcdf):
    rng = np.random.default_rng(n_rows)
    n_tris = 3 * n_rows + 5
    rows = np.sort(rng.choice(n_tris - 1, size=n_rows, replace=False))
    top = np.float32(1.0 - 2.0 ** -24)
    u = np.concatenate([lcdf, np.nextafter(lcdf, np.float32(0)),
                        rng.uniform(size=200).astype(np.float32),
                        [np.float32(0), top]]).astype(np.float32)
    got = bq.select_light_plain(torch.from_numpy(lcdf),
                                torch.from_numpy(rows.astype(np.int32)),
                                torch.from_numpy(u), n_tris).numpy()
    return n_tris, rows, u, got


@pytest.mark.parametrize("n_rows", [0, 1, 2, 7, 16, 100, 1000])
def test_light_choice_plain_twin_is_searchsorted_clipped(n_rows):
    """``select_light_plain`` (the kernels' binary search) equals
    ``np.searchsorted(cdf, u, side='right')`` over the light rows, as the
    row, clipped to T - 1: on random nondecreasing cdfs with dark runs
    and ties, with ``u`` at every cdf value, just below each, uniform,
    and at the largest draw 1 - 2^-24; and for L = 0."""
    rng = np.random.default_rng(n_rows + 1)
    lcdf = (_cdf_with_dark_runs(rng, n_rows) if n_rows
            else np.zeros(0, np.float32))
    assert (np.diff(lcdf) >= 0).all()
    n_tris, rows, u, got = _light_choice_inputs(n_rows, lcdf)
    k = np.searchsorted(lcdf, u, side="right")
    want = (np.where(k < n_rows, rows[np.minimum(k, n_rows - 1)], n_tris - 1)
            if n_rows else np.full(u.shape, n_tris - 1))
    np.testing.assert_array_equal(got, want)
    if n_rows:
        assert (got == n_tris - 1).any() == bool((u >= lcdf[-1]).any())


def test_light_choice_where_the_blocked_scan_steps_down():
    """XLA's CPU blocked scan of 1000 probabilities (three levels) can
    step down by an ulp at a block boundary, so the cdf is not sorted
    there. The kernels' loop is PyTorch's upper bound, so the plain twin
    equals ``torch.searchsorted(right=True)`` (the plain version's
    choice, ``megakernel_quality._select_light``) at every ``u``; a
    sorted-array search (``np.searchsorted``) differs inside the steps."""
    rng = np.random.default_rng(1000)
    p = rng.uniform(size=1000) * (rng.uniform(size=1000) < 0.7)
    lcdf = light_cdf._scan((p / p.sum()).astype(np.float32))
    assert (np.diff(lcdf) < 0).any()
    n_tris, rows, u, got = _light_choice_inputs(1000, lcdf)
    t_rows = torch.from_numpy(rows.astype(np.int32))
    cdf = torch.zeros(n_tris)
    cdf[t_rows.long()] = torch.from_numpy(lcdf)
    want = mq._select_light(cdf, t_rows, torch.from_numpy(u))
    np.testing.assert_array_equal(got, want.numpy())
    k = np.searchsorted(lcdf, u, side="right")
    sorted_view = np.where(k < 1000, rows[np.minimum(k, 999)], n_tris - 1)
    assert (got != sorted_view).any()


def test_light_choice_equals_the_full_table_choice_of_the_wavefront(
        combined256):
    """On a scene's table, the binary search over the light rows picks
    the row ``megakernel_quality._select_light`` (searchsorted over the
    same rows) picks, and the wavefront's full-table choice."""
    ps = _port_scene(combined256)
    tri = mq.quality_table(ps)
    rows, lcdf = bq.kernel_inputs(tri, bq.light_rows(ps), CPU)
    u = torch.from_numpy(np.random.default_rng(3).uniform(
        size=4096).astype(np.float32))
    got = bq.select_light_plain(lcdf, rows, u, ps.n_tris)
    assert torch.equal(got, mq._select_light(tri[:, mq.COL_CDF], rows, u))
    every_row = torch.arange(ps.n_tris, dtype=torch.int32)
    assert torch.equal(got, mq._select_light(tri[:, mq.COL_CDF], every_row,
                                             u))


@pytest.mark.parametrize("n_tris", [8193, 20_000])
def test_light_distribution_plain_beyond_one_block(n_tris):
    """Above the kernel's one-block size (``SHARED_TRIS``) the plain
    version is the same function: prob = w / total with the total the JAX
    package's ``jnp.sum`` (XLA's windows of 32), the cdf XLA's CPU blocked
    scan of prob (its ``jnp.cumsum``), both run op by op; and the pair is
    the JAX package's ``light_cdf`` to the bit."""
    js = j_procedural(n_tris, seed=0, emissive_fraction=0.01)
    ps = _port_scene(js)
    area = nee.triangle_areas(ps)
    cdf, prob = light_cdf.light_cdf_plain(ps.emission, area)
    em, a = ps.emission.numpy(), area.numpy()
    w = ((em[:, 0] + em[:, 1]) + em[:, 2]) * a
    with jax.disable_jit():
        total = np.asarray(jnp.sum(jnp.asarray(w)))
        want = np.asarray(jnp.cumsum(jnp.asarray(prob.numpy())))
        j_cdf, j_prob = (np.asarray(x) for x in jnee.light_cdf(js))
    np.testing.assert_array_equal(prob.numpy(), w / total)
    np.testing.assert_array_equal(cdf.numpy(), want)
    np.testing.assert_array_equal(prob.numpy(), j_prob)
    np.testing.assert_array_equal(cdf.numpy(), j_cdf)
    assert n_tris > light_cdf.SHARED_TRIS and light_cdf.MAX_TRIS == 1 << 20


def test_scatter_plain_at_19_columns_vs_fp64_oracle():
    """K7's plain version at K10's 19 columns, dense collisions (half the
    events on 4 hot triangles, a tenth -1): the float64 oracle rounded
    once."""
    rng = np.random.default_rng(19)
    n_tris, n_events = 700, 20_000
    idx = rng.integers(0, n_tris, size=n_events).astype(np.int32)
    hot = rng.integers(0, n_tris, size=4)
    on_hot = rng.random(n_events) < 0.5
    idx[on_hot] = hot[rng.integers(0, 4, size=int(on_hot.sum()))]
    idx[rng.random(n_events) < 0.1] = -1
    val = rng.normal(size=(n_events, ss.QUALITY_COLS)).astype(np.float32)
    want = np.zeros((n_tris, ss.QUALITY_COLS), np.float64)
    keep = idx >= 0
    np.add.at(want, idx[keep], val[keep].astype(np.float64))
    adj = torch.zeros((n_tris, ss.QUALITY_COLS))
    got = ss.stream_scatter_call(adj, torch.from_numpy(idx),
                                 torch.from_numpy(val))
    assert got is adj
    np.testing.assert_array_equal(adj.numpy(), want.astype(np.float32))
    assert np.bincount(idx[keep]).max() > 1000


# ---- the plain forward against the JAX package ----


def test_plain_forward_equals_op_by_op_jax(combined):
    """K9's plain version on the 1150-triangle scene against the JAX
    reference wavefront run op by op (16x8: the op-by-op run's cost is per
    operation; jitted JAX rounds some multiply-adds differently and can
    flip a bright path, which moves a small frame's mean). The two light
    distributions are equal to the bit (both sum the total in XLA's
    windows of 32); the frames are held to tests/test_bigscene_quality.py's
    flip bounds; with the JAX package's prob and cdf in the table, to
    test_torch_megakernel_quality.py's bounds for the kernel body (under
    1% of pixels off by more than 1e-4, the others within 1e-6: the
    last-bit differences of the two libraries' trigonometry and of the
    wavefront's order against the kernel body's)."""
    ps = _port_scene(combined)
    cdf, prob = nee.light_cdf(ps)
    small = dict(FWD, width=16, height=8)
    with jax.disable_jit():
        j_cdf, j_prob = (np.asarray(x) for x in jnee.light_cdf(combined))
        want = np.asarray(j_render_radiance(combined, JCamera.default(),
                                            JConfig(**small), 0))
    np.testing.assert_array_equal(cdf.numpy(), j_cdf)
    np.testing.assert_array_equal(prob.numpy(), j_prob)
    cfg = RenderConfig(**small)
    got = _plain_image(combined, cfg)
    assert combined.n_tris == 1150 and want.mean() > 1e-3
    flipped = (np.abs(got - want) > 1e-4).any(-1)
    assert flipped.mean() < 0.02, f"{flipped.mean():.4f} flipped"
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=2e-2)

    tri = mq.quality_table(ps).clone()
    tri[:, mq.COL_PROB] = torch.from_numpy(j_prob.copy())
    tri[:, mq.COL_CDF] = torch.from_numpy(j_cdf.copy())
    same = bq.bigq_call(*mq.pack_rays(Camera.default(CPU), cfg, 0), tri,
                        bq.light_rows(ps), cfg)
    diff = np.abs(same.reshape(cfg.height, cfg.width, 3).numpy() - want)
    flipped = (diff > 1e-4).any(-1)
    assert flipped.mean() < 0.01 and diff[~flipped].max() <= 1e-6


def _jax_streamed_image(js, cfg_kw):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jax.jit(jbq.render_radiance_bigscene_quality,
                                  static_argnames=("cfg", "fast"))(
            js, JCamera.default(), JConfig(**cfg_kw), 0))


def test_plain_forward_tracks_jax_streamed_kernel(combined):
    """Against JAX's K9 itself in interpret mode, with
    tests/test_bigscene_quality.py's bounds: its Plücker arithmetic
    differs from the reference Möller–Trumbore in the last bits, so under
    2% of pixels may be off by more than 1e-4, the means within 2e-2."""
    got = _plain_image(combined, RenderConfig(**FWD))
    want = _jax_streamed_image(combined, FWD)
    flipped = (np.abs(got - want) > 1e-4).any(-1)
    assert flipped.mean() < 0.02, f"{flipped.mean():.4f} flipped"
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=2e-2)


def test_all_dark_scene_is_black_and_finite():
    """No emissive triangle: L = 0, every light choice is the last row,
    whose prob is 0; the frame is black and finite."""
    js = j_procedural(1100, seed=1, emissive_fraction=0.0)
    assert js.light_idx == () or len(js.light_idx) == 0
    img = _plain_image(js, RenderConfig(**dict(FWD, width=16, height=8)))
    assert np.isfinite(img).all() and img.max() == 0.0


# ---- the plain backward: K10's events through K7's plain version ----


def _events_backward(o, d, keys, tri, rows, gbar, cfg):
    """K10's layout on the CPU: per (sample, bounce, ray) a surface event
    at the hit triangle (columns 0-17) and a light event at the light
    whose NEE term counted (columns 0-11, 15-18), -1 where either does
    not apply, at K10's fixed slots; the events summed by
    ``stream_scatter_plain``. Returns ``(gtab19, grays)``."""
    n, nb = o.shape[0], cfg.max_bounces
    g3 = gbar * float(np.float32(1.0 / cfg.spp))
    idx, val = [], []
    grays = torch.zeros((n, 6))
    with torch.no_grad():
        for _, saved in mq.quality_replay(o, d, keys, tri, rows, cfg):
            ev_idx = torch.full((nb, 2, n), -1, dtype=torch.int32)
            ev_val = torch.zeros((nb, 2, n, mqg.ADJ))
            tb, ob = torch.zeros((n, 3)), torch.zeros((n, 3))
            for b in reversed(range(len(saved))):
                sv = saved[b]
                tb, onew, gry_d, surf, light = mqg._reverse_bounce(
                    sv, tb, ob, g3, tri, cfg)
                ev_idx[b, 0] = torch.where(sv["hit"], sv["idx"], -1).int()
                ev_val[b, 0, :, :18] = surf
                if light is not None:
                    ev_idx[b, 1] = torch.where(sv["ok"], sv["li"], -1).int()
                    ev_val[b, 1] = light
                if b == 0:
                    grays = grays + torch.cat([onew, gry_d], 1)
                else:
                    ob = onew
            idx.append(ev_idx.reshape(-1))
            val.append(ev_val.reshape(-1, mqg.ADJ))
    adj = torch.zeros((tri.shape[0], mqg.ADJ))
    ss.stream_scatter_plain(adj, torch.cat(idx), torch.cat(val))
    return adj, grays


def test_plain_backward_through_events_equals_the_direct_sum(combined):
    """The backward's adjoint summed as K10 and K7 sum it (events at fixed
    slots, then the float64 scatter) equals ``quality_bwd_plain``'s
    direct ``index_add_`` within 1e-6 of each column group's max, and the
    ray adjoint to the bit."""
    ps = _port_scene(combined)
    cfg = RenderConfig(**dict(BWD, width=16, height=8, spp=2))
    o, d, keys = mq.pack_rays(Camera.default(CPU), cfg, 0)
    tri, rows = mq.quality_table(ps), bq.light_rows(ps)
    gbar = torch.from_numpy(np.random.default_rng(9).uniform(
        0.1, 1.0, (o.shape[0], 3)).astype(np.float32))
    got, got_rays = _events_backward(o, d, keys, tri, rows, gbar, cfg)
    want, want_rays = bqg.bigq_bwd_call(o, d, keys, tri, rows, gbar, cfg)
    for lo, hi in ((0, 9), (9, 12), (12, 15), (15, 18), (18, 19)):
        scale = want[:, lo:hi].abs().max().item()
        assert scale > 0, (lo, hi)
        np.testing.assert_allclose(got[:, lo:hi], want[:, lo:hi], rtol=0,
                                   atol=1e-6 * scale)
    assert torch.equal(got_rays, want_rays)


def _tagged(js):
    """``js`` with every triangle's albedo and emission drawn at random
    (Philox(13)): the same hits (they depend on the geometry and the keys
    alone), but a frame in which every hit of a path shows."""
    rng = np.random.Generator(np.random.Philox(13))
    t = np.asarray(js.vertices).shape[0]
    return j_make_scene(np.asarray(js.vertices),
                        rng.uniform(0.2, 0.9, (t, 3)).astype(np.float32),
                        rng.uniform(0.1, 1.0, (t, 3)).astype(np.float32))


def _weights(cfg_kw, agree):
    rng = np.random.Generator(np.random.Philox(7))
    w = rng.uniform(0.1, 1.0, (cfg_kw["height"], cfg_kw["width"], 3))
    return (w * agree[..., None]).astype(np.float32)


def test_plain_backward_tracks_jax_streamed_vjp(combined256):
    """``BigQualityRows`` on CPU tensors (K9's and K10's plain versions)
    against the VJP of JAX's streamed render in interpret mode, at
    tests/test_bigscene_quality.py::test_bigq_grad_tracks_wavefront's
    bound, 0.03·max|grad|, on the pixels whose paths agree: JAX's K9 finds
    hits with Plücker arithmetic, so a few of its paths may take another
    triangle. On a scene whose every triangle emits (``_tagged``), every
    hit of a path shows in the frame, so the paths agree where the frames
    agree within 1e-5; the others weigh 0 and are under 2% of the frame."""
    js = _tagged(combined256)
    cfg = dict(BWD, max_bounces=2)

    def render(v, a, e):
        return jbq.render_radiance_bigscene_quality(
            JScene(v, a, e, light_idx=js.light_idx), JCamera.default(),
            JConfig(**cfg), 0)

    with pltpu.force_tpu_interpret_mode():
        jax_img, vjp = jax.vjp(jax.jit(render), js.vertices, js.albedo,
                               js.emission)
    leaves = [torch.from_numpy(np.array(getattr(js, k))).requires_grad_()
              for k in FIELDS]
    img = bqg.render_radiance_bigscene_quality_grad(
        Scene(*leaves, js.light_idx), Camera.default(CPU),
        RenderConfig(**cfg), 0)
    jax_img = np.asarray(jax_img)
    agree = (np.abs(img.detach().numpy() - jax_img)
             <= 1e-5 * np.maximum(1.0, np.abs(jax_img))).all(-1)
    assert (~agree).mean() < 0.02, f"{(~agree).sum()} paths differ"
    wts = _weights(cfg, agree)
    got = torch.autograd.grad((img * torch.from_numpy(wts)).sum(), leaves)
    with pltpu.force_tpu_interpret_mode():
        want = vjp(jnp.asarray(wts))
    for name, g, w in zip(FIELDS, got, want):
        w = np.asarray(w)
        scale = np.abs(w).max()
        assert scale > 1e-6, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=0.03 * scale,
                                   err_msg=name)


# ---- the JAX streamed kernel's light choice at the top of the cdf ----


def _top_scene():
    """Eight lights of 16 triangles whose float32 cdf tops out below the
    largest draw, 1 - 2^-24, and a dark last row."""
    scene = j_procedural(16, seed=7, emissive_fraction=0.4)
    assert scene.light_idx == (0, 1, 2, 5, 6, 7, 10, 11)
    return scene


def test_jax_streamed_light_choice_clips_to_the_last_light():
    """At u >= the cdf at every light, JAX's K9 (``_select_light_vmem``,
    ``slot = min(count, n_lights - 1)``) picks the last light, while its
    K3 walk (``_select_gather_light_static``), its wavefront
    (``searchsorted`` clipped to T - 1) and the port's kernels pick the
    last row, here a dark one: a difference of the reference between its
    streamed kernel and its own wavefront, which the port does not
    follow."""
    js = _top_scene()
    t = js.n_tris
    with jax.disable_jit():
        cdf = np.asarray(jnee.light_cdf(js)[0])
    top = np.float32(1.0 - 2.0 ** -24)
    assert cdf[-1] < top and t - 1 not in js.light_idx
    u = np.full((1, 128), top, np.float32)

    # the wavefront's and the SMEM kernel's choice: the last row
    assert int(np.clip(np.searchsorted(cdf, top, side="right"), 0,
                       t - 1)) == t - 1
    tab = jmq.quality_table(js)
    li, _ = jmq._select_gather_light_static(tab, jnp.asarray(u[0]), (20,),
                                            js.light_idx, t)
    assert set(np.asarray(li).tolist()) == {t - 1}

    # the streamed kernel's: the last light
    _, _, ltab, cdf_t, _, n_lights = jbq.bigscene_quality_tables(js)

    def kernel(ltab_ref, cdf_ref, u_ref, slot_ref, gidx_ref):
        slot, rows = jbq._select_light_vmem(ltab_ref, cdf_ref, u_ref[...],
                                            n_lights)
        slot_ref[...] = slot
        gidx_ref[...] = rows[jbq._COL_GIDX:jbq._COL_GIDX + 1, :]

    with pltpu.force_tpu_interpret_mode():
        slot, gidx = pl.pallas_call(
            kernel,
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 3,
            out_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
            out_shape=[jax.ShapeDtypeStruct((1, 128), jnp.int32),
                       jax.ShapeDtypeStruct((1, 128), jnp.float32)],
        )(ltab, cdf_t, jnp.asarray(u))
    assert set(np.asarray(slot).ravel().tolist()) == {n_lights - 1}
    assert set(np.asarray(gidx).ravel().tolist()) == {js.light_idx[-1]}

    # the port's K9 and K3 choice: the last row, as the wavefront's
    ps = _port_scene(js)
    tri = mq.quality_table(ps)
    rows, lcdf = bq.kernel_inputs(tri, bq.light_rows(ps), CPU)
    got = bq.select_light_plain(lcdf, rows, torch.from_numpy(u[0]), t)
    assert set(got.tolist()) == {t - 1}


# ---- the wrappers on CPU tensors, and their checks ----


def _inputs(n_tris=1030, cfg=None):
    cfg = cfg or RenderConfig(width=8, height=4, spp=2, max_bounces=2,
                              **QUALITY)
    o, d, keys = mq.pack_rays(Camera.default(CPU), cfg)
    ps = procedural_scene(n_tris, seed=1, device=CPU)
    return (o, d, keys, mq.quality_table(ps), bq.light_rows(ps),
            torch.ones((o.shape[0], 3)), cfg)


def test_calls_on_cpu_take_plain_without_counting():
    o, d, keys, tri, rows, gbar, cfg = _inputs()
    before = (bq.bigq_call.launches, bqg.bigq_bwd_call.launches)
    out = bq.bigq_call(o, d, keys, tri, rows, cfg)
    gtab, grays = bqg.bigq_bwd_call(o, d, keys, tri, rows, gbar, cfg)
    assert (bq.bigq_call.launches, bqg.bigq_bwd_call.launches) == before
    assert torch.equal(out, mq.quality_plain(o, d, keys, tri, rows, cfg))
    want, want_rays = mqg.quality_bwd_plain(o, d, keys, tri, rows, gbar,
                                            cfg)
    assert torch.equal(gtab, want) and torch.equal(grays, want_rays)


@pytest.mark.parametrize("case", [
    "rays dtype", "rays shape", "keys dtype", "table columns", "empty table",
    "table above 2^20", "rows dtype", "rows not ascending", "lights above "
    "LIGHT_MAX", "contiguity", "devices", "estimator"])
def test_calls_reject_bad_inputs(case, monkeypatch):
    o, d, keys, tri, rows, gbar, cfg = _inputs()
    too_big = torch.empty((bq.BIGQ_MAX_TRIS + 1, mq.COLS), device="meta")
    args = {
        "rays dtype": (o.double(), d, keys, tri, rows),
        "rays shape": (o, d[:-1], keys, tri, rows),
        "keys dtype": (o, d, keys.int(), tri, rows),
        "table columns": (o, d, keys, tri[:, :18], rows),
        "empty table": (o, d, keys, tri[:0], None),
        "table above 2^20": (o.to("meta"), d.to("meta"), keys.to("meta"),
                             too_big, None),
        "rows dtype": (o, d, keys, tri, rows.long()),
        "rows not ascending": (o, d, keys, tri, rows.flip(0)),
        "lights above LIGHT_MAX": (o, d, keys, tri, rows),
        "contiguity": (o.T.contiguous().T, d, keys, tri, rows),
        "devices": (o, d, keys, tri.to("meta"), rows),
        "estimator": (o, d, keys, tri, rows),
    }[case]
    if case == "lights above LIGHT_MAX":
        monkeypatch.setattr(bq, "LIGHT_MAX", rows.shape[0] - 1)
    bad_cfg = cfg.replace(rng="lcg", sampler="angle", nee=False, mis=False) \
        if case == "estimator" else cfg
    err = NotImplementedError if case == "estimator" else ValueError
    with pytest.raises(err):
        bq.bigq_call(*args, bad_cfg)
    with pytest.raises(err):
        bqg.bigq_bwd_call(*args, gbar.to(args[0].device), bad_cfg)


def test_backward_call_rejects_bad_cotangents_and_long_paths():
    o, d, keys, tri, rows, gbar, cfg = _inputs()
    for bad in (gbar[:-1], gbar.double(), gbar.to("meta")):
        with pytest.raises(ValueError):
            bqg.bigq_bwd_call(o, d, keys, tri, rows, bad, cfg)
    with pytest.raises(ValueError, match="max_bounces"):
        bqg.bigq_bwd_call(o, d, keys, tri, rows, gbar,
                          cfg.replace(max_bounces=bqg.MAX_BOUNCES + 1))
    # int32 overflow of K7's event ids, on shapes alone (meta tensors)
    n = 1 << 26
    mo = torch.empty((n, 3), device="meta")
    mk = torch.empty(n, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="overflow"):
        bqg.bigq_bwd_call(mo, mo, mk, tri.to("meta"), None, mo,
                          cfg.replace(max_bounces=16))


def test_chunks_and_guardrails_follow_the_sizes():
    """K10's chunks depend on the sizes alone (at 1080p and 5 bounces one
    sample's events, 1.66 GB, fill the 2 GiB budget), and the caps are
    the JAX package's."""
    cfg = RenderConfig(width=1920, height=1080, spp=4, max_bounces=5,
                       **QUALITY)
    assert bqg.chunk_samples(1920 * 1080, cfg) == 1
    assert 2 * bqg.EVENT_BYTES * 5 * 1920 * 1080 == 1_658_880_000
    assert bqg.chunk_samples(512, cfg) == 4
    assert bq.BIGQ_MAX_TRIS == bqg.GRAD_MAX_TRIS == jbq.BIG_MAX_TRIS
    assert bq.LIGHT_MAX == jbq.LIGHT_MAX
    scene = default_scene(CPU)
    q = RenderConfig(width=8, height=4, spp=1, **QUALITY)
    assert bq.supported(scene, q) and bqg.supported_grad(scene, q)
    for bad in (q.replace(rng="lcg", sampler="angle", nee=False,
                          mis=False), q.replace(sampler="uniform")):
        assert not bq.supported(scene, bad)
    # vis_grad changes no frame: K9 renders it, as the JAX kernel does;
    # its gradient is VisGradFusedRenderer's
    assert bq.supported(scene, q.replace(vis_grad=True))
    assert not bqg.supported_grad(scene, q.replace(vis_grad=True))
    # K10's saved state holds 64 bounces
    assert bqg.supported_grad(scene, q.replace(max_bounces=17))
    assert not bqg.supported_grad(scene, q.replace(
        max_bounces=bqg.MAX_BOUNCES + 1))
    assert bq.static_light_idx(dataclasses.replace(
        scene, light_idx=None)) == (3, 4) == scene.light_idx


def test_big_quality_rows_gives_the_wavefront_gradient(combined256):
    """``BigQualityRows`` on CPU tensors gives the value and, within
    sum-order noise, the gradients of autograd through the port's own
    wavefront, camera position included."""
    ps = _port_scene(combined256)
    cfg = RenderConfig(**dict(BWD, width=16, height=8))
    wts = torch.from_numpy(_weights(dict(BWD, width=16, height=8),
                                    np.ones((8, 16))))

    def grads(render):
        leaves = [t.detach().clone().requires_grad_()
                  for t in (ps.vertices, ps.albedo, ps.emission)]
        pos = Camera.default(CPU).pos.clone().requires_grad_()
        cam = dataclasses.replace(Camera.default(CPU), pos=pos)
        img = render(Scene(*leaves, ps.light_idx), cam, cfg, 0)
        return torch.autograd.grad((img * wts).sum(), [*leaves, pos])

    got = grads(bqg.render_radiance_bigscene_quality_grad)
    want = grads(pathtracer.render_radiance)
    for name, g, w in zip((*FIELDS, "camera"), got, want):
        scale = w.abs().max().item()
        assert scale > 0, name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * scale,
                                   err_msg=name)


# ---- K9's and K11's queue: the sweeps each pixel needs ----


@pytest.mark.parametrize("est", [
    dict(QUALITY), dict(QUALITY, nee=False, mis=False, rr_start=1)],
    ids=["nee+mis", "bsdf only rr1"])
def test_quality_sweep_totals_count_the_hit_masks(est):
    """Per-pixel sweeps of K9's queue on a 16x8 default-scene frame from
    ``quality_replay``, against a count by hand of its masks, pixel by
    pixel: one camera sweep; with NEE one sweep a bounce that hit, without
    it one after each bounce that hit and survived the roulette, but the
    last; nothing for a pixel whose camera ray missed."""
    cfg = RenderConfig(width=16, height=8, spp=3, max_bounces=4, **est)
    scene = default_scene(CPU)
    o, d, k = mq.pack_rays(Camera.default(CPU), cfg, 0)
    tri, rows = mq.quality_table(scene), bq.light_rows(scene)
    got = bq.quality_sweep_totals(o, d, k, tri, rows, cfg)
    assert got.shape == (128, 4) and got.dtype == np.int64
    with torch.no_grad():
        replay = [[{key: v.tolist() for key, v in sv.items()
                    if key in ("hit", "rrs")} for sv in saved]
                  for _, saved in mq.quality_replay(o, d, k, tri, rows, cfg)]
    missed = 0
    for i in range(128):
        want = [1]
        for saved in replay:
            count = 0
            for b, sv in enumerate(saved):
                if cfg.nee:
                    count += sv["hit"][i]
                elif b < cfg.max_bounces - 1 and sv["hit"][i]:
                    count += sv["rrs"][i] if "rrs" in sv else 1
            want.append(count)
        if not replay[0][0]["hit"][i]:
            missed += 1
            assert want[1:] == [0] * cfg.spp
        assert got[i].tolist() == want, i
    # the frame has both: camera rays that miss and paths of several
    # bounces
    assert 0 < missed < 128 and got[:, 1:].max() >= 2
    sched = bs.lane_schedules(got, cta=32, ctas=2)
    assert sched["queue"]["cta_sweeps"] < sched["lockstep"]["cta_sweeps"]


def test_k10_schedules_by_launch_on_a_small_frame():
    """K10's queue launch by launch, a launch a sample, on a 16x8
    default-scene frame at 3 spp: each launch sweeps its sample's column
    of ``quality_sweep_totals``, and the camera column only in the first
    (``s0 == 0``), so a pixel whose camera ray missed needs no sweep in
    the later ones; lockstep and the queue counted by hand on 2 CTAs of 32
    lanes, the queue never needing more CTA sweeps than lockstep."""
    cfg = RenderConfig(width=16, height=8, spp=3, max_bounces=4, **QUALITY)
    scene = default_scene(CPU)
    o, d, k = mq.pack_rays(Camera.default(CPU), cfg, 0)
    totals = bq.quality_sweep_totals(o, d, k, mq.quality_table(scene),
                                     bq.light_rows(scene), cfg)
    missed = totals[:, 1:].sum(axis=1) == 0
    assert 0 < missed.sum() < 128
    lanes, cta = 64, 32
    for s0 in range(cfg.spp):
        per = bs.chunk_totals(totals, s0, 1)
        assert per.shape == (128, 2)
        assert (per[:, 0] == (1 if s0 == 0 else 0)).all()
        assert (per[:, 1] == totals[:, 1 + s0]).all()
        if s0 > 0:
            assert not per[missed].any()
        # lockstep: each CTA of 32 consecutive pixels sweeps as often as
        # its busiest pixel needs, column by column
        lockstep = sum(int(per[c:c + cta, j].max()) for c in range(0, 128, cta)
                       for j in range(2))
        # the queue: pixels in order, each to the lane free first (ties to
        # the lowest lane); a CTA sweeps until its last lane is done
        free = [0] * lanes
        for work in per.sum(axis=1).tolist():
            lane = min(range(lanes), key=lambda x: (free[x], x))
            free[lane] += work
        queue = sum(max(free[c:c + cta]) for c in range(0, lanes, cta))
        sched = bs.lane_schedules(per, cta=cta, ctas=lanes // cta)
        assert sched["useful_lane_sweeps"] == int(per.sum())
        assert sched["lockstep"]["cta_sweeps"] == lockstep
        assert sched["queue"]["cta_sweeps"] == queue <= lockstep


def test_quality_wrappers_size_their_grid_by_their_own_kernel():
    """K9, K11 and K10 launch on the grid of their own kernel's
    occupancy."""
    import inspect

    for call, kernel in ((bq.bigq_call, "K9"), (bq.bigq_hits_call, "K11"),
                         (bqg.bigq_bwd_call, "K10")):
        src = inspect.getsource(call)
        assert "queue_grid(" in src and f'"{kernel}")' in src
        for other in set(bs.QUEUE_KERNELS) - {kernel}:
            assert f'"{other}")' not in src


# ---- routing with a faked CUDA device ----


def _as_if_on_cuda(monkeypatch):
    """Scenes and cameras report a CUDA device; no plain version may be
    reached, and the kernels' renders only record their calls."""
    cuda = torch.device("cuda", 0)
    monkeypatch.setattr(Scene, "device", property(lambda self: cuda))
    monkeypatch.setattr(Camera, "device", property(lambda self: cuda))

    def forbidden(*args, **kw):
        raise AssertionError("plain version reached for a CUDA scene")

    for module, name in ((pathtracer, "render_radiance"),
                         (mq, "quality_plain"), (mqg, "quality_bwd_plain"),
                         (ss, "stream_scatter_plain"),
                         (light_cdf, "light_cdf_plain")):
        monkeypatch.setattr(module, name, forbidden)
    calls = []

    def kernel(tag):
        def render(scene, camera, cfg, seed=0):
            calls.append((tag, scene.n_tris))
            return torch.zeros((cfg.height, cfg.width, 3), requires_grad=True)
        return render

    monkeypatch.setattr(mq, "render_radiance_quality_megakernel",
                        kernel("K3"))
    monkeypatch.setattr(mqg, "render_radiance_quality_grad", kernel("K3+K4"))
    monkeypatch.setattr(bq, "render_radiance_bigscene_quality", kernel("K9"))
    monkeypatch.setattr(bqg, "render_radiance_bigscene_quality_grad",
                        kernel("K9+K10"))
    return calls


def _stub_scene(n_tris, n_lights=1):
    """A scene of ``n_tris`` triangles, its first ``n_lights`` lights,
    without drawing them (the routing reads sizes and the light set)."""
    z = torch.zeros((n_tris, 3))
    return Scene(torch.zeros((n_tris, 3, 3)), z, z,
                 tuple(range(n_lights)))


Q = RenderConfig(width=8, height=4, spp=1, **QUALITY)


@pytest.mark.parametrize("n_tris", [1025, 1 << 20])
def test_routing_sends_large_cuda_scenes_to_k9_k10(monkeypatch, n_tris):
    scene = _stub_scene(n_tris, n_lights=min(n_tris, 10_500))
    calls = _as_if_on_cuda(monkeypatch)
    cam = Camera.default(CPU)
    assert renderer.forward_renderer(scene, Q).name == "quality_bigscene"
    assert renderer.grad_renderer(scene, Q).name == "quality_bigscene"
    assert render_pt_fast(scene, cam, Q).shape == (4, 8, 3)
    assert render_radiance_fastgrad(scene, cam, Q).shape == (4, 8, 3)
    assert calls == [("K9", n_tris), ("K9+K10", n_tris)]


@pytest.mark.parametrize("at", ["forward", "gradient"])
def test_routing_keeps_scenes_at_the_crossovers_on_k3_k4(monkeypatch, at):
    """At the measured crossovers the fused kernels serve and
    differentiate; one triangle more goes to the streamed ones."""
    n = (renderer.QUALITY_ROUTE_MAX_TRIS if at == "forward"
         else renderer.QUALITY_GRAD_ROUTE_MAX_TRIS)
    calls = _as_if_on_cuda(monkeypatch)
    cam = Camera.default(CPU)
    fn, fused, streamed = ((render_pt_fast, "K3", "K9") if at == "forward"
                           else (render_radiance_fastgrad, "K3+K4",
                                 "K9+K10"))
    fn(_stub_scene(n), cam, Q)
    fn(_stub_scene(n + 1), cam, Q)
    assert calls == [(fused, n), (streamed, n + 1)]


def test_routing_declines_above_light_max_and_names_the_cap(monkeypatch):
    """Above ``LIGHT_MAX`` lights (patched to 256) the streamed route
    declines with NEE, and both directions go to the wavefront on the
    card, which has no light cap (the JAX package's wavefront renders such
    scenes); the cap is named where K9 is called itself, before any ray
    reaches it. Without NEE the lights are not read and the route takes
    the scene."""
    monkeypatch.setattr(bq, "LIGHT_MAX", 256)
    scene = _stub_scene(2000, n_lights=257)
    rays = pixel_rays(Camera.default(CPU), Q.width, Q.height)
    k9, k10 = bq.radiance_block, bqg.radiance_block_grad
    calls = _as_if_on_cuda(monkeypatch)
    cam = Camera.default(CPU)
    assert not bq.supported(scene, Q) and not bqg.supported_grad(scene, Q)
    assert renderer.forward_renderer(scene, Q).name == "wavefront"
    assert renderer.grad_renderer(scene, Q).name == "wavefront"
    for entry in (k9, k10):
        with pytest.raises(ValueError, match="LIGHT_MAX = 256 lights"):
            entry(scene, *rays, Q)
    assert calls == []
    render_pt_fast(scene, cam, Q.replace(nee=False, mis=False))
    assert calls == [("K9", 2000)]
    assert bq.supported(_stub_scene(2000, n_lights=256), Q)


def test_routing_raises_above_2_20_triangles(monkeypatch):
    scene = _stub_scene(bq.BIGQ_MAX_TRIS + 1)
    calls = _as_if_on_cuda(monkeypatch)
    cam = Camera.default(CPU)
    with pytest.raises(NotImplementedError, match="K9 take T <= 1048576"):
        render_pt_fast(scene, cam, Q)
    with pytest.raises(NotImplementedError,
                       match=r"K9 and K10 take T <= 1048576 \(2\^20\)"):
        render_radiance_fastgrad(scene, cam, Q)
    assert calls == []


def test_routing_keeps_cpu_tensors_on_the_wavefront(monkeypatch):
    scene, cam = procedural_scene(1100, seed=1, device=CPU), \
        Camera.default(CPU)
    cfg = RenderConfig(width=4, height=2, spp=1, max_bounces=2, **QUALITY)
    assert renderer.forward_renderer(scene, cfg).name == "wavefront"
    assert renderer.grad_renderer(scene, cfg).name == "wavefront"

    def forbidden(*args, **kw):
        raise AssertionError("a streamed path reached with CPU tensors")

    monkeypatch.setattr(bq, "bigq_call", forbidden)
    monkeypatch.setattr(bqg, "bigq_bwd_call", forbidden)
    assert render_pt_fast(scene, cam, cfg).shape == (2, 4, 3)
    assert render_radiance_fastgrad(scene, cam, cfg).shape == (2, 4, 3)


def test_sources_name_what_they_replace():
    """K9 and K10 name their TPU kernels and entry points and run the
    quality walk through the streamed sweep; K4 and K10 share the reverse
    step; K7 takes both widths."""
    from spath_tpu_torch.ops.kernels import build

    for source, replaces, entry in (
            ("bigscene_quality.cu",
             "megakernel_bigscene_quality.py::_bigq_kernel",
             "spath_bigscene_quality_forward"),
            ("bigscene_quality_grad.cu",
             "megakernel_bigscene_quality.py::_bigq_bwd_kernel",
             "spath_bigscene_quality_backward")):
        src = (build.SOURCE_DIR / source).read_text()
        assert "spath_tpu/ops/pallas/" + replaces.split("::")[0] in src
        assert replaces.split("::")[1] in src
        assert f'extern "C" int {entry}(' in src
        assert "spath::StreamQuality be{" in src
    walk = (build.SOURCE_DIR / "quality_walk.cuh").read_text()
    assert '#include "stream_sweep.cuh"' in walk
    assert "struct TableQuality" in walk and "struct StreamQuality" in walk
    assert "stream_nearest2<kQCols>" in walk
    for source in ("megakernel_quality_grad.cu", "bigscene_quality_grad.cu"):
        src = (build.SOURCE_DIR / source).read_text()
        assert '#include "quality_reverse.cuh"' in src
        assert "spath::reverse_bounce(" in src
    scatter = (build.SOURCE_DIR / "stream_scatter.cu").read_text()
    assert "accumulate<9>" in scatter and "accumulate<19>" in scatter
