"""The streamed large-scene kernels' wrappers on the CPU: K6 (forward), K8
(backward) and the stream scatter K7. Their plain versions against the
JAX package on the same numpy inputs (the wavefront run op by op, and
the streamed Pallas kernels in interpret mode), the scatter's plain
version against JAX's ``stream_scatter_rmw``, the routing, which never
hands a CUDA scene to a plain version, and the wrappers' checks. The
CUDA kernels themselves run only on the card (``chip_smoke.py``)."""

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
from spath_tpu.ops.pallas import megakernel_bigscene as jbs  # noqa: E402
from spath_tpu.ops.pallas import megakernel_bigscene_grad as jbg  # noqa
from spath_tpu.ops.pallas.megakernel_grad import _split3  # noqa: E402
from spath_tpu.scene import Scene as JScene  # noqa: E402
from spath_tpu.scene import default_scene as j_default_scene  # noqa: E402
from spath_tpu.scene import make_scene as j_make_scene  # noqa: E402
from spath_tpu.scene import procedural_scene as j_procedural  # noqa: E402
from spath_tpu_torch.camera import Camera  # noqa: E402
from spath_tpu_torch.config import RenderConfig  # noqa: E402
from spath_tpu_torch.convert import scene_from_numpy  # noqa: E402
from spath_tpu_torch.models import pathtracer, renderer  # noqa: E402
from spath_tpu_torch.models.pathtracer import (  # noqa: E402
    render_pt_fast, render_radiance_fastgrad,
)
from spath_tpu_torch.ops.kernels import bigscene as bs  # noqa: E402
from spath_tpu_torch.ops.kernels import bigscene_grad as bg  # noqa: E402
from spath_tpu_torch.ops.kernels import megakernel as mk  # noqa: E402
from spath_tpu_torch.ops.kernels import megakernel_grad as mg  # noqa: E402
from spath_tpu_torch.ops.kernels import stream_scatter as ss  # noqa: E402
from spath_tpu_torch.scene import Scene, default_scene  # noqa: E402
from spath_tpu_torch.scene import procedural_scene  # noqa: E402

CPU = torch.device("cpu")
#: tests/test_bigscene.py's frame: 512 rays, 2 samples of 3 bounces
SIZE = dict(width=32, height=16, spp=2, max_bounces=3)
FIELDS = ("vertices", "albedo", "emission")


def _combined_scene(n_extra=1143):
    """tests/test_bigscene.py's scene: the default scene (light, floor,
    wall) and procedural clutter, 5% emissive, n_extra + 7 triangles."""
    base = j_default_scene()
    proc = j_procedural(n_extra, seed=0, emissive_fraction=0.05)
    return j_make_scene(*(np.concatenate([np.asarray(getattr(base, k)),
                                          np.asarray(getattr(proc, k))])
                          for k in FIELDS))


@pytest.fixture(scope="module")
def combined():
    return _combined_scene()


def _port_scene(js):
    return scene_from_numpy(np.asarray(js.vertices), np.asarray(js.albedo),
                            np.asarray(js.emission), js.light_idx,
                            device=CPU)


def _plain_image(js, cfg, seed=0):
    """The port's K6 entry on CPU tensors: its plain version."""
    o, d, seeds = mk.pack_rays(Camera.default(CPU), cfg, seed)
    out = bs.bigscene_call(o, d, seeds, mk.scene_table(_port_scene(js)), cfg)
    return out.reshape(cfg.height, cfg.width, 3).numpy()


def test_plain_forward_equals_op_by_op_jax_above_1024(combined):
    """K6's plain version on the 1150-triangle scene equals the JAX
    package's reference wavefront run op by op, to the bit."""
    cfg = dict(SIZE, spp=1, max_bounces=2)
    got = _plain_image(combined, RenderConfig(**cfg))
    with jax.disable_jit():
        want = np.asarray(j_render_radiance(combined, JCamera.default(),
                                            JConfig(**cfg), 0))
    assert combined.n_tris == 1150 and want.mean() > 1e-3
    np.testing.assert_array_equal(got, want)


def test_plain_forward_tracks_jax_streamed_kernel(combined):
    """Against JAX's K6 itself, in interpret mode, with
    tests/test_bigscene.py's bounds: its Plücker arithmetic differs from
    the reference Möller–Trumbore in the last bits, so under 2% of pixels
    may be off by more than 1e-4, the means within 2e-2."""
    cfg = dict(SIZE, spp=1, max_bounces=2)
    got = _plain_image(combined, RenderConfig(**cfg))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.jit(jbs.render_radiance_bigscene,
                                  static_argnames=("cfg", "fast"))(
            combined, JCamera.default(), JConfig(**cfg), 0))
    flipped = (np.abs(got - want) > 1e-4).any(-1)
    assert flipped.mean() < 0.02, f"{flipped.mean():.4f} flipped"
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=2e-2)


def _weights():
    rng = np.random.Generator(np.random.Philox(7))
    return rng.uniform(0.1, 1.0, (SIZE["height"], SIZE["width"], 3)).astype(
        np.float32)


def _port_grads(js, render=bg.render_radiance_bigscene_grad, wts=None):
    """Vertex, albedo and emission gradients of the weighted frame
    through ``render`` (on CPU tensors: K6's and K8's plain versions
    under ``BigRows``)."""
    leaves = [torch.from_numpy(np.array(getattr(js, k))).requires_grad_()
              for k in FIELDS]
    img = render(Scene(*leaves, js.light_idx), Camera.default(CPU),
                 RenderConfig(**SIZE), 0)
    wts = _weights() if wts is None else wts
    loss = (img * torch.from_numpy(wts)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def _jax_grads(js, render, jit=False, wts=None):
    """``jax.grad`` of the JAX package's weighted frame through
    ``render``."""
    wts = jnp.asarray(_weights() if wts is None else wts)

    def loss(vertices, albedo, emission):
        return jnp.sum(render(JScene(vertices, albedo, emission),
                              JCamera.default(), JConfig(**SIZE), 0) * wts)

    grad = jax.grad(loss, argnums=(0, 1, 2))
    return (jax.jit(grad) if jit else grad)(js.vertices, js.albedo,
                                            js.emission)


def test_plain_backward_matches_op_by_op_jax_grad(combined):
    """K8's plain version (``mega_bwd_plain``, T uncapped) under
    ``BigRows`` against ``jax.grad`` of the JAX reference wavefront run op
    by op: the same program, so the bound is sum-order noise,
    1e-5·max|grad|."""
    got = _port_grads(combined)
    with jax.disable_jit():
        want = _jax_grads(combined, j_render_radiance)
    for name, g, w in zip(FIELDS, got, want):
        w = np.asarray(w)
        scale = np.abs(w).max()
        assert scale > 0, name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * scale,
                                   err_msg=name)


def _tagged(js):
    """``js`` with every triangle's albedo and emission drawn at random
    (Philox(13)): the same paths (hits and directions depend on the
    geometry and the seeds alone), but a frame in which every hit of a
    path shows."""
    rng = np.random.Generator(np.random.Philox(13))
    t = np.asarray(js.vertices).shape[0]
    return j_make_scene(np.asarray(js.vertices),
                        rng.uniform(0.2, 0.9, (t, 3)).astype(np.float32),
                        rng.uniform(0.1, 1.0, (t, 3)).astype(np.float32))


def test_plain_backward_tracks_jax_streamed_vjp(combined):
    """Against ``jax.grad`` of JAX's streamed render (K6 forward, K8 with
    its hi/lo-bf16 scatter backward) in interpret mode, at
    tests/test_bigscene.py's bound, 1e-4·max|grad| (the JAX K8 keeps ~16
    mantissa bits of each scattered value). JAX's K6 finds hits with
    Plücker arithmetic, which differs from the reference Möller–Trumbore
    in the last bits, so a few of its paths take another triangle than
    the reference's; with every pixel weighted, those move its albedo
    gradient by 5.7% of its max at this shape (ROADMAP queue 3). So the
    gradients are held on the pixels whose paths agree: those whose
    frames agree within 1e-5 when every triangle emits (``_tagged``); the
    others weigh 0, and they are under 2% of the frame."""
    tagged = _tagged(combined)
    got_img = _plain_image(tagged, RenderConfig(**SIZE))
    with pltpu.force_tpu_interpret_mode():
        jax_img = np.asarray(jax.jit(jbs.render_radiance_bigscene,
                                     static_argnames=("cfg", "fast"))(
            tagged, JCamera.default(), JConfig(**SIZE), 0))
    agree = (np.abs(got_img - jax_img)
             <= 1e-5 * np.maximum(1.0, np.abs(jax_img))).all(-1)
    assert (~agree).mean() < 0.02, f"{(~agree).sum()} paths differ"
    wts = _weights() * agree[..., None]
    got = _port_grads(combined, wts=wts)
    with pltpu.force_tpu_interpret_mode():
        want = _jax_grads(combined, jbg.render_radiance_bigscene_grad,
                          jit=True, wts=wts)
    for name, g, w in zip(FIELDS, got, want):
        w = np.asarray(w)
        scale = np.abs(w).max()
        assert scale > 1e-6, name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)


# ---- the stream scatter K7 against JAX's stream_scatter_rmw ----

ROWS, TILE_T, R = ss.COLS, 128, 128


def _jax_rmw(contribs, idxs, n_blocks: int, grid: int):
    """tests/test_stream_scatter.py's Pallas harness with 9 rows: each
    grid step scatters its (E, ROWS, R) contributions at (E, 1, R)
    indices into a (ROWS, n_blocks·TILE_T) accumulator through
    ``stream_scatter_rmw``."""

    def kernel(cmat, idx, out, rwbuf, rwsems):
        @pl.when(pl.program_id(0) == 0)
        def _init():
            jbs.zero_hbm_blocks(out, rwbuf, rwsems, n_blocks, TILE_T)

        events = [(_split3(cmat[e * ROWS:(e + 1) * ROWS, :]),
                   idx[e:e + 1, :].T)
                  for e in range(cmat.shape[0] // ROWS)]
        jbs.stream_scatter_rmw(out, rwbuf, rwsems, events, n_blocks, TILE_T,
                               R)

    ne = contribs.shape[1]
    nep = -(-ne // 8) * 8
    idx_p = jnp.concatenate(
        [idxs, jnp.full((grid, nep - ne, R), -1, jnp.int32)], axis=1)
    with pltpu.force_tpu_interpret_mode():
        out = pl.pallas_call(
            kernel, grid=(grid,),
            in_specs=[pl.BlockSpec((ne * ROWS, R), lambda i: (i, 0),
                                   memory_space=pltpu.VMEM),
                      pl.BlockSpec((nep, R), lambda i: (i, 0),
                                   memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec(memory_space=pl.ANY),
            out_shape=jax.ShapeDtypeStruct((ROWS, n_blocks * TILE_T),
                                           jnp.float32),
            scratch_shapes=[pltpu.VMEM((2, ROWS, TILE_T), jnp.float32),
                            pltpu.SemaphoreType.DMA((2, 2))],
        )(jnp.asarray(contribs).reshape(grid * ne * ROWS, R),
          idx_p.reshape(grid * nep, R))
    return np.asarray(out)


def _port_scatter(contribs, idxs, n_tris):
    """The same events in the port's layout, in (step, event, lane)
    order, through ``stream_scatter_call`` on CPU tensors."""
    grid, ne = idxs.shape[:2]
    val = np.ascontiguousarray(contribs.transpose(0, 1, 3, 2)).reshape(
        grid * ne * R, ROWS)
    adj = torch.zeros((n_tris, ROWS))
    ss.stream_scatter_call(adj, torch.from_numpy(idxs.reshape(-1)),
                           torch.from_numpy(val))
    return adj.numpy().T


@pytest.mark.parametrize("n_blocks", [1, 2, 3, 7])
def test_scatter_plain_matches_jax_rmw(n_blocks):
    rng = np.random.default_rng(n_blocks)
    grid, ne, t = 2, 3, n_blocks * TILE_T
    contribs = rng.normal(size=(grid, ne, ROWS, R)).astype(np.float32)
    idxs = rng.integers(-1, t, size=(grid, ne, R)).astype(np.int32)
    want = _jax_rmw(contribs, jnp.asarray(idxs), n_blocks, grid)
    got = _port_scatter(contribs, idxs, t)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


def test_scatter_plain_dense_collisions_vs_fp64_oracle():
    """tests/test_stream_scatter.py's collision depth: half of all events
    on 4 hot triangles, hundreds of additions deep. The plain version
    sums in float64 and rounds once: equal to the float64 oracle rounded,
    and within that file's bound of JAX's float32 pass."""
    rng = np.random.default_rng(42)
    n_blocks, grid, ne = 2, 8, 6
    t = n_blocks * TILE_T
    contribs = rng.normal(size=(grid, ne, ROWS, R)).astype(np.float32)
    idxs = rng.integers(0, t, size=(grid, ne, R)).astype(np.int32)
    hot = rng.integers(0, t, size=4)
    mask = rng.random(size=idxs.shape) < 0.5
    idxs[mask] = hot[rng.integers(0, 4, size=int(mask.sum()))]
    want64 = np.zeros((ROWS, t), np.float64)
    for g in range(grid):
        for e in range(ne):
            np.add.at(want64.T, idxs[g, e], contribs[g, e].T.astype(
                np.float64))
    got = _port_scatter(contribs, idxs, t)
    np.testing.assert_array_equal(got, want64.astype(np.float32))
    jax_got = _jax_rmw(contribs, jnp.asarray(idxs), n_blocks, grid)
    scale = np.abs(want64).max()
    np.testing.assert_allclose(jax_got, want64, rtol=2e-4, atol=1e-4 * scale)
    assert np.bincount(idxs.reshape(-1)).max() > 700


# ---- the wrappers on CPU tensors, and their checks ----


def _inputs(n_tris=1030, cfg=None):
    cfg = cfg or RenderConfig(width=8, height=4, spp=2)
    o, d, seeds = mk.pack_rays(Camera.default(CPU), cfg)
    tri = mk.scene_table(procedural_scene(n_tris, seed=1, device=CPU))
    return o, d, seeds, tri, torch.ones((o.shape[0], 3)), cfg


def test_calls_on_cpu_take_plain_without_counting():
    o, d, seeds, tri, gbar, cfg = _inputs()
    adj = torch.zeros((tri.shape[0], 9))
    idx = torch.tensor([0, -1, 1029, 0], dtype=torch.int32)
    val = torch.arange(36, dtype=torch.float32).reshape(4, 9)
    before = (bs.bigscene_call.launches, bg.bigscene_bwd_call.launches,
              ss.stream_scatter_call.launches)
    out = bs.bigscene_call(o, d, seeds, tri, cfg)
    gtab = bg.bigscene_bwd_call(o, d, seeds, tri, gbar.T.contiguous().T,
                                cfg)
    got = ss.stream_scatter_call(adj, idx, val)
    assert (bs.bigscene_call.launches, bg.bigscene_bwd_call.launches,
            ss.stream_scatter_call.launches) == before
    assert torch.equal(out, mk.megakernel_plain(o, d, seeds, tri, cfg))
    assert torch.equal(gtab, mg.mega_bwd_plain(o, d, seeds, tri, gbar, cfg))
    assert got is adj
    assert torch.equal(adj[0], val[0] + val[3])
    assert torch.equal(adj[1029], val[2]) and not adj[1:1029].any()


def test_calls_reject_bad_inputs():
    o, d, seeds, tri, gbar, cfg = _inputs()
    too_big = torch.zeros((bs.BIG_MAX_TRIS + 1, 18))
    for args in [(o.double(), d, seeds, tri), (o, d[:-1], seeds, tri),
                 (o, d, seeds.int(), tri), (o, d, seeds, tri[:, :12]),
                 (o, d, seeds, tri[:0]), (o, d, seeds, too_big),
                 (o.T.contiguous().T, d, seeds, tri),
                 (o, d, seeds, tri.to("meta"))]:
        with pytest.raises(ValueError):
            bs.bigscene_call(*args, cfg)
        with pytest.raises(ValueError):
            bg.bigscene_bwd_call(*args, gbar, cfg)
    for bad in (gbar[:-1], gbar.double(), gbar.to("meta")):
        with pytest.raises(ValueError):
            bg.bigscene_bwd_call(o, d, seeds, tri, bad, cfg)
    with pytest.raises(ValueError, match="max_bounces"):
        bg.bigscene_bwd_call(o, d, seeds, tri, gbar,
                             cfg.replace(max_bounces=bg.MAX_BOUNCES + 1))
    with pytest.raises(NotImplementedError):
        bs.bigscene_call(o, d, seeds, tri, cfg.replace(rng="hash"))
    # int32 overflow, on shapes alone (meta tensors hold no memory)
    n = 1 << 28
    mo = torch.empty((n, 3), device="meta")
    ms = torch.empty(n, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="overflow"):
        bg.bigscene_bwd_call(mo, mo, ms, tri.to("meta"), mo,
                             cfg.replace(max_bounces=16))
    big = 1 << 30
    with pytest.raises(ValueError, match="overflow"):
        bs.bigscene_call(torch.empty((big, 3), device="meta"),
                         torch.empty((big, 3), device="meta"),
                         torch.empty(big, dtype=torch.int64, device="meta"),
                         tri.to("meta"), cfg)


@pytest.mark.parametrize("case", ["adj dtype", "adj columns", "T", "idx "
                                  "dtype", "val shape", "devices",
                                  "contiguity", "overflow"])
def test_scatter_call_rejects_bad_inputs(case):
    adj, idx = torch.zeros((10, 9)), torch.zeros(4, dtype=torch.int32)
    val = torch.zeros((4, 9))
    args = {
        "adj dtype": (adj.double(), idx, val),
        "adj columns": (adj[:, :8], idx, val),
        "T": (torch.zeros((ss.MAX_TRIS + 1, 9)), idx, val),
        "idx dtype": (adj, idx.long(), val),
        "val shape": (adj, idx, val[:3]),
        "devices": (adj, idx, val.to("meta")),
        "contiguity": (adj, idx, torch.zeros((9, 4)).T),
        "overflow": (adj, torch.empty(1 << 31, dtype=torch.int32,
                                      device="meta"),
                     torch.empty((1 << 31, 9), device="meta")),
    }[case]
    with pytest.raises(ValueError):
        ss.stream_scatter_call(*args)


def test_plan_and_chunks_follow_the_sizes():
    """The scatter's plan and K8's chunks depend on the sizes alone, so
    two launches on the same inputs sum in the same order."""
    assert ss.plan(1 << 20, 1 << 20) == (4096, 256, 1)
    n_blocks, units, splits = ss.plan(3_000_000, 1150)
    assert n_blocks == 5 and splits == ss.MAX_SPLITS
    assert units == 733 and (units - 1) * ss.UNIT < 3_000_000
    # the two cells K7 is timed on: a K8 chunk and a K10 sample at 10k
    assert ss.plan(51_840_000, 10_000) == (40, 12_657, 27)
    assert ss.plan(20_736_000, 10_000) == (40, 5_063, 27)
    # the largest launch: 2^31 - 1 events in 2^19 units
    assert ss.plan(2**31 - 1, 1000)[1] == 1 << 19
    cfg = RenderConfig(width=1920, height=1080, spp=8, max_bounces=5)
    assert bg.chunk_samples(1920 * 1080, cfg) == 5
    assert bg.chunk_samples(512, cfg) == 8
    assert bg.chunk_samples(1 << 27, cfg.replace(max_bounces=16)) == 1


def test_queue_plan_fills_the_card_or_the_rays():
    """K6's persistent grid: every resident CTA, unless the rays fill
    fewer at one a lane."""
    assert bs.queue_plan(1920 * 1080, 6, 132) == 792
    assert bs.queue_plan(320 * 240, 6, 132) == 600
    assert bs.queue_plan(129, 6, 132) == 2 and bs.queue_plan(1, 1, 1) == 1
    for bad in ((0, 6, 132), (100, 0, 132), (100, 6, 0)):
        with pytest.raises(ValueError):
            bs.queue_plan(*bad)


#: Sweeps of 8 pixels at 2 samples: the camera sweep, then each sample's
#: sweeps after its first bounce (pixel 1 and 5 and 7 missed).
HAND_SWEEPS = [[1, 2, 2], [1, 0, 0], [1, 4, 0], [1, 1, 1],
               [1, 1, 0], [1, 0, 0], [1, 2, 1], [1, 0, 0]]


@pytest.mark.parametrize("ctas, want", [
    # 4-lane CTAs: lockstep sweeps 1 + 4 + 2 and 1 + 2 + 1 times (44 lane
    # slots); regeneration as often as its busiest lane, 5 and 4 (36);
    # with 8 lanes the queue gives each lane one pixel, as regeneration
    (2, dict(lockstep=(11, 1 - 22 / 44), regeneration=(9, 1 - 22 / 36),
             queue=(9, 1 - 22 / 36))),
    # one CTA of 4 lanes takes the 8 pixels in order: pixel 4 goes to lane
    # 1 at step 1, pixel 5 to lane 1 at 3 (a tie with lane 3, the lower
    # lane wins), 6 to lane 3 at 3, 7 to lane 1 at 4; the last lane ends
    # at 7 (28 lane slots)
    (1, dict(lockstep=(11, 1 - 22 / 44), regeneration=(9, 1 - 22 / 36),
             queue=(7, 1 - 22 / 28))),
])
def test_lane_schedules_by_hand(ctas, want):
    got = bs.lane_schedules(np.array(HAND_SWEEPS), cta=4, ctas=ctas)
    assert got["useful_lane_sweeps"] == 22
    for name, (sweeps, idle) in want.items():
        assert got[name]["cta_sweeps"] == sweeps, name
        assert got[name]["idle_lane_share"] == pytest.approx(idle), name


def test_lane_schedules_of_a_uniform_frame_idle_nothing():
    """Every pixel the same work, a whole number of CTAs: no schedule
    idles a lane; a ragged last CTA idles its missing lanes."""
    even = bs.lane_schedules(np.full((256, 3), 2), cta=128, ctas=2)
    for name in ("lockstep", "regeneration", "queue"):
        assert even[name]["idle_lane_share"] == 0.0
    ragged = bs.lane_schedules(np.full((130, 3), 2), cta=128, ctas=2)
    assert ragged["lockstep"]["idle_lane_share"] == pytest.approx(
        1 - 130 / 256)


#: HAND_SWEEPS cut into K8's two launches of one sample each: the second
#: has no camera column (it reads the camera hits back).
HAND_CHUNKS = {0: [[1, 2], [1, 0], [1, 4], [1, 1], [1, 1], [1, 0], [1, 2],
                   [1, 0]],
               1: [[0, 2], [0, 0], [0, 0], [0, 1], [0, 0], [0, 0], [0, 1],
                   [0, 0]]}


@pytest.mark.parametrize("s0", [0, 1])
def test_chunk_totals_cut_the_frame_by_launch(s0):
    got = bs.chunk_totals(np.array(HAND_SWEEPS), s0, 1)
    assert got.dtype == np.int64
    assert got.tolist() == HAND_CHUNKS[s0]


def test_lane_schedules_by_hand_on_a_later_chunk():
    """The second launch's pixels, one CTA of 4 lanes: work 2, 0, 0, 1, 0,
    0, 1, 0. Pixels without work take no sweep: lane 1 takes pixels 1 and
    2 at step 0 and pixel 3 (to step 1), lane 2 pixels 4, 5 and 6 (to step
    1), lane 3 pixel 7; lane 0's pixel 0 ends last, at 2 (8 lane slots).
    Lockstep and regeneration sweep 2 + 1 (12 slots)."""
    got = bs.lane_schedules(np.array(HAND_CHUNKS[1]), cta=4, ctas=1)
    assert got["useful_lane_sweeps"] == 4
    for name, (sweeps, idle) in dict(
            lockstep=(3, 1 - 4 / 12), regeneration=(3, 1 - 4 / 12),
            queue=(2, 1 - 4 / 8)).items():
        assert got[name]["cta_sweeps"] == sweeps, name
        assert got[name]["idle_lane_share"] == pytest.approx(idle), name
    # a chunk whose every camera ray missed sweeps nothing, idles nothing
    none = bs.lane_schedules(np.zeros((8, 2), dtype=np.int64), cta=4, ctas=2)
    for name in ("lockstep", "regeneration", "queue"):
        assert none[name] == dict(cta_sweeps=0, idle_lane_share=0.0), name


class _FakeOccupancy:
    """The library's occupancy queries, each kernel its own answer (K6 8,
    K8 5, K9 4, K11 3, K10 2 CTAs an SM), recording what was asked."""

    def __init__(self):
        self.asked = []

    def spath_bigscene_forward_occupancy(self):
        self.asked.append("K6")
        return 8

    def spath_bigscene_backward_occupancy(self):
        self.asked.append("K8")
        return 5

    def spath_bigscene_quality_forward_occupancy(self, export_hits):
        self.asked.append("K11" if export_hits else "K9")
        return 3 if export_hits else 4

    def spath_bigscene_quality_backward_occupancy(self):
        self.asked.append("K10")
        return 2


@pytest.fixture
def fake_card(monkeypatch):
    """A card of 132 SMs behind ``_FakeOccupancy``, with the cache of
    ``resident_ctas`` emptied before and after."""
    import contextlib
    import types

    lib = _FakeOccupancy()
    monkeypatch.setattr(bs, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda index: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda index: types.SimpleNamespace(
                            multi_processor_count=132))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    bs.resident_ctas.cache_clear()
    yield lib
    bs.resident_ctas.cache_clear()


@pytest.mark.parametrize("kernel, per_sm", [("K6", 8), ("K8", 5), ("K9", 4),
                                            ("K11", 3), ("K10", 2)])
def test_queue_grid_asks_each_kernel_its_own_occupancy(fake_card, kernel,
                                                       per_sm):
    """Each queue kernel's persistent grid is its own resident CTAs times
    the SMs, once a device (cached), unless the rays fill fewer CTAs."""
    assert bs.resident_ctas(0, kernel) == (per_sm, 132)
    cuda = torch.device("cuda", 0)
    assert bs.queue_grid(1920 * 1080, cuda, kernel) == per_sm * 132
    assert bs.queue_grid(1920 * 1080, torch.device("cuda"), kernel) \
        == per_sm * 132
    assert bs.queue_grid(300, cuda, kernel) == 3
    assert fake_card.asked == [kernel]


def test_a_failed_occupancy_query_names_the_kernel(fake_card, monkeypatch):
    monkeypatch.setattr(fake_card, "spath_bigscene_backward_occupancy",
                        lambda: -98)
    monkeypatch.setattr(fake_card, "spath_error_string",
                        lambda err: b"invalid device function",
                        raising=False)
    with pytest.raises(RuntimeError, match="K8 occupancy query failed"):
        bs.resident_ctas(0, "K8")


@pytest.mark.parametrize("call, kernel", [
    (bs.bigscene_call, "K6"), (bg.bigscene_bwd_call, "K8")])
def test_wrappers_size_their_grid_by_their_own_kernel(call, kernel):
    """The launches take the grid of their own kernel's occupancy."""
    import inspect

    src = inspect.getsource(call)
    assert 'queue_grid(' in src and f'"{kernel}")' in src
    for other in set(bs.QUEUE_KERNELS) - {kernel}:
        assert f'"{other}")' not in src


def test_guardrails():
    scene, cam = default_scene(CPU), Camera.default(CPU)
    cfg = RenderConfig(width=8, height=4, spp=1)
    assert bs.supported(scene, cfg) and bg.supported_grad(scene, cfg)
    for bad in (cfg.replace(rng="hash", sampler="cosine"),
                cfg.replace(sampler="cosine"), cfg.replace(stratify=True)):
        assert not bs.supported(scene, bad)
    assert bs.supported(scene, cfg.replace(max_bounces=20))
    # K8's saved state holds 64 bounces
    assert bg.supported_grad(scene, cfg.replace(max_bounces=17))
    assert not bg.supported_grad(scene, cfg.replace(
        max_bounces=bg.MAX_BOUNCES + 1))
    # vis_grad changes no frame: K6 renders it; its gradient is
    # VisGradFusedRenderer's
    assert bs.supported(scene, cfg.replace(vis_grad=True))
    assert not bg.supported_grad(scene, cfg.replace(vis_grad=True))
    assert bs.BIG_MAX_TRIS == bg.GRAD_MAX_TRIS == jbs.BIG_MAX_TRIS
    assert bg.GRAD_MAX_TRIS == jbs.BIG_GRAD_MAX_TRIS
    for fn in (bs.render_radiance_bigscene,
               bg.render_radiance_bigscene_grad):
        with pytest.raises(ValueError):
            fn(scene, cam, cfg.replace(rng="hash", sampler="cosine"), 0)


def test_big_rows_gives_the_wavefront_gradient(combined):
    """``BigRows`` on CPU tensors (K6's and K8's plain versions) gives the
    value and, within sum-order noise, the gradients of autograd through
    the port's own wavefront."""
    got = _port_grads(combined)
    want = _port_grads(combined, pathtracer.render_radiance)
    for name, g, w in zip(FIELDS, got, want):
        scale = np.abs(w).max()
        assert scale > 0, name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * scale,
                                   err_msg=name)


# ---- routing with a faked CUDA device ----


def _as_if_on_cuda(monkeypatch):
    """Scenes and cameras report a CUDA device; no plain version may be
    reached, and the kernels' renders only record their calls."""
    cuda = torch.device("cuda", 0)
    monkeypatch.setattr(Scene, "device", property(lambda self: cuda))
    monkeypatch.setattr(Camera, "device", property(lambda self: cuda))

    def forbidden(*args, **kw):
        raise AssertionError("plain version reached for a CUDA scene")

    for module, name in ((mk, "megakernel_plain"), (mg, "mega_bwd_plain"),
                         (ss, "stream_scatter_plain")):
        monkeypatch.setattr(module, name, forbidden)
    calls = []

    def kernel(tag):
        def render(scene, camera, cfg, seed=0):
            calls.append((tag, scene.n_tris))
            return torch.zeros((cfg.height, cfg.width, 3), requires_grad=True)
        return render

    # the wavefront on the card, its sweeps on K5
    monkeypatch.setattr(pathtracer, "render_radiance", kernel("wavefront"))

    monkeypatch.setattr(mk, "render_radiance_megakernel", kernel("K1"))
    monkeypatch.setattr(mg, "render_radiance_mega", kernel("K1+K2"))
    monkeypatch.setattr(bs, "render_radiance_bigscene", kernel("K6"))
    monkeypatch.setattr(bg, "render_radiance_bigscene_grad",
                        kernel("K6+K8"))
    return calls


@pytest.mark.parametrize("n_tris", [1025, 3000])
def test_routing_sends_large_cuda_scenes_to_the_streamed_kernels(
        monkeypatch, n_tris):
    scene = procedural_scene(n_tris, seed=1, device=CPU)
    calls = _as_if_on_cuda(monkeypatch)
    cfg, cam = RenderConfig(width=8, height=4, spp=1), Camera.default(CPU)
    assert renderer.forward_renderer(scene, cfg).name == "bigscene"
    assert renderer.grad_renderer(scene, cfg).name == "bigscene"
    assert render_pt_fast(scene, cam, cfg).shape == (4, 8, 3)
    assert render_radiance_fastgrad(scene, cam, cfg).shape == (4, 8, 3)
    assert calls == [("K6", n_tris), ("K6+K8", n_tris)]


@pytest.mark.parametrize("n_tris", [7, 64, 1024])
def test_routing_keeps_scenes_at_the_crossovers_on_the_fused_kernels(
        monkeypatch, n_tris):
    scene = (default_scene(CPU) if n_tris == 7
             else procedural_scene(n_tris, seed=1, device=CPU))
    calls = _as_if_on_cuda(monkeypatch)
    cfg, cam = RenderConfig(width=8, height=4, spp=1), Camera.default(CPU)
    render_pt_fast(scene, cam, cfg)
    render_radiance_fastgrad(scene, cam, cfg)
    want_fwd = "K1" if n_tris <= renderer.SMEM_ROUTE_MAX_TRIS else "K6"
    want_grad = ("K1+K2" if n_tris <= renderer.GRAD_ROUTE_MAX_TRIS
                 else "K6+K8")
    assert calls == [(want_fwd, n_tris), (want_grad, n_tris)]


def test_routing_raises_where_no_kernel_takes_a_cuda_scene(monkeypatch):
    """Above 2^20 triangles both directions name the streamed kernels'
    cap; a gradient above the backward kernels' 64 bounces goes to the
    wavefront on the card (the forward kernel takes any depth); the
    quality estimator above 1024 triangles goes to the streamed quality
    kernels K9 and K10, and to the wavefront above 64 bounces."""
    from spath_tpu_torch.ops.kernels import bigscene_quality as bq
    from spath_tpu_torch.ops.kernels import bigscene_quality_grad as bqg

    huge = procedural_scene(bs.BIG_MAX_TRIS + 1, seed=1, device=CPU)
    big = procedural_scene(1100, seed=1, device=CPU)
    calls = _as_if_on_cuda(monkeypatch)
    cfg, cam = RenderConfig(width=8, height=4, spp=1), Camera.default(CPU)
    with pytest.raises(NotImplementedError, match="K6 take T <= 1048576"):
        render_pt_fast(huge, cam, cfg)
    with pytest.raises(NotImplementedError, match="K6 and K8 take T <= "):
        render_radiance_fastgrad(huge, cam, cfg)
    assert calls == []
    long = cfg.replace(max_bounces=bg.MAX_BOUNCES + 1)
    render_radiance_fastgrad(big, cam, long)
    quality = cfg.replace(rng="hash", sampler="cosine", nee=True)
    render_radiance_fastgrad(big, cam, quality.replace(
        max_bounces=bqg.MAX_BOUNCES + 1))
    assert calls == [("wavefront", 1100)] * 2
    del calls[:]
    render_pt_fast(big, cam, long)
    assert calls == [("K6", 1100)]
    monkeypatch.setattr(bq, "render_radiance_bigscene_quality",
                        lambda s, c, f, seed=0: calls.append(
                            ("K9", s.n_tris)) or torch.zeros(4, 8, 3))
    monkeypatch.setattr(bqg, "render_radiance_bigscene_quality_grad",
                        lambda s, c, f, seed=0: calls.append(
                            ("K9+K10", s.n_tris)) or torch.zeros(4, 8, 3))
    render_pt_fast(big, cam, quality)
    render_radiance_fastgrad(big, cam, quality)
    assert calls[1:] == [("K9", 1100), ("K9+K10", 1100)]


def test_routing_keeps_cpu_tensors_on_the_wavefront(monkeypatch):
    scene, cam = procedural_scene(1100, seed=1, device=CPU), \
        Camera.default(CPU)
    cfg = RenderConfig(width=4, height=2, spp=1, max_bounces=2)
    assert renderer.forward_renderer(scene, cfg).name == "wavefront"
    assert renderer.grad_renderer(scene, cfg).name == "wavefront"

    def forbidden(*args, **kw):
        raise AssertionError("a streamed path reached with CPU tensors")

    monkeypatch.setattr(bs, "bigscene_call", forbidden)
    monkeypatch.setattr(bg, "bigscene_bwd_call", forbidden)
    assert render_pt_fast(scene, cam, cfg).shape == (2, 4, 3)
    assert render_radiance_fastgrad(scene, cam, cfg).shape == (2, 4, 3)


def test_sources_name_what_they_replace():
    """Each streamed source names its TPU kernel and entry point; K6 and
    K8 share the streamed walk, which runs K1's tests."""
    from spath_tpu_torch.ops.kernels import build

    for source, replaces, entry in (
            ("bigscene.cu", "megakernel_bigscene.py::_bigscene_kernel",
             "spath_bigscene_forward"),
            ("bigscene_grad.cu",
             "megakernel_bigscene_grad.py::_bigscene_bwd_kernel",
             "spath_bigscene_backward"),
            ("stream_scatter.cu", "megakernel_bigscene.py::stream_scatter_rmw",
             "spath_stream_scatter")):
        src = (build.SOURCE_DIR / source).read_text()
        assert "spath_tpu/ops/pallas/" + replaces.split("::")[0] in src
        assert replaces.split("::")[1] in src
        assert f'extern "C" int {entry}(' in src
    sweep = (build.SOURCE_DIR / "stream_sweep.cuh").read_text()
    assert '#include "megakernel_common.cuh"' in sweep
    assert "mt_test<SharedRow>" in sweep and "origin_terms<SharedRow>" in sweep
    for source in ("bigscene.cu", "bigscene_grad.cu"):
        assert '#include "stream_sweep.cuh"' in (
            build.SOURCE_DIR / source).read_text()
