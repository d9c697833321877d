"""The threefry and table streams of the port against the JAX package on
the CPU: ``jax.random``'s threefry functions and ``per_pixel_uniforms``
bit for bit, the table stream's functions bit for bit, frames of both
streams and threefry gradients against the JAX package's
``render_radiance`` run op by op (``jax.disable_jit``), ``recover`` on a
threefry config, ``bounce_stats``, the tone maps and the CLI. 16×12
frames, at most 2 samples; inputs from numpy with fixed seeds."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spath_tpu.camera import Camera as JCamera  # noqa: E402
from spath_tpu.config import QUALITY as J_QUALITY  # noqa: E402
from spath_tpu.config import RenderConfig as JConfig  # noqa: E402
from spath_tpu.models import inverse as jinv  # noqa: E402
from spath_tpu.models.pathtracer import (  # noqa: E402
    render_radiance as j_render_radiance,
)
from spath_tpu.ops import rng as jrng  # noqa: E402
from spath_tpu.scene import Scene as JScene  # noqa: E402
from spath_tpu.scene import default_scene as j_default_scene  # noqa: E402
from spath_tpu.utils import image as jimage  # noqa: E402
from spath_tpu.utils.profiling import bounce_stats as j_bounce_stats  # noqa: E402,E501
from spath_tpu_torch import cli  # noqa: E402
from spath_tpu_torch.camera import Camera  # noqa: E402
from spath_tpu_torch.config import QUALITY, RenderConfig  # noqa: E402
from spath_tpu_torch.models import inverse as inv  # noqa: E402
from spath_tpu_torch.models.pathtracer import (  # noqa: E402
    render_pt_fast, render_radiance,
)
from spath_tpu_torch.models.renderer import forward_renderer  # noqa: E402
from spath_tpu_torch.ops import rng  # noqa: E402
from spath_tpu_torch.ops.kernels import build  # noqa: E402
from spath_tpu_torch.ops.kernels.threefry import (  # noqa: E402
    MAX_DRAWS, threefry_call,
)
from spath_tpu_torch.scene import Scene, default_scene  # noqa: E402
from spath_tpu_torch.utils import image  # noqa: E402
from spath_tpu_torch.utils import profiling  # noqa: E402

CPU = torch.device("cpu")
SEEDS = (0, 3, 2**31 - 1)
DATA = (0, 1, 12345, 2**31, 2**32 - 1)
N_DRAWS = (1, 2, 5, 7, 8)
#: the frame of every render test, and its seed
FRAME = dict(width=16, height=12, spp=2, max_bounces=3)
SEED = 5


def _words(key) -> tuple[int, int]:
    return tuple(int(w) for w in np.asarray(jax.random.key_data(key)))


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


# ---- threefry, bit for bit against jax.random ----


def test_jax_threefry_flag_is_the_one_the_port_follows():
    """The port follows jax 0.9.0's default ``jax_threefry_partitionable
    = True``: if the default flips, every draw changes, and this fails
    first."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_key_fold_in_and_uniform_bit_equal_to_jax(seed):
    key = jax.random.key(seed)
    assert rng.threefry_key(seed) == _words(key)
    for data in DATA:
        assert rng.fold_in(rng.threefry_key(seed), data) == _words(
            jax.random.fold_in(key, data)), data
    for n in N_DRAWS:
        want = jax.random.uniform(key, (n,), jnp.float32)
        got = rng.threefry_uniform(rng.threefry_key(seed), n)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_threefry_key_takes_what_jax_takes_and_refuses_the_rest():
    """The JAX package runs with x64 off: a seed is cast to 32 bits, so a
    seed above 2^32 keys as its low word, a negative one as its two's
    complement; a key's two words pass as they are; a float and an int
    beyond the C long range are refused with jax's exceptions."""
    for seed in (2**32 + 7, -1, -5, 2**63 - 1, np.uint32(9), True,
                 torch.tensor(11)):
        want = _words(jax.random.key(int(seed)))
        assert rng.threefry_key(seed) == want, seed
    key = jax.random.fold_in(jax.random.key(7), 3)
    for words in (_words(key), list(_words(key)),
                  torch.tensor(_words(key))):
        assert rng.threefry_key(words) == _words(key)
    for bad, err in ((1.5, TypeError), (2**64, OverflowError),
                     (-(2**63) - 1, OverflowError)):
        with pytest.raises(err):
            jax.random.key(bad)
        with pytest.raises(err):
            rng.threefry_key(bad)
    with pytest.raises(ValueError):
        rng.threefry_key((2**32, 0))


@pytest.fixture(scope="module")
def pixel_ids():
    """193 global pixel ids, among them ids near 2^32."""
    r = np.random.Generator(np.random.Philox(11))
    ids = np.concatenate([np.arange(64), r.integers(64, 2**32, 64),
                          2**32 - 1 - np.arange(65)])
    return ids.astype(np.uint32)


@pytest.mark.parametrize("n_draws", N_DRAWS)
def test_per_pixel_uniforms_bit_equal_to_the_jax_package(pixel_ids,
                                                         n_draws):
    """``per_pixel_uniforms`` against ``spath_tpu.ops.rng.
    per_pixel_uniforms`` under a key folded with a sample and a bounce, as
    the wavefront keys a step; ``threefry_call`` on CPU tensors is it, and
    counts no launch."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(3), 1), 2)
    want = jrng.per_pixel_uniforms(key, jnp.asarray(pixel_ids), n_draws)
    ids = torch.from_numpy(pixel_ids.astype(np.int64))
    got = rng.per_pixel_uniforms(_words(key), ids, n_draws)
    assert got.dtype == torch.float32 and got.shape == (n_draws, 193)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    before = threefry_call.launches
    assert torch.equal(threefry_call(_words(key), ids, n_draws), got)
    assert threefry_call.launches == before


def test_threefry_call_rejects_bad_inputs():
    ids = torch.arange(8)
    for key, ids_, n in (((2**32, 0), ids, 2), ((1,), ids, 2),
                         ((1, 2), ids.int(), 2), ((1, 2), ids[None], 2),
                         ((1, 2), ids, 0), ((1, 2), ids, MAX_DRAWS + 1),
                         ((1, 2), ids.to("meta"), 2)):
        with pytest.raises(ValueError):
            threefry_call(key, ids_, n)


def test_threefry_source_names_what_it_replaces_and_is_declared():
    """The kernel names the XLA function it stands for, its entry point,
    and ``ops/kernels/build.py`` declares that entry point's arguments."""
    src = (build.SOURCE_DIR / "threefry.cu").read_text()
    assert "spath_tpu/ops/rng.py:220" in src
    assert 'extern "C" int spath_threefry(' in src
    assert "__funnelshift_l" in src and "0x1BD11BDAu" in src
    declared = (build.SOURCE_DIR.parent / "ops" / "kernels"
                / "build.py").read_text()
    assert "lib.spath_threefry.argtypes" in declared


# ---- the table stream, bit for bit against the JAX package ----


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 5])
def test_glibc_rand_bit_equal(seed):
    want, got = jrng.GlibcRand(seed), rng.GlibcRand(seed)
    assert [got.rand() for _ in range(1000)] == \
        [want.rand() for _ in range(1000)]
    assert got() == want()


@pytest.mark.parametrize("n", [10, 1000])
def test_vec_dist_table_and_device_table_bit_equal(n):
    want = jrng.vec_dist_table(n)
    got = rng.vec_dist_table(n)
    assert got.dtype == np.float64 and got.shape == (n + 1,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        rng.vec_dist_table(n, rng.GlibcRand(7)),
        jrng.vec_dist_table(n, jrng.GlibcRand(7)))
    np.testing.assert_array_equal(rng.device_table(n), jrng.device_table(n))
    assert rng.device_table(n).dtype == np.float32
    assert torch.equal(rng.table_tensor(n, CPU),
                       torch.from_numpy(jrng.device_table(n)))


@pytest.mark.parametrize("exact", [True, False])
def test_table_rng_bit_equal(exact):
    want = jrng.TableRng(50, seed=3, exact=exact)
    got = rng.TableRng(50, seed=3, exact=exact)
    assert [got() for _ in range(120)] == [want() for _ in range(120)]


@pytest.mark.parametrize("offset", [0, 3, 2**31 + 1, 2**32 - 9])
def test_table_uniforms_bit_equal_with_the_cursor_wrapping(offset):
    """The cursor ``pixel + offset + k`` wraps at 2^32 before ``% len``:
    offsets near 2^32 and pixel ids near 2^32 take that path."""
    table = jrng.device_table(50)
    pix = np.concatenate([np.arange(40), 2**32 - 1 - np.arange(24)]
                         ).astype(np.uint32)
    for sample, bounce in ((0, 0), (1, 2), (70_000, 4)):
        want = jrng.table_uniforms(jnp.asarray(table), jnp.asarray(pix),
                                   sample, bounce, 2, 5, offset)
        got = rng.table_uniforms(torch.from_numpy(table),
                                 torch.from_numpy(pix.astype(np.int64)),
                                 sample, bounce, 2, 5, offset)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- frames and gradients against the JAX package, op by op ----


def _j_frame(cfg: dict, seed) -> np.ndarray:
    with jax.disable_jit():
        return np.asarray(j_render_radiance(
            j_default_scene(), JCamera.default(),
            JConfig(**cfg, intersect="reference"), seed))


def _assert_flip_budget(got: np.ndarray, want: np.ndarray) -> None:
    """tests/test_torch_quality.py's bound: under 1% of pixels off by more
    than 1e-4 (the libraries' trig may differ in the last bit and flip a
    path), 1e-6 elsewhere."""
    assert want.max() > 0.05
    diff = np.abs(got - want)
    flipped = (diff > 1e-4).any(-1)
    assert flipped.mean() < 0.01
    assert diff[~flipped].max() <= 1e-6


STREAM_CASES = {
    "quality preset": dict(rng="threefry", sampler="cosine", nee=True),
    "threefry bsdf only": dict(rng="threefry", sampler="cosine"),
    "threefry rr strat": dict(rng="threefry", sampler="cosine", nee=True,
                              rr_start=1, stratify=True),
    "threefry vis_grad": dict(rng="threefry", sampler="cosine", nee=True,
                              rr_start=1, vis_grad=True),
    "table angle": dict(rng="table", sampler="angle"),
    "table cosine": dict(rng="table", sampler="cosine"),
}


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_render_radiance_matches_jax(case):
    """The wavefront on both streams: NEE with MIS, Russian roulette,
    stratification and vis_grad (8 draws a bounce) on threefry; the table
    stream with the reference's angle sampler and the cosine sampler."""
    cfg = dict(FRAME, **STREAM_CASES[case])
    got = render_radiance(default_scene(CPU), Camera.default(CPU),
                          RenderConfig(**cfg), SEED).numpy()
    _assert_flip_budget(got, _j_frame(cfg, SEED))


def test_a_threefry_key_as_the_seed():
    """A typed key as the JAX package's seed (``_is_key``) and its two
    words as the port's, as a tuple and as a tensor."""
    key = jax.random.fold_in(jax.random.key(9), 4)
    cfg = dict(FRAME, **STREAM_CASES["quality preset"])
    want = _j_frame(cfg, key)
    for seed in (_words(key), torch.tensor(_words(key))):
        got = render_radiance(default_scene(CPU), Camera.default(CPU),
                              RenderConfig(**cfg), seed).numpy()
        _assert_flip_budget(got, want)
    # not the frame of the seed 9
    assert not np.array_equal(want, _j_frame(cfg, 9))


def test_quality_preset_is_the_jax_package_s():
    assert QUALITY.__dict__ == J_QUALITY.__dict__
    assert QUALITY.rng == "threefry" and QUALITY.nee


def test_table_refuses_what_jax_refuses():
    scene, cam = default_scene(CPU), Camera.default(CPU)
    for kw, msg in ((dict(nee=True), "nee requires"),
                    (dict(rr_start=1), "rr_start/stratify"),
                    (dict(stratify=True), "rr_start/stratify")):
        cfg = RenderConfig(**FRAME, rng="table", **kw)
        with pytest.raises(ValueError, match=msg):
            render_radiance(scene, cam, cfg)
        with pytest.raises(ValueError, match=msg):
            _j_frame(dict(FRAME, rng="table", **kw), 0)


def test_threefry_grads_match_jax():
    """Vertex, albedo, emission and camera-position gradients of a
    weighted frame of the QUALITY preset's estimator (threefry, cosine,
    NEE with MIS) against ``jax.grad`` of JAX's ``render_radiance`` run
    op by op: the same program, so the bound is sum-order noise,
    1e-5·max|grad| of each."""
    kw = dict(FRAME, **STREAM_CASES["quality preset"])
    wts = np.random.Generator(np.random.Philox(7)).uniform(
        0.1, 1.0, (12, 16, 3)).astype(np.float32)
    js, jcam = j_default_scene(), JCamera.default()

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
    for name, g, w in zip(("vertices", "albedo", "emission", "camera"),
                          got, want):
        w = np.asarray(w)
        scale = np.abs(w).max()
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * scale,
                                   err_msg=name)


# ---- recover, bounce_stats and the profiling helpers ----


def _perturbed(albedo: np.ndarray) -> np.ndarray:
    """The CLI's perturbation: ``default_rng(1)`` uniform ±0.4, clipped
    to [0.05, 1]."""
    return np.clip(albedo + np.random.default_rng(1).uniform(
        -0.4, 0.4, albedo.shape).astype(np.float32), 0.05, 1.0)


def test_recover_on_a_threefry_config(tmp_path):
    """Three steps of ``recover`` on the QUALITY preset's estimator, the
    CLI's perturbation and optimizer, the target's seed fixed: the first
    loss equals the JAX package's ``render_loss`` run op by op within
    1e-5 relative, the loss falls, and the metrics file holds one record a
    step."""
    cfg = dict(FRAME, **STREAM_CASES["quality preset"])
    scene, cam = default_scene(CPU), Camera.default(CPU)
    target = render_radiance(scene, cam, RenderConfig(**cfg), SEED)
    bad = _perturbed(scene.albedo.numpy())
    jcam = JCamera.default()
    with jax.disable_jit():
        want = float(jinv.render_loss(
            jinv.InverseParams(jcam.pos, jcam.angle, jcam.focal,
                               jnp.asarray(bad)),
            j_default_scene(), jnp.asarray(target.numpy()),
            JConfig(**cfg, intersect="reference"), SEED))
    metrics = tmp_path / "m.jsonl"
    log = []
    state, losses = inv.recover(
        scene, target, inv.InverseParams(cam.pos, cam.angle, cam.focal,
                                         torch.from_numpy(bad)),
        RenderConfig(**cfg),
        inv.param_group_optimizer(freeze_pose=True, albedo_lr=2e-2),
        steps=3, fixed_seed=SEED, log_every=1, log_fn=log.append,
        metrics_path=str(metrics))
    assert abs(losses[0] - want) <= 1e-5 * want, (losses[0], want)
    assert losses[2] < losses[1] < losses[0], losses
    assert [m.split(":")[0] for m in log] == ["step 0", "step 1", "step 2"]
    lines = metrics.read_text().splitlines()
    assert len(lines) == 3 and '"event": "train_step"' in lines[0]
    assert '"grad_norm"' in lines[2] and '"step": 2' in lines[2]


def test_recover_defaults_to_adam_at_learning_rate():
    """``optimizer=None``: Adam at ``learning_rate`` on every parameter,
    as the JAX package's ``optax.adam(learning_rate)``; ``log_every=0``
    logs nothing."""
    cfg = RenderConfig(width=8, height=4, spp=1, max_bounces=2)
    scene, cam = default_scene(CPU), Camera.default(CPU)
    target = render_radiance(scene, cam, cfg, 0)
    log = []
    state, losses = inv.recover(
        scene, target, inv.InverseParams.init(scene, cam), cfg, steps=1,
        learning_rate=1e-3, log_every=0, log_fn=log.append)
    groups = state.optimizer.param_groups
    assert isinstance(state.optimizer, torch.optim.Adam) and log == []
    assert [g["lr"] for g in groups] == [1e-3]
    assert len(groups[0]["params"]) == 4 and len(losses) == 1


@pytest.mark.parametrize("kw", [dict(), STREAM_CASES["quality preset"]])
def test_bounce_stats_equal_jax(kw):
    """Each bounce's live share of one sample: LCG and threefry, against
    the JAX package's ``bounce_stats`` run op by op."""
    cfg = dict(width=16, height=12, spp=1, max_bounces=4, **kw)
    with jax.disable_jit():
        want = j_bounce_stats(j_default_scene(), JCamera.default(),
                              JConfig(**cfg, intersect="reference"), SEED)
    got = profiling.bounce_stats(default_scene(CPU), Camera.default(CPU),
                                 RenderConfig(**cfg), SEED)
    assert got.dtype == np.float32 and got.shape == (4,)
    np.testing.assert_array_equal(got, want)
    assert 0.0 < got[-1] <= got[0] < 1.0


def test_frame_timer_trace_and_sync(tmp_path):
    cfg = RenderConfig(width=8, height=4, spp=2, max_bounces=3)
    ft = profiling.FrameTimer(cfg)
    scene, cam = default_scene(CPU), Camera.default(CPU)
    with profiling.trace_to(str(tmp_path / "trace")):
        for _ in range(2):
            with ft.frame():
                img = profiling.sync(render_pt_fast(scene, cam, cfg))
    assert ft.n_rays_per_frame == 8 * 4 * 2 * 3 and len(ft.times) == 2
    assert ft.rays_per_s == ft.n_rays_per_frame / min(ft.times)
    assert ft.last_s == ft.times[-1] and img.shape == (4, 8, 3)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    x = {"a": [torch.ones(2)], "b": 1}
    assert profiling.sync(x) is x


# ---- tone maps and the CLI ----


@pytest.mark.parametrize("mode", image.TONEMAP_MODES)
def test_tonemap_and_rgba_u8_equal_jax(mode):
    hdr = np.random.Generator(np.random.Philox(5)).uniform(
        0.0, 3.0, (12, 16, 3)).astype(np.float32)
    for exposure in (1.0, 2.0, 0.25):
        got = image.tonemap(hdr, mode, exposure)
        want = jimage.tonemap(hdr, mode, exposure)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(image.to_rgb_u8(got),
                                      jimage.to_rgb_u8(want))
        np.testing.assert_array_equal(image.to_rgba_u8(got),
                                      jimage.to_rgba_u8(want))
    assert image.TONEMAP_MODES == jimage.TONEMAP_MODES
    with pytest.raises(ValueError):
        image.tonemap(hdr, "filmic")


CLI_CASES = {
    "threefry": (["--mode", "quality", "--rng", "threefry"],
                 dict(rng="threefry", sampler="cosine", nee=True), None),
    "table": (["--rng", "table"], dict(rng="table", sampler="angle"), None),
    "reinhard": (["--mode", "quality", "--tonemap", "reinhard",
                  "--exposure", "2"],
                 dict(rng="hash", sampler="cosine", nee=True), "reinhard"),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_render_equals_the_entry_point_it_wraps(case, tmp_path):
    """``render`` with the new streams and tone map, u8-equal to the
    function it wraps on the config the JAX CLI builds: ``render_pt_fast``,
    or the serving path's radiance through ``tonemap``."""
    argv, kw, tone = CLI_CASES[case]
    out = tmp_path / "f.png"
    assert cli.main(["render", "--size", "16x12", "--spp", "2",
                     "--bounces", "3", "--seed", str(SEED), "--device",
                     "cpu", "--out", str(out), *argv]) == 0
    cfg = RenderConfig(**FRAME, intersect="pluecker", **kw)
    scene, cam = default_scene(CPU), Camera.default(CPU)
    if tone is None:
        want = render_pt_fast(scene, cam, cfg, SEED).numpy()
    else:
        want = image.tonemap(forward_renderer(scene, cfg).render_radiance(
            scene, cam, cfg, SEED).numpy(), tone, 2.0)
    got = image.read_png(str(out))
    np.testing.assert_array_equal(got, image.to_rgb_u8(want))
    assert got.max() > 100
