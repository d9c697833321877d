"""The fused kernel's wrapper (K1) on the CPU: its plain version against
the JAX package's Pallas kernel (interpret mode) and wavefront on the
same inputs, the packing and table layouts, the input checks, and the
build's flags. The CUDA kernel itself runs only on the card
(``chip_smoke.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from spath_tpu.camera import Camera as JCamera  # noqa: E402
from spath_tpu.config import RenderConfig as JConfig  # noqa: E402
from spath_tpu.models.pathtracer import (  # noqa: E402
    render_radiance_jit as j_render_radiance_jit,
)
from spath_tpu.ops.pallas import megakernel as jmk  # noqa: E402
from spath_tpu.scene import default_scene as j_default_scene  # noqa: E402
from spath_tpu.scene import make_scene  # noqa: E402
from spath_tpu.scene import procedural_scene as j_procedural  # noqa: E402
from spath_tpu_torch.camera import Camera  # noqa: E402
from spath_tpu_torch.config import RenderConfig  # noqa: E402
from spath_tpu_torch.convert import scene_from_numpy  # noqa: E402
from spath_tpu_torch.ops.kernels import build  # noqa: E402
from spath_tpu_torch.ops.kernels import megakernel as mk  # noqa: E402
from spath_tpu_torch.ops.kernels import megakernel_grad as mg  # noqa: E402

CPU = torch.device("cpu")
#: one 1024-ray tile of K1, 3 samples of 5 bounces
SIZE = dict(width=32, height=32, spp=3, max_bounces=5)


def _default_plus_18():
    """The default scene and 18 small random triangles, 25 in all: the
    regime where K1 walks its table in a loop (T > 16). A procedural
    scene alone shows no light in so small a frame."""
    base, extra = j_default_scene(), j_procedural(18, seed=2)
    return make_scene(*(np.concatenate([np.asarray(getattr(base, k)),
                                        np.asarray(getattr(extra, k))])
                        for k in ("vertices", "albedo", "emission")))


def _port_scene(js):
    return scene_from_numpy(np.asarray(js.vertices), np.asarray(js.albedo),
                            np.asarray(js.emission), js.light_idx,
                            device=CPU)


def _plain_image(js, cfg, seed):
    o, d, seeds = mk.pack_rays(Camera.default(CPU), cfg, seed)
    out = mk.megakernel_plain(o, d, seeds, mk.scene_table(_port_scene(js)),
                              cfg)
    assert out.shape == (cfg.width * cfg.height, 3)
    return out.reshape(cfg.height, cfg.width, 3).numpy()


def _assert_conforms(got, want):
    """The kernel-vs-wavefront bounds of tests/test_pallas.py: under 1% of
    pixels off by more than 1e-4 (trig-ulp path flips), mean within 5%."""
    assert got.shape == want.shape
    flipped = (np.abs(got - want) > 1e-4).any(-1)
    assert flipped.mean() < 0.01, f"{flipped.mean():.4f} flipped"
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=5e-2)


def test_plain_matches_jax_megakernel():
    """Against K1 itself, run by the Pallas interpreter (its fori-walk
    regime; the unrolled one compiles twice as long on the CPU)."""
    js = _default_plus_18()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jmk.render_radiance_megakernel(
            js, JCamera.default(), JConfig(**SIZE), 5))
    got = _plain_image(js, RenderConfig(**SIZE), 5)
    assert want.max() > 0.1                          # a light is seen
    _assert_conforms(got, want)


def test_plain_matches_jax_wavefront():
    """The default scene, the main path's, against the JAX wavefront."""
    js = j_default_scene()
    want = np.asarray(j_render_radiance_jit(js, JCamera.default(),
                                            JConfig(**SIZE), 5))
    assert want.max() > 0.1
    _assert_conforms(_plain_image(js, RenderConfig(**SIZE), 5), want)


def test_pack_rays_and_table_match_jax():
    """The same numbers as K1's packing, without its TPU padding: the
    JAX package's (8, Np) rays carry 2 zero rows and zero lanes past n,
    its (T, 24) table 6 zero columns."""
    cfg = RenderConfig(width=24, height=8, spp=1)
    o, d, seeds = mk.pack_rays(Camera.default(CPU), cfg, seed=7)
    pack = jax.jit(jmk.pack_rays, static_argnums=(1, 3))
    jrays, jseeds = pack(JCamera.default(), JConfig(width=24, height=8,
                                                    spp=1), 7, 1024)[:2]
    jrays, n = np.asarray(jrays), 192
    assert o.shape == d.shape == (n, 3) and seeds.shape == (n,)
    assert o.is_contiguous() and d.is_contiguous()
    np.testing.assert_array_equal(o.numpy(), jrays[0:3, :n].T)
    np.testing.assert_array_equal(d.numpy(), jrays[3:6, :n].T)
    assert not jrays[6:].any() and not jrays[:, n:].any()
    np.testing.assert_array_equal(seeds.numpy().astype(np.uint32),
                                  np.asarray(jseeds)[0, :n])
    for js in (j_default_scene(), j_procedural(40, seed=1)):
        table = mk.scene_table(_port_scene(js))
        want = np.asarray(jax.jit(jmk._scene_table)(js))
        assert table.shape == (want.shape[0], 18) and table.is_contiguous()
        assert not want[:, 18:].any()
        np.testing.assert_array_equal(table[:, :9].numpy(), want[:, :9])
        np.testing.assert_allclose(table.numpy(), want[:, :18],
                                   rtol=2 ** -22, atol=1e-7)


def test_supported_matches_jax_guardrails():
    small = _port_scene(j_default_scene())
    assert mk.supported(small, RenderConfig(rng="lcg", sampler="angle"))
    assert mk.supported(_port_scene(j_procedural(100)), RenderConfig())
    assert not mk.supported(_port_scene(j_procedural(mk.MAX_TRIS + 8)),
                            RenderConfig())
    assert mk.MAX_TRIS == jmk.MAX_TRIS
    for kw in (dict(rng="threefry"), dict(rng="hash", sampler="cosine"),
               dict(rng="hash", nee=True), dict(rng="hash", rr_start=2),
               dict(rng="hash", stratify=True)):
        assert not mk.supported(small, RenderConfig(**kw)), kw
    # vis_grad changes no frame: K1 renders it, as the JAX kernel does,
    # and only the gradient refuses it (VisGradFusedRenderer's residual)
    vis = dict(vis_grad=True)
    assert mk.supported(small, RenderConfig(**vis))
    assert jmk.supported(j_default_scene(), JConfig(**vis))
    assert not mg.supported_grad(small, RenderConfig(**vis))
    assert mg.supported_grad(small, RenderConfig())


def test_mega_call_cpu_takes_plain_without_counting():
    scene = _port_scene(j_default_scene())
    cfg = RenderConfig(width=8, height=4, spp=2)
    o, d, seeds = mk.pack_rays(Camera.default(CPU), cfg)
    tri = mk.scene_table(scene)
    before = mk.mega_call.launches
    got = mk.mega_call(o, d, seeds, tri, cfg)
    assert mk.mega_call.launches == before        # no kernel was launched
    assert got.shape == (32, 3)
    assert torch.equal(got, mk.megakernel_plain(o, d, seeds, tri, cfg))


def test_mega_call_rejects_bad_inputs():
    scene = _port_scene(j_default_scene())
    cfg = RenderConfig(width=8, height=4, spp=1)
    o, d, seeds = mk.pack_rays(Camera.default(CPU), cfg)
    tri = mk.scene_table(scene)
    big = mk.scene_table(_port_scene(j_procedural(mk.MAX_TRIS + 1)))
    bad = [
        (o.double(), d, seeds, tri, cfg),
        (o, d[:-1], seeds, tri, cfg),
        (o.T.contiguous(), d, seeds, tri, cfg),
        (o, d, seeds.int(), tri, cfg),
        (o, d, seeds[:-1], tri, cfg),
        (o, d, seeds, torch.cat([tri, tri[:, :6]], 1), cfg),
        (o, d, seeds, tri[:0], cfg),
        (o, d, seeds, big, cfg),
        (o.T.contiguous().T, d, seeds, tri, cfg),   # not contiguous
        (o, d, seeds, tri, cfg.replace(spp=0)),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            mk.mega_call(*args)
    with pytest.raises(NotImplementedError):
        mk.mega_call(o, d, seeds, tri, cfg.replace(rng="hash"))


def test_build_flags_and_rebuild_hash(tmp_path, monkeypatch):
    cmd = build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in cmd and "-fmad=false" in cmd
    assert not any("fast_math" in f or "fast-math" in f for f in cmd)
    assert [p.name for p in build.sources()] == [
        "bigscene.cu", "bigscene_grad.cu", "bigscene_quality.cu",
        "bigscene_quality_grad.cu", "intersect.cu", "light_cdf.cu",
        "megakernel.cu", "megakernel_grad.cu", "megakernel_quality.cu",
        "megakernel_quality_grad.cu", "stream_scatter.cu", "sweep_mm.cu",
        "threefry.cu"]
    assert [p.name for p in build.hashed_files()] == [
        "bigscene.cu", "bigscene_grad.cu", "bigscene_quality.cu",
        "bigscene_quality_grad.cu", "intersect.cu", "light_cdf.cu",
        "megakernel.cu", "megakernel_common.cuh", "megakernel_grad.cu",
        "megakernel_lanes.cuh", "megakernel_quality.cu",
        "megakernel_quality_grad.cu", "pixel_source.cuh",
        "quality_lanes.cuh", "quality_queue.cuh", "quality_reverse.cuh",
        "quality_walk.cuh",
        "stream_scatter.cu", "stream_sweep.cuh", "sweep_mm.cu",
        "threefry.cu"]
    assert build.LIBRARY.parent.parts[-2:] == ("build", "kernels")
    monkeypatch.setattr(build, "SOURCE_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "k.cuh"\n')
    (tmp_path / "k.cuh").write_text("// one\n")
    (tmp_path / "notes.txt").write_text("not a source\n")
    h1 = build.source_hash()
    (tmp_path / "notes.txt").write_text("edited\n")
    assert build.source_hash() == h1
    (tmp_path / "k.cuh").write_text("// two\n")       # a header edit
    h2 = build.source_hash()
    assert h2 != h1
    (tmp_path / "k.h").write_text("// three\n")       # a new header
    h3 = build.source_hash()
    assert h3 != h2
    (tmp_path / "k.cu").write_text("// four\n")
    assert build.source_hash() not in (h1, h2, h3)
    assert [p.name for p in build.sources()] == ["k.cu"]


@pytest.mark.parametrize("source, replaces, entry", [
    ("megakernel.cu", "spath_tpu/ops/pallas/megakernel.py::_megakernel",
     "spath_megakernel_forward"),
    ("megakernel_grad.cu",
     "spath_tpu/ops/pallas/megakernel_grad.py::_mega_bwd_kernel",
     "spath_megakernel_backward"),
    ("megakernel_quality.cu",
     "spath_tpu/ops/pallas/megakernel_quality.py::_quality_kernel",
     "spath_quality_forward"),
    ("megakernel_quality_grad.cu",
     "spath_tpu/ops/pallas/megakernel_quality_grad.py::_qbwd_kernel",
     "spath_quality_backward"),
])
def test_kernel_source_names_what_it_replaces(source, replaces, entry):
    """Each source names its TPU kernel and entry point, and the walk it
    shares with its twin: K1/K2 the conformance header, K3/K4 the quality
    walk (which includes the conformance header's sweeps)."""
    src = (build.SOURCE_DIR / source).read_text()
    assert replaces in src
    assert f'extern "C" int {entry}(' in src
    header = "quality_walk.cuh" if "quality" in source \
        else "megakernel_common.cuh"
    assert f'#include "{header}"' in src


def test_light_cdf_source_names_what_it_computes():
    """The light distribution kernel names the JAX function whose columns
    it builds, its entry point, and the order it sums in."""
    src = (build.SOURCE_DIR / "light_cdf.cu").read_text()
    assert "spath_tpu/ops/nee.py::light_cdf" in src
    assert 'extern "C" int spath_light_cdf(' in src
    assert "blocks of 16" in src and "-fmad=false" in src


# ---- K1's lane loop: its grid, and the schedules counted by hand ----


def test_k1_grid_is_persistent_on_its_own_occupancy(monkeypatch):
    """K1's grid: its own resident CTAs (``QUEUE_KERNELS["K1"]``) times the
    SMs, asked once a device, unless the rays fill fewer CTAs; and
    ``mega_call`` sizes its launch by K1's entry, no other kernel's."""
    import contextlib
    import inspect
    import types

    from spath_tpu_torch.ops.kernels import bigscene as bs

    asked = []

    class Lib:
        def spath_megakernel_forward_occupancy(self):
            asked.append("K1")
            return 9

    monkeypatch.setattr(bs, "library", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda index: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda index: types.SimpleNamespace(
                            multi_processor_count=132))
    bs.resident_ctas.cache_clear()
    try:
        cuda = torch.device("cuda", 0)
        assert bs.queue_grid(1920 * 1080, cuda, "K1") == 9 * 132
        assert bs.queue_grid(300, cuda, "K1") == 3
        assert asked == ["K1"]
    finally:
        bs.resident_ctas.cache_clear()
    src = inspect.getsource(mk.mega_call)
    assert 'queue_grid(' in src and '"K1")' in src
    for other in set(bs.QUEUE_KERNELS) - {"K1"}:
        assert f'"{other}")' not in src


def _conformance_totals():
    """Four pixels of 2 samples at 3 bounces, as ``mg.walk_totals`` gives
    them: (hits of sample 0, sample 1) (2, 1), (1, 3), (0, 0) (its camera
    ray missed) and (3, 2); a sample sweeps once after each hit but the
    last bounce's, so (2, 1), (1, 2), (0, 0) and (2, 2) times."""
    hits = np.array([[0, 2, 1], [0, 1, 3], [0, 0, 0], [0, 3, 2]])
    sweeps = np.array([[1, 2, 1], [1, 1, 2], [1, 0, 0], [1, 2, 2]])
    return sweeps, hits


def test_conformance_schedules_counted_by_hand():
    """One warp of two lanes on one run of the 4 pixels. Lane 0 runs pixel
    0 (steps 0-3) and pixel 2 (step 4), lane 1 pixel 1 (0-3) and pixel 3
    (4-8): 9 forward steps, against lockstep's (1 + 2 + 2) + (1 + 2 + 2).
    Samples end (lane, step, records): (1, 1, 1), (0, 2, 2), (0, 3, 1),
    (1, 3, 3), (1, 6, 3), (1, 8, 2). In the lane as each ends: 1 + 2 + 3 +
    3 + 2 reverse steps; epochs of 3 steps: 2 + 3 + 5; of 9: 9. Lockstep
    reverses each sample as long as its warp's longest: (2 + 3) + (3 +
    2)."""
    sweeps, hits = _conformance_totals()
    got = mg.reverse_counts(sweeps, hits, run=4, warps=1, epochs=(3, 9),
                            lanes=2)
    assert got == dict(forward_steps=9, in_lane=11, epochs={3: 10, 9: 9},
                       records=12, lockstep=dict(forward_steps=10,
                                                 reverse_steps=10))
    # the forward steps are K1's: the runs schedule of K3's count
    from spath_tpu_torch.ops.kernels import bigscene as bs

    assert bs.run_schedule(sweeps, 4, 1, lanes=2)["warp_steps"] == 9
    assert bs.lane_schedules(sweeps, 2)["lockstep"]["cta_sweeps"] == 10


def test_walk_totals_count_the_replays_sweeps_and_hits():
    """``walk_totals`` on a 16x8 frame of 3 samples: a camera sweep a
    pixel, a hit at each bounce a path enters alive, a sweep after every
    hit but the last bounce's; the pixels whose camera ray missed have
    neither."""
    cfg = RenderConfig(width=16, height=8, spp=3, max_bounces=4)
    o, d, seeds = mk.pack_rays(Camera.default(CPU), cfg)
    tri = mk.scene_table(_port_scene(j_default_scene()))
    sweeps, hits = mg.walk_totals(o, d, seeds, tri, cfg)
    assert sweeps.shape == hits.shape == (128, 4)
    assert (sweeps[:, 0] == 1).all() and (hits[:, 0] == 0).all()
    assert np.array_equal(sweeps[:, 1:], np.minimum(hits[:, 1:], 3))
    want = np.zeros((128, 3), dtype=np.int64)
    for s, saved in enumerate(mg.replay(o, d, seeds, tri, cfg)):
        for hit, *_ in saved:
            want[:, s] += hit.numpy()
    assert np.array_equal(hits[:, 1:], want)
    missed = (hits[:, 1:] == 0).all(axis=1)
    assert 0 < missed.sum() < 128
    assert (sweeps[missed, 1:] == 0).all()
