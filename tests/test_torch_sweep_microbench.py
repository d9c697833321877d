"""T1, the matmul-only sweep (``spath_tpu_torch/ops/kernels/sweep_mm.py``),
and its tool on the CPU: the port's operands bit-equal to
``intersect_pallas``'s and to ``tools/sweep_microbench.py``'s K = 64
selection, the plain version against the tool's two Pallas kernels run
in interpret mode with the tool's own BlockSpecs, the wrapper's routing
and input checks, and ``python -m spath_tpu_torch.tools.sweep_microbench
--device cpu``. The CUDA kernel runs on the card (``chip_smoke.py`` phase
42), held to the same bound at 230,400 rays x 65,536 triangles.
"""

import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from spath_tpu.camera import Camera as JCamera  # noqa: E402
from spath_tpu.camera import generate_rays as j_generate_rays  # noqa: E402
from spath_tpu.ops.pallas import intersect_pallas as IP  # noqa: E402
from spath_tpu.scene import procedural_scene as j_procedural  # noqa: E402
from spath_tpu_torch.ops.kernels import sweep_mm as sm  # noqa: E402
from spath_tpu_torch.tools import sweep_microbench as tool  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TILE_N, TILE_T, NBLK = IP.TILE_N, IP.TILE_T, IP._NBLK


def _jax_tool():
    """``tools/sweep_microbench.py``, loaded by its path (``tools`` is not
    a package)."""
    spec = importlib.util.spec_from_file_location(
        "jax_sweep_microbench", ROOT / "tools" / "sweep_microbench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_k64(gfeat, rfeat):
    """The tool's K = 64 operands (``sweep_microbench.py:140-147``):
    ``(64, 4T)`` and ``(64, N)``, both K-major."""
    tp, np_ = gfeat.shape[0] // 4, rfeat.shape[1]
    g3 = gfeat.reshape(tp * 4, 8, 16)[:, :6, :10]
    gT = g3.reshape(tp * 4, 60).T
    gT = jnp.concatenate([gT, jnp.zeros((4, tp * 4), gT.dtype)], axis=0)
    r3 = rfeat.reshape(8, 16, np_)[:6, :10, :]
    rT = r3.reshape(60, np_)
    rT = jnp.concatenate([rT, jnp.zeros((4, np_), rT.dtype)], axis=0)
    return gT, rT


def _jax_t1(kernel, gfeat, rfeat, k64: bool):
    """One of the tool's Pallas kernels in interpret mode, with the
    tool's grid and BlockSpecs (``sweep_microbench.py:118-160``)."""
    np_ = rfeat.shape[1]
    tp = (gfeat.shape[1] if k64 else gfeat.shape[0]) // 4
    grid = (np_ // TILE_N, tp // (TILE_T * NBLK))
    if k64:
        in_specs = [pl.BlockSpec((64, 4 * TILE_T * NBLK), lambda i, j: (0, j),
                                 memory_space=pltpu.VMEM),
                    pl.BlockSpec((64, TILE_N), lambda i, j: (0, i),
                                 memory_space=pltpu.VMEM)]
    else:
        in_specs = [pl.BlockSpec((4 * TILE_T * NBLK, IP._KP),
                                 lambda i, j: (j, 0), memory_space=pltpu.VMEM),
                    pl.BlockSpec((IP._KP, TILE_N), lambda i, j: (0, i),
                                 memory_space=pltpu.VMEM)]
    call = pl.pallas_call(
        kernel, grid=grid, in_specs=in_specs,
        out_specs=[pl.BlockSpec((1, TILE_N), lambda i, j: (0, i),
                                memory_space=pltpu.VMEM)],
        out_shape=[jax.ShapeDtypeStruct((1, np_), jnp.float32)],
        interpret=True)
    return np.asarray(call(gfeat, rfeat)[0])[0]


def _u16(x):
    """The 16-bit patterns of a bf16 array or tensor."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def _inputs(n_tris):
    """``procedural_scene(n_tris, seed=0)`` and 32x32 default-camera rays
    from the JAX package, as numpy."""
    scene = j_procedural(n_tris, seed=0)
    o, d = j_generate_rays(JCamera.default(), 32, 32)
    return (np.asarray(o), np.asarray(d),
            [np.asarray(v) for v in (scene.v0, scene.v1, scene.v2)])


@pytest.fixture(scope="module")
def case():
    """Both packages' operands on ``procedural_scene(2048)`` and 32x32
    rays, and the tool's two kernels in interpret mode at 1,024 rays x
    1,024 and x 2,048 triangles (two grid steps of the revisited
    accumulator), computed once."""
    mod = _jax_tool()
    o, d, v = _inputs(2048)
    jo, jd, jv = jnp.asarray(o), jnp.asarray(d), [jnp.asarray(x) for x in v]
    rows = IP._ray_rows(jo, jd)
    tri = IP._tri_features(*jv)
    jax_ops = dict(ray_rows=rows, split3=IP._split3(rows),
                   pack_lhs=IP.pack_lhs(rows, False, axis=0),
                   pack_rhs=IP.pack_rhs(tri[1], axis=0),
                   tri_features=tri,
                   pack_tri_blocks=IP.pack_tri_blocks(*jv, TILE_T))
    jax_ops["pack_k64"] = _jax_k64(jax_ops["pack_tri_blocks"],
                                   jax_ops["pack_lhs"])
    to, td = torch.from_numpy(o.copy()), torch.from_numpy(d.copy())
    tv = [torch.from_numpy(x.copy()) for x in v]
    t_rows = sm._ray_rows(to, td)
    t_tri = sm._tri_features(*tv)
    g128, r128 = sm.sweep_operands(to, td, *tv)
    port_ops = dict(ray_rows=t_rows, split3=sm._split3(t_rows),
                    pack_lhs=sm.pack_lhs(t_rows, axis=0),
                    pack_rhs=sm.pack_rhs(t_tri[1], axis=0),
                    tri_features=t_tri, pack_tri_blocks=g128,
                    pack_k64=sm.pack_k64(g128, r128))
    runs = {}
    for n_tris in (1024, 2048):
        rows_j = 4 * n_tris
        g, r = jax_ops["pack_tri_blocks"][:rows_j], jax_ops["pack_lhs"]
        gT, rT = _jax_k64(g, r)
        runs[128, n_tris] = _jax_t1(mod._mm_only_kernel, g, r, False)
        runs[64, n_tris] = _jax_t1(mod._mm_sub64_kernel, gT, rT, True)
    return dict(jax=jax_ops, port=port_ops, runs=runs, g128=g128,
                r128=r128)


@pytest.mark.parametrize("name", ["ray_rows", "split3", "pack_lhs",
                                  "pack_rhs", "tri_features",
                                  "pack_tri_blocks", "pack_k64"])
def test_operands_bit_equal_to_jax(case, name):
    """Each operand step of the port equals JAX's to the bit (bf16 through
    its 16-bit patterns), the K = 64 pair as the transpose of the tool's
    K-major operands."""
    want, got = case["jax"][name], case["port"][name]
    if name == "pack_k64":
        want = (np.asarray(want[0]).T, want[1])
    if not isinstance(got, tuple):
        want, got = (want,), (got,)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        if g.dtype == torch.bfloat16:
            np.testing.assert_array_equal(_u16(g), _u16(w))
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_split3_is_exact(case):
    """hi + mid + lo == x in float32, on the ray rows and on every
    triangle feature row."""
    for x in (case["port"]["ray_rows"], *case["port"]["tri_features"]):
        hi, mid, lo = sm._split3(x)
        assert torch.equal(hi.float() + mid.float() + lo.float(), x)


@pytest.mark.parametrize("k", [128, 64])
@pytest.mark.parametrize("n_tris", [1024, 2048])
def test_plain_matches_jax_kernels(case, k, n_tris):
    """The plain version (float64) against ``_mm_only_kernel`` (K = 128)
    and ``_mm_sub64_kernel`` (K = 64) in interpret mode, for every ray
    within ``2^-16 · (sum_b max_r sum_k |G||R| + |ref|)``: the bf16
    products are exact, only the order of the float32 sums differs; and
    within ``TIGHT_SHARE`` of that bound, which the lo-dropping control
    below exceeds. The largest share of the bound seen here was 9.1e-3
    (K = 64, 1,024 triangles)."""
    g, r = case["g128"][:4 * n_tris], case["r128"]
    if k == 64:
        g, r = sm.pack_k64(g, r)
    ref = sm.sweep_mm_plain(g, r)
    scale = sm.sweep_mm_scale(g, r)
    assert ref.shape == (1024,) and torch.isfinite(ref).all()
    assert np.abs(ref.numpy()).max() > 1.0              # not vacuous
    share = sm.error_ratio(torch.tensor(case["runs"][k, n_tris]), ref, scale)
    assert share <= sm.TIGHT_SHARE, share


@pytest.mark.parametrize("k", [128, 64])
@pytest.mark.parametrize("n_tris", [1024, 2048])
def test_lo_drop_control_fails_the_check(case, k, n_tris):
    """The check can see a lower-precision product: the plain version of
    the operands without the split's lo-term groups (``drop_lo``) is off
    by more than ``TIGHT_SHARE`` of the bound (0.15-0.18 here), while the
    Pallas kernels stay below it."""
    g, r = case["g128"][:4 * n_tris], case["r128"]
    if k == 64:
        g, r = sm.pack_k64(g, r)
    ref = sm.sweep_mm_plain(g, r)
    scale = sm.sweep_mm_scale(g, r)
    gl, rl = sm.drop_lo(g, r)
    width = 16 if k == 128 else 10          # the hh, hm, mh groups stay
    assert torch.equal(gl[:, :3 * width], g[:, :3 * width])
    assert torch.equal(rl[:3 * width], r[:3 * width])
    share = sm.error_ratio(sm.sweep_mm_plain(gl, rl), ref, scale)
    assert sm.TIGHT_SHARE < share <= 1.0, share


def test_variants_agree(case):
    """The two depths compute one function: the K = 64 operands only drop
    zero columns, so the float64 plain outputs agree to float32."""
    g, r = case["g128"], case["r128"]
    a, b = sm.sweep_mm_plain(g, r), sm.sweep_mm_plain(*sm.pack_k64(g, r))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2**-23, atol=0)


def test_call_on_cpu_takes_plain_without_counting(case):
    g, r = sm.pack_k64(case["g128"][:4096], case["r128"][:, :300].contiguous())
    before = sm.sweep_mm_call.launches
    got = sm.sweep_mm_call(g, r)
    assert sm.sweep_mm_call.launches == before
    assert got.dtype == torch.float32 and got.shape == (300,)
    assert torch.equal(got, sm.sweep_mm_plain(g, r))


@pytest.mark.parametrize("bad", ["dtype", "depth", "mismatch", "rows",
                                 "empty", "rank", "strided", "device"])
def test_call_checks_inputs(bad):
    g = torch.zeros((2048, 64), dtype=torch.bfloat16)
    r = torch.zeros((64, 40), dtype=torch.bfloat16)
    if bad == "dtype":
        g = g.float()
    elif bad == "depth":
        g, r = g[:, :32].contiguous(), r[:32].contiguous()
    elif bad == "mismatch":
        r = torch.zeros((128, 40), dtype=torch.bfloat16)
    elif bad == "rows":
        g = g[:1536]
    elif bad == "empty":
        r = r[:, :0].contiguous()
    elif bad == "rank":
        r = r[None]
    elif bad == "strided":
        r = torch.zeros((64, 80), dtype=torch.bfloat16)[:, ::2]
    else:
        g, r = g.to("meta"), r.to("meta")
    with pytest.raises(ValueError):
        sm.sweep_mm_call(g, r)


def test_kernel_source_names_what_it_replaces():
    """``csrc/sweep_mm.cu`` names both TPU kernels, runs on the bf16 tensor
    cores (warpgroup ``wgmma`` fed by TMA, no ``mma.sync``), and has one
    entry point a depth, which the loader declares."""
    from spath_tpu_torch.ops.kernels import build

    src = (build.SOURCE_DIR / "sweep_mm.cu").read_text()
    assert "_mm_only_kernel" in src and "_mm_sub64_kernel" in src
    assert (f"wgmma.mma_async.sync.aligned.m64n{sm.WG_RAYS}k16.f32.bf16.bf16"
            in src)
    assert "cp.async.bulk.tensor.2d" in src
    assert "mma.sync.aligned" not in src
    for k in sm.DEPTHS:
        assert f'extern "C" int spath_sweep_mm_k{k}(' in src
        assert f"spath_sweep_mm_k{{k}}" in Path(build.__file__).read_text()
    assert 'extern "C" int spath_sweep_mm_plan(' in src
    assert "spath_sweep_mm_plan" in Path(build.__file__).read_text()


def _source_constant(src, name):
    m = re.search(rf"constexpr int {name} = ([^;]+);", src)
    assert m, name
    return m[1]


def test_launch_plan_mirrors_the_source():
    """``launch_plan``'s shared-memory alignment and limit are the
    kernel's, which its ``static_assert`` holds the shared bytes to. The
    rest of the plan (rays, threads, stages, shared bytes) is held to the
    compiled one, ``spath_sweep_mm_plan``, on the card in
    ``chip_smoke.py`` phase 42."""
    from spath_tpu_torch.ops.kernels import build

    src = (build.SOURCE_DIR / "sweep_mm.cu").read_text()
    assert int(_source_constant(src, "kAlign")) == sm.SMEM_ALIGN
    assert int(_source_constant(src, "kSmemLimit")) == sm.SMEM_LIMIT
    assert "static_assert(kSmemBytes <= kSmemLimit" in src


@pytest.mark.parametrize("k", [64, 128])
@pytest.mark.parametrize("n_rays", [1, 255, 257, 447, 448, 449, 1349,
                                    230400])
def test_launch_plan(k, n_rays):
    """The launch covers every ray with whole CTAs of 448 (four
    warpgroups of 112), no cluster, and fits the H100's 227 KB of shared memory a
    block: the rays' K-major copy, the ring of stages, the block-end
    exchange and the barriers, after the 1024-byte alignment."""
    p = sm.launch_plan(k, n_rays, 65536)
    assert p["cta_rays"] == 4 * p["wg_rays"] == 448
    assert p["threads"] == 640 and p["cluster"] == 1
    assert (p["ctas"] - 1) * p["cta_rays"] < n_rays <= p["ctas"] * p[
        "cta_rays"]
    assert p["stage_bytes"] == 64 * k * 2
    assert p["ray_bytes"] == 448 * k * 2
    assert p["smem_bytes"] == (1024 + p["ray_bytes"] + p["stages"]
                               * p["stage_bytes"] + p["xch_bytes"]
                               + p["bar_bytes"])
    assert p["smem_bytes"] <= sm.SMEM_LIMIT == 227 * 1024
    assert p["stages"] >= 4
    assert p["waves"] == pytest.approx(p["ctas"] / 132)
    assert sm.launch_plan(k, n_rays, sms=114)["waves"] == pytest.approx(
        p["ctas"] / 114)
    assert p["l2_bytes_of_g"] == p["ctas"] * 4 * 65536 * k * 2
    if n_rays == 230400:
        # the tool's shape: 515 CTAs, 3.90 waves; G read 34.6 / 17.3 GB
        assert p["ctas"] == 515
        assert p["l2_bytes_of_g"] / 1e9 == pytest.approx(
            34.561 if k == 128 else 17.281, abs=1e-3)


def test_launch_plan_refuses_other_depths():
    with pytest.raises(ValueError):
        sm.launch_plan(32, 100)
    with pytest.raises(ValueError):
        sm.launch_plan(64, 0)


def test_tool_lines_name_the_instruction():
    """The tool's T1 lines name ``wgmma`` (and TMA), not ``mma.sync``."""
    ops = tool.operands(16, 16, 512, torch.device("cpu"))
    names = {line["key"]: line["name"] for line in tool.lines(ops)}
    for k in sm.DEPTHS:
        assert "(wgmma bf16, TMA)" in names[f"T1 K={k}"]
        assert "mma.sync" not in names[f"T1 K={k}"]


def test_bound_reckoning():
    """The tool's shape: 60-term bf16 FLOP over 989 TFLOP/s (7.33 ms), the
    variants' own ceilings (15.6 and 7.8 ms) and operand bytes (127 and
    64 MB)."""
    b64, b128 = sm.bound(230400, 65536, 64), sm.bound(230400, 65536, 128)
    assert b64["by"] == b128["by"] == "operations"
    assert b64["ms"] == b128["ms"] == pytest.approx(7.3284, abs=1e-4)
    assert b128["ceiling_ms"] == pytest.approx(15.634, abs=1e-3)
    assert b64["ceiling_ms"] == pytest.approx(7.817, abs=1e-3)
    assert b128["bytes"] == pytest.approx(127.0e6, rel=1e-3)
    assert b64["bytes"] == pytest.approx(64.0e6, rel=1e-3)


def test_tool_rehearses_on_the_cpu():
    """``python -m spath_tpu_torch.tools.sweep_microbench --device cpu``
    at a tiny size runs the plain versions, names the CPU and times
    nothing; the K = 128 and K = 64 outputs agree."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "spath_tpu_torch.tools.sweep_microbench",
         "--device", "cpu", "--width", "16", "--height", "16", "--tris",
         "512"], capture_output=True, text=True, cwd=ROOT, env=env,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "ran on the CPU" in proc.stdout
    assert " ms" not in proc.stdout and "TFLOP/s" not in proc.stdout


def test_tool_without_a_card_exits_nonzero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        tool.run(["--width", "16", "--height", "16", "--tris", "512"])
    assert exc.value.code not in (0, None)
