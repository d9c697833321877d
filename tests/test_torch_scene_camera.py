"""The port's config, scene, camera, conversion and image IO against the
JAX package, on the same numpy inputs."""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from spath_tpu import config as jconfig  # noqa: E402
from spath_tpu.camera import Camera as JCamera  # noqa: E402
from spath_tpu.camera import generate_rays as j_generate_rays  # noqa: E402
from spath_tpu.scene import default_scene as j_default_scene  # noqa: E402
from spath_tpu.scene import procedural_scene as j_procedural  # noqa: E402
from spath_tpu.utils.image import to_rgb_u8 as j_to_rgb_u8  # noqa: E402
from spath_tpu_torch import config as tconfig  # noqa: E402
from spath_tpu_torch.camera import generate_rays  # noqa: E402
from spath_tpu_torch.convert import (  # noqa: E402
    camera_from_numpy, camera_to_numpy, scene_from_numpy, scene_to_numpy,
)
from spath_tpu_torch.scene import default_scene, procedural_scene  # noqa: E402
from spath_tpu_torch.utils.image import (  # noqa: E402
    read_png, to_rgb_u8, write_png,
)

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]


def test_render_config_fields_and_defaults_match():
    jf = {f.name: f.default for f in dataclasses.fields(jconfig.RenderConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tconfig.RenderConfig)}
    assert tf == jf
    assert (tconfig.EPSILON, tconfig.MAX_DIST) == (jconfig.EPSILON,
                                                   jconfig.MAX_DIST)
    assert dataclasses.asdict(tconfig.CONFORMANCE) == dataclasses.asdict(
        jconfig.CONFORMANCE)
    cfg = tconfig.RenderConfig(width=8, height=4)
    assert cfg.n_pixels == 32 and cfg.replace(spp=3).spp == 3


@pytest.mark.parametrize("which", ["default", "procedural40"])
def test_scene_arrays_match(which):
    if which == "default":
        js, ts = j_default_scene(), default_scene(CPU)
    else:
        js, ts = j_procedural(40, seed=3), procedural_scene(40, seed=3,
                                                            device=CPU)
    for name in ("vertices", "albedo", "emission"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
        assert getattr(ts, name).dtype == torch.float32
    assert ts.light_idx == js.light_idx
    assert ts.n_tris == js.n_tris
    # unit normals: same op order, 1 ulp allowed for XLA's sqrt/divide
    np.testing.assert_allclose(ts.normals().numpy(),
                               np.asarray(js.normals()),
                               rtol=2 ** -22, atol=1e-7)


def test_zero_area_triangle_normal_is_finite():
    verts = np.zeros((1, 3, 3), np.float32)
    scene = scene_from_numpy(verts, np.ones((1, 3)), np.zeros((1, 3)),
                             device=CPU)
    assert torch.equal(scene.normals(), torch.zeros(1, 3))


def _j_camera(pos, angle, focal):
    return JCamera(pos=jnp.asarray(pos, jnp.float32),
                   angle=jnp.asarray(angle, jnp.float32),
                   focal=jnp.float32(focal))


@pytest.mark.parametrize("pose", [
    ((0.0, 0.0, -3.0), (0.0, 0.0, 0.0), 2.0),       # default camera
    ((0.3, 0.1, -2.0), (0.1, -0.2, 0.0), 1.5),      # moved and rotated
    ((0.0, 0.0, -3.0), (0.4, 0.7, 0.0), 2.0),       # rotated
])
def test_generate_rays_matches(pose):
    pos, angle, focal = pose
    w, h = 24, 16
    jo, jd = (np.asarray(a) for a in j_generate_rays(
        _j_camera(pos, angle, focal), w, h))
    to, td = generate_rays(camera_from_numpy(pos, angle, focal, device=CPU),
                           w, h)
    if angle == (0.0, 0.0, 0.0):
        # no rotation: bit-exact
        np.testing.assert_array_equal(to.numpy(), jo)
        np.testing.assert_array_equal(td.numpy(), jd)
    else:
        # cos/sin of the angles come from two libraries and differ in the
        # last bit on some angles: within 2 ulp of each vector's largest
        # component (a component near 0 carries the cancellation error)
        for got, want in ((to.numpy(), jo), (td.numpy(), jd)):
            ulp = np.spacing(np.abs(want).max(axis=-1, keepdims=True))
            assert (np.abs(got - want) <= 2 * ulp).all(), \
                np.max(np.abs(got - want) / ulp)


def test_convert_round_trip():
    js = j_procedural(12, seed=4)
    arrays = tuple(np.asarray(a) for a in (js.vertices, js.albedo,
                                           js.emission))
    scene = scene_from_numpy(*arrays, light_idx=js.light_idx, device=CPU)
    for got, want in zip(scene_to_numpy(scene), arrays):
        np.testing.assert_array_equal(got, want)
    assert scene.light_idx == js.light_idx
    cam = camera_from_numpy([0.1, 0.2, -2.5], [0.05, -0.1, 0.0], 1.75,
                            device=CPU)
    pos, angle, focal = camera_to_numpy(cam)
    np.testing.assert_array_equal(pos, np.float32([0.1, 0.2, -2.5]))
    np.testing.assert_array_equal(angle, np.float32([0.05, -0.1, 0.0]))
    assert focal == np.float32(1.75) and focal.shape == ()


def test_image_tonemap_and_png_round_trip(tmp_path):
    rng = np.random.Generator(np.random.Philox(7))
    img = rng.uniform(-0.2, 1.3, size=(5, 7, 3)).astype(np.float32)
    u8 = to_rgb_u8(img)
    np.testing.assert_array_equal(u8, j_to_rgb_u8(img))
    path = str(tmp_path / "x.png")
    write_png(path, img)
    np.testing.assert_array_equal(read_png(path), u8)


def test_port_imports_no_jax():
    """The port runs where JAX does not exist: no module of it and not
    chip_smoke.py imports jax or the JAX package."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|spath_tpu)(\.|\s|$)",
                         re.MULTILINE)
    files = sorted((ROOT / "spath_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []
