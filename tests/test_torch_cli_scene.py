"""The port's scene import and export (``spath_tpu_torch/scene_io.py``)
against the JAX package's ``spath_tpu.scene_io`` on the same text, and
the CLI's ``--scene``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spath_tpu import scene_io as j_io  # noqa: E402
from spath_tpu_torch import cli, scene_io  # noqa: E402
from spath_tpu_torch.scene import procedural_scene  # noqa: E402
from spath_tpu_torch.utils.image import read_png  # noqa: E402

CPU = torch.device("cpu")

#: A quad (fan-split into two triangles) and a triangle given by negative
#: (relative) indices and v/vt/vn tokens, with materials from an MTL.
OBJ = """# two materials
mtllib scene.mtl
v -1 -1 1
v 1 -1 1
v 1 1 1
v -1 1 1
usemtl wall
f 1 2 3 4
v 0 0.75 0.5
v 0.5 0.75 0
v -0.5 0.75 0
usemtl light
f -3/1/1 -2/2/1 -1/3/1
"""
MTL = """newmtl wall
Kd 0.8 0.7 0.6
newmtl light
Kd 1 1 1
Ke 4 4 3.5
"""
#: A PLY with per-face colours, an extra element, and faces listed
#: before the vertices.
PLY = """ply
format ascii 1.0
element face 2
property list uchar int vertex_indices
property uchar red
property uchar green
property uchar blue
element edge 1
property int vertex1
property int vertex2
element vertex 5
property float x
property float y
property float z
end_header
4 0 1 2 3 255 128 0
3 1 2 4 10 20 30
0 1
-1 -1 1
1 -1 1
1 1 1
-1 1 1
0 2 1
"""


def _arrays(scene):
    return [np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach")
                       else t) for t in (scene.vertices, scene.albedo,
                                         scene.emission)]


def _same(port, jax_scene):
    for got, want in zip(_arrays(port), _arrays(jax_scene)):
        np.testing.assert_array_equal(got, want)
    assert port.light_idx == tuple(jax_scene.light_idx)


@pytest.mark.parametrize("with_mtl", [True, False])
def test_loads_obj_matches_jax(tmp_path, with_mtl):
    """With the MTL beside it the colours come from Kd/Ke; without it
    every face takes the default material, as in JAX."""
    if with_mtl:
        (tmp_path / "scene.mtl").write_text(MTL)
    port = scene_io.loads_obj(OBJ, mtl_dir=str(tmp_path), device=CPU)
    _same(port, j_io.loads_obj(OBJ, mtl_dir=str(tmp_path)))
    assert port.n_tris == 3
    if with_mtl:
        assert port.light_idx == (2,)


def test_loads_ply_matches_jax():
    port = scene_io.loads_ply(PLY, device=CPU)
    _same(port, j_io.loads_ply(PLY))
    assert port.n_tris == 3


def test_loaders_refuse_what_jax_refuses():
    for text in ("v 0 0 0\n", "v 0 0 0\nf 1 2 3\n"):
        with pytest.raises(ValueError):
            scene_io.loads_obj(text, device=CPU)
    with pytest.raises(ValueError):
        scene_io.loads_ply("not a ply\n", device=CPU)
    with pytest.raises(ValueError):
        scene_io.load_scene("mesh.stl", device=CPU)


def test_save_obj_round_trips(tmp_path):
    scene = procedural_scene(40, seed=3, emissive_fraction=0.2, device=CPU)
    path = tmp_path / "out.obj"
    scene_io.save_obj(scene, str(path))
    back = scene_io.load_scene(str(path), device=CPU)
    for got, want in zip(_arrays(back), _arrays(scene)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert back.light_idx == scene.light_idx
    j_back = j_io.load_obj(str(path))
    _same(back, j_back)


def test_cli_render_procedural_scene_writes_png(tmp_path):
    out = tmp_path / "p.png"
    assert cli.main(["render", "--scene", "procedural:40:3", "--device",
                     "cpu", "--size", "16x8", "--spp", "2", "--out",
                     str(out)]) == 0
    assert read_png(str(out)).shape == (8, 16, 3)


def test_cli_render_mesh_scene(tmp_path):
    (tmp_path / "scene.mtl").write_text(MTL)
    mesh = tmp_path / "scene.obj"
    mesh.write_text(OBJ)
    out = tmp_path / "m.png"
    assert cli.main(["render", "--scene", str(mesh), "--device", "cpu",
                     "--size", "16x8", "--spp", "1", "--flat", "--out",
                     str(out)]) == 0
    assert read_png(str(out)).max() > 0


@pytest.mark.parametrize("spec", ["bogus", "procedural:", "procedural:x",
                                  "mesh.stl"])
def test_cli_unknown_scene_exits_nonzero(tmp_path, spec):
    out = tmp_path / "x.png"
    for command in (["render", "--out", str(out)], ["invert", "--steps",
                                                     "1"]):
        with pytest.raises(SystemExit) as exc:
            cli.main(command + ["--scene", spec, "--device", "cpu",
                                "--size", "8x4", "--spp", "1"])
        assert exc.value.code not in (0, None)
    assert not out.exists()


def test_cli_invert_on_a_procedural_scene(capsys):
    assert cli.main(["invert", "--scene", "procedural:60:1", "--device",
                     "cpu", "--size", "16x8", "--spp", "1", "--steps",
                     "2"]) == 0
    assert "albedo error" in capsys.readouterr().out
