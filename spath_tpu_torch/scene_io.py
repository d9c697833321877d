"""Scene import/export: Wavefront OBJ (+MTL) and ASCII PLY.

The reference has no scene IO at all — its one scene is hardcoded C++
(``src/main.cpp:185-232``). These loaders are the offline equivalent:
arbitrary triangle meshes become the same ``Scene`` structure-of-arrays
(vertices/albedo/emission), with materials mapped from MTL ``Kd``
(diffuse reflectance → albedo) and ``Ke`` (emission). Polygons are
fan-triangulated; quads/ngons therefore import exactly like the
reference's hand-split rectangles (floor/light/wall pairs).

Pure NumPy/stdlib — no third-party mesh dependencies. The port's own
copy of ``spath_tpu/scene_io.py``: the same parsing, building a port
``Scene`` on the device the caller names.
"""

from __future__ import annotations

import os

import numpy as np

from spath_tpu_torch.scene import Scene, make_scene

#: Material applied when an OBJ has no MTL / a face has no ``usemtl``.
DEFAULT_ALBEDO = (0.75, 0.75, 0.75)
DEFAULT_EMISSION = (0.0, 0.0, 0.0)


def _parse_mtl(path: str) -> dict[str, tuple[tuple, tuple]]:
    """MTL file → {name: (albedo, emission)}. Unknown keys ignored."""
    mats: dict[str, tuple[tuple, tuple]] = {}
    cur = None
    try:
        lines = open(path, encoding="utf-8", errors="replace").readlines()
    except OSError:
        return mats
    for line in lines:
        parts = line.split()
        if not parts or parts[0].startswith("#"):
            continue
        key = parts[0].lower()
        if key == "newmtl" and len(parts) > 1:
            cur = parts[1]
            mats[cur] = (DEFAULT_ALBEDO, DEFAULT_EMISSION)
        elif cur and key in ("kd", "ke") and len(parts) >= 4:
            rgb = tuple(float(x) for x in parts[1:4])
            alb, emi = mats[cur]
            mats[cur] = (rgb, emi) if key == "kd" else (alb, rgb)
    return mats


def _face_vertex_index(token: str, n_verts: int) -> int:
    """OBJ face token ``v``, ``v/vt``, ``v//vn`` or ``v/vt/vn`` → 0-based
    vertex index (negative indices are relative, per the OBJ spec)."""
    i = int(token.split("/")[0])
    return i - 1 if i > 0 else n_verts + i


def loads_obj(text: str, mtl_dir: str | None = None, *, device) -> Scene:
    """Parse OBJ text into a Scene on ``device`` (fan-triangulating every
    face)."""
    verts: list[list[float]] = []
    tris: list[tuple[int, int, int]] = []
    tri_mat: list[str | None] = []
    mats: dict[str, tuple[tuple, tuple]] = {}
    cur_mat: str | None = None
    for line in text.splitlines():
        parts = line.split()
        if not parts or parts[0].startswith("#"):
            continue
        key = parts[0]
        if key == "v" and len(parts) >= 4:
            verts.append([float(x) for x in parts[1:4]])
        elif key == "f" and len(parts) >= 4:
            idx = [_face_vertex_index(t, len(verts)) for t in parts[1:]]
            for k in range(1, len(idx) - 1):   # fan triangulation
                tris.append((idx[0], idx[k], idx[k + 1]))
                tri_mat.append(cur_mat)
        elif key == "usemtl" and len(parts) > 1:
            cur_mat = parts[1]
        elif key == "mtllib" and len(parts) > 1 and mtl_dir is not None:
            mats.update(_parse_mtl(os.path.join(mtl_dir, parts[1])))
    if not tris:
        raise ValueError("OBJ contains no faces")
    v = np.asarray(verts, np.float32)
    f = np.asarray(tris, np.int64)
    if f.min() < 0 or f.max() >= len(v):
        raise ValueError("OBJ face index out of range")
    vertices = v[f]                                    # (T, 3, 3)
    albedo = np.empty((len(f), 3), np.float32)
    emission = np.empty((len(f), 3), np.float32)
    for t, name in enumerate(tri_mat):
        alb, emi = mats.get(name, (DEFAULT_ALBEDO, DEFAULT_EMISSION))
        albedo[t] = alb
        emission[t] = emi
    return make_scene(vertices, albedo, emission, device)


def load_obj(path: str, *, device) -> Scene:
    """Load a Wavefront OBJ file (with MTL materials if referenced)."""
    text = open(path, encoding="utf-8", errors="replace").read()
    return loads_obj(text, mtl_dir=os.path.dirname(os.path.abspath(path)),
                     device=device)


def save_obj(scene: Scene, path: str) -> None:
    """Export a Scene as OBJ + MTL (one material per distinct
    albedo/emission pair). Round-trips through ``load_obj``."""
    v = scene.vertices.detach().cpu().numpy().reshape(-1, 3)
    alb = scene.albedo.detach().cpu().numpy()
    emi = scene.emission.detach().cpu().numpy()
    keys = [tuple(np.round(np.concatenate([a, e]), 6)) for a, e in
            zip(alb, emi)]
    uniq: dict[tuple, int] = {}
    for k in keys:
        uniq.setdefault(k, len(uniq))
    mtl_path = os.path.splitext(path)[0] + ".mtl"
    with open(mtl_path, "w", encoding="utf-8") as f:
        for k, i in uniq.items():
            f.write(f"newmtl m{i}\n")
            f.write("Kd %.6f %.6f %.6f\n" % k[:3])
            f.write("Ke %.6f %.6f %.6f\n\n" % k[3:])
    with open(path, "w", encoding="utf-8") as f:
        f.write(f"mtllib {os.path.basename(mtl_path)}\n")
        for p in v:
            f.write("v %.9g %.9g %.9g\n" % tuple(p))
        last = None
        for t, k in enumerate(keys):
            if uniq[k] != last:
                last = uniq[k]
                f.write(f"usemtl m{last}\n")
            f.write("f %d %d %d\n" % (3 * t + 1, 3 * t + 2, 3 * t + 3))


def loads_ply(text: str, *, device) -> Scene:
    """Parse ASCII PLY (vertex x/y/z + face vertex lists; optional
    per-face red/green/blue → albedo) into a Scene on ``device``."""
    lines = iter(text.splitlines())
    if next(lines, "").strip() != "ply":
        raise ValueError("not a PLY file")
    n_v = n_f = 0
    elems: list[tuple[str, int]] = []
    props: dict[str, list[str]] = {}
    cur_elem = None
    for line in lines:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            if parts[1] != "ascii":
                raise ValueError("only ascii PLY is supported")
        elif parts[0] == "element":
            cur_elem = parts[1]
            elems.append((parts[1], int(parts[2])))
            props[cur_elem] = []
        elif parts[0] == "property" and cur_elem:
            props[cur_elem].append(parts[-1])
        elif parts[0] == "end_header":
            break
    counts = dict(elems)
    n_v, n_f = counts.get("vertex", 0), counts.get("face", 0)
    vp = props.get("vertex", [])
    try:
        xi, yi, zi = vp.index("x"), vp.index("y"), vp.index("z")
    except ValueError:
        raise ValueError("PLY vertex element lacks x/y/z") from None
    fp = props.get("face", [])
    has_rgb = all(c in fp for c in ("red", "green", "blue"))

    verts = np.empty((n_v, 3), np.float32)
    tris: list[tuple[int, int, int]] = []
    cols: list[tuple[float, float, float]] = []
    # Walk the data rows in the header's element order; rows of elements
    # other than vertex/face (edge, material, ...) are skipped, so files
    # with extra elements or a face-before-vertex order parse correctly.
    for name, count in elems:
        if name == "vertex":
            for i in range(count):
                parts = next(lines).split()
                verts[i] = [float(parts[xi]), float(parts[yi]),
                            float(parts[zi])]
        elif name == "face":
            for _ in range(count):
                parts = next(lines).split()
                k = int(parts[0])
                idx = [int(x) for x in parts[1:1 + k]]
                col = DEFAULT_ALBEDO
                if has_rgb and len(parts) >= 1 + k + 3:
                    col = tuple(
                        float(c) / 255.0 for c in parts[1 + k:4 + k])
                for j in range(1, k - 1):
                    tris.append((idx[0], idx[j], idx[j + 1]))
                    cols.append(col)
        else:
            for _ in range(count):
                next(lines)
    if not tris:
        raise ValueError("PLY contains no faces")
    f = np.asarray(tris, np.int64)
    if f.min() < 0 or f.max() >= n_v:
        raise ValueError("PLY face index out of range")
    albedo = np.asarray(cols, np.float32)
    emission = np.zeros_like(albedo)
    return make_scene(verts[f], albedo, emission, device)


def load_ply(path: str, *, device) -> Scene:
    return loads_ply(open(path, encoding="utf-8", errors="replace").read(),
                     device=device)


def load_scene(path: str, *, device) -> Scene:
    """Load a scene by extension (.obj / .ply) onto ``device``."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        return load_obj(path, device=device)
    if ext == ".ply":
        return load_ply(path, device=device)
    raise ValueError(f"unsupported scene format: {ext!r}")
