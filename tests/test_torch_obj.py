"""The port's OBJ loading, meshes and presets against the JAX package.

Every OBJ is written into ``tmp_path`` from text or from a lat-long sphere
made with NumPy.  The OBJ parsers and the mesh bake are host code copied
from the JAX package (and, for the native parser, the same C++ source), so
their outputs must be BIT-equal; the preset scene's tables must be
bit-equal too, as tests/test_torch_scene.py holds them.
"""

import dataclasses
import os
import shutil
import textwrap
import time

import numpy as np
import pytest

from opengl_raytracer_tpu.models.mesh import Mesh as JMesh
from opengl_raytracer_tpu.models.obj import load_obj_py as j_load_obj_py
from opengl_raytracer_tpu.models.scene import Scene as JScene
from opengl_raytracer_tpu.native import loader as jloader
from opengl_raytracer_tpu import presets as jpresets

from opengl_raytracer_torch import Mesh, presets
from opengl_raytracer_torch.models import obj as obj_mod
from opengl_raytracer_torch.models.mesh import resolve_obj_path
from opengl_raytracer_torch.models.obj import load_obj, load_obj_py
from opengl_raytracer_torch.native import loader
from opengl_raytracer_torch.ops import bvh as bvh_mod
from opengl_raytracer_torch.utils.config import RenderConfig
from test_torch_scene import (_assert_bit_equal, _assert_scene_equal,
                              jax_native)  # noqa: F401 (autouse)


def write_latlong_obj(path, n_lat, n_lon, radius=1.0, normals=False):
    """A lat-long sphere of 2 * n_lat * n_lon triangles as an OBJ: shared
    ``v`` lines, and ``v//n`` faces with unit ``vn`` normals or bare ``v``
    faces."""
    th = np.linspace(0.0, np.pi, n_lat + 1)
    ph = np.linspace(0.0, 2.0 * np.pi, n_lon + 1)
    T, P = np.meshgrid(th, ph, indexing="ij")
    unit = np.stack([np.sin(T) * np.cos(P), np.cos(T), np.sin(T) * np.sin(P)],
                    axis=-1).reshape(-1, 3)
    idx = np.arange(unit.shape[0]).reshape(n_lat + 1, n_lon + 1) + 1
    c00, c10, c11, c01 = idx[:-1, :-1], idx[1:, :-1], idx[1:, 1:], idx[:-1, 1:]
    faces = np.concatenate([np.stack([c00, c10, c11], -1).reshape(-1, 3),
                            np.stack([c00, c11, c01], -1).reshape(-1, 3)])
    lines = [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in unit * radius]
    if normals:
        lines += [f"vn {x:.9g} {y:.9g} {z:.9g}" for x, y, z in unit]
        lines += [f"f {a}//{a} {b}//{b} {c}//{c}" for a, b, c in faces]
    else:
        lines += [f"f {a} {b} {c}" for a, b, c in faces]
    os.makedirs(os.path.dirname(str(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)


def stage_default_models(root):
    """Small stand-ins for the default scene's two meshes under ``root``:
    a 10x10-cell bumpless sphere of radius 36 as the dragon (200
    triangles), a smooth 6x12-cell unit sphere (144 triangles)."""
    write_latlong_obj(os.path.join(root, "stanford_minidragon", "dragon.obj"),
                      10, 10, radius=36.0)
    write_latlong_obj(os.path.join(root, "sphere", "sphere.obj"), 6, 12,
                      normals=True)
    return str(root)


# Face forms of tests/test_obj.py, as OBJ text.
FORMS = {
    "full": """\
        v 0 0 0
        v 1 0 0
        v 0 1 0
        vt 0.25 0.5
        vn 0 0 1
        f 1/1/1 2/1/1 3/1/1
        """,
    "v_flip": """\
        v 0 0 0
        v 1 0 0
        v 0 1 0
        vt 0.2 0.3
        f 1/1 2/1 3/1
        """,
    "v//n": """\
        v 0 0 0
        v 1 0 0
        v 0 1 0
        vn 0 1 0
        f 1//1 2//1 3//1
        """,
    "bare": """\
        v 0 0 0
        v 1 0 0
        v 0 1 0
        f 1 2 3
        """,
    "fan": """\
        v 0 0 0
        v 1 0 0
        v 1 1 0
        v 0 1 0
        v 0 2 0
        vt 0.1 0.9
        vn 0.6 0.8 0
        f 1/1/1 2/1/1 3/1/1 4/1/1 5/1/1
        """,
    "five_field_v": """\
        v 9 1 2 3
        v 9 4 5 6
        v 9 7 8 9
        f 1 2 3
        """,
    "negative_index_quirk": """\
        v 1 1 1
        v 2 2 2
        v 3 3 3
        f 0 -1 -2
        """,
    "four_field_tokens": """\
        v 0 0 0
        v 1 0 0
        v 0 1 0
        vt 0.5 0.5
        vn 0 1 0
        f 1/1/1/9 2/1/1/9 3/1/1/9
        """,
}


def write_obj(tmp_path, text, name="t.obj"):
    p = tmp_path / name
    p.write_text(textwrap.dedent(text))
    return str(p)


@pytest.mark.parametrize("form", list(FORMS))
def test_parsers_bit_equal_to_jax(tmp_path, form):
    """The port's Python and native parsers against the JAX Python parser,
    on each face form, bit for bit."""
    path = write_obj(tmp_path, FORMS[form])
    ref = j_load_obj_py(path, progress=False)
    assert ref.shape[0] > 0 and ref.shape[1] == 8
    _assert_bit_equal(ref, load_obj_py(path, progress=False), "python")
    _assert_bit_equal(ref, loader.load_obj_native(path), "native")


def test_out_of_range_index_fails_in_both_packages(tmp_path):
    """"-3" indexes pool[-4] of a 3-vertex pool: IndexError from the Python
    parsers, IOError from the native ones."""
    path = write_obj(tmp_path, "v 1 1 1\nv 2 2 2\nv 3 3 3\nf -3 1 2\n")
    for parse in (load_obj_py, j_load_obj_py):
        with pytest.raises(IndexError):
            parse(path, progress=False)
    for parse in (loader.load_obj_native, jloader.load_obj_native):
        with pytest.raises(IOError):
            parse(path)


def test_load_obj_records_its_parser(tmp_path, monkeypatch):
    path = write_obj(tmp_path, FORMS["fan"])
    native = load_obj(path)
    assert obj_mod.last_parser == "native"
    monkeypatch.setattr(loader, "get_lib", lambda: None)
    python = load_obj(path)
    assert obj_mod.last_parser == "python"
    _assert_bit_equal(native, python, "native vs python")


@pytest.mark.parametrize("touched", ["objparser.cpp", "bvh.cpp"])
def test_native_library_rebuilds_when_any_source_is_newer(tmp_path,
                                                          monkeypatch,
                                                          touched):
    srcs = []
    for s in loader._SOURCES:
        srcs.append(str(tmp_path / os.path.basename(s)))
        shutil.copy(s, srcs[-1])
    lib = str(tmp_path / "build" / "liboglrt_native.so")
    monkeypatch.setattr(loader, "_SOURCES", srcs)
    monkeypatch.setattr(loader, "_LIB_PATH", lib)
    assert loader._build() and os.path.exists(lib)

    now = time.time()
    for s in srcs:
        os.utime(s, (now - 100, now - 100))
    os.utime(lib, (now - 50, now - 50))
    assert loader._build()
    assert os.path.getmtime(lib) == now - 50  # up to date: not rebuilt

    src = srcs[[os.path.basename(s) for s in srcs].index(touched)]
    os.utime(src, (now - 10, now - 10))
    assert loader._build()
    assert os.path.getmtime(lib) > now - 10  # rebuilt
    assert not [f for f in os.listdir(os.path.dirname(lib))
                if f.endswith(".tmp")]


def test_mesh_bit_equal_to_jax(tmp_path):
    path = write_obj(tmp_path, FORMS["fan"])
    write_latlong_obj(tmp_path / "ball.obj", 5, 7, radius=2.5, normals=True)
    for p in (path, str(tmp_path / "ball.obj")):
        kw = dict(color=[0.5, 0.25, 1.0], roughness=0.5, scale=1.75)
        ref = JMesh([1.5, -2.0, 7.25], [30, -45, 110], p, **kw)
        got = Mesh([1.5, -2.0, 7.25], [30, -45, 110], p, **kw)
        for name in ("pos", "normals", "uvs"):
            _assert_bit_equal(getattr(ref, name), getattr(got, name), name)
        assert got.color == ref.color and got.roughness == ref.roughness


@pytest.mark.parametrize("how", ["file", "directory", "bare_name", "missing"])
def test_resolve_obj_path(tmp_path, monkeypatch, how):
    root = tmp_path / "assets"
    path = write_latlong_obj(root / "ball" / "b.obj", 2, 3)
    monkeypatch.setenv("OGLRT_MODELS_PATH",
                       os.pathsep.join([str(tmp_path / "empty"), str(root)]))
    if how == "file":
        assert resolve_obj_path(path) == path
    elif how == "directory":
        assert resolve_obj_path(str(root / "ball")) == path
    elif how == "bare_name":
        assert resolve_obj_path("ball") == path
    else:
        with pytest.raises(FileNotFoundError, match="searched"):
            resolve_obj_path("no_such_model")


def test_default_scene_tables_bit_equal_to_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("OGLRT_MODELS_PATH", stage_default_models(tmp_path))
    jdata = JScene(jpresets.default_objects(), max_leaf_tris=32).send()
    scene = presets.default_scene()
    assert scene.total_triangles == 200 + 144 + 84
    assert obj_mod.last_parser == "native"
    assert bvh_mod.last_builder == "native"
    assert jloader._lib is not None  # the JAX side ran native too
    _assert_scene_equal(jdata, scene)


@pytest.mark.parametrize("name", ["objparser.cpp", "bvh.cpp"])
def test_native_sources_are_the_jax_packages(name):
    """The port builds its native library from its own copies of the JAX
    package's C++ sources, byte for byte the same."""
    with open(os.path.join(os.path.dirname(loader.__file__), name), "rb") as f:
        ours = f.read()
    with open(os.path.join(os.path.dirname(jloader.__file__), name),
              "rb") as f:
        theirs = f.read()
    assert ours == theirs
    assert os.path.join(os.path.dirname(loader.__file__), name) \
        in loader._SOURCES


def test_default_and_baseline_configs_match_jax():
    ref, got = jpresets.default_config(), presets.default_config()
    for f in dataclasses.fields(RenderConfig):
        assert getattr(got, f.name) == getattr(ref, f.name), f.name
    got = presets.default_config(bounces=4, rays_per_pixel=4)
    assert (got.bounces, got.rays_per_pixel) == (4, 4)
    jb, tb = jpresets.baseline_configs(), presets.baseline_configs()
    assert list(tb) == list(jb)
    for name in jb:
        assert set(tb[name]) == set(jb[name]), name
        assert tb[name]["cam_pos"] == jb[name]["cam_pos"]
        assert tb[name]["cam_dir"] == jb[name]["cam_dir"]
        for f in dataclasses.fields(RenderConfig):
            assert (getattr(tb[name]["config"], f.name)
                    == getattr(jb[name]["config"], f.name)), (name, f.name)
    assert presets.DEFAULT_CAM_POS == jpresets.DEFAULT_CAM_POS
    assert presets.DEFAULT_CAM_DIR == jpresets.DEFAULT_CAM_DIR
