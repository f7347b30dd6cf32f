"""The port's native OBJ loader (`io/native.py` around `native/fastobj.cpp`)
against its Python parser and the JAX package's native loader, on OBJ files
the tests write: every array of the parsed model equal, names and materials
equal. `use_native=True` must raise where no compiler can be found, and
"auto" must parse in Python there.
"""
import os

import numpy as np
import pytest

from mafrixraytracing_torch.io import native as tnative
from mafrixraytracing_torch.io import obj as tobj
from mafrixraytracing_tpu.io import obj as jobj
import torch_port_helpers  # noqa: F401  (sizes torch's threads to the run)

ARRAYS = ("vertices", "uvs", "normals", "face_v", "face_t", "face_n",
          "face_group", "face_material")

SMALL_OBJ = """# every reference form: a, a/b, a//c, a/b/c, negative, quads, a fan
mtllib small.mtl
v 0 0 0
v 1 0 0
v 0 1 0
v 1 1 0
v 0.5 1.5 0.25
vt 0 0
vt 1 0
vt 0 1
vn 0 0 1
g one
usemtl red
f 1/1/1 2/2/1 3/3/1
g two
usemtl blue
s 1
f 2 4 3 1
f -1//1 -2//1 -3//1
f 1/1 2/2 4/3
o three
f 1 2 4 5 3
"""
SMALL_MTL = "newmtl red\nKd 1 0 0\nnewmtl blue\nKd 0 0 1\nNs 20\n"


def write_small(tmp_path):
    (tmp_path / "small.mtl").write_text(SMALL_MTL)
    p = tmp_path / "small.obj"
    p.write_text(SMALL_OBJ)
    return str(p)


def write_grid(tmp_path, n=40, seed=3):
    """A seeded height field of 2 n^2 triangles with uvs and normals."""
    rs = np.random.default_rng(seed)
    g = np.linspace(-1.0, 1.0, n + 1)
    x, z = np.meshgrid(g, g, indexing="ij")
    y = 0.1 * rs.normal(size=x.shape)
    v = np.stack([x, y, z], -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    a = (i * (n + 1) + j).ravel() + 1
    b, c, d = a + 1, a + n + 1, a + n + 2
    faces = np.concatenate([np.stack([a, c, b], 1), np.stack([b, c, d], 1)])
    p = tmp_path / "grid.obj"
    with open(p, "w") as f:
        f.write("g grid\n")
        f.writelines("v %.7f %.7f %.7f\n" % tuple(q) for q in v)
        f.writelines("vt %.6f %.6f\n" % (q[0] * 0.5 + 0.5, q[2] * 0.5 + 0.5) for q in v)
        f.write("vn 0 1 0\n")
        f.writelines("f %d/%d/1 %d/%d/1 %d/%d/1\n" % (q[0], q[0], q[1], q[1], q[2], q[2])
                     for q in faces)
    return str(p), faces.shape[0]


def assert_models_equal(a, b):
    for f in ARRAYS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.group_names == b.group_names
    assert a.usemtl_names == b.usemtl_names
    assert a.material_order == b.material_order
    assert a.materials.keys() == b.materials.keys()
    for k in a.materials:
        assert a.materials[k].albedo == pytest.approx(b.materials[k].albedo), k
        assert a.materials[k].type == b.materials[k].type, k


@pytest.fixture
def native_built():
    if not tnative.available():
        pytest.skip(f"no native parser here: {tnative.build_error()}")


@pytest.mark.parametrize("which", ["small", "grid"])
def test_native_equals_python_parser(native_built, tmp_path, which):
    if which == "small":
        path = write_small(tmp_path)
    else:
        path, nf = write_grid(tmp_path)
    nat = tobj.load_obj(path, use_native=True)
    py = tobj.load_obj(path, use_native=False)
    assert_models_equal(nat, py)
    assert_models_equal(tobj.load_obj(path, use_native="always"), py)
    assert_models_equal(tobj.load_obj(path), py)             # "auto"
    if which == "grid":
        assert nat.face_v.shape == (nf, 3) and nat.mesh().faces.shape == (nf, 3)
    else:
        assert nat.face_v.shape[0] == 1 + 2 + 1 + 1 + 3
        assert set(nat.groups) == {"one", "two", "three"}
        assert nat.group_mesh("one").faces.shape == (1, 3)


def test_native_equals_jax_package(native_built, tmp_path):
    path = write_small(tmp_path)
    nat = tobj.load_obj(path, use_native=True)
    ref = jobj.load_obj(path, use_native="auto")
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(nat, f), getattr(ref, f), err_msg=f)
    assert nat.group_names == ref.group_names
    assert nat.usemtl_names == ref.usemtl_names
    assert nat.material_order == ref.material_order


def test_native_missing_file_raises(native_built, tmp_path):
    with pytest.raises(FileNotFoundError):
        tobj.load_obj(str(tmp_path / "absent.obj"), use_native=True)


def test_use_native_argument_is_checked(tmp_path):
    with pytest.raises(ValueError, match="use_native"):
        tobj.load_obj(write_small(tmp_path), use_native="sometimes")


def test_without_a_compiler(monkeypatch, tmp_path):
    """No g++ on PATH and no library built: `use_native=True` raises and
    names the reason, "auto" parses in Python, "never" never asks."""
    path = write_small(tmp_path)
    py = tobj.load_obj(path, use_native="never")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_build_error", None)
    monkeypatch.setattr(tnative, "_SO_PATH", str(tmp_path / "build" / "lib.so"))
    with pytest.raises(RuntimeError, match="native OBJ parser unavailable.*g\\+\\+"):
        tobj.load_obj(path, use_native=True)
    assert not tnative.available() and "g++" in tnative.build_error()
    assert_models_equal(tobj.load_obj(path, use_native="auto"), py)
    assert_models_equal(tobj.load_obj(path, use_native=False), py)
    assert not os.path.exists(tmp_path / "build" / "lib.so")


def test_broken_source_reports_the_compiler(native_built, monkeypatch, tmp_path):
    """A build that fails is reported with the compiler's message."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_build_error", None)
    monkeypatch.setattr(tnative, "_SRC_PATH", str(bad))
    monkeypatch.setattr(tnative, "_SO_PATH", str(tmp_path / "build" / "lib.so"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tobj.load_obj(write_small(tmp_path), use_native="always")
    assert not list((tmp_path / "build").glob("*.part"))
