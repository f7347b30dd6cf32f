"""The port's scene loading against the JAX package's.

OBJ, MTL and XML files are written to `tmp_path` and parsed by both packages
(the JAX package with its Python parser, `use_native="never"`, since the
port has only that one): vertices, faces, normals, uvs, groups, per-face
materials and every `SceneSpec` field must be equal exactly, and so must the
arrays both compilers make of the specs.
"""
import dataclasses
import os
import textwrap

import numpy as np
import pytest

from mafrixraytracing_torch.io.mtl import load_mtl as tload_mtl
from mafrixraytracing_torch.io.obj import load_obj as tload_obj
from mafrixraytracing_torch.scene import assets as tassets
from mafrixraytracing_torch.scene.compiler import (
    STATIC_FLAGS,
    TENSOR_FIELDS,
    compile_arrays,
)
from mafrixraytracing_torch.scene.xml_parser import parse_scene_xml as tparse
from mafrixraytracing_tpu.io.mtl import load_mtl as jload_mtl
from mafrixraytracing_tpu.io.obj import load_obj as jload_obj
from mafrixraytracing_tpu.scene import assets as jassets
from mafrixraytracing_tpu.scene.compiler import compile_scene as jcompile
from mafrixraytracing_tpu.scene.xml_parser import parse_scene_xml as jparse
import torch_port_helpers  # noqa: F401  (sizes torch's threads to the run)

MODEL_OBJ = """\
# two groups, an MTL, uvs, normals, negative indices, a quad and a 5-gon
mtllib model.mtl
v -1 0 1
v 1 0 1
v 1 0 -1
v -1 0 -1
v -1 2 -1
v 1 2 -1
v 0 3 -1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 1 0
vn 0 0 1
g floor
usemtl red
f 1/1/1 2/2/1 3/3/1 4/4/1
g wall
usemtl glass
f 4/1/2 3/2/2 6/3/2 5/4/2
usemtl nowhere
f -3//2 -2//2 -1//2
o roof
s off
f 1 2 6 7 5
"""

MODEL_MTL = """\
newmtl red
Kd 0.8 0.1 0.1
Ka 0.2 0.2 0.2
Ns 10
newmtl glass
Kd 1 1 1
Ni 1.45
d 0.2
newmtl chrome
Kd 0.1 0.1 0.1
Ks 0.9 0.9 0.9
Ns 800
illum 3
newmtl lamp
Ke 5 5 5
newmtl tex
Kd 1 1 1
map_Kd missing.png
"""

BOX_OBJ = """\
v -1 0 1
v 1 0 1
v 1 0 -1
v -1 0 -1
v -1 2 -1
v 1 2 -1
v -0.2 1.98 -0.2
v 0.2 1.98 -0.2
v 0.2 1.98 0.2
v -0.2 1.98 0.2
g floor
f 1 2 3 4
g wall
f 4 3 6 5
g light
f 7 8 9 10
"""

SCENE_XML = """\
<Scene version="0.1">
    <Camera type="pinhole">
          <Point name="position" value="0,1,3"/>
          <Vector name="direction" value="0,0,-1"/>
          <float name="fov" value="120"/>
          <float name="aspectratio" value="1.0"/>
    </Camera>
    <Models>
        <Model type="obj" name="box">
          <string name="filename" value="box.obj"/>
        </Model>
    </Models>
    <Materials>
        <Material type="lambert"><color name="albedo" value="0.725,0.71,0.68"/></Material>
        <Material type="metal"><color name="albedo" value="0.9,0.9,0.9"/>
            <float name="fuzz" value="0.1"/></Material>
        <Material type="dielectric"><float name="ior" value="1.33"/></Material>
        <Material type="emissive"><color name="emission" value="3,2,1"/></Material>
        <Material type="glossy"><float name="exponent" value="50"/></Material>
    </Materials>
    <Shapes>
        <Shape type="shapelist">
            <string name="obj_ref" value="box.floor"/>
            <int name="material" value="0"/>
        </Shape>
        <Shape type="shapelist">
            <string name="obj_ref" value="box.wall"/>
            <int name="material" value="1"/>
        </Shape>
    </Shapes>
    <Spheres>
        <Sphere><Point name="center" value="0,0.5,0"/><float name="radius" value="0.5"/>
            <int name="material" value="2"/></Sphere>
        <Sphere><Point name="center" value="0.5,0.3,0.4"/><float name="radius" value="0.3"/>
            <int name="material" value="4"/><Point name="velocity" value="0,0.1,0"/></Sphere>
    </Spheres>
    <Light type="area">
        <string name="shape_ref" value="box.light"/>
        <color name="intensity" value="10.0,10.0,10.0"/>
    </Light>
    <Light type="point">
        <Point name="position" value="0,1.5,0"/>
        <color name="intensity" value="1,2,3"/>
    </Light>
    <Film>
        <int name="width" value="48"/>
        <int name="height" value="32"/>
    </Film>
</Scene>
"""


@pytest.fixture
def asset_dir(tmp_path):
    for name, text in (("model.obj", MODEL_OBJ), ("model.mtl", MODEL_MTL),
                       ("box.obj", BOX_OBJ)):
        with open(os.path.join(tmp_path, name), "w") as f:
            f.write(textwrap.dedent(text))
    return str(tmp_path)


def same(a, b, path="spec"):
    """Deep exact equality of two spec trees, one from each package (their
    dataclasses have the same names and fields, in different modules)."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        names = [f.name for f in dataclasses.fields(a)]
        assert names == [f.name for f in dataclasses.fields(b)], path
        for n in names:
            same(getattr(a, n), getattr(b, n), f"{path}.{n}")
        assert getattr(a, "texture_path", None) == getattr(b, "texture_path", None)
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b and type(a) is type(b), (path, a, b)


MODEL_FIELDS = ("vertices", "uvs", "normals", "face_v", "face_t", "face_n",
                "face_group", "face_material", "group_names", "usemtl_names",
                "materials", "material_order")


def test_load_mtl_equal(asset_dir):
    p = os.path.join(asset_dir, "model.mtl")
    t, j = tload_mtl(p), jload_mtl(p)
    same(t, j)
    assert [m.type for m in t.values()] == ["lambert", "dielectric", "metal",
                                            "emissive", "lambert"]
    assert t["tex"].texture_path == "missing.png"


@pytest.mark.parametrize("field", MODEL_FIELDS)
def test_load_obj_fields_equal(asset_dir, field):
    p = os.path.join(asset_dir, "model.obj")
    t, j = tload_obj(p), jload_obj(p, use_native="never")
    same(getattr(t, field), getattr(j, field), field)


def test_load_obj_groups_and_meshes_equal(asset_dir):
    p = os.path.join(asset_dir, "model.obj")
    t, j = tload_obj(p), jload_obj(p, use_native="never")
    assert t.face_v.shape == (2 + 2 + 1 + 3, 3)   # quad, quad, tri, 5-gon fan
    assert t.groups == j.groups and set(t.groups) == {"floor", "wall", "roof"}
    same(t.mesh(), j.mesh(), "mesh")
    for g in t.groups:
        same(t.group_mesh(g), j.group_mesh(g), g)
        assert t.group_materials(g) == j.group_materials(g)
    assert t.group_materials("wall") == ["glass", "glass", "nowhere"]
    # the floor has uvs and normals, the roof neither
    assert t.group_mesh("floor").uvs is not None
    assert t.group_mesh("roof").normals is None


def test_register_model_materials_equal(asset_dir):
    p = os.path.join(asset_dir, "model.obj")
    out = []
    for load, assets in ((tload_obj, tassets), (jload_obj, jassets)):
        materials, textures = [], []
        ids, names = assets.register_model_materials(load(p), p, materials,
                                                     textures)
        out.append((ids, names, materials, textures))
    same(out[0], out[1], "registered")
    # unknown usemtl and no usemtl fall back to the first MTL material
    assert out[0][0].tolist() == [0, 0, 1, 1, 0, 0, 0, 0]


@pytest.mark.parametrize("make", ["mesh_scene", "model_scene"])
def test_asset_scene_specs_and_arrays_equal(asset_dir, make):
    p = os.path.join(asset_dir, "model.obj")
    tspec = getattr(tassets, make)(p, 64, 48)
    jspec = getattr(jassets, make)(p, 64, 48)
    same(tspec, jspec)
    arrays, flags = compile_arrays(tspec)
    js = jcompile(jspec).scene
    for k in TENSOR_FIELDS:
        np.testing.assert_array_equal(arrays[k], np.asarray(getattr(js, k)), err_msg=k)
    assert flags == {k: getattr(js, k) for k in STATIC_FLAGS}
    if make == "model_scene":
        assert flags["has_dielectric"] and arrays["mat_type"][1] == 2


def test_parse_scene_xml_spec_and_arrays_equal(asset_dir):
    tspec, jspec = tparse(SCENE_XML, asset_dir), jparse(SCENE_XML, asset_dir)
    same(tspec, jspec)
    assert [m.type for m in tspec.materials] == ["lambert", "metal", "dielectric",
                                                 "emissive", "glossy"]
    assert len(tspec.shapes) == 2 and len(tspec.spheres) == 2
    assert len(tspec.area_lights) == 1 and len(tspec.point_lights) == 1
    assert (tspec.film.width, tspec.film.height) == (48, 32)
    arrays, flags = compile_arrays(tspec)
    js = jcompile(jspec).scene
    for k in TENSOR_FIELDS:
        np.testing.assert_array_equal(arrays[k], np.asarray(getattr(js, k)), err_msg=k)
    assert flags == {k: getattr(js, k) for k in STATIC_FLAGS}


def test_parse_scene_xml_rejects_what_the_reference_rejects(asset_dir):
    for bad in ('<Scene version="9"/>', '<World version="0.1"/>',
                '<Scene version="0.1"><Models><Model type="ply" name="m"/>'
                '</Models></Scene>'):
        with pytest.raises(ValueError):
            tparse(bad, asset_dir)
        with pytest.raises(AssertionError):
            jparse(bad, asset_dir)
    with pytest.raises(ValueError, match="unknown material type"):
        tparse('<Scene version="0.1"><Materials><Material type="x"/>'
               '</Materials></Scene>', asset_dir)


@pytest.mark.parametrize("name", ["spot_scene", "cube_scene", "renault_scene"])
def test_named_scenes_raise_without_assets(name, monkeypatch, tmp_path):
    """The named scenes point at the reference renderer's meshes and raise
    when those are absent; nothing is fetched."""
    for attr in ("SPOT_OBJ", "CUBE_OBJ", "RENAULT_OBJ"):
        monkeypatch.setattr(tassets, attr, str(tmp_path / "absent.obj"))
    assert not os.path.exists(tassets.SPOT_OBJ)
    with pytest.raises(FileNotFoundError):
        getattr(tassets, name)(32, 32)


def test_named_scene_paths_mirror_the_jax_package():
    for attr in ("SPOT_OBJ", "CUBE_OBJ", "RENAULT_OBJ"):
        t = getattr(tassets, attr).split(os.sep)[-3:]
        assert t == getattr(jassets, attr).split(os.sep)[-3:]
    assert tassets.have_reference_assets() == os.path.exists(tassets.SPOT_OBJ)
