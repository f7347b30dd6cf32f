"""XML scene description parser (reference-compatible semantics).

A copy of `mafrixraytracing_tpu/scene/xml_parser.py` (NumPy and the standard
library only): importing any module of that package imports JAX, and the
port runs where JAX is absent. One difference: malformed input raises
`ValueError` here, where that module uses `assert`.

Parses the reference's `Scene.xml` grammar, version "0.1"
(`Scene/Scene.fs:26-261`; asserted version at `Scene.fs:268-270`):

  <Scene version="0.1">
    <Camera type="pinhole"> Point position / Vector direction / float fov /
                            float aspectratio </Camera>
    <Models><Model type="obj" name=...><string name="filename" .../></Model></Models>
    <Materials><Material type="lambert"><color name="albedo" .../></Material>...</Materials>
    <Shapes><Shape type="shapelist"><string name="obj_ref" value="model.group"/>
                                    <int name="material" .../></Shape>...</Shapes>
    <Light type="area"><string name="shape_ref" value="model.group"/>
                       <color name="intensity" .../></Light>
    <Film><int name="width"/><int name="height"/></Film>
  </Scene>

Like the reference (`Scene.fs:266`), `parse_scene_xml` takes the XML *string*
(not a path); OBJ filenames resolve against `asset_dir` (the reference reads
from the CWD, `ObjModelLoader.fs:307`).

Deliberate fixes vs. the reference (SURVEY §2.12): XML material indices are
kept in their own namespace instead of being appended to the registry *after*
MTL materials (`Scene.fs:258-259`), which in the reference silently shifts
every XML index when the OBJ carries an MTL. Extensions beyond the reference
grammar (all optional): Material types "metal"/"dielectric"/"emissive" with
float fuzz/ior, `<Light type="point">`, `<Spheres>`, `<Background>`.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET

from mafrixraytracing_torch.scene import spec as S

SUPPORTED_VERSION = "0.1"


def _params(el) -> dict:
    """Collect child param elements (<float name=.. value=..> etc.)."""
    out = {}
    for child in el:
        name = child.get("name")
        if name is None:
            continue
        out[(child.tag, name)] = child.get("value", "")
    return out


def _vec(s: str):
    return tuple(float(x) for x in s.replace(";", ",").split(","))


def parse_scene_xml(xml_string: str, asset_dir: str = ".") -> S.SceneSpec:
    from mafrixraytracing_torch.io.obj import load_obj

    root = ET.fromstring(xml_string)
    if root.tag != "Scene":
        raise ValueError(f"root must be <Scene>, got <{root.tag}>")
    version = root.get("version", SUPPORTED_VERSION)
    if version != SUPPORTED_VERSION:
        raise ValueError(f"unsupported scene version {version}")

    scene = S.SceneSpec(materials=[], shapes=[], area_lights=[], point_lights=[],
                        spheres=[])

    # --- camera (reference Parse.Camera, Scene.fs:57-76) ---
    cam_el = root.find("Camera")
    if cam_el is not None:
        p = _params(cam_el)
        scene.camera = S.CameraSpec(
            type=cam_el.get("type", "pinhole"),
            position=_vec(p.get(("Point", "position"), "0,1,3")),
            direction=_vec(p.get(("Vector", "direction"), "0,0,-1")),
            fov=float(p.get(("float", "fov"), "120")),
            aspect=float(p.get(("float", "aspectratio"), "1.0")),
            fov_convention="mafrix",
        )

    # --- models (reference Parse.Model, Scene.fs:103-135) ---
    models = {}
    models_el = root.find("Models")
    if models_el is not None:
        for m_el in models_el.findall("Model"):
            if m_el.get("type") != "obj":
                raise ValueError("only obj models supported")
            name = m_el.get("name")
            p = _params(m_el)
            fname = p.get(("string", "filename"))
            models[name] = load_obj(os.path.join(asset_dir, fname))

    # --- XML materials (reference Parse.Material, Scene.fs:78-101) ---
    mats_el = root.find("Materials")
    if mats_el is not None:
        for mat_el in mats_el.findall("Material"):
            mtype = mat_el.get("type", "lambert")
            p = _params(mat_el)
            albedo = _vec(p.get(("color", "albedo"), "0.8,0.8,0.8"))
            if mtype == "lambert":
                scene.materials.append(S.MaterialSpec(type="lambert", albedo=albedo))
            elif mtype == "metal":
                scene.materials.append(
                    S.MaterialSpec(type="metal", albedo=albedo,
                                   fuzz=float(p.get(("float", "fuzz"), "0")))
                )
            elif mtype == "dielectric":
                scene.materials.append(
                    S.MaterialSpec(type="dielectric", albedo=albedo,
                                   ior=float(p.get(("float", "ior"), "1.5")))
                )
            elif mtype == "emissive":
                scene.materials.append(
                    S.MaterialSpec(type="emissive", albedo=albedo,
                                   emission=_vec(p.get(("color", "emission"), "1,1,1")))
                )
            elif mtype == "glossy":
                # normalized Phong lobe (reference's dead GlossySpecular,
                # `Brdfs/GlossySpecular.fs:5-15`) with exponent control
                scene.materials.append(
                    S.MaterialSpec(type="glossy", albedo=albedo,
                                   exponent=float(p.get(("float", "exponent"),
                                                        "32")))
                )
            else:
                raise ValueError(f"unknown material type {mtype!r}")

    def group_mesh(ref: str):
        model_name, group = ref.split(".", 1)
        return models[model_name].group_mesh(group)

    # --- shapes (reference Parse.Shape, Scene.fs:137-177) ---
    shapes_el = root.find("Shapes")
    if shapes_el is not None:
        for sh_el in shapes_el.findall("Shape"):
            if sh_el.get("type") != "shapelist":
                raise ValueError("only shapelist shapes supported")
            p = _params(sh_el)
            mesh = group_mesh(p[("string", "obj_ref")])
            mat_idx = int(p.get(("int", "material"), "0"))
            scene.shapes.append(S.ShapeSpec(mesh, mat_idx))

    # --- spheres (extension) ---
    sph_el = root.find("Spheres")
    if sph_el is not None:
        for s_el in sph_el.findall("Sphere"):
            p = _params(s_el)
            scene.spheres.append(
                S.SphereSpec(
                    center=_vec(p[("Point", "center")]),
                    radius=float(p[("float", "radius")]),
                    material=int(p.get(("int", "material"), "0")),
                    # optional shutter-interval motion (MovingSphere)
                    velocity=_vec(p[("Point", "velocity")])
                    if ("Point", "velocity") in p else (0.0, 0.0, 0.0),
                )
            )

    # --- lights (reference Parse.Lights, Scene.fs:179-199; the reference
    # supports exactly one area light; we accept any number + point lights) ---
    for l_el in root.findall("Light"):
        ltype = l_el.get("type", "area")
        p = _params(l_el)
        if ltype == "area":
            mesh = group_mesh(p[("string", "shape_ref")])
            scene.area_lights.append(
                S.AreaLightSpec(
                    mesh,
                    radiance=_vec(p.get(("color", "intensity"), "10,10,10")),
                    # reference lights are sample-only (invisible) — keep that
                    # default for XML scenes so images match
                    visible=p.get(("string", "visible"), "false") == "true",
                )
            )
        elif ltype == "point":
            scene.point_lights.append(
                S.PointLightSpec(
                    position=_vec(p[("Point", "position")]),
                    intensity=_vec(p.get(("color", "intensity"), "1,1,1")),
                )
            )
        else:
            raise ValueError(f"unknown light type {ltype!r}")

    # --- film (reference Parse.Film, Scene.fs:201-211) ---
    film_el = root.find("Film")
    if film_el is not None:
        p = _params(film_el)
        scene.film = S.FilmSpec(
            width=int(p.get(("int", "width"), "300")),
            height=int(p.get(("int", "height"), "300")),
        )

    return scene
