"""Scenes assembled around external OBJ assets (spot / Cube / Renault12TL).

A copy of `mafrixraytracing_tpu/scene/assets.py` (NumPy only): importing any
module of that package imports JAX, and the port runs where JAX is absent.
`mesh_scene` and `model_scene` build a renderable scene from any OBJ path
(auto-framed camera, ground plane, overhead area light). The named scenes
look for the reference renderer's meshes under the same asset directory as
the JAX package does and raise `FileNotFoundError` when they are absent.
"""
from __future__ import annotations

import os

import numpy as np

from mafrixraytracing_torch.film.image import read_image
from mafrixraytracing_torch.io.obj import load_obj
from mafrixraytracing_torch.scene import spec as S

# The reference renderer's checkout sits beside the home directory; for the
# user the JAX package was written under this is the directory it names.
REFERENCE_ASSETS = os.path.join(os.path.expanduser("~"), "reference", "3DModel")
SPOT_OBJ = os.path.join(REFERENCE_ASSETS, "spot", "spot_triangulated_good.obj")
CUBE_OBJ = os.path.join(REFERENCE_ASSETS, "Cube", "Cube.obj")
RENAULT_OBJ = os.path.join(REFERENCE_ASSETS, "Renault12TL", "Renault12TL.obj")


def load_texture(path: str):
    """Decode an image file to (H, W, 3) float32 in [0, 1]; None on failure.
    (The reference decodes with ImageSharp, `Core/Texture.fs:30-44`; the
    vertical flip it does at load happens at *sample* time here, see
    `materials.texture.sample_atlas`.)"""
    try:
        return read_image(path)
    except (ImportError, OSError):
        return None


def register_model_materials(model, obj_path: str, materials: list, textures: list):
    """Register a parsed model's MTL materials (and their map_Kd textures)
    into a scene's material/texture lists and return per-face global material
    ids for `model.mesh()` — the SoA analog of the reference registering MTL
    materials during model load (`Models/Obj_Mtl.fs:195-217`) and resolving
    the current `usemtl` per face (`Models/ObjModelLoader.fs:296-304`).

    Faces with no / unknown usemtl get a default lambert material (appended
    once, only if needed). Returns (face_ids, name_to_global_id)."""
    base = os.path.dirname(os.path.abspath(obj_path))
    name_to_id = {}
    for nm in model.material_order:
        spec = model.materials[nm]
        tex_path = getattr(spec, "texture_path", None)
        if tex_path:
            img = load_texture(os.path.join(base, tex_path))
            if img is not None:
                spec.texture_id = len(textures)
                textures.append(img)
        name_to_id[nm] = len(materials)
        materials.append(spec)

    fm = model.face_material  # (F,) usemtl id or -1
    lut = np.full(max(len(model.usemtl_names), 1), -1, np.int64)
    for i, nm in enumerate(model.usemtl_names):
        lut[i] = name_to_id.get(nm, -1)
    face_ids = np.where(fm >= 0, lut[np.clip(fm, 0, len(lut) - 1)], -1)
    if (face_ids < 0).any():
        # faces with no (or unknown) usemtl: the reference's default
        # materialIndex 0 resolves to the first MTL material registered
        # during load (`Scene/Scene.fs:251-259` ordering), so prefer that;
        # a generic lambert only when the model brought no materials at all
        if model.material_order:
            default_id = name_to_id[model.material_order[0]]
        else:
            default_id = len(materials)
            materials.append(S.MaterialSpec(type="lambert", albedo=(0.8, 0.8, 0.8)))
        face_ids = np.where(face_ids >= 0, face_ids, default_id)
    return face_ids.astype(np.int32), name_to_id


def model_scene(
    obj_path: str,
    width: int = 512,
    height: int = 512,
    light_radiance=(12.0, 12.0, 12.0),
) -> S.SceneSpec:
    """Hero shot for an OBJ with its *real* MTL materials and textures wired
    through — the flagship flow of the reference (`Scene/Scene.fs:251-259`:
    MTL materials registered during model load, per-face usemtl binding)."""
    model = load_obj(obj_path)
    mesh = model.mesh()
    materials: list = []
    textures: list = []
    face_ids, _ = register_model_materials(model, obj_path, materials, textures)

    v = mesh.vertices
    lo, hi = v.min(axis=0), v.max(axis=0)
    center = (lo + hi) / 2.0
    size = float(np.max(hi - lo))

    cam_pos = center + np.array([0.0, 0.35 * size, 1.8 * size], np.float32)
    cam_dir = center - cam_pos
    ground_y = float(lo[1]) - 0.02 * size
    g = 3.0 * size
    ground = S.make_rect_mesh(
        (center[0] - g, ground_y, center[2] + g),
        (center[0] + g, ground_y, center[2] + g),
        (center[0] + g, ground_y, center[2] - g),
        (center[0] - g, ground_y, center[2] - g),
    )
    ground_id = len(materials)
    materials.append(S.MaterialSpec(type="lambert", albedo=(0.8, 0.8, 0.8)))
    ls = 0.8 * size
    lh = float(hi[1]) + 1.5 * size
    light = S.make_rect_mesh(
        (center[0] - ls, lh, center[2] - ls),
        (center[0] + ls, lh, center[2] - ls),
        (center[0] + ls, lh, center[2] + ls),
        (center[0] - ls, lh, center[2] + ls),
    )
    return S.SceneSpec(
        camera=S.CameraSpec(
            position=tuple(cam_pos),
            direction=tuple(cam_dir),
            fov=45.0,
            aspect=width / height,
            fov_convention="standard",
        ),
        materials=materials,
        shapes=[
            S.ShapeSpec(mesh, 0, face_materials=face_ids),
            S.ShapeSpec(ground, ground_id),
        ],
        area_lights=[S.AreaLightSpec(light, radiance=light_radiance, visible=False)],
        film=S.FilmSpec(width=width, height=height),
        textures=textures,
    )


def cube_scene(width: int = 512, height: int = 512) -> S.SceneSpec:
    """The BASELINE Cube config (12 tris, wall1.tif texture via cube.mtl)."""
    return model_scene(CUBE_OBJ, width, height)


def renault_scene(width: int = 1024, height: int = 1024) -> S.SceneSpec:
    """The BASELINE Renault12TL config (~37k faces; its map_Kd BaseColor is
    stripped from the reference checkout — `.MISSING_LARGE_BLOBS` — so the
    material falls back to its Kd color)."""
    return model_scene(RENAULT_OBJ, width, height)


def mesh_scene(
    obj_path: str,
    width: int = 512,
    height: int = 512,
    albedo=(0.7, 0.5, 0.4),
    light_radiance=(12.0, 12.0, 12.0),
) -> S.SceneSpec:
    """Generic hero shot for a mesh: auto-framed camera, ground plane, and an
    overhead area light (the capability demonstrated by the reference's
    `DrawWithTexture`/spot sample, re-lit for path tracing)."""
    model = load_obj(obj_path)
    mesh = model.mesh()

    v = mesh.vertices
    lo, hi = v.min(axis=0), v.max(axis=0)
    center = (lo + hi) / 2.0
    size = float(np.max(hi - lo))

    cam_pos = center + np.array([0.0, 0.35 * size, 1.8 * size], np.float32)
    cam_dir = center - cam_pos
    ground_y = float(lo[1]) - 0.02 * size
    g = 3.0 * size
    ground = S.make_rect_mesh(
        (center[0] - g, ground_y, center[2] + g),
        (center[0] + g, ground_y, center[2] + g),
        (center[0] + g, ground_y, center[2] - g),
        (center[0] - g, ground_y, center[2] - g),
    )
    ls = 0.8 * size
    lh = float(hi[1]) + 1.5 * size
    light = S.make_rect_mesh(
        (center[0] - ls, lh, center[2] - ls),
        (center[0] + ls, lh, center[2] - ls),
        (center[0] + ls, lh, center[2] + ls),
        (center[0] - ls, lh, center[2] + ls),
    )

    return S.SceneSpec(
        camera=S.CameraSpec(
            position=tuple(cam_pos),
            direction=tuple(cam_dir),
            fov=45.0,
            aspect=width / height,
            fov_convention="standard",
        ),
        materials=[
            S.MaterialSpec(type="lambert", albedo=albedo),
            S.MaterialSpec(type="lambert", albedo=(0.8, 0.8, 0.8)),
        ],
        shapes=[S.ShapeSpec(mesh, 0), S.ShapeSpec(ground, 1)],
        area_lights=[S.AreaLightSpec(light, radiance=light_radiance, visible=False)],
        film=S.FilmSpec(width=width, height=height),
    )


def spot_scene(width: int = 512, height: int = 512) -> S.SceneSpec:
    """The BASELINE spot-cow benchmark scene (5,856 tris)."""
    return mesh_scene(SPOT_OBJ, width, height)


def spot_textured_scene(width: int = 512, height: int = 512) -> S.SceneSpec:
    """Spot with its texture applied (the reference textures spot the same
    way in its rasterizer demo, `RenderTest/Sample/DrawWithTexture.fs:14-43`;
    spot ships no MTL, so the binding is explicit)."""
    sc = mesh_scene(SPOT_OBJ, width, height, albedo=(1.0, 1.0, 1.0))
    img = load_texture(os.path.join(REFERENCE_ASSETS, "spot", "spot_texture.png"))
    if img is not None:
        sc.materials[0].texture_id = len(sc.textures)
        sc.textures.append(img)
    return sc


def have_reference_assets() -> bool:
    return os.path.exists(SPOT_OBJ)
