"""Host-side scene specification (pre-compilation).

The reference's scene layer is an object graph built by an XML parser
(`EngineCore/Scene/Scene.fs:26-261`): camera + model map + materials + shapes
+ a light + film. Here the same concepts are plain Python/NumPy dataclasses;
`scene.compiler.compile_scene` flattens them into the `ScenePytree` SoA
arrays that the device kernels consume. Scene building is host work.

A copy of `mafrixraytracing_tpu/scene/spec.py`: importing any module of that
package imports JAX, and the port runs where JAX is absent.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

MATERIAL_TYPES = {"lambert": 0, "metal": 1, "dielectric": 2, "emissive": 3,
                  "glossy": 4}


@dataclass
class MaterialSpec:
    """One material-table row (replaces the `IMaterial` class zoo,
    reference `Core/Materials/Material.fs:29-125`). `glossy` is the
    normalized Phong lobe with exponent control — the reference's DEAD
    `GlossySpecular` (`Core/Materials/Brdfs/GlossySpecular.fs:5-15`,
    f = ks * (r.wo)^exp * col), energy-normalized here."""

    type: str = "lambert"
    albedo: tuple = (0.8, 0.8, 0.8)
    emission: tuple = (0.0, 0.0, 0.0)
    fuzz: float = 0.0          # metal roughness (reference `Material.fs:58-64`)
    ior: float = 1.5           # dielectric index (reference `Material.fs:98-125`)
    exponent: float = 32.0     # Phong exponent for type == "glossy"
    texture_id: int = -1       # -1 = none; else index into the scene texture atlas

    def __post_init__(self):
        assert self.type in MATERIAL_TYPES, self.type


@dataclass
class Mesh:
    """Indexed triangle mesh, host-side (what `LoadObjModel` produces,
    reference `Models/ObjModelLoader.fs:306-341`). Quads must already be
    triangulated (the reference's `Rect` = two triangles,
    `Core/Shape/Rect.fs:11-46`)."""

    vertices: np.ndarray                  # (V, 3) f32
    faces: np.ndarray                     # (F, 3) i32 vertex indices
    normals: np.ndarray | None = None     # (VN, 3) f32 per-vertex normals
    face_normals: np.ndarray | None = None  # (F, 3) i32 indices into normals
    uvs: np.ndarray | None = None         # (VT, 2) f32
    face_uvs: np.ndarray | None = None    # (F, 3) i32 indices into uvs

    @property
    def num_faces(self) -> int:
        return int(self.faces.shape[0])


@dataclass
class ShapeSpec:
    """A mesh group bound to a material — the analog of the XML
    `<Shape type="shapelist" obj_ref=... material=...>` element
    (reference `Scene/Scene.fs:137-177`). `face_materials` optionally gives a
    per-face material id (overriding `material`), the SoA analog of the
    reference resolving the current `usemtl` per face during model load
    (`Models/ObjModelLoader.fs:296-304`)."""

    mesh: Mesh
    material: int
    transform: np.ndarray | None = None   # optional 4x4 instancing transform
    face_materials: np.ndarray | None = None  # (F,) i32 per-face material ids


@dataclass
class SphereSpec:
    """Analytic sphere (reference `Core/Shape/Sphere.fs:9-48`). `velocity`
    moves the center over the shutter interval, center(t) = center + t *
    velocity for ray time t in [0, 1) — the reference's `MovingSphere`
    (`RenderTest/Sample/RayTracing.fs:210-253`)."""

    center: tuple
    radius: float
    material: int
    velocity: tuple = (0.0, 0.0, 0.0)


@dataclass
class AreaLightSpec:
    """Diffuse area emitter over a triangle list (generalizes the reference's
    single rect `NewAreaLight`, `Core/Lights/Light.fs:31-64`). `radiance` is
    emitted radiance per unit area per steradian (the reference calls it
    `intensity`). `visible=True` also inserts the geometry into the hittable
    set with an emissive material so BSDF rays can see the light — the
    reference's light was sample-only/invisible (SURVEY §3.2)."""

    mesh: Mesh
    radiance: tuple = (10.0, 10.0, 10.0)
    visible: bool = True
    two_sided: bool = False


@dataclass
class PointLightSpec:
    """Point light, radiance intensity/d^2 (reference `NewPointLight`,
    `Core/Lights/Light.fs:9-29`)."""

    position: tuple
    intensity: tuple


@dataclass
class FilmSpec:
    width: int = 300
    height: int = 300


@dataclass
class CameraSpec:
    type: str = "pinhole"
    position: tuple = (0.0, 1.0, 3.0)
    direction: tuple = (0.0, 0.0, -1.0)
    fov: float = 120.0
    aspect: float = 1.0
    up: tuple = (0.0, 1.0, 0.0)
    fov_convention: str = "mafrix"
    aperture: float = 0.0
    focus_dist: float | None = None


@dataclass
class SceneSpec:
    """Everything `InitSceneState` gathers (reference
    `Scene/Scene.fs:265-271`), as data."""

    camera: CameraSpec = field(default_factory=CameraSpec)
    materials: list = field(default_factory=list)       # [MaterialSpec]
    shapes: list = field(default_factory=list)          # [ShapeSpec]
    spheres: list = field(default_factory=list)         # [SphereSpec]
    area_lights: list = field(default_factory=list)     # [AreaLightSpec]
    point_lights: list = field(default_factory=list)    # [PointLightSpec]
    film: FilmSpec = field(default_factory=FilmSpec)
    textures: list = field(default_factory=list)        # [np.ndarray (H,W,3)]


def make_rect_mesh(p0, p1, p2, p3) -> Mesh:
    """Quad from 4 corners -> 2 triangles (p0,p1,p2) and (p0,p2,p3), the same
    split the reference's `Rect` uses (`Core/Shape/Rect.fs:11-20`)."""
    v = np.asarray([p0, p1, p2, p3], np.float32)
    f = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return Mesh(vertices=v, faces=f)


def merge_meshes(meshes: list) -> Mesh:
    vs, fs = [], []
    off = 0
    for m in meshes:
        vs.append(np.asarray(m.vertices, np.float32))
        fs.append(np.asarray(m.faces, np.int64) + off)
        off += m.vertices.shape[0]
    return Mesh(
        vertices=np.concatenate(vs, axis=0),
        faces=np.concatenate(fs, axis=0).astype(np.int32),
    )


def transformed_vertices(mesh: Mesh, transform: np.ndarray | None) -> np.ndarray:
    v = np.asarray(mesh.vertices, np.float32)
    if transform is None:
        return v
    vh = np.concatenate([v, np.ones((v.shape[0], 1), np.float32)], axis=1)
    out = vh @ np.asarray(transform, np.float32).T
    w = np.where(np.abs(out[:, 3:4]) > 1e-12, out[:, 3:4], 1.0)
    return (out[:, :3] / w).astype(np.float32)
