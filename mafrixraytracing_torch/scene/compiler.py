"""Scene compiler: `SceneSpec` -> `TorchScene` flat SoA tensors.

Port of `mafrixraytracing_tpu/scene/compiler.py`. The numpy part (meshes to
padded triangle, sphere, material and light tables, the cluster build) is
the JAX compiler's, line for line, so both packages compile a spec to equal
arrays; the tensors are made at the end, on the requested device.

`TorchScene` has the same field names as the JAX `ScenePytree`, and the same
static capability flags as plain attributes. `from_jax_arrays` builds one from
a `ScenePytree` flattened to numpy, so tests can feed both packages the same
scene.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mafrixraytracing_torch.core.device import resolve
from mafrixraytracing_torch.scene import spec as S
from mafrixraytracing_torch.utils.padding import bucket_size, pad_to


@dataclasses.dataclass
class TorchScene:
    # --- triangles (T,) ---
    tri_v0: torch.Tensor
    tri_e1: torch.Tensor
    tri_e2: torch.Tensor
    tri_n0: torch.Tensor   # shading normals per corner
    tri_n1: torch.Tensor
    tri_n2: torch.Tensor
    tri_uv0: torch.Tensor  # (T, 2)
    tri_uv1: torch.Tensor
    tri_uv2: torch.Tensor
    tri_mat: torch.Tensor     # (T,) int32
    tri_light: torch.Tensor   # (T,) int32 emitter row in the light table, or -1
    tri_mask: torch.Tensor    # (T,) bool
    mesh_vertices: torch.Tensor  # (V, 3) shared vertex buffer
    tri_face_vi: torch.Tensor    # (T, 3) int32 corner indices into it
    # --- spheres (Sp,) ---
    sph_center: torch.Tensor
    sph_radius: torch.Tensor
    sph_velocity: torch.Tensor
    sph_mat: torch.Tensor
    sph_mask: torch.Tensor
    # --- material table (M,) ---
    mat_type: torch.Tensor      # int32: 0 lambert 1 metal 2 dielectric 3 emissive 4 glossy
    mat_albedo: torch.Tensor    # (M, 3)
    mat_emission: torch.Tensor  # (M, 3)
    mat_fuzz: torch.Tensor      # (M,) metal roughness or Phong exponent
    mat_ior: torch.Tensor       # (M,)
    mat_tex: torch.Tensor       # (M,) int32 atlas page, -1 = untextured
    tex_atlas: torch.Tensor     # (K, R, R, 3)
    # --- area-light triangle table (L,) ---
    light_v0: torch.Tensor
    light_e1: torch.Tensor
    light_e2: torch.Tensor
    light_normal: torch.Tensor
    light_radiance: torch.Tensor
    light_area: torch.Tensor
    light_two_sided: torch.Tensor
    light_mask: torch.Tensor
    light_cdf: torch.Tensor
    light_total_area: torch.Tensor  # ()
    # --- point lights (P,) ---
    plight_pos: torch.Tensor
    plight_intensity: torch.Tensor
    plight_mask: torch.Tensor
    # --- sphere area lights (SL,) ---
    slight_center: torch.Tensor
    slight_radius: torch.Tensor
    slight_radiance: torch.Tensor
    slight_velocity: torch.Tensor
    slight_mask: torch.Tensor
    # --- environment ---
    background: torch.Tensor  # (3,)
    # --- acceleration: 128-triangle clusters in median-split order ---
    cluster_min: torch.Tensor  # (C, 3); empty clusters have min > max
    cluster_max: torch.Tensor
    super_min: torch.Tensor    # (S, 3)
    super_max: torch.Tensor
    mega_ids: torch.Tensor     # (MAX_MEGA,) int32, -1 padded
    # --- static capability flags (let the hot path skip whole branches) ---
    has_textures: bool = False
    has_glossy: bool = False
    has_metal: bool = True
    has_dielectric: bool = True
    num_live_spheres: int = 0
    num_mega: int = 0

    def replace(self, **changes) -> "TorchScene":
        return dataclasses.replace(self, **changes)


STATIC_FLAGS = ("has_textures", "has_glossy", "has_metal", "has_dielectric",
                "num_live_spheres", "num_mega")
TENSOR_FIELDS = tuple(f.name for f in dataclasses.fields(TorchScene)
                      if f.name not in STATIC_FLAGS)


@dataclasses.dataclass
class CompiledScene:
    scene: TorchScene
    camera: "object"
    film_width: int = 300
    film_height: int = 300


def from_jax_arrays(d: dict, flags: dict, device=None) -> TorchScene:
    """A `TorchScene` from a JAX `ScenePytree` flattened to numpy arrays
    (`d`: field name -> array) and its static fields (`flags`), on `device`
    (None: the CUDA card)."""
    device = resolve(device)
    tensors = {k: torch.as_tensor(np.array(d[k])).to(device)
               for k in TENSOR_FIELDS}
    return TorchScene(**tensors, **{k: flags[k] for k in STATIC_FLAGS})


def _mesh_face_arrays(mesh: S.Mesh, transform=None):
    """Per-face v0/e1/e2, shading normals, uvs, area, and the transformed
    vertex buffer with its face index triples (the JAX compiler's)."""
    v = S.transformed_vertices(mesh, transform)
    f = np.asarray(mesh.faces, np.int64)
    p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    e1 = p1 - p0
    e2 = p2 - p0
    gn = np.cross(e1, e2)
    norm = np.linalg.norm(gn, axis=1, keepdims=True)
    gn = gn / np.maximum(norm, 1e-12)

    if mesh.normals is not None and mesh.face_normals is not None:
        nrm = np.asarray(mesh.normals, np.float32)
        fn = np.asarray(mesh.face_normals, np.int64)
        n0, n1, n2 = nrm[fn[:, 0]], nrm[fn[:, 1]], nrm[fn[:, 2]]
        if transform is not None:
            inv_t = np.linalg.inv(np.asarray(transform)[:3, :3]).T
            n0, n1, n2 = (x @ inv_t.T for x in (n0, n1, n2))
            n0, n1, n2 = (
                x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
                for x in (n0, n1, n2)
            )
    else:
        n0 = n1 = n2 = gn

    if mesh.uvs is not None and mesh.face_uvs is not None:
        uv = np.asarray(mesh.uvs, np.float32)
        fu = np.asarray(mesh.face_uvs, np.int64)
        uv0, uv1, uv2 = uv[fu[:, 0]], uv[fu[:, 1]], uv[fu[:, 2]]
    else:
        uv0 = uv1 = uv2 = np.zeros((f.shape[0], 2), np.float32)

    area = 0.5 * norm[:, 0]
    return p0, e1, e2, gn, (n0, n1, n2), (uv0, uv1, uv2), area, (v, f)


def compile_arrays(scene_spec: S.SceneSpec):
    """The host half of the compiler: `SceneSpec` -> (numpy arrays keyed by
    `TorchScene` field, static flags). Identical to the JAX compiler's."""
    materials = list(scene_spec.materials)
    if not materials:
        materials = [S.MaterialSpec()]

    tri_chunks = {k: [] for k in ("v0", "e1", "e2", "n0", "n1", "n2",
                                  "uv0", "uv1", "uv2", "mat", "light",
                                  "face_vi")}
    vert_chunks: list = []
    vert_offset = 0

    def add_verts(v, f):
        nonlocal vert_offset
        vert_chunks.append(np.asarray(v, np.float32))
        out = np.asarray(f, np.int64) + vert_offset
        vert_offset += v.shape[0]
        return out.astype(np.int32)

    def add_tris(p0, e1, e2, sn, uvs, mat_id, light_id, face_vi):
        n = p0.shape[0]
        tri_chunks["face_vi"].append(np.asarray(face_vi, np.int32))
        tri_chunks["v0"].append(p0)
        tri_chunks["e1"].append(e1)
        tri_chunks["e2"].append(e2)
        for key, val in zip(("n0", "n1", "n2"), sn):
            tri_chunks[key].append(val)
        for key, val in zip(("uv0", "uv1", "uv2"), uvs):
            tri_chunks[key].append(val)
        tri_chunks["mat"].append(
            np.asarray(mat_id, np.int32)
            if np.ndim(mat_id)
            else np.full(n, mat_id, np.int32)
        )
        tri_chunks["light"].append(
            np.asarray(light_id, np.int32)
            if np.ndim(light_id)
            else np.full(n, light_id, np.int32)
        )

    for shape in scene_spec.shapes:
        p0, e1, e2, gn, sn, uvs, _, (v, f) = _mesh_face_arrays(
            shape.mesh, shape.transform
        )
        mat = shape.material
        if shape.face_materials is not None:
            mat = np.asarray(shape.face_materials, np.int32)
            if mat.shape[0] != p0.shape[0]:
                raise ValueError(f"face_materials has {mat.shape[0]} entries "
                                 f"for {p0.shape[0]} faces")
        add_tris(p0, e1, e2, sn, uvs, mat, -1, add_verts(v, f))

    # --- area lights: light table + (optionally) emissive hittable geometry ---
    lt = {k: [] for k in ("v0", "e1", "e2", "normal", "radiance", "area",
                          "two_sided")}
    light_row = 0
    for al in scene_spec.area_lights:
        p0, e1, e2, gn, sn, uvs, area, (v, f) = _mesh_face_arrays(al.mesh)
        n = p0.shape[0]
        lt["v0"].append(p0)
        lt["e1"].append(e1)
        lt["e2"].append(e2)
        lt["normal"].append(gn)
        lt["radiance"].append(np.tile(np.asarray(al.radiance, np.float32), (n, 1)))
        lt["area"].append(area.astype(np.float32))
        lt["two_sided"].append(np.full(n, al.two_sided, bool))
        if al.visible:
            mat_id = len(materials)
            materials.append(
                S.MaterialSpec(type="emissive", albedo=(0, 0, 0),
                               emission=al.radiance)
            )
            add_tris(p0, e1, e2, sn, uvs, mat_id,
                     np.arange(light_row, light_row + n, dtype=np.int32),
                     add_verts(v, f))
        light_row += n

    # --- concatenate + pad triangles ---
    if tri_chunks["v0"]:
        tri = {k: np.concatenate(v, axis=0) for k, v in tri_chunks.items()}
    else:
        tri = {
            **{k: np.zeros((0, 3), np.float32)
               for k in ("v0", "e1", "e2", "n0", "n1", "n2")},
            **{k: np.zeros((0, 2), np.float32) for k in ("uv0", "uv1", "uv2")},
            "mat": np.zeros((0,), np.int32),
            "light": np.zeros((0,), np.int32),
            "face_vi": np.zeros((0, 3), np.int32),
        }
    num_tris = tri["v0"].shape[0]
    T = bucket_size(num_tris, 128)
    tri_mask = pad_to(np.ones(num_tris, bool), T, False)
    tri = {k: pad_to(np.asarray(v), T, 0 if v.dtype != np.int32 else -1)
           for k, v in tri.items()}

    # --- acceleration build: median-split triangles, cluster AABBs ---
    from mafrixraytracing_torch.accel.clusters import build_clusters

    accel = build_clusters(tri["v0"], tri["e1"], tri["e2"], tri_mask)
    perm = accel["perm"]
    tri = {k: v[perm] for k, v in tri.items()}
    tri_mask = tri_mask[perm]

    verts = (
        np.concatenate(vert_chunks, axis=0).astype(np.float32)
        if vert_chunks
        else np.zeros((0, 3), np.float32)
    )
    Vp = bucket_size(max(verts.shape[0], 1), 128)
    mesh_vertices = pad_to(verts, Vp)

    # --- spheres ---
    ns = len(scene_spec.spheres)
    Sp = bucket_size(ns, 8)
    sph_center = np.zeros((Sp, 3), np.float32)
    sph_radius = np.zeros((Sp,), np.float32)
    sph_velocity = np.zeros((Sp, 3), np.float32)
    sph_mat = np.zeros((Sp,), np.int32)
    sph_mask = np.zeros((Sp,), bool)
    for i, sp in enumerate(scene_spec.spheres):
        sph_center[i] = sp.center
        sph_radius[i] = sp.radius
        sph_velocity[i] = sp.velocity
        sph_mat[i] = sp.material
        sph_mask[i] = True

    # --- material table ---
    M = bucket_size(len(materials), 8)
    mat_type = np.zeros((M,), np.int32)
    mat_albedo = np.zeros((M, 3), np.float32)
    mat_emission = np.zeros((M, 3), np.float32)
    mat_fuzz = np.zeros((M,), np.float32)
    mat_ior = np.full((M,), 1.5, np.float32)
    mat_tex = np.full((M,), -1, np.int32)
    for i, m in enumerate(materials):
        mat_type[i] = S.MATERIAL_TYPES[m.type]
        mat_albedo[i] = m.albedo
        mat_emission[i] = m.emission
        # type-overloaded: metal roughness OR Phong exponent for glossy
        mat_fuzz[i] = m.exponent if m.type == "glossy" else m.fuzz
        mat_ior[i] = m.ior
        mat_tex[i] = m.texture_id

    from mafrixraytracing_torch.materials.texture import build_atlas

    atlas = build_atlas(scene_spec.textures)

    # --- light table (padded) ---
    if lt["v0"]:
        light = {k: np.concatenate(v, axis=0) for k, v in lt.items()}
    else:
        light = {
            **{k: np.zeros((0, 3), np.float32)
               for k in ("v0", "e1", "e2", "normal", "radiance")},
            "area": np.zeros((0,), np.float32),
            "two_sided": np.zeros((0,), bool),
        }
    nl = light["v0"].shape[0]
    L = bucket_size(nl, 8)
    light_mask = pad_to(np.ones(nl, bool), L, False)
    light = {k: pad_to(np.asarray(v), L) for k, v in light.items()}
    areas = light["area"] * light_mask
    total_area = float(np.sum(areas))
    if total_area > 0:
        cdf = np.cumsum(areas) / total_area
    else:
        cdf = np.ones((L,), np.float32)
    cdf[-1] = 1.0 + 1e-6  # guard against u == 1.0 falling off the end

    # --- point lights (size 0 when there are none: no phantom queries) ---
    npl = len(scene_spec.point_lights)
    P = bucket_size(npl, 8) if npl else 0
    plight_pos = np.zeros((P, 3), np.float32)
    plight_intensity = np.zeros((P, 3), np.float32)
    plight_mask = np.zeros((P,), bool)
    for i, pl in enumerate(scene_spec.point_lights):
        plight_pos[i] = pl.position
        plight_intensity[i] = pl.intensity
        plight_mask[i] = True

    # --- sphere area lights: emissive-material spheres ---
    sl_rows = [
        i for i, sp in enumerate(scene_spec.spheres)
        if materials[sp.material].type == "emissive"
    ]
    SL = bucket_size(len(sl_rows), 4) if sl_rows else 0
    slight_center = np.zeros((SL, 3), np.float32)
    slight_radius = np.zeros((SL,), np.float32)
    slight_radiance = np.zeros((SL, 3), np.float32)
    slight_velocity = np.zeros((SL, 3), np.float32)
    slight_mask = np.zeros((SL,), bool)
    for row, i in enumerate(sl_rows):
        sp = scene_spec.spheres[i]
        slight_center[row] = sp.center
        slight_radius[row] = sp.radius
        slight_radiance[row] = materials[sp.material].emission
        slight_velocity[row] = sp.velocity
        slight_mask[row] = True

    arrays = dict(
        tri_v0=tri["v0"], tri_e1=tri["e1"], tri_e2=tri["e2"],
        tri_n0=tri["n0"], tri_n1=tri["n1"], tri_n2=tri["n2"],
        tri_uv0=tri["uv0"], tri_uv1=tri["uv1"], tri_uv2=tri["uv2"],
        tri_mat=np.clip(tri["mat"], 0, M - 1), tri_light=tri["light"],
        tri_mask=tri_mask, mesh_vertices=mesh_vertices,
        tri_face_vi=np.clip(tri["face_vi"], 0, Vp - 1),
        sph_center=sph_center, sph_radius=sph_radius,
        sph_velocity=sph_velocity, sph_mat=sph_mat, sph_mask=sph_mask,
        mat_type=mat_type, mat_albedo=mat_albedo, mat_emission=mat_emission,
        mat_fuzz=mat_fuzz, mat_ior=mat_ior, mat_tex=mat_tex, tex_atlas=atlas,
        light_v0=light["v0"], light_e1=light["e1"], light_e2=light["e2"],
        light_normal=light["normal"], light_radiance=light["radiance"],
        light_area=light["area"], light_two_sided=light["two_sided"],
        light_mask=light_mask, light_cdf=np.asarray(cdf, np.float32),
        light_total_area=np.float32(total_area),
        plight_pos=plight_pos, plight_intensity=plight_intensity,
        plight_mask=plight_mask,
        slight_center=slight_center, slight_radius=slight_radius,
        slight_radiance=slight_radiance, slight_velocity=slight_velocity,
        slight_mask=slight_mask,
        background=np.zeros((3,), np.float32),
        cluster_min=accel["cluster_min"], cluster_max=accel["cluster_max"],
        super_min=accel["super_min"], super_max=accel["super_max"],
        mega_ids=accel["mega_ids"],
    )
    flags = dict(
        has_textures=bool((mat_tex >= 0).any()),
        has_glossy=bool((mat_type == S.MATERIAL_TYPES["glossy"]).any()),
        has_metal=bool((mat_type == S.MATERIAL_TYPES["metal"]).any()),
        has_dielectric=bool((mat_type == S.MATERIAL_TYPES["dielectric"]).any()),
        num_live_spheres=ns,
        num_mega=int((accel["mega_ids"] >= 0).sum()),
    )
    return arrays, flags


def compile_scene(scene_spec: S.SceneSpec, device=None) -> CompiledScene:
    """Flatten a `SceneSpec` into tensors on `device` (None: the CUDA card;
    host build in numpy, tensors made at the end)."""
    from mafrixraytracing_torch.camera.camera import Camera

    device = resolve(device)
    arrays, flags = compile_arrays(scene_spec)
    scene = from_jax_arrays(arrays, flags, device=device)

    cam_spec = scene_spec.camera
    if cam_spec.type == "thin_lens":
        pos = np.asarray(cam_spec.position, np.float32)
        look = pos + np.asarray(cam_spec.direction, np.float32)
        camera = Camera.thin_lens(
            pos, look, cam_spec.fov, cam_spec.aspect,
            aperture=cam_spec.aperture, focus_dist=cam_spec.focus_dist,
            up=cam_spec.up, device=device,
        )
    else:
        camera = Camera.pinhole(
            cam_spec.position, cam_spec.direction, cam_spec.fov,
            cam_spec.aspect, up=cam_spec.up,
            fov_convention=cam_spec.fov_convention, device=device,
        )
    return CompiledScene(scene=scene, camera=camera,
                         film_width=scene_spec.film.width,
                         film_height=scene_spec.film.height)
