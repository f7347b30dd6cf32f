"""Wavefront OBJ loader.

A copy of the Python parser of `mafrixraytracing_tpu/io/obj.py` (NumPy only):
importing any module of that package imports JAX, and the port runs where
JAX is absent. `load_obj(use_native="auto")` prefers the C++ parser
(`io/native.py`, which shares this array representation) and parses in
Python when no compiler is found.

Same grammar coverage as the reference's FParsec loader
(`Models/ObjModelLoader.fs:306-341`): v / vt / vn; faces with `a`, `a/b`,
`a//c`, `a/b/c` references including negative (relative) indices
(`ObjModelLoader.fs:63-70`); groups `g` / objects `o`; `usemtl`; `mtllib`
(materials loaded first, like `ObjModelLoader.fs:317-330`); `s`, `usemap`
and comments are accepted and ignored. Quads become two triangles — the
reference routes 4-vertex faces to its `Rect` shape (two triangles,
`ObjModelLoader.fs:76-92`); faces with >4 vertices are fan-triangulated
(a strict superset of the reference, which errors on them).

The parsed model is array-based (SoA) end to end — per-face NumPy index
arrays, not per-face objects — so group extraction is O(1) Python work.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from mafrixraytracing_torch.io.mtl import load_mtl
from mafrixraytracing_torch.scene.spec import Mesh


@dataclass
class ObjModel:
    """Parsed OBJ file — array analog of the reference's `ObjState`
    (`ObjModelLoader.fs:18-53`). Face corner index -1 means "absent"."""

    vertices: np.ndarray       # (V, 3) f32
    uvs: np.ndarray            # (VT, 2) f32
    normals: np.ndarray        # (VN, 3) f32
    face_v: np.ndarray         # (F, 3) i32 vertex indices
    face_t: np.ndarray         # (F, 3) i32 uv indices or -1
    face_n: np.ndarray         # (F, 3) i32 normal indices or -1
    face_group: np.ndarray     # (F,) i32 group id
    face_material: np.ndarray  # (F,) i32 usemtl id or -1
    group_names: list          # group id -> name
    usemtl_names: list         # usemtl id -> name
    materials: dict            # MTL name -> MaterialSpec (from mtllib)
    material_order: list       # registration order of MTL materials

    @property
    def groups(self) -> dict:
        """{name: group id} for groups that own at least one face."""
        used = set(np.unique(self.face_group).tolist())
        return {n: i for i, n in enumerate(self.group_names) if i in used}

    def _mask_mesh(self, mask: np.ndarray) -> Mesh:
        fv = self.face_v[mask]
        ft = self.face_t[mask]
        fn = self.face_n[mask]
        has_uv = len(self.uvs) > 0 and bool((ft >= 0).all()) and ft.size > 0
        has_n = len(self.normals) > 0 and bool((fn >= 0).all()) and fn.size > 0
        return Mesh(
            vertices=self.vertices,
            faces=fv.astype(np.int32),
            normals=self.normals if has_n else None,
            face_normals=fn.astype(np.int32) if has_n else None,
            uvs=self.uvs if has_uv else None,
            face_uvs=ft.astype(np.int32) if has_uv else None,
        )

    def group_mesh(self, name: str) -> Mesh:
        """Indexed Mesh for one group (used by XML `obj_ref` binding,
        reference `Scene/Scene.fs:137-177`)."""
        gid = self.group_names.index(name)
        return self._mask_mesh(self.face_group == gid)

    def mesh(self) -> Mesh:
        """Whole-file mesh (all groups merged)."""
        return self._mask_mesh(np.ones(self.face_v.shape[0], bool))

    def group_materials(self, name: str) -> list:
        """Per-face usemtl names (or None) for one group."""
        gid = self.group_names.index(name)
        fm = self.face_material[self.face_group == gid]
        return [self.usemtl_names[i] if i >= 0 else None for i in fm]


def load_obj(path: str, use_native="auto") -> ObjModel:
    """Parse an OBJ file (and the MTL files it names). `use_native`: "auto"
    prefers the C++ parser (`io/native.py`, much faster on large meshes) and
    parses in Python when it cannot be built; "never" or False forces Python;
    "always" or True requires the C++ parser and raises `RuntimeError` when
    its build fails."""
    if use_native not in ("auto", "always", "never", True, False):
        raise ValueError(f"use_native must be 'auto', 'always', 'never' or a "
                         f"bool, got {use_native!r}")
    if use_native in ("auto", "always", True):
        from mafrixraytracing_torch.io import native

        model = native.load_obj_native(path)
        if model is not None:
            return model
        if use_native != "auto":
            raise RuntimeError(
                f"native OBJ parser unavailable: {native.build_error()}")
    return _load_obj_python(path)


def _resolve(idx: int, count: int):
    """1-based absolute or negative relative OBJ index -> 0-based
    (reference `ObjModelLoader.fs:63-70`)."""
    if idx > 0:
        return idx - 1
    if idx < 0:
        return count + idx
    raise ValueError("OBJ index 0 is invalid")


def _parse_corner(token: str, nv: int, nt: int, nn: int):
    parts = token.split("/")
    vi = _resolve(int(parts[0]), nv)
    ti = ni = -1
    if len(parts) >= 2 and parts[1] != "":
        ti = _resolve(int(parts[1]), nt)
    if len(parts) >= 3 and parts[2] != "":
        ni = _resolve(int(parts[2]), nn)
    return (vi, ti, ni)


def _load_obj_python(path: str) -> ObjModel:
    vertices, uvs, normals = [], [], []
    face_v, face_t, face_n, face_group, face_material = [], [], [], [], []
    group_names = ["default"]
    group_ids = {"default": 0}
    usemtl_names: list = []
    usemtl_ids: dict = {}
    cur_group = 0
    cur_mtl = -1
    materials: dict = {}
    material_order: list = []
    base = os.path.dirname(os.path.abspath(path))

    with open(path, "r", errors="replace") as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            tag = parts[0]
            if tag == "v":
                vertices.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                uvs.append([float(x) for x in parts[1:3]])
            elif tag == "vn":
                normals.append([float(x) for x in parts[1:4]])
            elif tag == "f":
                corners = [
                    _parse_corner(t, len(vertices), len(uvs), len(normals))
                    for t in parts[1:]
                ]
                # triangle fan: (0, i, i+1) — for quads this is the same
                # (0,1,2)+(0,2,3) split as the reference's Rect
                for i in range(1, len(corners) - 1):
                    tri = (corners[0], corners[i], corners[i + 1])
                    face_v.append([c[0] for c in tri])
                    face_t.append([c[1] for c in tri])
                    face_n.append([c[2] for c in tri])
                    face_group.append(cur_group)
                    face_material.append(cur_mtl)
            elif tag in ("g", "o"):
                name = parts[1] if len(parts) > 1 else "default"
                if name not in group_ids:
                    group_ids[name] = len(group_names)
                    group_names.append(name)
                cur_group = group_ids[name]
            elif tag == "usemtl":
                name = parts[1] if len(parts) > 1 else ""
                if name not in usemtl_ids:
                    usemtl_ids[name] = len(usemtl_names)
                    usemtl_names.append(name)
                cur_mtl = usemtl_ids[name]
            elif tag == "mtllib":
                mtl_path = os.path.join(base, " ".join(parts[1:]))
                if os.path.exists(mtl_path):
                    for nm, mspec in load_mtl(mtl_path).items():
                        if nm not in materials:
                            materials[nm] = mspec
                            material_order.append(nm)
            elif tag in ("s", "usemap", "mg", "l", "p"):
                continue  # accepted, ignored (parity with the reference grammar)
            # unknown tags ignored

    F = len(face_v)
    return ObjModel(
        vertices=np.asarray(vertices, np.float32).reshape(-1, 3),
        uvs=np.asarray(uvs, np.float32).reshape(-1, 2),
        normals=np.asarray(normals, np.float32).reshape(-1, 3),
        face_v=np.asarray(face_v, np.int32).reshape(F, 3),
        face_t=np.asarray(face_t, np.int32).reshape(F, 3),
        face_n=np.asarray(face_n, np.int32).reshape(F, 3),
        face_group=np.asarray(face_group, np.int32),
        face_material=np.asarray(face_material, np.int32),
        group_names=group_names,
        usemtl_names=usemtl_names,
        materials=materials,
        material_order=material_order,
    )
