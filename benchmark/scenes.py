"""A configuration's scene, built twice from the same inputs: through the
measured program (its scene builders and compiler) and through the
reference's own compiler. The mesh configuration's OBJ file is written
here from its fixed seed, once per checkout."""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from .reference import scenes as ref_scenes

WORK = Path(__file__).resolve().parent / "work"


def write_mesh_obj(path: str, rows: int, seed: int, scale: float = 1.0) -> None:
    """A displaced UV sphere of rows x rows quads (2 rows^2 triangles) with
    a small tetrahedron on top (4 more), radius `scale`, bumps from `seed`,
    as an OBJ file with uvs (136 rows: 36,996 faces)."""
    cols = rows
    rs = np.random.default_rng(seed)
    th = np.linspace(0.02, np.pi - 0.02, rows + 1)[:, None]
    ph = np.linspace(0.0, 2.0 * np.pi, cols + 1)[None, :]
    bump = rs.normal(size=(rows + 1, cols))
    r = 1.0 + 0.04 * np.concatenate([bump, bump[:, :1]], axis=1)  # closed seam
    v = np.stack([r * np.sin(th) * np.cos(ph), r * np.cos(th),
                  r * np.sin(th) * np.sin(ph)], axis=-1).reshape(-1, 3)
    uv = np.stack(np.broadcast_arrays(ph / (2.0 * np.pi), 1.0 - th / np.pi),
                  axis=-1).reshape(-1, 2)
    i, j = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    a = (i * (cols + 1) + j).ravel()
    b, c, d = a + 1, a + cols + 1, a + cols + 2
    faces = np.concatenate([np.stack([a, c, b], 1), np.stack([b, c, d], 1)])
    n = v.shape[0]
    tet = np.array([[0.0, 1.35, 0.0], [0.1, 1.1, 0.1], [-0.1, 1.1, 0.1],
                    [0.0, 1.1, -0.12]])
    tet_f = np.array([[0, 1, 2], [0, 2, 3], [0, 3, 1], [1, 3, 2]]) + n
    v = np.concatenate([v, tet])
    uv = np.concatenate([uv, np.full((4, 2), 0.5)])
    faces = np.concatenate([faces, tet_f]) + 1   # OBJ indices start at 1
    tmp = f"{path}.part"
    with open(tmp, "w") as f:
        f.write("# seeded displaced sphere, %d faces\ng mesh\n" % faces.shape[0])
        f.writelines("v %.7f %.7f %.7f\n" % tuple(p) for p in v * scale)
        f.writelines("vt %.7f %.7f\n" % tuple(t) for t in uv)
        f.writelines("f %d/%d %d/%d %d/%d\n" % (x, x, y, y, z, z) for x, y, z in faces)
    os.replace(tmp, path)


def mesh_obj(scene: dict, scale: float) -> str:
    """The path of the configuration's OBJ at `scale`, under the
    benchmark's work directory in the checkout; written at the first call."""
    WORK.mkdir(exist_ok=True)
    path = WORK / f"mesh_r{scene['rows']}_s{scene['mesh_seed']}_x{scale:g}.obj"
    if not path.exists():
        write_mesh_obj(str(path), scene["rows"], scene["mesh_seed"], scale)
    return str(path)


def film(config: dict):
    """(width, height) of the configuration's film, in pixels."""
    return config["film"]["x_pixels"], config["film"]["y_pixels"]


def program_scene(config: dict, device, scale: float = 1.0):
    """The program's compiled scene (`CompiledScene`) on `device`."""
    from mafrixraytracing_torch.scene.compiler import compile_scene

    spec = config["scene"]
    W, H = film(config)
    if spec["builder"] == "cornell_box":
        from mafrixraytracing_torch.scene.builtin import cornell_box

        s = cornell_box(W, H, light_radiance=tuple(spec["light_radiance"]))
    elif spec["builder"] == "seeded_mesh":
        from mafrixraytracing_torch.scene.assets import mesh_scene

        s = mesh_scene(mesh_obj(spec, scale), W, H, albedo=tuple(spec["albedo"]),
                       light_radiance=tuple(spec["light_radiance"]))
    else:
        raise ValueError(f"unknown scene builder {spec['builder']!r}")
    return compile_scene(s, device=device)


def reference_scene(config: dict, device, dtype, scale: float = 1.0):
    """(reference scene, reference camera) from the same inputs."""
    spec = config["scene"]
    W, H = film(config)
    if spec["builder"] == "cornell_box":
        inp = ref_scenes.cornell(W, H, spec["light_radiance"])
    else:
        inp = ref_scenes.framed_mesh(mesh_obj(spec, scale), W, H, spec["albedo"],
                                     spec["light_radiance"])
    return (ref_scenes.compile_inputs(inp, device, dtype),
            ref_scenes.camera(inp.camera, device, dtype))
