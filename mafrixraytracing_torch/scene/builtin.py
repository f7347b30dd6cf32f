"""Built-in procedural scenes.

The reference's flagship demo needs `CornellBox-Original.obj`, which is
missing from its repo (SURVEY §0); we generate an equivalent Cornell box
procedurally with the same camera / materials / light configuration as the
embedded XML in `RenderTest/Sample/RayTracing4.fs:10-71` (camera (0,1,3)
dir (0,0,-1) fov 120, white/green/red lambert walls, area light (10,10,10),
300x300 film).

A copy of `mafrixraytracing_tpu/scene/builtin.py`: importing any module of
that package imports JAX, and the port runs where JAX is absent.
"""
from __future__ import annotations

import numpy as np

from mafrixraytracing_torch.scene import spec as S


def _box_mesh(center, half_extents, rotate_y_deg=0.0) -> S.Mesh:
    """Axis-aligned box rotated about +y, as 12 triangles with outward
    normals (the reference's dead `Box` shape, `Core/Shape/Box.fs:9-129`,
    built boxes from 6 rects the same way)."""
    cx, cy, cz = center
    hx, hy, hz = half_extents
    corners = np.array(
        [
            [sx * hx, sy * hy, sz * hz]
            for sx in (-1, 1)
            for sy in (-1, 1)
            for sz in (-1, 1)
        ],
        np.float32,
    )  # index bit pattern: (x<<2)|(y<<1)|z with -1 -> 0, +1 -> 1
    a = np.deg2rad(rotate_y_deg)
    rot = np.array(
        [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]],
        np.float32,
    )
    corners = corners @ rot.T + np.asarray(center, np.float32)

    # 6 faces as corner quads (ordered so the cross product points outward)
    quads = [
        (0b100, 0b101, 0b111, 0b110),  # +x
        (0b001, 0b000, 0b010, 0b011),  # -x
        (0b010, 0b110, 0b111, 0b011),  # +y
        (0b000, 0b001, 0b101, 0b100),  # -y
        (0b001, 0b011, 0b111, 0b101),  # +z
        (0b000, 0b100, 0b110, 0b010),  # -z
    ]
    faces = []
    for q in quads:
        faces.append([q[0], q[1], q[2]])
        faces.append([q[0], q[2], q[3]])
    return S.Mesh(vertices=corners, faces=np.asarray(faces, np.int32))


def cornell_box(
    width: int = 300,
    height: int = 300,
    light_radiance=(10.0, 10.0, 10.0),
    light_visible: bool = True,
) -> S.SceneSpec:
    """Cornell-box scene matching the reference flagship demo
    (`RenderTest/Sample/RayTracing4.fs:10-71` + `Scene.xml`): box spanning
    x,z in [-1,1], y in [0,2]; white floor/ceiling/back and boxes, green
    right wall, red left wall; rect area light just under the ceiling."""
    white = S.MaterialSpec(type="lambert", albedo=(0.725, 0.71, 0.68))
    green = S.MaterialSpec(type="lambert", albedo=(0.14, 0.45, 0.091))
    red = S.MaterialSpec(type="lambert", albedo=(0.63, 0.065, 0.05))
    materials = [white, green, red]

    # Walls as rects with inward-facing winding (normals point into the box).
    floor = S.make_rect_mesh((-1, 0, 1), (1, 0, 1), (1, 0, -1), (-1, 0, -1))
    ceiling = S.make_rect_mesh((-1, 2, -1), (1, 2, -1), (1, 2, 1), (-1, 2, 1))
    back = S.make_rect_mesh((-1, 0, -1), (1, 0, -1), (1, 2, -1), (-1, 2, -1))
    right = S.make_rect_mesh((1, 0, -1), (1, 0, 1), (1, 2, 1), (1, 2, -1))
    left = S.make_rect_mesh((-1, 0, 1), (-1, 0, -1), (-1, 2, -1), (-1, 2, 1))

    short_box = _box_mesh((0.33, 0.3, 0.37), (0.29, 0.3, 0.29), rotate_y_deg=-17.0)
    tall_box = _box_mesh((-0.33, 0.6, -0.28), (0.29, 0.6, 0.29), rotate_y_deg=17.0)

    shapes = [
        S.ShapeSpec(floor, 0),
        S.ShapeSpec(ceiling, 0),
        S.ShapeSpec(back, 0),
        S.ShapeSpec(right, 1),
        S.ShapeSpec(left, 2),
        S.ShapeSpec(short_box, 0),
        S.ShapeSpec(tall_box, 0),
    ]

    # Light rect just below the ceiling, wound so the normal points down.
    h = 1.98
    s = 0.235
    light_mesh = S.make_rect_mesh((-s, h, -s), (s, h, -s), (s, h, s), (-s, h, s))

    return S.SceneSpec(
        camera=S.CameraSpec(
            position=(0.0, 1.0, 3.0),
            direction=(0.0, 0.0, -1.0),
            fov=120.0,
            aspect=width / height,
            fov_convention="mafrix",
        ),
        materials=materials,
        shapes=shapes,
        area_lights=[
            S.AreaLightSpec(light_mesh, radiance=light_radiance, visible=light_visible)
        ],
        film=S.FilmSpec(width=width, height=height),
    )


def furnace(width: int = 64, height: int = 64, albedo: float = 0.7) -> S.SceneSpec:
    """White-furnace validation scene: a lambertian sphere inside a constant
    emissive environment. With environment radiance 1 and albedo a, converged
    pixel values over the sphere must be sum_k a^k -> 1/(1-a) * background
    handled by the integrator's miss shader. Used by energy-conservation
    tests (the reference has no such test; SURVEY §4)."""
    return S.SceneSpec(
        camera=S.CameraSpec(
            position=(0.0, 0.0, 3.0),
            direction=(0.0, 0.0, -1.0),
            fov=90.0,
            aspect=width / height,
            fov_convention="standard",
        ),
        materials=[S.MaterialSpec(type="lambert", albedo=(albedo,) * 3)],
        spheres=[S.SphereSpec(center=(0.0, 0.0, 0.0), radius=1.0, material=0)],
        film=S.FilmSpec(width=width, height=height),
    )


def sphere_triad(width: int = 200, height: int = 100) -> S.SceneSpec:
    """Three-sphere hero shot in the style of the reference's RTIOW sample
    (`RenderTest/Sample/RayTracing.fs:417-474`): lambert / metal / dielectric
    spheres on a big ground sphere with an area light overhead."""
    materials = [
        S.MaterialSpec(type="lambert", albedo=(0.5, 0.5, 0.5)),   # ground
        S.MaterialSpec(type="lambert", albedo=(0.1, 0.2, 0.5)),
        S.MaterialSpec(type="metal", albedo=(0.8, 0.6, 0.2), fuzz=0.05),
        S.MaterialSpec(type="dielectric", albedo=(1.0, 1.0, 1.0), ior=1.5),
    ]
    spheres = [
        S.SphereSpec((0.0, -100.5, -1.0), 100.0, 0),
        S.SphereSpec((0.0, 0.0, -1.0), 0.5, 1),
        S.SphereSpec((1.05, 0.0, -1.0), 0.5, 2),
        S.SphereSpec((-1.05, 0.0, -1.0), 0.5, 3),
    ]
    light_mesh = S.make_rect_mesh(
        (-2, 3, -3), (2, 3, -3), (2, 3, 1), (-2, 3, 1)
    )
    return S.SceneSpec(
        camera=S.CameraSpec(
            position=(0.0, 0.7, 2.0),
            direction=(0.0, -0.25, -1.0),
            fov=60.0,
            aspect=width / height,
            fov_convention="standard",
        ),
        materials=materials,
        spheres=spheres,
        area_lights=[
            S.AreaLightSpec(light_mesh, radiance=(4.0, 4.0, 4.0), visible=False)
        ],
        film=S.FilmSpec(width=width, height=height),
    )
