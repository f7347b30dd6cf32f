"""The port's two-level (supercluster) search against the JAX package.

With `SUPER_MIN_C` patched to 0 in both packages every scene takes the
two-level path: the cull runs on the superclusters and the walk goes through
the plain versions of kernels D and E here, and through the Pallas kernels
in interpret mode there (as tests/test_pallas.py:170 runs them). Contract:
`idx` equal, `t` within rtol 1e-4 / atol 1e-5 (the Pallas kernel divides by
an approximate reciprocal), occlusion equal. One seeded mesh of 16,928
triangles has more than 128 clusters and needs no patch.

The CUDA kernels themselves are held against their plain versions on the
card in tests/test_torch_kernels.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafrixraytracing_torch.accel.clusters import SUPER
from mafrixraytracing_torch.core import rng as trng
from mafrixraytracing_torch.core.v3 import V3 as TV3
from mafrixraytracing_torch.geometry import intersect as tisect
from mafrixraytracing_torch.integrator import path as TP
from mafrixraytracing_torch.ops import intersect as ti
from mafrixraytracing_torch.scene.compiler import (
    STATIC_FLAGS,
    TENSOR_FIELDS,
    compile_scene as tcompile,
    from_jax_arrays,
)
from mafrixraytracing_torch.scene import spec as TS
from mafrixraytracing_tpu.core.types import Rays
from mafrixraytracing_tpu.core.v3 import V3 as JV3
from mafrixraytracing_tpu.geometry import intersect as jisect
from mafrixraytracing_tpu.integrator import path as JP
from mafrixraytracing_tpu.ops import intersect_pallas as ip
from mafrixraytracing_tpu.scene import builtin as jbuiltin
from mafrixraytracing_tpu.scene import spec as JS
from mafrixraytracing_tpu.scene.compiler import compile_scene as jcompile
import torch_port_helpers  # noqa: F401  (sizes torch's threads to the run)

T_MIN = 1e-3


def soup_spec(n=1024, seed=3):
    rs = np.random.default_rng(seed)
    centers = rs.uniform(-1.0, 1.0, (n, 1, 3))
    verts = (centers + rs.normal(0.0, 0.08, (n, 3, 3))).reshape(-1, 3)
    mesh = JS.Mesh(vertices=verts.astype(np.float32),
                   faces=np.arange(3 * n, dtype=np.int32).reshape(n, 3))
    return JS.SceneSpec(shapes=[JS.ShapeSpec(mesh=mesh, material=0)])


def flat_quad_over_mega_ground(S=JS):
    """tests/test_pallas.py:101: a small flat quad at y = 0 (a regular
    cluster with a zero-thickness AABB) over a huge ground quad (mega)."""
    quad = S.make_rect_mesh((-0.5, 0.0, -0.5), (0.5, 0.0, -0.5),
                            (0.5, 0.0, 0.5), (-0.5, 0.0, 0.5))
    ground = S.make_rect_mesh((-10.0, -5.0, -10.0), (10.0, -5.0, -10.0),
                              (10.0, -5.0, 10.0), (-10.0, -5.0, 10.0))
    return S.SceneSpec(shapes=[S.ShapeSpec(mesh=quad, material=0),
                               S.ShapeSpec(mesh=ground, material=0)])


def bumpy_sphere(S, rows=92, cols=92, seed=5):
    """A displaced UV sphere of rows * cols * 2 = 16,928 triangles (padded
    to 32,768: 256 clusters, about half of them empty, 16 superclusters) with a ground quad and an area light."""
    rs = np.random.default_rng(seed)
    th = np.linspace(0.02, np.pi - 0.02, rows + 1)[:, None]
    ph = np.linspace(0.0, 2.0 * np.pi, cols, endpoint=False)[None, :]
    r = 1.0 + 0.05 * rs.normal(size=(rows + 1, cols))
    v = np.stack([r * np.sin(th) * np.cos(ph), r * np.cos(th) + 1.2,
                  r * np.sin(th) * np.sin(ph)], axis=-1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    a = (i * cols + j).ravel()
    b = (i * cols + (j + 1) % cols).ravel()
    c = ((i + 1) * cols + j).ravel()
    d = ((i + 1) * cols + (j + 1) % cols).ravel()
    faces = np.concatenate([np.stack([a, c, b], 1), np.stack([b, c, d], 1)])
    mesh = S.Mesh(vertices=v.astype(np.float32), faces=faces.astype(np.int32))
    ground = S.make_rect_mesh((-4.0, 0.0, 4.0), (4.0, 0.0, 4.0),
                              (4.0, 0.0, -4.0), (-4.0, 0.0, -4.0))
    light = S.make_rect_mesh((-1.0, 4.0, -1.0), (1.0, 4.0, -1.0),
                             (1.0, 4.0, 1.0), (-1.0, 4.0, 1.0))
    return S.SceneSpec(
        camera=S.CameraSpec(position=(0.0, 1.6, 4.0), direction=(0.0, -0.1, -1.0),
                            fov=45.0, aspect=1.0, fov_convention="standard"),
        materials=[S.MaterialSpec(type="lambert", albedo=(0.7, 0.5, 0.4)),
                   S.MaterialSpec(type="lambert", albedo=(0.8, 0.8, 0.8))],
        shapes=[S.ShapeSpec(mesh, 0), S.ShapeSpec(ground, 1)],
        area_lights=[S.AreaLightSpec(light, radiance=(12.0, 12.0, 12.0),
                                     visible=False)],
        film=S.FilmSpec(width=32, height=32))


CASES = {
    "cornell": (lambda: jbuiltin.cornell_box(), (0.0, 1.0, 1.5)),
    "flat_quad": (flat_quad_over_mega_ground, (0.0, 2.0, 0.0)),
    "sphere_triad": (lambda: jbuiltin.sphere_triad(), (0.0, 0.7, 2.0)),
    "soup": (soup_spec, (0.0, 0.0, 0.0)),
}


def carry_over(jscene):
    d = {k: np.asarray(getattr(jscene, k)) for k in TENSOR_FIELDS}
    return from_jax_arrays(d, {k: getattr(jscene, k) for k in STATIC_FLAGS},
                           device="cpu")


def scenes(name):
    js = jcompile(CASES[name][0]()).scene
    return js, carry_over(js)


def rays(n, origin, seed, dead_frac=0.1, t_far=1e8):
    rs = np.random.default_rng(seed)
    o = (np.asarray(origin, np.float32)
         + rs.normal(0.0, 0.2, (n, 3))).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(rs.random(n) < dead_frac, 0.0, t_far).astype(np.float32)
    return o, d, t_max


def aimed_rays(n, seed):
    """Rays from around the bumpy-sphere camera toward points in and around
    the sphere (centre (0, 1.2, 0), radius 1): most of them hit the mesh."""
    rs = np.random.default_rng(seed)
    o = (np.float32([0.0, 1.6, 4.0]) + rs.normal(0.0, 0.2, (n, 3))).astype(np.float32)
    target = np.float32([0.0, 1.2, 0.0]) + rs.uniform(-1.1, 1.1, (n, 3))
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def both_v3(o, d):
    jo, jd = JV3.of(jnp.asarray(o)), JV3.of(jnp.asarray(d))
    to, td = TV3.of(torch.as_tensor(o)), TV3.of(torch.as_tensor(d))
    return (jo, jd), (to, td)


@pytest.fixture
def two_level(monkeypatch):
    monkeypatch.setattr(ip, "SUPER_MIN_C", 0)
    monkeypatch.setattr(ti, "SUPER_MIN_C", 0)


@pytest.fixture(scope="module")
def bumpy():
    js = jcompile(bumpy_sphere(JS))
    return js, carry_over(js.scene)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("n", [384, 333])
def test_closest_super_matches_pallas(two_level, name, n):
    """Aligned and non-aligned batches with ~10% dead rays."""
    js, ts = scenes(name)
    o, d, t_max = rays(n, CASES[name][1], seed=n)
    (jo, jd), (to, td) = both_v3(o, d)
    t_j, i_j = ip.find_closest_soa(js, jo, jd, T_MIN, jnp.asarray(t_max),
                                   interpret=True)
    walk, *_ = ti._prep(ts, to, td, T_MIN, torch.as_tensor(t_max), anyhit=False)
    assert ti._is_super(walk) and walk[2].shape[1] == ts.super_min.shape[0]
    t_t, i_t = ti.find_closest_soa(ts, to, td, T_MIN, torch.as_tensor(t_max))
    i_j, t_j = np.asarray(i_j), np.asarray(t_j)
    np.testing.assert_array_equal(i_t.numpy(), i_j)
    hit = i_j >= 0
    assert hit.sum() > n // 10
    np.testing.assert_allclose(t_t.numpy()[hit], t_j[hit], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("scale", [1.01, 100.0])
def test_occluded_super_matches_pallas(two_level, name, scale):
    """Per-ray t_max just above and far above the closest hit."""
    js, ts = scenes(name)
    o, d, _ = rays(300, CASES[name][1], seed=11, dead_frac=0.0)
    (jo, jd), (to, td) = both_v3(o, d)
    t_hit, i_hit = ti.find_closest_soa(ts, to, td, T_MIN, 1e8)
    t_far = np.where(i_hit.numpy() >= 0, t_hit.numpy() * scale, 1e8)
    t_far = t_far.astype(np.float32)
    t_far[::9] = 0.0
    occ_j = ip.occluded_soa(js, jo, jd, T_MIN, jnp.asarray(t_far),
                            interpret=True)
    occ_t = ti.occluded_soa(ts, to, td, T_MIN, torch.as_tensor(t_far))
    np.testing.assert_array_equal(occ_t.numpy(), np.asarray(occ_j))
    want = (i_hit.numpy() >= 0) & (t_far > 0)
    np.testing.assert_array_equal(occ_t.numpy(), want)
    assert 0 < occ_t.sum() < 300


def test_straight_down_flat_tile(two_level):
    """Axis-aligned rays onto a zero-thickness child AABB (entry == exit):
    the quad at t = 2 must be kept, not the ground at t = 7."""
    js, ts = scenes("flat_quad")
    assert ts.num_mega >= 2
    n = 1024
    xz = np.random.default_rng(11).uniform(-0.45, 0.45, (n, 2))
    o = np.stack([xz[:, 0], np.full(n, 2.0), xz[:, 1]], 1).astype(np.float32)
    d = np.tile(np.float32([[0.0, -1.0, 0.0]]), (n, 1))
    (jo, jd), (to, td) = both_v3(o, d)
    t_j, i_j = ip.find_closest_soa(js, jo, jd, T_MIN, 1e8, interpret=True)
    t_t, i_t = ti.find_closest_soa(ts, to, td, T_MIN, 1e8)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(t_t.numpy(), 2.0, atol=1e-4)
    # the refinement the CUDA kernels run keeps the quad's child for every ray
    walk, *_ = ti._prep(ts, to, td, T_MIN, 1e8, anyhit=False)
    keep = ti.refine_children(walk[1], walk[-1], t_t)
    assert keep[:, 0, 0].all()


@pytest.mark.parametrize("name", list(CASES))
def test_two_level_equals_flat(monkeypatch, name):
    """The port's two paths give the same hits on the same scene."""
    _, ts = scenes(name)
    o, d, t_max = rays(500, CASES[name][1], seed=21)
    _, (to, td) = both_v3(o, d)
    t_max = torch.as_tensor(t_max)
    flat = ti.find_closest_soa(ts, to, td, T_MIN, t_max)
    occ_flat = ti.occluded_soa(ts, to, td, T_MIN, t_max.clamp(max=1.5))
    monkeypatch.setattr(ti, "SUPER_MIN_C", 0)
    two = ti.find_closest_soa(ts, to, td, T_MIN, t_max)
    occ_two = ti.occluded_soa(ts, to, td, T_MIN, t_max.clamp(max=1.5))
    assert torch.equal(two[1], flat[1]) and torch.equal(two[0], flat[0])
    assert torch.equal(occ_two, occ_flat)


@pytest.mark.parametrize("name", ["cornell", "soup", "bumpy"])
def test_pack_bounds_matches_pallas(name, bumpy):
    """Same values as the JAX `pack_bounds`, whatever the layout: there
    rows s * 8 + k of (S * 8, 16), here [s, k] of (S, 7, 16)."""
    js, ts = (bumpy[0].scene, bumpy[1]) if name == "bumpy" else scenes(name)
    S = ts.super_min.shape[0]
    jb = np.asarray(ip.pack_bounds(js)).reshape(S, 8, SUPER)
    tb = ti.pack_bounds(ts).numpy()
    assert tb.shape == (S, ti.BOUNDS_ROWS, SUPER)
    np.testing.assert_array_equal(tb, jb[:, :7])
    C = ts.cluster_min.shape[0]
    assert tb[:, 6].reshape(-1)[C:].sum() == 0  # slots past C are not live


def test_refinement_keeps_every_hit_child(bumpy):
    """`refine_children` (the kernels' refinement) with the final hit
    distance as the limit keeps the child cluster of every ray's hit."""
    _, ts = bumpy
    o, d = aimed_rays(256, seed=8)
    _, (to, td) = both_v3(o, d)
    walk, *_ = ti._prep(ts, to, td, T_MIN, 1e8, anyhit=False)
    t, i = ti.closest_super_hit(*walk, T_MIN)
    hit = i >= 0
    assert hit.sum() > 128
    keep = ti.refine_children(walk[1], walk[-1], t)
    c = (i[hit] // 128).long()
    assert keep[hit, c // SUPER, c % SUPER].all()
    # and it is a cull: far fewer than all children survive
    assert keep.float().mean() < 0.25


def test_large_scene_matches_brute_force(bumpy):
    """More than 128 clusters, so the two-level path without a patch,
    against the JAX brute-force search and the Pallas kernels."""
    jcs, ts = bumpy
    C = ts.cluster_min.shape[0]
    assert C > ti.SUPER_MIN_C and C == 256 and ts.super_min.shape[0] == 16
    o, d = aimed_rays(256, seed=3)
    (jo, jd), (to, td) = both_v3(o, d)
    t_b, i_b = jisect.find_closest(
        jcs.scene, Rays(origin=jnp.asarray(o), direction=jnp.asarray(d)),
        T_MIN, 1e8)
    t_t, i_t = ti.find_closest_soa(ts, to, td, T_MIN, 1e8)
    i_b, t_b = np.asarray(i_b), np.asarray(t_b)
    np.testing.assert_array_equal(i_t.numpy(), i_b)
    hit = i_b >= 0
    assert (i_b[hit] < 16928).sum() > 128
    np.testing.assert_allclose(t_t.numpy()[hit], t_b[hit], rtol=1e-4, atol=1e-5)
    t_p, i_p = ip.find_closest_soa(jcs.scene, jo, jd, T_MIN, 1e8,
                                   interpret=True)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_p))
    # the port's own brute-force oracle agrees too
    _, i_o = tisect.find_closest(ts, to, td, T_MIN, 1e8)
    np.testing.assert_array_equal(i_t.numpy(), i_o.numpy())
    t_far = np.where(hit, t_b * 1.01, 1e8).astype(np.float32)
    occ_t = ti.occluded_soa(ts, to, td, T_MIN, torch.as_tensor(t_far))
    np.testing.assert_array_equal(occ_t.numpy(), hit)


def test_large_scene_render_matches_jax(bumpy):
    """32x32 x 4 spp through the two-level path against the JAX package at
    the same seed, with the tolerance tests/test_torch_path.py states."""
    jcs, ts = bumpy
    W = H = 32
    compact = (1.0, 0.7, 0.3, 0.15, 0.05)
    tcam = tcompile(bumpy_sphere(TS), device="cpu").camera
    jimg = np.asarray(JP.render_image(
        jcs.scene, jcs.camera, W, H, 4, jax.random.key(7),
        JP.PathTracerConfig(max_depth=5, compact=compact)))
    timg = TP.render_image(ts, tcam, W, H, 4, trng.root_key(7, "cpu"),
                           TP.PathTracerConfig(max_depth=5, compact=compact))
    timg = timg.numpy()
    assert timg.shape == (H, W, 3) and np.isfinite(timg).all()
    close = np.isclose(timg, jimg, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert close.mean() >= 0.995, close.mean()
    assert abs(timg.mean() - jimg.mean()) <= 1e-4 * abs(jimg.mean())
    assert timg.mean() > 0.01
