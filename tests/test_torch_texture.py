"""The port's texture atlas and textured shading against the JAX package.

`sample_atlas` (nearest and bilinear) on seeded uvs that include wrap-around,
exact texel centres and negative texture ids: within 1e-6 (both do the same
float32 arithmetic; nearest is a pure gather). A checker-textured scene is
rendered by both packages at the same seed, with the tolerance
tests/test_torch_path.py states: rtol 1e-3 / atol 1e-4 on at least 99.5% of
pixels and the image mean within 1e-4 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafrixraytracing_torch.core import rng as trng
from mafrixraytracing_torch.geometry import intersect as tisect
from mafrixraytracing_torch.integrator import path as TP
from mafrixraytracing_torch.materials import texture as ttex
from mafrixraytracing_torch.scene import spec as TS
from mafrixraytracing_torch.scene.compiler import (
    STATIC_FLAGS,
    TENSOR_FIELDS,
    compile_scene as tcompile,
    from_jax_arrays,
)
from mafrixraytracing_tpu.integrator import path as JP
from mafrixraytracing_tpu.materials import texture as jtex
from mafrixraytracing_tpu.scene import spec as JS
from mafrixraytracing_tpu.scene.compiler import compile_scene as jcompile
import torch_port_helpers  # noqa: F401  (sizes torch's threads to the run)


def test_host_textures_equal():
    np.testing.assert_array_equal(ttex.checker_texture(), jtex.checker_texture())
    np.testing.assert_array_equal(
        ttex.checker_texture((0.9, 0.9, 0.9), (0.1, 0.3, 0.1), tiles=4, res=64),
        jtex.checker_texture((0.9, 0.9, 0.9), (0.1, 0.3, 0.1), tiles=4, res=64))
    np.testing.assert_array_equal(ttex.perlin_texture(3, 4.0, 64),
                                  jtex.perlin_texture(3, 4.0, 64))
    pages = [ttex.checker_texture(res=32), ttex.perlin_texture(1, res=48)]
    np.testing.assert_array_equal(ttex.build_atlas(pages, 64),
                                  jtex.build_atlas(pages, 64))


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_sample_atlas_matches_jax(mode):
    rs = np.random.default_rng(0)
    R = 32
    atlas = rs.random((3, R, R, 3)).astype(np.float32)
    n = 4096
    uv = rs.uniform(-2.5, 3.5, (n, 2)).astype(np.float32)   # wraps both ways
    uv[:64] = rs.integers(0, R, (64, 2)) / np.float32(R - 1)  # texel centres
    uv[64:72] = [[0.0, 0.0], [1.0, 1.0], [0.0, 1.0], [1.0, 0.0],
                 [-1.0, 2.0], [0.5, 0.5], [1e-7, 1 - 1e-7], [-1e-7, 1e-7]]
    tid = rs.integers(-2, 5, n).astype(np.int32)  # < 0 white, > K - 1 clamps
    j = np.asarray(jtex.sample_atlas(jnp.asarray(atlas), jnp.asarray(tid),
                                     jnp.asarray(uv), mode=mode))
    t = ttex.sample_atlas(torch.as_tensor(atlas), torch.as_tensor(tid),
                          torch.as_tensor(uv), mode=mode).numpy()
    assert t.shape == (n, 3)
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)
    assert (t[tid < 0] == 1.0).all() and (t[tid >= 0] != 1.0).any()


def textured_box(S, tex):
    """A checker-textured floor and back wall with a plain box on the floor,
    under an area light."""
    floor = S.make_rect_mesh((-1, 0, 1), (1, 0, 1), (1, 0, -1), (-1, 0, -1))
    back = S.make_rect_mesh((-1, 0, -1), (1, 0, -1), (1, 2, -1), (-1, 2, -1))
    uv = np.float32([[0, 0], [1, 0], [1, 1], [0, 1]])
    fu = np.int32([[0, 1, 2], [0, 2, 3]])
    floor = S.Mesh(vertices=floor.vertices, faces=floor.faces, uvs=uv * 2.0,
                   face_uvs=fu)
    back = S.Mesh(vertices=back.vertices, faces=back.faces, uvs=uv, face_uvs=fu)
    v = np.float32([[x, y, z] for x in (-0.3, 0.3) for y in (0.0, 0.6)
                    for z in (-0.3, 0.3)])
    f = np.int32([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                  [0, 5, 1], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                  [1, 5, 7], [1, 7, 3]])
    light = S.make_rect_mesh((-0.3, 1.98, -0.3), (0.3, 1.98, -0.3),
                             (0.3, 1.98, 0.3), (-0.3, 1.98, 0.3))
    return S.SceneSpec(
        camera=S.CameraSpec(position=(0.0, 1.0, 3.0), direction=(0.0, -0.1, -1.0),
                            fov=50.0, aspect=1.0, fov_convention="standard"),
        materials=[S.MaterialSpec(albedo=(1.0, 1.0, 1.0), texture_id=0),
                   S.MaterialSpec(albedo=(0.9, 0.8, 0.7), texture_id=1),
                   S.MaterialSpec(albedo=(0.6, 0.6, 0.8))],
        shapes=[S.ShapeSpec(floor, 0), S.ShapeSpec(back, 1),
                S.ShapeSpec(S.Mesh(vertices=v, faces=f), 2)],
        area_lights=[S.AreaLightSpec(light, radiance=(15.0, 15.0, 15.0),
                                     visible=True)],
        film=S.FilmSpec(width=32, height=32),
        textures=[tex.checker_texture((0.9, 0.9, 0.9), (0.1, 0.3, 0.1)),
                  tex.perlin_texture(2)])


@pytest.fixture(scope="module")
def boxes():
    jcs = jcompile(textured_box(JS, jtex))
    d = {k: np.asarray(getattr(jcs.scene, k)) for k in TENSOR_FIELDS}
    ts = from_jax_arrays(d, {k: getattr(jcs.scene, k) for k in STATIC_FLAGS},
                         device="cpu")
    tcs = tcompile(textured_box(TS, ttex), device="cpu")
    return jcs, ts, tcs


def test_textured_scene_compiles_equal(boxes):
    jcs, ts, tcs = boxes
    assert ts.has_textures and tcs.scene.has_textures
    assert tuple(ts.tex_atlas.shape) == (2, 256, 256, 3)
    for k in TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(tcs.scene, k).numpy(),
                                      np.asarray(getattr(jcs.scene, k)), err_msg=k)


def test_textured_albedo_at_hits(boxes):
    """`hit_attributes_soa` modulates the albedo by the nearest texel."""
    from mafrixraytracing_torch.ops import intersect as ti

    _, ts, tcs = boxes
    px, py = TP.make_pixel_uv(32, 32, "cpu")
    o, d = tcs.camera.get_rays((px + 0.5) / 32, (py + 0.5) / 32)
    t, idx = ti.find_closest_soa(ts, o, d, 1e-3, 1e8)
    hit, sh = tisect.hit_attributes_soa(ts, o, d, idx, t)
    m = hit.material
    want = ts.mat_albedo[m] * ttex.sample_atlas(
        ts.tex_atlas, ts.mat_tex[m], torch.stack([hit.u, hit.v], -1), "nearest")
    ok = idx >= 0
    torch.testing.assert_close(sh.albedo.arr()[ok], want[ok], rtol=0, atol=0)
    on_floor = ok & (m == 0)
    assert on_floor.sum() > 50
    # the checker's two colours both show on the floor
    assert sh.albedo.x[on_floor].min() < 0.2 < 0.8 < sh.albedo.x[on_floor].max()


def test_textured_render_matches_jax(boxes):
    jcs, ts, tcs = boxes
    W = H = 32
    compact = (1.0, 0.7, 0.3, 0.15, 0.05)
    jimg = np.asarray(JP.render_image(
        jcs.scene, jcs.camera, W, H, 4, jax.random.key(11),
        JP.PathTracerConfig(max_depth=5, compact=compact)))
    timg = TP.render_image(ts, tcs.camera, W, H, 4, trng.root_key(11, "cpu"),
                           TP.PathTracerConfig(max_depth=5, compact=compact)).numpy()
    assert np.isfinite(timg).all()
    close = np.isclose(timg, jimg, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert close.mean() >= 0.995, close.mean()
    assert abs(timg.mean() - jimg.mean()) <= 1e-4 * abs(jimg.mean())
    # and the texture is in the picture: an untextured copy differs
    plain = ts.replace(has_textures=False)
    pimg = TP.render_image(plain, tcs.camera, W, H, 4, trng.root_key(11, "cpu"),
                           TP.PathTracerConfig(max_depth=5, compact=compact)).numpy()
    assert np.abs(pimg - timg).mean() > 0.01
