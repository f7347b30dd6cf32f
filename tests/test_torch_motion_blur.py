"""Motion blur in the port against the JAX package: time-sampled rays and
moving spheres (the reference's `MovingSphere` and time-interval camera,
`RenderTest/Sample/RayTracing.fs:210-253, 335-364`).

The three cases of tests/test_motion_blur.py are ported, and the time-shifted
functions are held against the JAX package on the same numpy inputs:
`closest_sphere_soa` and `find_closest_soa` (`idx` equal, `t` within rtol
1e-4 / atol 1e-5), `hit_attributes_soa` (rtol 1e-4 / atol 1e-5), the moving
sphere light of NEE, and a 32x32 `render_image` with `motion_blur=True` at the
same seed, plain and through the compacted loop, with the tolerance of
tests/test_torch_path.py (rtol 1e-3 / atol 1e-4 on 99.5% of pixels, the mean
within 1e-4 relative).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafrixraytracing_torch.core import rng as trng
from mafrixraytracing_torch.core.v3 import V3 as TV3
from mafrixraytracing_torch.geometry import intersect as tisect
from mafrixraytracing_torch.integrator import path as TP
from mafrixraytracing_torch.ops import intersect as ti
from mafrixraytracing_tpu.core.v3 import V3 as JV3
from mafrixraytracing_tpu.geometry import intersect as jisect
from mafrixraytracing_tpu.integrator import path as JP
from mafrixraytracing_tpu.ops import intersect_pallas as ip
from mafrixraytracing_tpu.scene import spec as S
from mafrixraytracing_tpu.scene.compiler import compile_scene as jcompile

from torch_port_helpers import carry_camera, carry_scene

T_MIN = 1e-3


def moving_scene(velocity, light_velocity=None):
    """tests/test_motion_blur.py:13: a red sphere moving over a floor under
    an area light; optionally a moving emissive sphere too."""
    floor = S.make_rect_mesh((-4, 0, 4), (4, 0, 4), (4, 0, -4), (-4, 0, -4))
    light = S.make_rect_mesh((-1, 3, -1), (1, 3, -1), (1, 3, 1), (-1, 3, 1))
    materials = [S.MaterialSpec(albedo=(0.75, 0.75, 0.75)),
                 S.MaterialSpec(albedo=(0.9, 0.2, 0.2))]
    spheres = [S.SphereSpec(center=(-0.8, 0.5, 0.0), radius=0.5, material=1,
                            velocity=velocity)]
    if light_velocity is not None:
        materials.append(S.MaterialSpec(type="emissive", emission=(9.0, 8.0, 6.0)))
        spheres.append(S.SphereSpec(center=(1.2, 1.4, 0.3), radius=0.3, material=2,
                                    velocity=light_velocity))
    jcs = jcompile(S.SceneSpec(
        camera=S.CameraSpec(position=(0.0, 1.0, 4.0), direction=(0.0, -0.1, -1.0),
                            fov=50.0, fov_convention="standard"),
        materials=materials, shapes=[S.ShapeSpec(floor, 0)], spheres=spheres,
        area_lights=[S.AreaLightSpec(light, radiance=(14.0,) * 3, visible=False)]))
    return jcs, carry_scene(jcs.scene), carry_camera(jcs.camera)


def render(ts, tcam, motion_blur, spp=24, w=32, h=32, compact=()):
    cfg = TP.PathTracerConfig(max_depth=2, rr_enable=False,
                              motion_blur=motion_blur, compact=compact)
    return TP.render_image(ts, tcam, w, h, spp, trng.root_key(3, "cpu"), cfg).numpy()


def seeded_rays(jcam, n, seed):
    rs = np.random.default_rng(seed)
    r = jcam.get_rays(jnp.asarray(rs.random(n), jnp.float32),
                      jnp.asarray(rs.random(n), jnp.float32))
    return (np.array(r.origin), np.array(r.direction),
            rs.random(n).astype(np.float32))


def both_v3(a):
    return JV3.of(jnp.asarray(a)), TV3.of(torch.as_tensor(a))


# --- the three cases of tests/test_motion_blur.py -------------------------------


def test_moving_sphere_blurs():
    """A sphere moving +x over the shutter: with motion blur on, coverage
    spreads along x; a sphere that stands still is unaffected by the flag."""
    _, ts, tcam = moving_scene((1.6, 0.0, 0.0))
    img_off, img_on = render(ts, tcam, False), render(ts, tcam, True)

    def red_cols(img):
        red = (img[..., 0] > img[..., 1] * 1.5) & (img[..., 0] > 0.02)
        return red.any(axis=0)

    assert red_cols(img_on).sum() > red_cols(img_off).sum() + 2
    _, ss, scam = moving_scene((0.0, 0.0, 0.0))
    s_off, s_on = render(ss, scam, False), render(ss, scam, True)
    np.testing.assert_allclose(s_on.mean(), s_off.mean(), rtol=0.05)
    # the flag draws no random number the render otherwise uses
    np.testing.assert_array_equal(s_on, s_off)


def test_velocity_reaches_scene():
    jcs, ts, _ = moving_scene((1.0, 2.0, 3.0), light_velocity=(0.5, 0.0, -0.5))
    np.testing.assert_allclose(ts.sph_velocity[0].numpy(), (1, 2, 3))
    np.testing.assert_array_equal(ts.sph_velocity.numpy(),
                                  np.asarray(jcs.scene.sph_velocity))
    np.testing.assert_array_equal(ts.slight_velocity.numpy(),
                                  np.asarray(jcs.scene.slight_velocity))
    assert np.abs(ts.slight_velocity.numpy()).max() == 0.5


def test_moving_sphere_shades_on_surface():
    """The attribute recompute shifts the centre as the search does: at t = 1
    a unit sphere of velocity (2, 0, 0) is hit at (2, 0, 1), normal (0, 0, 1)."""
    jcs = jcompile(S.SceneSpec(
        materials=[S.MaterialSpec()],
        spheres=[S.SphereSpec(center=(0.0, 0.0, 0.0), radius=1.0, material=0,
                              velocity=(2.0, 0.0, 0.0))]))
    ts = carry_scene(jcs.scene)
    B = 8
    o = TV3(torch.full((B,), 2.0), torch.zeros(B), torch.full((B,), 5.0))
    d = TV3(torch.zeros(B), torch.zeros(B), torch.full((B,), -1.0))
    times = torch.ones(B)
    for search in (tisect.find_closest, ti.find_closest_soa):
        t, idx = search(ts, o, d, 1e-3, 1e8, times=times)
        assert bool((idx >= 0).all())
        np.testing.assert_allclose(t.numpy(), 4.0, atol=1e-4)
    assert not bool((ti.find_closest_soa(ts, o, d, 1e-3, 1e8)[1] >= 0).any())
    assert bool(ti.occluded_soa(ts, o, d, 1e-3, 1e8, times=times).all())
    assert not bool(ti.occluded_soa(ts, o, d, 1e-3, 1e8).any())
    hit, _ = tisect.hit_attributes_soa(ts, o, d, idx, t, times=times)
    np.testing.assert_allclose(hit.normal.arr().numpy(), [[0.0, 0.0, 1.0]] * B,
                               atol=1e-4)
    np.testing.assert_allclose(hit.point.arr().numpy(), [[2.0, 0.0, 1.0]] * B,
                               atol=1e-4)


# --- against the JAX package on the same inputs ---------------------------------


@pytest.mark.parametrize("fused", [False, True])
def test_time_shifted_search_matches_jax(monkeypatch, fused):
    """`closest_sphere_soa` and the cluster search with `times`, list and
    fused-cull paths: the clustered triangles are static, only the sphere
    merge moves."""
    monkeypatch.setattr(ip, "FUSED_CULL", fused)
    monkeypatch.setattr(ti, "FUSED_CULL", fused)
    jcs, ts, _ = moving_scene((1.6, 0.3, -0.4), light_velocity=(0.0, -0.8, 0.5))
    o, d, times = seeded_rays(jcs.camera, 300, seed=2)
    (jo, to), (jd, td) = both_v3(o), both_v3(d)
    t_max = np.full(300, 1e8, np.float32)
    t_j, i_j = jisect._closest_sphere_soa(
        jcs.scene, jo, jd, jnp.full((300,), T_MIN), jnp.asarray(t_max),
        times=jnp.asarray(times))
    t_t, i_t = tisect.closest_sphere_soa(ts, to, td, T_MIN, torch.as_tensor(t_max),
                                         times=torch.as_tensor(times))
    hit = np.asarray(t_j) < 1e29
    assert hit.sum() > 20
    np.testing.assert_array_equal(i_t.numpy()[hit], np.asarray(i_j)[hit])
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), rtol=1e-4, atol=1e-5)
    t_j, i_j = ip.find_closest_soa(jcs.scene, jo, jd, T_MIN, 1e8, interpret=True,
                                   times=jnp.asarray(times))
    t_t, i_t = ti.find_closest_soa(ts, to, td, T_MIN, 1e8,
                                   times=torch.as_tensor(times))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), rtol=1e-4, atol=1e-5)
    # the shift matters: without times other spheres are hit
    assert (ti.find_closest_soa(ts, to, td, T_MIN, 1e8)[1] != i_t).any()
    occ_j = ip.occluded_soa(jcs.scene, jo, jd, T_MIN, jnp.asarray(t_j * 0.99 + 5.0),
                            interpret=True, times=jnp.asarray(times))
    occ_t = ti.occluded_soa(ts, to, td, T_MIN, torch.as_tensor(np.asarray(t_j) * 0.99 + 5.0),
                            times=torch.as_tensor(times))
    np.testing.assert_array_equal(occ_t.numpy(), np.asarray(occ_j))


def test_time_shifted_attributes_match_jax():
    jcs, ts, _ = moving_scene((1.6, 0.3, -0.4), light_velocity=(0.0, -0.8, 0.5))
    o, d, times = seeded_rays(jcs.camera, 300, seed=4)
    (jo, to), (jd, td) = both_v3(o), both_v3(d)
    tt = torch.as_tensor(times)
    t, idx = ti.find_closest_soa(ts, to, td, T_MIN, 1e8, times=tt)
    jh, jsh = jisect.hit_attributes_soa(
        jcs.scene, jo, jd, jnp.asarray(idx.numpy().astype(np.int32)),
        jnp.asarray(t.numpy()), times=jnp.asarray(times))
    th, tsh = tisect.hit_attributes_soa(ts, to, td, idx, t, times=tt)
    T = ts.tri_v0.shape[0]
    assert (idx >= T).sum() > 20
    for name in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(th, name).numpy(),
                                   np.asarray(getattr(jh, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    for name in ("point", "normal"):
        np.testing.assert_allclose(getattr(th, name).arr().numpy(),
                                   np.asarray(getattr(jh, name).arr()),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(tsh.light_pdf_sa.numpy(), np.asarray(jsh.light_pdf_sa),
                               rtol=1e-4, atol=1e-5)
    # hit points of a moving sphere lie on the shifted sphere
    c = ts.sph_center[0] + ts.sph_velocity[0] * tt[:, None]
    on0 = idx == T
    r = (th.point.arr() - c).norm(dim=1)[on0]
    np.testing.assert_allclose(r.numpy(), 0.5, atol=1e-4)


@pytest.mark.parametrize("compact", [(), (1.0, 0.6, 0.3)])
def test_motion_blur_render_matches_jax(compact):
    """32x32 x 4 spp, depth 3, a moving sphere, at the same seed; also
    through the compacted loop, which must carry the times along with the
    lanes it keeps. (No sphere light here: the JAX package's NEE hands one
    time per path to a query of one shadow ray per light row and fails on
    the shapes; the port repeats the times, see the next test.)"""
    jcs, ts, tcam = moving_scene((1.6, 0.0, 0.0))
    W = H = 32
    kw = dict(max_depth=3, motion_blur=True, compact=compact)
    want = np.asarray(JP.render_image(jcs.scene, jcs.camera, W, H, 4,
                                      jax.random.key(7),
                                      JP.PathTracerConfig(backend="jnp", **kw)))
    got = TP.render_image(ts, tcam, W, H, 4, trng.root_key(7, "cpu"),
                          TP.PathTracerConfig(**kw)).numpy()
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert close.mean() >= 0.995, close.mean()
    assert abs(got.mean() - want.mean()) <= 1e-4 * abs(want.mean())
    off = TP.render_image(ts, tcam, W, H, 4, trng.root_key(7, "cpu"),
                          TP.PathTracerConfig(max_depth=3, compact=compact)).numpy()
    assert np.abs(got - off).mean() > 1e-3     # the flag changes the picture


def test_moving_sphere_light_nee_matches_jax():
    """`nee_sphere_soa` samples a moving sphere light at its shifted centre:
    against the JAX function on the same hits, keys and times (visibility
    stubbed to unoccluded), and in a render, where the port's shadow queries
    repeat each path's time once per light row."""
    from mafrixraytracing_torch.lights import lights as TL
    from mafrixraytracing_tpu.core import rng as jrng
    from mafrixraytracing_tpu.lights import lights as JL

    jcs, ts, tcam = moving_scene((0.0, 0.0, 0.0), light_velocity=(0.0, -0.8, 0.5))
    n = 400
    o, d, times = seeded_rays(jcs.camera, n, seed=6)
    (jo, to), (jd, td) = both_v3(o), both_v3(d)
    tt = torch.as_tensor(times)
    t, idx = ti.find_closest_soa(ts, to, td, T_MIN, 1e8, times=tt)
    jh, jsh = jisect.hit_attributes_soa(
        jcs.scene, jo, jd, jnp.asarray(idx.numpy().astype(np.int32)),
        jnp.asarray(t.numpy()), times=jnp.asarray(times))
    th, tsh = tisect.hit_attributes_soa(ts, to, td, idx, t, times=tt)
    jkeys = jrng.pixel_keys(jax.random.key(5), n)
    tkeys = trng.pixel_keys(trng.root_key(5, "cpu"), n)
    outs = {}
    for label, tm in (("moving", times), ("static", None)):
        want = JL.nee_sphere_soa(
            jcs.scene, jh, jkeys, lambda so, sd, a, b: jnp.zeros(so.x.shape, bool),
            jsh, times=None if tm is None else jnp.asarray(tm))
        got = TL.nee_sphere_soa(
            ts, th, tkeys, lambda so, sd, a, b: torch.zeros_like(so.x, dtype=torch.bool),
            tsh, times=None if tm is None else torch.as_tensor(tm))
        np.testing.assert_allclose(got.arr().numpy(), np.asarray(want.arr()),
                                   rtol=1e-3, atol=1e-5)
        outs[label] = got.arr().numpy()
    assert outs["moving"].max() > 0.05
    assert np.abs(outs["moving"] - outs["static"]).mean() > 1e-3
    on, off = render(ts, tcam, True, spp=4), render(ts, tcam, False, spp=4)
    assert np.isfinite(on).all() and np.abs(on - off).mean() > 1e-3


def test_flat_pixels_sample_the_shutter():
    """`render_flat_pixels` draws the shutter time from the same stream as
    `render_image`: with one sample a pixel the two agree bit for bit."""
    _, ts, tcam = moving_scene((1.6, 0.0, 0.0))
    W = H = 16
    cfg = TP.PathTracerConfig(max_depth=2, rr_enable=False, motion_blur=True)
    ids = torch.arange(W * H)
    on = TP.render_flat_pixels(ts, tcam, ids, W, H, 2, trng.root_key(3, "cpu"), cfg)
    off = TP.render_flat_pixels(ts, tcam, ids, W, H, 2, trng.root_key(3, "cpu"),
                                TP.PathTracerConfig(max_depth=2, rr_enable=False))
    assert torch.isfinite(on).all() and not torch.equal(on, off)
