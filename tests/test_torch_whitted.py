"""The port's Whitted and direct-lighting integrators against the JAX package.

The same rays, made with numpy from the JAX camera's film, go through
`trace_whitted` of both packages (the JAX one on its jnp search, the port's on
the plain versions of its kernels). Nothing is random, so the two differ only
by float rounding: rtol 1e-4 / atol 1e-5 on every ray, except on Cornell,
whose short box has a face coplanar with the floor (ROADMAP section 3): there
a ray can take the other of two coplanar triangles and a shadow ray that
grazes an edge can flip, so at least 99.5% of rays must agree (a frame's
pixel-centre rays can also land on the edge a wall shares with the floor,
where the two searches' t differ by an ulp and either triangle may win); on
sphere_triad a chain of refractions through the glass sphere amplifies an ulp
a thousandfold on single rays, so 99.8% there. `trace_direct`
is compared at the same RNG keys with the tolerance of
tests/test_torch_path.py (rtol 1e-3 / atol 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafrixraytracing_torch.core import rng as trng
from mafrixraytracing_torch.core.v3 import V3 as TV3
from mafrixraytracing_torch.integrator import direct as tdirect
from mafrixraytracing_torch.integrator import whitted as tw
from mafrixraytracing_torch.ops import intersect as ti
from mafrixraytracing_tpu.core import rng as jrng
from mafrixraytracing_tpu.core.types import Rays
from mafrixraytracing_tpu.integrator import direct as jdirect
from mafrixraytracing_tpu.integrator import whitted as jw
from mafrixraytracing_tpu.scene import builtin as jbuiltin
from mafrixraytracing_tpu.scene import spec as S
from mafrixraytracing_tpu.scene.compiler import compile_scene as jcompile

from torch_port_helpers import carry_camera, carry_scene

W = H = 24


def cornell_mirror_floor():
    """tests/test_whitted.py:36: the floor rebound to a fresh mirror."""
    sc = jbuiltin.cornell_box(width=W, height=H)
    sc.shapes[0].material = len(sc.materials)
    sc.materials.append(S.MaterialSpec(type="metal", albedo=(0.95, 0.95, 0.95),
                                       fuzz=0.0))
    return sc


def cornell_glass_pane():
    """tests/test_whitted.py:68: a glass quad just in front of the camera."""
    sc = jbuiltin.cornell_box(width=W, height=H)
    pane = S.make_rect_mesh((-2, -2, 2.0), (2, -2, 2.0), (2, 2, 2.0), (-2, 2, 2.0))
    sc.materials.append(S.MaterialSpec(type="dielectric", ior=1.5))
    sc.shapes.append(S.ShapeSpec(pane, len(sc.materials) - 1))
    return sc


def point_lit_floor():
    """A floor under a point light and an area light, with a glossy ball:
    the point-light term and the glossy-shades-as-lambert branch."""
    floor = S.make_rect_mesh((-3, 0, 3), (3, 0, 3), (3, 0, -3), (-3, 0, -3))
    lamp = S.make_rect_mesh((-0.5, 3, -0.5), (0.5, 3, -0.5), (0.5, 3, 0.5),
                            (-0.5, 3, 0.5))
    return S.SceneSpec(
        camera=S.CameraSpec(position=(0.0, 1.5, 4.0), direction=(0.0, -0.3, -1.0),
                            fov=50.0, fov_convention="standard"),
        materials=[S.MaterialSpec(albedo=(0.6, 0.6, 0.6)),
                   S.MaterialSpec(type="glossy", albedo=(0.8, 0.3, 0.3), fuzz=20.0)],
        shapes=[S.ShapeSpec(floor, 0)],
        spheres=[S.SphereSpec(center=(0.0, 0.6, 0.0), radius=0.6, material=1)],
        area_lights=[S.AreaLightSpec(lamp, radiance=(8.0,) * 3, visible=True)],
        point_lights=[S.PointLightSpec(position=(1.5, 2.0, 1.0),
                                       intensity=(6.0, 5.0, 4.0))])


SCENES = {
    "furnace": (lambda: jbuiltin.furnace(W, H), 1.0),
    "sphere_triad": (lambda: jbuiltin.sphere_triad(W, H), 0.998),
    "cornell": (lambda: jbuiltin.cornell_box(W, H), 0.995),
    "mirror_floor": (cornell_mirror_floor, 0.995),
    "glass_pane": (cornell_glass_pane, 0.995),
    "point_lit_floor": (point_lit_floor, 1.0),
}


def both(name):
    jcs = jcompile(SCENES[name][0]())
    return jcs, carry_scene(jcs.scene), carry_camera(jcs.camera)


def film_rays(jcam, n=W * H, seed=0):
    """Rays through seeded film points, as numpy (origin, direction)."""
    rs = np.random.default_rng(seed)
    r = jcam.get_rays(jnp.asarray(rs.random(n), jnp.float32),
                      jnp.asarray(rs.random(n), jnp.float32))
    return np.asarray(r.origin), np.asarray(r.direction)


def as_v3(a):
    return TV3.of(torch.as_tensor(np.array(a)))


@pytest.mark.parametrize("sky", [True, False])
@pytest.mark.parametrize("name", list(SCENES))
def test_trace_whitted_matches_jax(name, sky):
    jcs, ts, _ = both(name)
    o, d = film_rays(jcs.camera)
    want = np.asarray(jw.trace_whitted(
        jcs.scene, Rays(origin=jnp.asarray(o), direction=jnp.asarray(d)),
        config=jw.WhittedConfig(max_depth=4, sky=sky, backend="jnp")))
    got = tw.trace_whitted(ts, as_v3(o), as_v3(d),
                           config=tw.WhittedConfig(max_depth=4, sky=sky)).numpy()
    assert got.shape == want.shape == (W * H, 3) and np.isfinite(got).all()
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=1)
    assert close.mean() >= SCENES[name][1], (name, close.mean())
    assert got.max() > 0.05 or (name == "furnace" and not sky)
    assert abs(got.mean() - want.mean()) <= 2e-3 * abs(want.mean())


def test_sky_gradient_matches_jax():
    d = np.float32([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0], [0.6, 0.0, 0.8],
                    [0.0, 0.28, -0.96]])
    got = tw.sky_gradient(as_v3(d)).arr().numpy()
    np.testing.assert_allclose(got, np.asarray(jw.sky_gradient(jnp.asarray(d))),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[0], (0.5, 0.7, 1.0), atol=1e-6)
    np.testing.assert_allclose(got[1], (1.0, 1.0, 1.0), atol=1e-6)


@pytest.mark.parametrize("name", ["cornell", "sphere_triad"])
def test_render_whitted_bit_equal_twice_and_close_to_jax(name):
    """No RNG anywhere: two renders are bit-identical, and the frame matches
    the JAX package's."""
    R = 32
    jcs = jcompile(getattr(jbuiltin, {"cornell": "cornell_box"}.get(name, name))(R, R))
    ts, tcam = carry_scene(jcs.scene), carry_camera(jcs.camera)
    cfg = tw.WhittedConfig(max_depth=4)
    a = tw.render_whitted(ts, tcam, R, R, cfg)
    b = tw.render_whitted(ts, tcam, R, R, cfg)
    assert a.shape == (R, R, 3) and torch.equal(a, b) and float(a.max()) > 0.0
    want = np.asarray(jw.render_whitted(
        jcs.scene, jcs.camera, R, R, jw.WhittedConfig(max_depth=4, backend="jnp")))
    close = np.isclose(a.numpy(), want, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.995, close.mean()


def test_whitted_goes_through_the_fused_search(monkeypatch):
    """Whitted is a second entry point onto the search: with `FUSED_CULL` its
    queries take the fused dispatchers, flat and two-level, same bits."""
    _, ts, tcam = both("cornell")
    cfg = tw.WhittedConfig(max_depth=3)
    want = tw.render_whitted(ts, tcam, W, H, cfg)
    for super_min_c, names in ((128, ("fused_closest_hit", "fused_any_hit")),
                               (0, ("fused_closest_super_hit",
                                    "fused_any_super_hit"))):
        calls = {n: 0 for n in names}
        monkeypatch.setattr(ti, "SUPER_MIN_C", super_min_c)
        monkeypatch.setattr(ti, "FUSED_CULL", True)
        for n in names:
            def counted(*a, _n=n, _f=getattr(ti, n)):
                calls[_n] += 1
                return _f(*a)
            monkeypatch.setattr(ti, n, counted)
        monkeypatch.setattr(ti, "closest_hit", lambda *a: pytest.fail("list path"))
        monkeypatch.setattr(ti, "any_hit", lambda *a: pytest.fail("list path"))
        assert torch.equal(tw.render_whitted(ts, tcam, W, H, cfg), want)
        assert all(v > 0 for v in calls.values()), calls
        monkeypatch.undo()


def test_mirror_and_glass_change_the_picture():
    """The delta recursion really traces: a mirror floor differs from the
    lambert floor in the bottom rows, and a glass pane dims the scene
    without hiding it (tests/test_whitted.py:29, :65)."""
    cfg = tw.WhittedConfig(max_depth=4)
    imgs = {}
    for name in ("cornell", "mirror_floor", "glass_pane"):
        _, ts, tcam = both(name)
        imgs[name] = tw.render_whitted(ts, tcam, W, H, cfg).numpy()
    assert np.abs(imgs["cornell"][-6:] - imgs["mirror_floor"][-6:]).max() > 0.05
    assert imgs["glass_pane"].max() > 0.1
    assert imgs["glass_pane"].mean() < imgs["cornell"].mean() + 1e-6


def test_empty_scene_is_sky():
    jcs = jcompile(S.SceneSpec(shapes=[], area_lights=[]))
    img = tw.render_whitted(carry_scene(jcs.scene), carry_camera(jcs.camera), 8, 8,
                            tw.WhittedConfig(max_depth=4))
    assert float(img.min()) > 0.4


@pytest.mark.parametrize("name", ["cornell", "sphere_triad", "point_lit_floor"])
def test_trace_direct_matches_jax(name):
    """One bounce with NEE at the same keys."""
    jcs, ts, _ = both(name)
    o, d = film_rays(jcs.camera, seed=3)
    n = o.shape[0]
    jkeys = jrng.pixel_keys(jax.random.key(11), n)
    tkeys = trng.pixel_keys(trng.root_key(11, "cpu"), n)
    want = np.asarray(jdirect.trace_direct(
        jcs.scene, Rays(origin=jnp.asarray(o), direction=jnp.asarray(d)), jkeys,
        backend="jnp"))
    got = tdirect.trace_direct(ts, as_v3(o), as_v3(d), tkeys).numpy()
    assert tdirect.direct_config().max_depth == 1
    assert tdirect.direct_config(mis=False).mis is False
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=1)
    assert close.mean() >= 0.995, close.mean()
    assert abs(got.mean() - want.mean()) <= 1e-3 * abs(want.mean())
    assert got.mean() > 0.01
