"""The port's lobes, lights and compacted backward against the JAX package.

Beyond Cornell (lambert, area light): the sphere triad (metal, dielectric,
spheres), a scene with a glossy quad, a point light and an emissive sphere
(NEE for point and sphere lights, sphere-light MIS, mega triangles), and
gradients through a compacted wavefront. Same seeds and scene arrays in both
packages; tolerances as in test_torch_path.py (image rtol 1e-3 / atol 1e-4
on 99.5% of pixels, mean within 1e-4 relative; gradients rtol 1e-3 /
atol 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mafrixraytracing_torch.core import rng as trng
from mafrixraytracing_torch.integrator import path as TP
from mafrixraytracing_torch.scene import builtin as tbuiltin
from mafrixraytracing_torch.scene import spec as TS
from mafrixraytracing_torch.scene.compiler import (
    STATIC_FLAGS,
    TENSOR_FIELDS,
    compile_scene as tcompile,
    from_jax_arrays,
)
from mafrixraytracing_tpu.integrator import path as JP
from mafrixraytracing_tpu.scene import builtin as jbuiltin
from mafrixraytracing_tpu.scene import spec as JS
from mafrixraytracing_tpu.scene.compiler import compile_scene as jcompile
import torch_port_helpers  # noqa: F401  (sizes torch's threads to the run)


def lights_spec(S, size=16):
    """Glossy quad on a floor, a point light, an emissive and a lambert
    sphere (built from either package's spec module)."""
    mats = [
        S.MaterialSpec(type="lambert", albedo=(0.7, 0.7, 0.7)),
        S.MaterialSpec(type="emissive", albedo=(0, 0, 0), emission=(6.0, 5.0, 4.0)),
        S.MaterialSpec(type="glossy", albedo=(0.8, 0.8, 0.8), exponent=20.0),
    ]
    floor = S.make_rect_mesh((-3, 0, 3), (3, 0, 3), (3, 0, -3), (-3, 0, -3))
    quad = S.make_rect_mesh((-0.5, 0.01, 0.5), (0.5, 0.01, 0.5),
                            (0.5, 0.01, -0.5), (-0.5, 0.01, -0.5))
    return S.SceneSpec(
        camera=S.CameraSpec(position=(0, 1.5, 3), direction=(0, -0.4, -1),
                            fov=60, aspect=1.0, fov_convention="standard"),
        materials=mats,
        shapes=[S.ShapeSpec(floor, 0), S.ShapeSpec(quad, 2)],
        spheres=[S.SphereSpec((0.8, 0.6, -0.5), 0.3, 1),
                 S.SphereSpec((-0.7, 0.4, 0.0), 0.4, 0)],
        point_lights=[S.PointLightSpec((0.0, 2.0, 1.0), (3.0, 3.0, 3.0))],
        film=S.FilmSpec(size, size),
    )


SCENES = {
    "sphere_triad": (lambda: jbuiltin.sphere_triad(16, 16),
                     lambda: tbuiltin.sphere_triad(16, 16)),
    "lights": (lambda: lights_spec(JS), lambda: lights_spec(TS)),
}


def pair(jspec, tspec):
    jcs = jcompile(jspec)
    d = {k: np.asarray(getattr(jcs.scene, k)) for k in TENSOR_FIELDS}
    ts = from_jax_arrays(d, {k: getattr(jcs.scene, k) for k in STATIC_FLAGS},
                         device="cpu")
    return jcs, ts, tcompile(tspec, device="cpu").camera


@pytest.mark.parametrize("name", list(SCENES))
def test_render_matches_jax(name):
    jspec, tspec = (f() for f in SCENES[name])
    jcs, ts, tcam = pair(jspec, tspec)
    if name == "sphere_triad":
        assert ts.has_metal and ts.has_dielectric and ts.num_live_spheres == 4
    else:
        assert ts.has_glossy and ts.plight_mask.any() and ts.slight_mask.any()
    jimg = np.asarray(JP.render_image(jcs.scene, jcs.camera, 16, 16, 4,
                                      jax.random.key(2),
                                      JP.PathTracerConfig(max_depth=4)))
    timg = TP.render_image(ts, tcam, 16, 16, 4, trng.root_key(2, "cpu"),
                           TP.PathTracerConfig(max_depth=4)).numpy()
    close = np.isclose(timg, jimg, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert close.mean() >= 0.995, close.mean()
    assert abs(timg.mean() - jimg.mean()) <= 1e-4 * abs(jimg.mean())


def test_gradients_through_compaction_match_jax():
    """64x64 x 1 spp (4096 rays: the 1024-rounded buckets shrink and kill),
    depth 3."""
    compact = (1.0, 0.5, 0.3)
    jcs, ts, tcam = pair(jbuiltin.cornell_box(64, 64), tbuiltin.cornell_box(64, 64))
    js = jcs.scene
    jcfg = JP.PathTracerConfig(max_depth=3, compact=compact, remat=False)

    def loss(a, r, v):
        s = js.replace(mat_albedo=a, light_radiance=r, tri_v0=v)
        return jnp.mean(JP.render_image(s, jcs.camera, 64, 64, 1,
                                        jax.random.key(4), jcfg))

    jg = jax.grad(loss, argnums=(0, 1, 2))(js.mat_albedo, js.light_radiance,
                                           js.tri_v0)
    leaves = [ts.mat_albedo.clone().requires_grad_(),
              ts.light_radiance.clone().requires_grad_(),
              ts.tri_v0.clone().requires_grad_()]
    s = ts.replace(mat_albedo=leaves[0], light_radiance=leaves[1],
                   tri_v0=leaves[2])
    TP.render_image(s, tcam, 64, 64, 1, trng.root_key(4, "cpu"),
                    TP.PathTracerConfig(max_depth=3, compact=compact)
                    ).mean().backward()
    for g_j, leaf in zip(jg, leaves):
        g_j = np.asarray(g_j)
        assert np.abs(g_j).max() > 0
        np.testing.assert_allclose(leaf.grad.numpy(), g_j, rtol=1e-3, atol=1e-5)
