"""The port's scene compiler and camera against the JAX package.

Every `TorchScene` field must equal the JAX `ScenePytree` field compiled
from the same spec, `from_jax_arrays` must carry a JAX scene over unchanged,
and the cameras must produce the same rays: origins within rtol 1e-6, unit
directions within 1e-6 of the vector's length (float32 `tan` and the
normalisation round differently in the two libraries by an ulp or two, which
a component near zero would turn into a large relative error).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafrixraytracing_torch.camera.camera import Camera as TCamera
from mafrixraytracing_torch.geometry.intersect import packed_attr_table
from mafrixraytracing_torch.scene import builtin as tbuiltin
from mafrixraytracing_torch.scene.compiler import (
    STATIC_FLAGS,
    TENSOR_FIELDS,
    compile_scene as tcompile,
    from_jax_arrays,
)
from mafrixraytracing_tpu.camera.camera import Camera as JCamera
from mafrixraytracing_tpu.geometry import intersect as jisect
from mafrixraytracing_tpu.scene import builtin as jbuiltin
from mafrixraytracing_tpu.scene.compiler import compile_scene as jcompile
import torch_port_helpers  # noqa: F401  (sizes torch's threads to the run)

SCENES = ["cornell_box", "sphere_triad", "furnace"]


def jax_scene_arrays(scene):
    """A JAX ScenePytree flattened to numpy, plus its static fields."""
    d = {k: np.asarray(getattr(scene, k)) for k in TENSOR_FIELDS}
    flags = {k: getattr(scene, k) for k in STATIC_FLAGS}
    return d, flags


@pytest.mark.parametrize("name", SCENES)
def test_compile_scene_fields_equal(name):
    js = jcompile(getattr(jbuiltin, name)()).scene
    ts = tcompile(getattr(tbuiltin, name)(), device="cpu").scene
    for k in TENSOR_FIELDS:
        a = np.asarray(getattr(js, k))
        b = getattr(ts, k).numpy()
        assert a.shape == b.shape, (k, a.shape, b.shape)
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)
    for k in STATIC_FLAGS:
        assert getattr(js, k) == getattr(ts, k), k


def moving_spheres():
    """A moving sphere and a moving emissive sphere: non-zero `sph_velocity`
    and `slight_velocity`, which motion blur reads."""
    from mafrixraytracing_tpu.scene import spec as S

    return S.SceneSpec(
        materials=[S.MaterialSpec(albedo=(0.9, 0.2, 0.2)),
                   S.MaterialSpec(type="emissive", emission=(9.0, 8.0, 6.0))],
        spheres=[S.SphereSpec(center=(-0.8, 0.5, 0.0), radius=0.5, material=0,
                              velocity=(1.6, 0.25, -0.5)),
                 S.SphereSpec(center=(1.2, 1.4, 0.3), radius=0.3, material=1,
                              velocity=(0.0, -0.8, 0.5))])


@pytest.mark.parametrize("name", SCENES + ["moving_spheres"])
def test_from_jax_arrays_round_trip(name):
    spec = moving_spheres() if name == "moving_spheres" else getattr(jbuiltin, name)()
    js = jcompile(spec).scene
    d, flags = jax_scene_arrays(js)
    if name == "moving_spheres":
        assert np.abs(d["sph_velocity"]).max() == 1.6
        assert np.abs(d["slight_velocity"]).max() == 0.8
    ts = from_jax_arrays(d, flags, device="cpu")
    for k in TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(ts, k).numpy(), d[k], err_msg=k)
    back = {k: getattr(ts, k).numpy() for k in TENSOR_FIELDS}
    rebuilt = js.replace(**{k: jnp.asarray(v) for k, v in back.items()})
    for k in TENSOR_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(rebuilt, k)), d[k])
    for k in STATIC_FLAGS:
        assert getattr(ts, k) == flags[k]


@pytest.mark.parametrize("name", SCENES)
def test_packed_attr_table_equal(name):
    js = jcompile(getattr(jbuiltin, name)()).scene
    ts = tcompile(getattr(tbuiltin, name)(), device="cpu").scene
    np.testing.assert_array_equal(np.asarray(jisect.packed_attr_table(js)),
                                  packed_attr_table(ts).numpy())


def _film(n=97, seed=0):
    rs = np.random.default_rng(seed)
    return (rs.random(n).astype(np.float32), rs.random(n).astype(np.float32),
            rs.random((n, 2)).astype(np.float32))


def _compare_rays(jcam, tcam, lens):
    u, v, luv = _film()
    jr = jcam.get_rays(jnp.asarray(u), jnp.asarray(v),
                       lens_uv=jnp.asarray(luv) if lens else None)
    o, d = tcam.get_rays(torch.as_tensor(u), torch.as_tensor(v),
                         lens_uv=torch.as_tensor(luv) if lens else None)
    np.testing.assert_allclose(o.arr().numpy(), np.asarray(jr.origin),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(d.arr().numpy(), np.asarray(jr.direction),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("convention", ["mafrix", "standard"])
@pytest.mark.parametrize("lens", [False, True])
def test_pinhole_rays_match(convention, lens):
    args = ((0.0, 1.0, 3.0), (0.1, -0.2, -1.0), 75.0, 1.5)
    jcam = JCamera.pinhole(*args, fov_convention=convention)
    tcam = TCamera.pinhole(*args, fov_convention=convention, device="cpu")
    _compare_rays(jcam, tcam, lens)


def test_thin_lens_rays_match():
    args = ((0.3, 0.7, 2.0), (0.0, 0.0, -1.0), 60.0, 2.0)
    jcam = JCamera.thin_lens(*args, aperture=0.2, focus_dist=2.5)
    tcam = TCamera.thin_lens(*args, aperture=0.2, focus_dist=2.5, device="cpu")
    _compare_rays(jcam, tcam, lens=True)
    jcam = JCamera.thin_lens(*args, aperture=0.1)
    tcam = TCamera.thin_lens(*args, aperture=0.1, device="cpu")
    _compare_rays(jcam, tcam, lens=True)


def test_compiled_camera_matches():
    jcs = jcompile(jbuiltin.cornell_box(48, 32))
    tcs = tcompile(tbuiltin.cornell_box(48, 32), device="cpu")
    _compare_rays(jcs.camera, tcs.camera, lens=True)
    assert (tcs.film_width, tcs.film_height) == (48, 32)


def test_default_device_is_the_card():
    """With no device argument the entry points build on the CUDA card; on
    a machine without one they raise instead of giving CPU tensors."""
    from mafrixraytracing_torch.core import rng as trng
    from mafrixraytracing_torch.core.device import resolve

    assert resolve("cpu") == torch.device("cpu")
    calls = [lambda: tcompile(tbuiltin.cornell_box(8, 8)),
             lambda: TCamera.pinhole((0, 1, 3), (0, 0, -1), 60.0, 1.0),
             lambda: TCamera.thin_lens((0, 1, 3), (0, 0, 0), 60.0, 1.0, 0.1),
             lambda: trng.root_key(0),
             lambda: resolve(None)]
    if torch.cuda.is_available():
        assert resolve(None).type == "cuda"
        assert trng.root_key(0).is_cuda
        assert tcompile(tbuiltin.cornell_box(8, 8)).scene.tri_v0.is_cuda
    else:
        for call in calls:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
