"""The port's integrator against the JAX package's, on the CPU.

Same seed, same scene arrays: the port's RNG is bit-exact, so both trace the
same paths and differ only by float rounding. Tolerances:
- the image: rtol 1e-3 / atol 1e-4 on at least 99.5% of pixels, and the
  image mean within 1e-4 relative. The allowance is for branch flips: a
  grazing ray whose hit or shadow test lands within rounding of an edge can
  take a different path in the two packages.
- gradients: rtol 1e-3 / atol 1e-5 of `jax.grad`.
- `trace_stats` query counts and survival profile: exact.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafrixraytracing_torch.core import rng as trng
from mafrixraytracing_torch.integrator import path as TP
from mafrixraytracing_torch.scene.compiler import (
    STATIC_FLAGS,
    TENSOR_FIELDS,
    compile_scene as tcompile,
    from_jax_arrays,
)
from mafrixraytracing_torch.scene import builtin as tbuiltin
from mafrixraytracing_tpu.core import rng as jrng
from mafrixraytracing_tpu.integrator import path as JP
from mafrixraytracing_tpu.scene import builtin as jbuiltin
from mafrixraytracing_tpu.scene.compiler import compile_scene as jcompile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPACT = (1.0, 0.7, 0.3, 0.15, 0.05)


def cornell(w, h):
    jcs = jcompile(jbuiltin.cornell_box(w, h))
    d = {k: np.asarray(getattr(jcs.scene, k)) for k in TENSOR_FIELDS}
    ts = from_jax_arrays(d, {k: getattr(jcs.scene, k) for k in STATIC_FLAGS},
                         device="cpu")
    return jcs, ts, tcompile(tbuiltin.cornell_box(w, h), device="cpu").camera


@pytest.mark.parametrize("B", [100, 1000, 1024, 4096, 65536, 524288])
@pytest.mark.parametrize("sched", [COMPACT, (1.0, 0.85, 0.59, 0.48, 0.07),
                                   (1.0, 1.0, 0.999, 0.2, 0.0)])
def test_compact_buckets_match(B, sched):
    jc = JP.PathTracerConfig(max_depth=5, compact=sched)
    tc = TP.PathTracerConfig(max_depth=5, compact=sched)
    assert TP.compact_buckets(tc, B) == JP.compact_buckets(jc, B)


def test_tile_order_and_groups_match():
    for G in (1, 2, 8, 16):
        assert TP._spp_tile_shape(G) == JP._spp_tile_shape(G)
        jp, ji = JP.tiled_pixel_order(48, 40, *JP._spp_tile_shape(G))
        tp, tinv = TP.tiled_pixel_order(48, 40, *TP._spp_tile_shape(G))
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tinv, ji)
    for spp, B, target in ((64, 65536, 1 << 19), (2, 1024, 1 << 19),
                           (6, 300, 1000), (1, 4096, 1024)):
        assert TP._spp_group(spp, B, target) == JP._spp_group(spp, B, target)


@pytest.mark.parametrize("size,compact", [(32, ()), (32, COMPACT),
                                          (64, COMPACT)])
def test_trace_stats_counts_exact(size, compact):
    """Same rays (the JAX camera's, handed over as numpy), same keys: the
    query count and the survival profile are equal. At 64x64 the buckets
    are small enough that population-control kills happen."""
    from mafrixraytracing_torch.core.v3 import V3

    W = H = size
    jcs, ts, _ = cornell(W, H)
    jcfg = JP.PathTracerConfig(max_depth=5, compact=compact)
    tcfg = TP.PathTracerConfig(max_depth=5, compact=compact)
    px, py = JP.make_pixel_uv(W, H)
    jrays = jcs.camera.get_rays((px + 0.5) / W, (py + 0.5) / H)
    jkeys = jrng.pixel_keys(jax.random.key(123), W * H)
    jq, jprof = jax.jit(lambda s, r: JP.trace_stats(s, r, jkeys, jcfg,
                                                    return_profile=True))(
        jcs.scene, jrays)
    o = V3.of(torch.as_tensor(np.asarray(jrays.origin)))
    d = V3.of(torch.as_tensor(np.asarray(jrays.direction)))
    tq, tprof = TP.trace_stats(ts, o, d, trng.pixel_keys(trng.root_key(123, "cpu"), W * H),
                               tcfg, return_profile=True)
    assert float(tq) == float(jq)
    np.testing.assert_array_equal(tprof.numpy(), np.asarray(jprof))
    if size == 64:
        buckets = TP.compact_buckets(tcfg, W * H)
        assert (tprof.numpy()[1:] * W * H <= np.asarray(buckets[1:])).all()
        assert tprof[1] * W * H == buckets[1]  # a kill happened


def own_camera_rays(name, W, H):
    """Each package compiles the scene and makes its own camera rays."""
    from mafrixraytracing_torch.scene.compiler import compile_scene

    jcs = jcompile(getattr(jbuiltin, name)(W, H))
    tcs = compile_scene(getattr(tbuiltin, name)(W, H), device="cpu")
    px, py = JP.make_pixel_uv(W, H)
    jrays = jcs.camera.get_rays((px + 0.5) / W, (py + 0.5) / H)
    tpx, tpy = TP.make_pixel_uv(W, H, "cpu")
    o, d = tcs.camera.get_rays((tpx + 0.5) / W, (tpy + 0.5) / H)
    return jcs, tcs, jrays, o, d


@pytest.mark.parametrize("name", ["cornell_box", "furnace", "sphere_triad"])
def test_own_camera_directions_within_2ulp(name):
    """A recorded rounding difference: the float32 `tan` of XLA and ATen
    differ by an ulp for some fields of view, so the cameras' plane vectors,
    and then the unit directions, differ by up to 2 ulp of 1. Where the
    cameras' vectors are equal (furnace) the directions are bit-equal."""
    jcs, tcs, jrays, o, d = own_camera_rays(name, 64, 64)
    np.testing.assert_array_equal(o.arr().numpy(), np.asarray(jrays.origin))
    diff = np.abs(d.arr().numpy() - np.asarray(jrays.direction)).max()
    assert diff <= 2 * np.finfo(np.float32).eps, diff
    if name == "furnace":
        assert diff == 0.0


@pytest.mark.parametrize("name", ["furnace", "sphere_triad"])
def test_trace_stats_own_cameras_exact(name):
    """Own cameras, own rays: on a scene with no coplanar faces a 2-ulp
    difference in direction flips no hit, so the query count and the
    survival profile are equal."""
    W = H = 32
    jcs, tcs, jrays, o, d = own_camera_rays(name, W, H)
    jcfg = JP.PathTracerConfig(max_depth=5, compact=COMPACT)
    tcfg = TP.PathTracerConfig(max_depth=5, compact=COMPACT)
    jkeys = jrng.pixel_keys(jax.random.key(123), W * H)
    jq, jprof = jax.jit(lambda s, r: JP.trace_stats(s, r, jkeys, jcfg,
                                                    return_profile=True))(
        jcs.scene, jrays)
    tq, tprof = TP.trace_stats(
        tcs.scene, o, d, trng.pixel_keys(trng.root_key(123, "cpu"), W * H),
        tcfg, return_profile=True)
    assert float(tq) == float(jq)
    np.testing.assert_array_equal(tprof.numpy(), np.asarray(jprof))


def test_render_image_matches_jax():
    W = H = 32
    jcs, ts, tcam = cornell(W, H)
    jimg = np.asarray(JP.render_image(
        jcs.scene, jcs.camera, W, H, 2, jax.random.key(7),
        JP.PathTracerConfig(max_depth=5, compact=COMPACT)))
    timg = TP.render_image(ts, tcam, W, H, 2, trng.root_key(7, "cpu"),
                           TP.PathTracerConfig(max_depth=5, compact=COMPACT))
    timg = timg.numpy()
    assert timg.shape == (H, W, 3) and np.isfinite(timg).all()
    close = np.isclose(timg, jimg, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert close.mean() >= 0.995, close.mean()
    assert abs(timg.mean() - jimg.mean()) <= 1e-4 * abs(jimg.mean())


def test_render_image_mafrix_matches_jax():
    """The reference-parity estimator through `render_image`, with the same
    tolerances as the physical one."""
    W = H = 16
    jcs, ts, tcam = cornell(W, H)
    jimg = np.asarray(JP.render_image(
        jcs.scene, jcs.camera, W, H, 2, jax.random.key(7),
        JP.PathTracerConfig(max_depth=3, estimator="mafrix", backend="jnp")))
    timg = TP.render_image(ts, tcam, W, H, 2, trng.root_key(7, "cpu"),
                           TP.PathTracerConfig(max_depth=3, estimator="mafrix"))
    timg = timg.numpy()
    assert TP.PathTracerConfig().estimator == "physical"
    close = np.isclose(timg, jimg, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(timg.mean() - jimg.mean()) <= 1e-3 * abs(jimg.mean())
    assert timg.mean() > 0.01


def test_gradients_match_jax():
    W = H = 16
    jcs, ts, tcam = cornell(W, H)
    js = jcs.scene
    jcfg = JP.PathTracerConfig(max_depth=5, remat=False)

    def loss(a, r, v):
        s = js.replace(mat_albedo=a, light_radiance=r, tri_v0=v)
        return jnp.mean(JP.render_image(s, jcs.camera, W, H, 1,
                                        jax.random.key(3), jcfg))

    jg = jax.grad(loss, argnums=(0, 1, 2))(js.mat_albedo, js.light_radiance,
                                           js.tri_v0)
    leaves = [ts.mat_albedo.clone().requires_grad_(),
              ts.light_radiance.clone().requires_grad_(),
              ts.tri_v0.clone().requires_grad_()]
    s = ts.replace(mat_albedo=leaves[0], light_radiance=leaves[1],
                   tri_v0=leaves[2])
    TP.render_image(s, tcam, W, H, 1, trng.root_key(3, "cpu"),
                    TP.PathTracerConfig(max_depth=5)).mean().backward()
    for g_j, leaf in zip(jg, leaves):
        g_j = np.asarray(g_j)
        assert np.abs(g_j).max() > 0
        np.testing.assert_allclose(leaf.grad.numpy(), g_j, rtol=1e-3, atol=1e-5)


def test_runs_without_jax():
    """The port imports and renders with JAX unavailable."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "import mafrixraytracing_torch as mt\n"
        "from mafrixraytracing_torch import bench\n"
        "from mafrixraytracing_torch.core import rng\n"
        "from mafrixraytracing_torch.scene.builtin import cornell_box\n"
        "cs = mt.compile_scene(cornell_box(8, 8), device='cpu')\n"
        "img = mt.render_image(cs.scene, cs.camera, 8, 8, 2,\n"
        "    rng.root_key(1, 'cpu'),\n"
        "    mt.PathTracerConfig(compact=(1.0, 0.7, 0.3, 0.15, 0.05)))\n"
        "assert img.shape == (8, 8, 3) and bool(img.isfinite().all())\n"
        "assert float(img.mean()) > 0\n"
        "from mafrixraytracing_torch.opt import inverse\n"
        "fitted, losses = inverse.fit(cs.scene, cs.camera, img.detach(),\n"
        "    ('mat_albedo', 'mesh_vertices'), steps=2, spp=1,\n"
        "    config=mt.PathTracerConfig(max_depth=2), smooth_geometry=1)\n"
        "assert len(losses) == 2 and all(l == l for l in losses)\n"
        "assert not any(m.startswith('mafrixraytracing_tpu') for m in sys.modules)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_forward_without_grad_leaves_no_graph():
    _, ts, tcam = cornell(8, 8)
    leaf = ts.mat_albedo.clone().requires_grad_()
    img = TP.render_image(ts.replace(mat_albedo=leaf), tcam, 8, 8, 1,
                          trng.root_key(0, "cpu"), TP.PathTracerConfig())
    assert img.requires_grad
    with torch.no_grad():
        img = TP.render_image(ts.replace(mat_albedo=leaf), tcam, 8, 8, 1,
                              trng.root_key(0, "cpu"), TP.PathTracerConfig())
    assert not img.requires_grad
