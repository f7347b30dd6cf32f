"""The port's inverse-rendering pieces against the JAX package's, on the CPU.

Same arrays through both packages (`device="cpu"`; JAX with `backend="jnp"`):
- `refresh_clusters`: the four bound arrays exactly equal (min/max only);
- `apply_params`: derived caches exactly equal, a shared vertex's gradient is
  the sum over its faces, moved geometry is found by the port's search;
- `smooth_vertex_grads`, `image_loss`: rtol 1e-6 (a handful of float32
  operations in the same order);
- `render_flat_pixels` / `render_sample_batch`: rtol 1e-4 / atol 1e-5 at the
  same key with the JAX camera's vectors handed over (the port sums a
  pixel's samples in another order than the JAX scan);
- the mafrix estimator: rtol 1e-4 / atol 1e-5 of `_trace_mafrix` at the same
  rays and keys, and the converged-mean criterion of `tests/test_parity.py`
  against `golden_numpy.py` at a smaller size.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_numpy import GoldenScene, render as golden_render
from torch_port_helpers import carry_camera, carry_scene, floor_spec
from mafrixraytracing_torch.accel.clusters import refresh_clusters as t_refresh
from mafrixraytracing_torch.core import rng as trng
from mafrixraytracing_torch.core.v3 import V3
from mafrixraytracing_torch.geometry import intersect as tgi
from mafrixraytracing_torch.integrator import path as TP
from mafrixraytracing_torch.ops import intersect as toi
from mafrixraytracing_torch.opt import inverse as tinv
from mafrixraytracing_tpu.accel.clusters import refresh_clusters as j_refresh
from mafrixraytracing_tpu.core import rng as jrng
from mafrixraytracing_tpu.integrator import path as JP
from mafrixraytracing_tpu.opt import inverse as jinv
from mafrixraytracing_tpu.parallel.render import _render_flat_pixels
from mafrixraytracing_tpu.scene import builtin as jbuiltin
from mafrixraytracing_tpu.scene import spec as S
from mafrixraytracing_tpu.scene.compiler import compile_scene as jcompile

BOUNDS = ("cluster_min", "cluster_max", "super_min", "super_max")


def bumpy_mesh(rows=100, cols=100, seed=5):
    """A displaced sphere of 20,000 triangles: 256 clusters, 16 superclusters."""
    rs = np.random.default_rng(seed)
    th = np.linspace(0.02, np.pi - 0.02, rows + 1)[:, None]
    ph = np.linspace(0.0, 2.0 * np.pi, cols, endpoint=False)[None, :]
    r = 1.0 + 0.05 * rs.normal(size=(rows + 1, cols))
    v = np.stack([r * np.sin(th) * np.cos(ph), r * np.cos(th),
                  r * np.sin(th) * np.sin(ph)], axis=-1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    a = (i * cols + j).ravel()
    b = (i * cols + (j + 1) % cols).ravel()
    c = ((i + 1) * cols + j).ravel()
    d = ((i + 1) * cols + (j + 1) % cols).ravel()
    faces = np.concatenate([np.stack([a, c, b], 1), np.stack([b, c, d], 1)])
    mesh = S.Mesh(vertices=v.astype(np.float32), faces=faces.astype(np.int32))
    ground = S.make_rect_mesh((-9, -2, -9), (9, -2, -9), (9, -2, 9), (-9, -2, 9))
    return S.SceneSpec(materials=[S.MaterialSpec()],
                       shapes=[S.ShapeSpec(mesh, 0), S.ShapeSpec(ground, 0)])


# --- refresh_clusters --------------------------------------------------------


def assert_bounds_equal(ts, js):
    for k in BOUNDS:
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)), err_msg=k)


@pytest.mark.parametrize("name", ["cornell", "bumpy"])
def test_refresh_clusters_equals_jax(name):
    js = jcompile(jbuiltin.cornell_box(16, 16) if name == "cornell"
                  else bumpy_mesh()).scene
    if name == "bumpy":
        assert js.cluster_min.shape[0] > 128 and js.num_mega >= 2
    ts = carry_scene(js)
    # as compiled: the refresh reproduces the host build's bounds
    assert_bounds_equal(t_refresh(ts), j_refresh(js))
    assert_bounds_equal(t_refresh(ts), js)
    # after moving every vertex by a seeded field
    rs = np.random.default_rng(2)
    dv = rs.normal(0.0, 0.3, js.tri_v0.shape).astype(np.float32)
    de = rs.normal(0.0, 0.1, js.tri_e1.shape).astype(np.float32)
    jm = j_refresh(js.replace(tri_v0=js.tri_v0 + dv, tri_e1=js.tri_e1 + de))
    tm = t_refresh(ts.replace(tri_v0=ts.tri_v0 + torch.as_tensor(dv),
                              tri_e1=ts.tri_e1 + torch.as_tensor(de)))
    assert_bounds_equal(tm, jm)
    assert not np.array_equal(tm.cluster_min.numpy(), np.asarray(js.cluster_min))
    # the refreshed bounds feed pack_bounds, which must cover the table
    if name == "bumpy":
        assert toi.pack_bounds(tm).shape[0] == tm.super_min.shape[0]


def test_refresh_clusters_drops_mega_pads_and_detaches():
    """`mega_ids == -1` pads are dropped, not wrapped to the last triangle;
    bounds carry no gradient."""
    js = jcompile(floor_spec(light=False)).scene
    ts = carry_scene(js)
    assert (ts.mega_ids == -1).any()
    # put a live, clustered triangle in the last row, where -1 would wrap to
    last = ts.tri_v0.shape[0] - 1
    mask = ts.tri_mask.clone()
    mask[last] = True
    v0 = ts.tri_v0.clone()
    v0[last] = torch.tensor([5.0, 6.0, 7.0])
    e1 = ts.tri_e1.clone()
    e1[last] = torch.tensor([1.0, 0.0, 0.0])
    leaf = v0.requires_grad_()
    out = t_refresh(ts.replace(tri_v0=leaf, tri_e1=e1, tri_mask=mask))
    assert not out.cluster_max.requires_grad
    assert out.cluster_max[-1].tolist() == [6.0, 6.0, 7.0]
    jout = j_refresh(js.replace(tri_v0=jnp.asarray(v0.detach().numpy()),
                                tri_e1=jnp.asarray(e1.numpy()),
                                tri_mask=jnp.asarray(mask.numpy())))
    assert_bounds_equal(out, jout)


# --- apply_params -------------------------------------------------------------


def test_mesh_vertex_param_shares_gradients():
    js = jcompile(floor_spec(light=False)).scene
    ts = carry_scene(js)
    mv = ts.mesh_vertices.clone().requires_grad_()
    derived = tinv.apply_params(ts, {"mesh_vertices": mv})
    jderived = jinv.apply_params(js, {"mesh_vertices": js.mesh_vertices})
    live = ts.tri_mask.numpy()
    for k in ("tri_v0", "tri_e1", "tri_e2"):
        np.testing.assert_array_equal(getattr(derived, k).detach().numpy()[live],
                                      getattr(ts, k).numpy()[live])
        np.testing.assert_array_equal(getattr(derived, k).detach().numpy(),
                                      np.asarray(getattr(jderived, k)))
    assert_bounds_equal(derived, jderived)
    w = ts.tri_mask[:, None]
    torch.where(w, derived.tri_v0 * 1.0 + derived.tri_e1 * 2.0
                + derived.tri_e2 * 3.0, 0.0).sum().backward()
    f = ts.tri_face_vi.numpy()
    expect = np.zeros_like(ts.mesh_vertices.numpy())
    for t in np.nonzero(live)[0]:
        expect[f[t, 0]] += 1.0 - 2.0 - 3.0
        expect[f[t, 1]] += 2.0
        expect[f[t, 2]] += 3.0
    np.testing.assert_allclose(mv.grad.numpy(), expect, atol=1e-5)
    assert np.unique(f[live]).size == 4

    def jloss(m):
        s = jinv.apply_params(js, {"mesh_vertices": m})
        return jnp.sum(jnp.where(js.tri_mask[:, None], s.tri_v0 * 1.0
                                 + s.tri_e1 * 2.0 + s.tri_e2 * 3.0, 0.0))

    np.testing.assert_allclose(mv.grad.numpy(),
                               np.asarray(jax.grad(jloss)(js.mesh_vertices)),
                               atol=1e-5)


def test_mesh_vertex_update_refreshes_accel():
    """A quad moved +2 in y, far outside its original cluster box, is found
    at its new height (t = 3) by the port's cluster search: `apply_params`
    refreshed the bounds."""
    quad = S.make_rect_mesh((-0.5, 0.0, -0.5), (0.5, 0.0, -0.5),
                            (0.5, 0.0, 0.5), (-0.5, 0.0, 0.5))
    ground = S.make_rect_mesh((-10, -5, -10), (10, -5, -10),
                              (10, -5, 10), (-10, -5, 10))
    ts = carry_scene(jcompile(S.SceneSpec(
        materials=[S.MaterialSpec()],
        shapes=[S.ShapeSpec(quad, 0), S.ShapeSpec(ground, 0)])).scene)
    assert ts.num_mega >= 2
    mv = ts.mesh_vertices.clone()
    rows = torch.nonzero(mv[:, 1].abs() < 1e-6)[:4, 0]
    mv[rows, 1] += 2.0
    n = 256
    o = V3.of(torch.tensor([[0.0, 5.0, 0.0]]).repeat(n, 1))
    d = V3.of(torch.tensor([[0.0, -1.0, 0.0]]).repeat(n, 1))
    moved = tinv.apply_params(ts, {"mesh_vertices": mv})
    t_c, i_c = toi.find_closest_soa(moved, o, d, 1e-3, 1e8)
    t_b, i_b = tgi.find_closest(moved, o, d, 1e-3, 1e8)
    assert torch.equal(i_c, i_b)
    np.testing.assert_allclose(t_c.numpy(), 3.0, atol=1e-4)
    assert moved.cluster_max[:, 1].max() == 2.0


def test_apply_params_clips_albedo():
    ts = carry_scene(jcompile(floor_spec(light=False)).scene)
    alb = ts.mat_albedo.clone()
    alb[0] = torch.tensor([1.7, -0.2, 0.5])
    alb[1] = torch.tensor([1.0, 0.0, 0.25])
    alb.requires_grad_()
    out = tinv.apply_params(ts, {"mat_albedo": alb})
    assert out.mat_albedo[0].tolist() == [1.0, 0.0, 0.5]
    # at a bound half the gradient passes, as through `jnp.clip`
    out.mat_albedo[:2].sum().backward()
    assert alb.grad[:2].tolist() == [[0.0, 0.0, 1.0], [0.5, 0.5, 1.0]]
    jg = jax.grad(lambda a: jnp.sum(jinv.apply_params(
        jcompile(floor_spec(light=False)).scene, {"mat_albedo": a}).mat_albedo[:2]))(
            jnp.asarray(alb.detach().numpy()))
    np.testing.assert_array_equal(alb.grad.numpy(), np.asarray(jg))
    assert out.cluster_min is ts.cluster_min      # no geometry, no refresh
    assert tinv.extract_params(ts, ("mat_albedo",))["mat_albedo"] is ts.mat_albedo


# --- smooth_vertex_grads, image_loss ----------------------------------------


def test_smooth_vertex_grads_matches_jax():
    js = jcompile(bumpy_mesh(12, 12)).scene
    ts = carry_scene(js)
    g = np.random.default_rng(0).normal(size=js.mesh_vertices.shape).astype(np.float32)
    for iters in (1, 4):
        want = np.asarray(jinv.smooth_vertex_grads(js, jnp.asarray(g), iters=iters))
        got = tinv.smooth_vertex_grads(ts, torch.as_tensor(g), iters=iters).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_smooth_vertex_grads_properties():
    ts = carry_scene(jcompile(floor_spec(light=False)).scene)
    V = ts.mesh_vertices.shape[0]
    live = np.zeros(V, bool)
    live[np.unique(ts.tri_face_vi.numpy()[ts.tri_mask.numpy()])] = True
    const = torch.as_tensor(np.where(live[:, None], [[0.0, 2.0, 0.0]], 0.0)
                            .astype(np.float32))
    out = tinv.smooth_vertex_grads(ts, const, iters=6)
    np.testing.assert_allclose(out.numpy()[live], const.numpy()[live], atol=1e-5)
    noise = torch.as_tensor(np.where(
        live[:, None], np.random.default_rng(0).normal(size=(V, 3)), 0.0)
        .astype(np.float32))
    sm = tinv.smooth_vertex_grads(ts, noise, iters=6).numpy()
    assert np.abs(sm[live]).mean() < 0.7 * np.abs(noise.numpy()[live]).mean()


def test_image_loss_matches_jax():
    rs = np.random.default_rng(4)
    img = rs.uniform(0.0, 3.0, (64, 3)).astype(np.float32)
    target = rs.uniform(0.0, 3.0, (64, 3)).astype(np.float32)
    want = float(jinv.image_loss(jnp.asarray(img), jnp.asarray(target)))
    got = float(tinv.image_loss(torch.as_tensor(img), torch.as_tensor(target)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert float(tinv.image_loss(torch.as_tensor(target),
                                 torch.as_tensor(target))) == 0.0


# --- render_flat_pixels, render_sample_batch ---------------------------------


@pytest.mark.parametrize("name", ["furnace", "sphere_triad"])
def test_render_flat_pixels_matches_jax(name):
    W, H = 16, 12
    jcs = jcompile(getattr(jbuiltin, name)(W, H))
    jcs = jcs.replace(scene=jcs.scene.replace(
        background=jnp.ones((3,), jnp.float32)))
    ts, tcam = carry_scene(jcs.scene), carry_camera(jcs.camera)
    jcfg = JP.PathTracerConfig(max_depth=3, backend="jnp")
    tcfg = TP.PathTracerConfig(max_depth=3)
    ids = np.random.default_rng(1).permutation(W * H)[:100]
    for spp, offset in ((3, 0), (2, 5)):
        want = np.asarray(_render_flat_pixels(
            jcs.scene, jcs.camera, jnp.asarray(ids, jnp.int32), W, H, spp,
            jax.random.key(9), jcfg, sample_offset=offset))
        got = TP.render_flat_pixels(ts, tcam, torch.as_tensor(ids), W, H, spp,
                                    trng.root_key(9, "cpu"), tcfg,
                                    sample_offset=offset).numpy()
        assert got.shape == (100, 3) and got.max() > 0.01
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # one wavefront per sample gives the same image as the grouped one
    one = TP.render_flat_pixels(ts, tcam, torch.as_tensor(ids), W, H, 2,
                                trng.root_key(9, "cpu"),
                                TP.PathTracerConfig(max_depth=3, wavefront=100),
                                sample_offset=5).numpy()
    np.testing.assert_allclose(one, got, rtol=1e-5, atol=1e-6)


def test_render_sample_batch_matches_jax():
    W = H = 12
    jcs = jcompile(jbuiltin.sphere_triad(W, H))
    ts, tcam = carry_scene(jcs.scene), carry_camera(jcs.camera)
    for s in (0, 3):
        want = np.asarray(JP.render_sample_batch(
            jcs.scene, jcs.camera, W, H, s, jax.random.key(42),
            JP.PathTracerConfig(max_depth=2, rr_enable=False, backend="jnp")))
        got = TP.render_sample_batch(
            ts, tcam, W, H, s, trng.root_key(42, "cpu"),
            TP.PathTracerConfig(max_depth=2, rr_enable=False)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# --- the mafrix estimator ------------------------------------------------------


@pytest.mark.parametrize("name", ["sphere_triad", "cornell_box"])
def test_mafrix_estimator_matches_jax(name):
    """Same rays, same keys, through `trace_radiance`; and the compacted loop
    gives the uncompacted image while every bucket holds the live lanes."""
    W = H = 16
    jcs = jcompile(getattr(jbuiltin, name)(W, H))
    ts = carry_scene(jcs.scene)
    px, py = JP.make_pixel_uv(W, H)
    jrays = jcs.camera.get_rays((px + 0.5) / W, (py + 0.5) / H)
    jkeys = jrng.pixel_keys(jax.random.key(5), W * H)
    want = np.asarray(JP.trace_radiance(
        jcs.scene, jrays, jkeys,
        JP.PathTracerConfig(max_depth=4, estimator="mafrix", backend="jnp")))
    o = V3.of(torch.as_tensor(np.array(jrays.origin)))
    d = V3.of(torch.as_tensor(np.array(jrays.direction)))
    tkeys = trng.pixel_keys(trng.root_key(5, "cpu"), W * H)
    cfg = TP.PathTracerConfig(max_depth=4, estimator="mafrix")
    got = TP.trace_radiance(ts, o, d, tkeys, cfg).numpy()
    assert want.max() > 0.01
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=-1)
    # Cornell's coplanar faces let a rounding difference flip a hit
    assert close.mean() >= (1.0 if name == "sphere_triad" else 0.99), close.mean()
    full = TP.trace_radiance(
        ts, o, d, tkeys,
        TP.PathTracerConfig(max_depth=4, estimator="mafrix",
                            compact=(1.0, 1.0, 1.0, 1.0))).numpy()
    np.testing.assert_array_equal(full, got)
    with pytest.raises(ValueError, match="estimator"):
        TP.trace_radiance(ts, o, d, tkeys, TP.PathTracerConfig(estimator="x"))


@pytest.mark.parametrize("compact", [(), (1.0, 0.9, 0.8, 0.7)])
def test_mafrix_estimator_matches_golden_cornell(compact):
    """The converged-mean criterion of `tests/test_parity.py` against the
    numpy transcription of the reference algorithm, at 16x16 x 64 spp, also
    through the compacted loop."""
    W = H = 16
    SPP, DEPTH = 64, 3
    from mafrixraytracing_torch.scene.builtin import cornell_box
    from mafrixraytracing_torch.scene.compiler import compile_scene

    cs = compile_scene(cornell_box(width=W, height=H, light_visible=False),
                       device="cpu")
    sc = cs.scene
    mask = sc.tri_mask.numpy()
    s, h = 0.235, 1.98
    golden = GoldenScene(
        sc.tri_v0.numpy()[mask], sc.tri_e1.numpy()[mask], sc.tri_e2.numpy()[mask],
        sc.mat_albedo.numpy()[sc.tri_mat.numpy()[mask]],
        (-s, h, -s), (2 * s, 0, 0), (0, 0, 2 * s), (0, -1, 0), (10.0, 10.0, 10.0))
    img_g = golden_render(golden, (0, 1, 3), (0, 0, -1), 120.0, W, H, SPP, DEPTH,
                          seed=3)
    cfg = TP.PathTracerConfig(estimator="mafrix", max_depth=DEPTH + 1,
                              rr_enable=False, compact=compact)
    with torch.no_grad():
        img_f = TP.render_image(sc, cs.camera, W, H, SPP,
                                trng.root_key(11, "cpu"), cfg).numpy()

    def blocks(img):
        return img.reshape(H // 4, 4, W // 4, 4, 3).mean(axis=(1, 3))

    bg, bf = blocks(img_g), blocks(img_f)
    np.testing.assert_allclose(bf.mean(), bg.mean(), rtol=0.05)
    rel = np.abs(bf - bg) / np.maximum(bg, 0.02)
    assert (rel < 0.15).mean() > 0.9, rel.max()
    assert np.sign(bf[:, 0, 0].mean() - bf[:, 0, 1].mean()) == np.sign(
        bg[:, 0, 0].mean() - bg[:, 0, 1].mean())
