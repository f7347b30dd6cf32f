"""The port's rasterizer (`mafrixraytracing_torch/raster/pipeline.py`) against
the JAX package's `rasterize` on the CPU and against an independent numpy
golden (a copy of the one in `tests/test_raster.py`).

Both packages get the same camera matrices, the JAX package's `look_at` /
`perspective` / `orthographic` as numpy arrays (the camera factories are held
within 2 ulp on their own). Images agree within atol 1e-5 where both draw
the same face. The vertex stage is a product with 4x4 matrices that XLA's
CPU dot and ATen sum in different orders, so a pixel centre within an ulp
of a shared edge may change face: the winners must agree on at least 99.9%
of the pixels, and the count that differs is printed. The JAX package does
not expose its winners; a second render with a texture that codes each
face's index in its colour reads them out.

Two faults of the JAX version are not copied (`ROADMAP.md` §3, "Recorded
differences"), and a test shows each with both packages' values: normals
under a rotation (`test_rotated_normals_follow_apply_normal`) and slivers
(`test_sliver_covers_nothing`). A third: the JAX vertex gradient is NaN at
vertex 0 when the faces are padded to a chunk multiple
(`test_gradients_match_jax`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafrixraytracing_torch.core import transform as T
from mafrixraytracing_torch.raster import pipeline as R
from mafrixraytracing_tpu.core import transform as JT
from mafrixraytracing_tpu.raster import pipeline as JR
import torch_port_helpers  # noqa: F401  (sizes torch's threads to the run)

W = H = 24
N = 64                      # side of the mesh renders


def _lights(mod, *spec):
    return tuple(mod.RasterLight(*s) for s in spec)


AMBIENT = (("ambient", (1.0, 1.0, 1.0)),)
MESH_LIGHTS = (("ambient", (0.3, 0.3, 0.3)), ("directional", (0.9, 0.9, 0.9), (0, -1, -1)))


def _ortho_cam():
    view = JR.look_at((0.0, 0.0, 5.0), (0.0, 0.0, 0.0))
    proj = JR.orthographic(1.0, 1.0, near=0.1, far=100.0)
    return np.asarray(view), np.asarray(proj)


def _np_raster(vertices, faces, view, proj, w, h, cull=True):
    """Independent NumPy edge-function rasterizer: per-pixel winning face id
    and barycentrics (mirrors the reference's DrawTrangle semantics)."""
    V = np.asarray(vertices, np.float64)
    vh = np.concatenate([V, np.ones((V.shape[0], 1))], axis=1)
    clip = vh @ np.asarray(view, np.float64).T @ np.asarray(proj, np.float64).T
    ndc = clip[:, :3] / clip[:, 3:4]
    sx = (ndc[:, 0] * 0.5 + 0.5) * w
    sy = (0.5 - ndc[:, 1] * 0.5) * h
    sz = ndc[:, 2]
    best = np.full((h * w,), -1, np.int64)
    zbuf = np.full((h * w,), np.inf)
    px = np.tile(np.arange(w) + 0.5, h)
    py = np.repeat(np.arange(h) + 0.5, w)
    for fi, f in enumerate(np.asarray(faces)):
        x0, x1, x2 = sx[f]
        y0, y1, y2 = sy[f]
        z0, z1, z2 = sz[f]
        area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
        if cull and area >= 0:
            continue
        if abs(area) < 1e-8:
            continue
        w0 = ((x1 - px) * (y2 - py) - (x2 - px) * (y1 - py)) / area
        w1 = ((x2 - px) * (y0 - py) - (x0 - px) * (y2 - py)) / area
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        z = w0 * z0 + w1 * z1 + w2 * z2
        upd = inside & (z > -1) & (z < 1) & (z < zbuf)
        zbuf[upd] = z[upd]
        best[upd] = fi
    return best.reshape(h, w), zbuf.reshape(h, w)


def _both(V, F, view, proj, n=None, uv=None, tex=None, model=None, lights=AMBIENT,
          w=W, h=H, **kw):
    """(port image, JAX image) as numpy, from the same numpy inputs."""
    V = np.asarray(V, np.float32)
    n = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (V.shape[0], 1)) if n is None else n
    uv = np.zeros((V.shape[0], 2), np.float32) if uv is None else uv
    tex = np.ones((2, 2, 3), np.float32) if tex is None else tex
    model = np.eye(4, dtype=np.float32) if model is None else np.asarray(model, np.float32)
    args = (V, np.asarray(F, np.int32), n, uv, model, view, proj, tex)
    port = R.rasterize(*(torch.from_numpy(np.array(a)) for a in args), w, h,
                       lights=_lights(R, *lights), **kw).numpy()
    ref = np.asarray(JR.rasterize(*(jnp.asarray(a) for a in args), w, h,
                                  lights=_lights(JR, *lights), **kw))
    return port, ref


def _port_faces(V, F, view, proj, model=None, w=W, h=H, chunk=64, cull_backfaces=True):
    """The port's winners: the face each pixel shows, -1 where none."""
    model = np.eye(4, dtype=np.float32) if model is None else np.asarray(model, np.float32)
    v, f, m, vw, pj = (torch.from_numpy(np.array(a)) for a in
                       (np.asarray(V, np.float32), np.asarray(F, np.int64), model, view,
                        proj))
    sx, sy, sz, _, _ = R._screen(v, m, vw, pj, w, h)
    return R._search(sx, sy, sz, f, w, h, chunk, cull_backfaces)[1].reshape(h, w).numpy()


def test_coverage_matches_numpy_golden():
    """Random mesh: the set of covered pixels matches the independent numpy
    rasterizer, and the image JAX's."""
    rng = np.random.default_rng(0)
    V = rng.uniform(-0.9, 0.9, (18, 3)).astype(np.float32)
    F = np.arange(18).reshape(6, 3)
    view, proj = _ortho_cam()
    img, ref = _both(V, F, view, proj, cull_backfaces=False)
    best, _ = _np_raster(V, F, view, proj, W, H, cull=False)
    np.testing.assert_array_equal(img.sum(axis=-1) > 0, best >= 0)
    np.testing.assert_array_equal(_port_faces(V, F, view, proj, cull_backfaces=False), best)
    np.testing.assert_allclose(img, ref, atol=1e-5)


def test_zbuffer_near_wins():
    """Two stacked quads: the nearer one owns the overlap (z-buffered write,
    reference `Core/RenderTarget.fs:15-20`)."""
    V = np.array(
        [[-0.8, -0.8, -1], [-0.8, 0.8, -1], [0.8, 0.8, -1], [0.8, -0.8, -1],
         [-0.3, -0.3, 0], [-0.3, 0.3, 0], [0.3, 0.3, 0], [0.3, -0.3, 0]],
        np.float32,
    )
    F = np.array([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]], np.int32)
    view, proj = _ortho_cam()
    best, _ = _np_raster(V, F, view, proj, W, H, cull=False)
    assert best[H // 2, W // 2] in (2, 3)  # near quad wins the center
    img, ref = _both(V, F, view, proj, cull_backfaces=False)
    np.testing.assert_array_equal(img.sum(-1) > 0, best >= 0)
    # which quad each pixel shows (on a quad's diagonal either triangle may win)
    np.testing.assert_array_equal(
        _port_faces(V, F, view, proj, cull_backfaces=False) // 2, best // 2)
    np.testing.assert_allclose(img, ref, atol=1e-5)


def test_backface_culling():
    """Reversed-winding triangle disappears when culling is on (reference
    `RemoveBackfaces`, `Core/Pipeline.fs:14-21`)."""
    V = np.array([[-0.5, -0.5, 0], [0.5, -0.5, 0], [0, 0.5, 0]], np.float32)
    view, proj = _ortho_cam()
    img_back, ref_back = _both(V, [[0, 2, 1]], view, proj, cull_backfaces=True)
    img_front, ref_front = _both(V, [[0, 1, 2]], view, proj, cull_backfaces=True)
    assert img_back.sum() == 0.0
    assert img_front.sum() > 0.0
    np.testing.assert_allclose(img_back, ref_back, atol=1e-5)
    np.testing.assert_allclose(img_front, ref_front, atol=1e-5)


def test_perspective_correct_interpolation():
    """A uv-textured slanted quad: affine interpolation (the reference's
    `DrawTrangle`) and perspective-correct sampling differ, and each equals
    JAX's."""
    V = np.array([[-1, -0.5, 3], [1, -0.5, 3], [1, 0.5, -3], [-1, 0.5, -3]], np.float32)
    F = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    view = np.asarray(JR.look_at((0.0, 0.0, 6.0), (0.0, 0.0, 0.0)))
    proj = np.asarray(JR.perspective(60.0, 1.0, near=0.5, far=50.0))
    ramp = np.linspace(0, 1, 64, dtype=np.float32)
    tex = np.tile(ramp[:, None, None], (1, 64, 3))
    affine, ref_affine = _both(V, F, view, proj, uv=uv, tex=tex, cull_backfaces=False)
    correct, ref_correct = _both(V, F, view, proj, uv=uv, tex=tex, cull_backfaces=False,
                                 perspective_correct=True)
    assert np.abs(affine - correct).max() > 0.02  # they genuinely differ
    np.testing.assert_allclose(affine, ref_affine, atol=1e-5)
    np.testing.assert_allclose(correct, ref_correct, atol=1e-5)


# --- a seeded mesh at 64x64 ------------------------------------------------

def _mesh(nf=400, seed=0):
    """A seeded soup of `nf` triangles about the origin with per-vertex
    normals, random uvs and a random 32x32 texture."""
    rs = np.random.default_rng(seed)
    c = rs.uniform(-0.7, 0.7, (nf, 1, 3))
    V = (c + rs.normal(0.0, 0.15, (nf, 3, 3))).reshape(-1, 3).astype(np.float32)
    F = np.arange(3 * nf, dtype=np.int32).reshape(nf, 3)
    n = (V / np.linalg.norm(V, axis=1, keepdims=True)).astype(np.float32)
    uv = rs.uniform(-0.5, 1.5, (3 * nf, 2)).astype(np.float32)
    tex = rs.uniform(0.0, 1.0, (32, 32, 3)).astype(np.float32)
    return V, F, n, uv, tex


def _mesh_cam():
    return (np.asarray(JR.look_at((0.0, 0.3, 2.2), (0.0, 0.0, 0.0))),
            np.asarray(JR.perspective(40.0, 1.0, near=0.2, far=20.0)))


def _id_uvs_texture(nf):
    """uvs and a 32x32 texture that give face f the colour (1, g, b) with
    g = (1 + f % 31) / 32, b = (1 + f // 31) / 32 (texel centres, so the
    interpolation's rounding cannot move a sample)."""
    f = np.repeat(np.arange(nf), 3)
    uv = np.stack([(f % 31 + 0.5) / 31.0, 1.0 - (f // 31 + 0.5) / 31.0], 1).astype(np.float32)
    ty, tx = np.mgrid[0:32, 0:32]
    tex = np.stack([np.ones((32, 32)), (1 + tx) / 32.0, (1 + ty) / 32.0], -1).astype(np.float32)
    return uv, tex


def _decode_faces(img):
    """The face index each pixel of an id render shows, -1 on the background."""
    r = np.maximum(img[..., 0], 1e-30)
    tx = np.rint(img[..., 1] / r * 32.0 - 1.0)
    ty = np.rint(img[..., 2] / r * 32.0 - 1.0)
    return np.where(img[..., 0] > 0, ty * 31 + tx, -1).astype(np.int64)


MODELS = {"identity": np.eye(4, dtype=np.float32),
          "nonuniform_scale": np.diag([1.25, 0.8, 1.1, 1.0]).astype(np.float32)}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_mesh_against_jax(model):
    """400 faces at 64x64, perspective-correct and textured, under the
    identity and under a non-uniform scale (a symmetric matrix, for which the
    two packages' normal matrices agree)."""
    V, F, n, uv, tex = _mesh()
    view, proj = _mesh_cam()
    m = MODELS[model]
    kw = dict(n=n, model=m, lights=MESH_LIGHTS, w=N, h=N, perspective_correct=True)
    img, ref = _both(V, F, view, proj, uv=uv, tex=tex, **kw)
    id_uv, id_tex = _id_uvs_texture(F.shape[0])
    ids, ref_ids = (_decode_faces(a) for a in _both(V, F, view, proj, uv=id_uv,
                                                     tex=id_tex, **kw))
    port_faces = _port_faces(V, F, view, proj, model=m, w=N, h=N)
    np.testing.assert_array_equal(ids, port_faces)          # the decoding is exact
    same = port_faces == ref_ids
    print(f"{model}: {int((~same).sum())} of {same.size} pixels show another face "
          f"than JAX's; {int((port_faces >= 0).sum())} covered")
    assert same.mean() >= 0.999
    assert 0.3 < (port_faces >= 0).mean() < 0.95
    np.testing.assert_allclose(img[same], ref[same], atol=1e-5)


def test_camera_matrices_within_2ulp():
    """Every entry within 2 ulp, but `look_at`'s translation column, -rot @
    eye, a sum that cancels: XLA's CPU dot takes it as a chain of fused
    multiply-adds and ATen's in another order, so it is held within 2 ulp of
    its largest term."""
    rs = np.random.default_rng(5)
    for _ in range(8):
        eye, target = rs.normal(size=3) * 3, rs.normal(size=3)
        up = (0.0, 1.0, 0.0)
        got = R.look_at(tuple(eye), tuple(target), up, device="cpu").numpy()
        want = np.asarray(JR.look_at(tuple(eye), tuple(target), up))
        np.testing.assert_array_max_ulp(got[:, :3], want[:, :3], maxulp=2)
        np.testing.assert_array_equal(got[3], want[3])
        terms = np.abs(want[:3, :3] * eye.astype(np.float32)).max(axis=1)
        assert (np.abs(got[:3, 3] - want[:3, 3]) <= 2 * np.spacing(terms)).all()
    for fov, aspect in ((40.0, 1.0), (60.0, 16 / 9), (27.3, 0.75)):
        np.testing.assert_array_max_ulp(
            R.perspective(fov, aspect, 0.2, 20.0, device="cpu").numpy(),
            np.asarray(JR.perspective(fov, aspect, 0.2, 20.0)), maxulp=2)
    np.testing.assert_array_max_ulp(
        R.orthographic(1.5, 0.7, 0.1, 30.0, device="cpu").numpy(),
        np.asarray(JR.orthographic(1.5, 0.7, 0.1, 30.0)), maxulp=2)


def _port_mesh_args(V, F, n, uv, tex, model=None):
    view, proj = _mesh_cam()
    model = np.eye(4, dtype=np.float32) if model is None else model
    return tuple(torch.from_numpy(np.array(a)) for a in (V, F, n, uv, model, view, proj, tex))


def test_chunk_does_not_change_the_frame():
    """The lowest face index wins a tie whatever the chunk: 16, 7 (a short
    last chunk) and 64 give the same bits."""
    args = _port_mesh_args(*_mesh())
    lights = _lights(R, *MESH_LIGHTS)
    ref = R.rasterize(*args, N, N, lights=lights, chunk=64, perspective_correct=True)
    frames = [R._frame(*args, N, N, lights, c, True, True, (0.0, 0.0, 0.0))
              for c in (64, 16, 7)]
    assert torch.equal(frames[0][0], ref)
    for img, best, texel in frames[1:]:
        assert torch.equal(img, ref)
        assert torch.equal(best, frames[0][1]) and torch.equal(texel, frames[0][2])


def _scan(sx, sy, sz, faces, w, h, chunk, cull):
    """A direct port of the JAX scan (`pipeline.py:153-212`), padding with
    index-0 faces and carrying the winner's w0, w1 (b_u, b_v), with the
    port's front rule (|area| > 1e-8)."""
    F = faces.shape[0]
    Fp = (F + chunk - 1) // chunk * chunk
    fpad = torch.zeros((Fp, 3), dtype=torch.int64)
    fpad[:F] = faces
    valid = torch.arange(Fp) < F
    PX = (torch.arange(w, dtype=torch.float32) + 0.5)[None, :].repeat(h, 1).reshape(-1)
    PY = (torch.arange(h, dtype=torch.float32) + 0.5).repeat_interleave(w)
    P = w * h
    zbuf = torch.full((P,), torch.inf)
    best = torch.full((P,), -1, dtype=torch.int64)
    b_u, b_v = torch.zeros(P), torch.zeros(P)
    for base in range(0, Fp, chunk):
        f, vmask = fpad[base:base + chunk], valid[base:base + chunk]
        x0, x1, x2 = (sx[f[:, k]] for k in range(3))
        y0, y1, y2 = (sy[f[:, k]] for k in range(3))
        z0, z1, z2 = (sz[f[:, k]] for k in range(3))
        area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
        big = area.abs() > 1e-8
        front = (area < 0.0) & big if cull else big
        inv_area = torch.where(big, 1.0 / area, 0.0)
        dx, dy = PX[:, None], PY[:, None]
        w0 = ((x1 - dx) * (y2 - dy) - (x2 - dx) * (y1 - dy)) * inv_area[None]
        w1 = ((x2 - dx) * (y0 - dy) - (x0 - dx) * (y2 - dy)) * inv_area[None]
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        z = w0 * z0[None] + w1 * z1[None] + w2 * z2[None]
        ok = inside & front[None] & vmask[None] & (z > -1) & (z < 1) & (z < zbuf[:, None])
        z = torch.where(ok, z, torch.inf)
        arg = torch.argmin(z, dim=1)

        def take(a):
            return torch.take_along_dim(a, arg[:, None], dim=1)[:, 0]

        znew = take(z)
        better = torch.isfinite(znew) & (znew < zbuf)
        zbuf = torch.where(better, znew, zbuf)
        best = torch.where(better, base + arg, best)
        b_u = torch.where(better, take(w0), b_u)
        b_v = torch.where(better, take(w1), b_v)
    return zbuf, best, b_u, b_v


@pytest.mark.parametrize("cull", [True, False])
def test_winner_search_matches_the_scan(cull):
    """The no-grad search plus the per-pixel recompute give the bits of the
    scan that carries the barycentrics."""
    V, F, n, uv, tex = _mesh()
    args = _port_mesh_args(V, F, n, uv, tex)
    v, f, n_, uv_, model, view, proj = args[:7]
    sx, sy, sz, inv_w, world = R._screen(v, model, view, proj, N, N)
    zbuf, best = R._search(sx, sy, sz, f.long(), N, N, 64, cull)
    hit, b0, b1, _ = R._winners(sx, sy, inv_w, world, n_, uv_, f.long(), best, N, N)
    z_s, best_s, bu, bv = _scan(sx, sy, sz, f.long(), N, N, 64, cull)
    assert torch.equal(best, best_s) and torch.equal(zbuf, z_s)
    assert torch.equal(b0, bu) and torch.equal(b1, bv)
    assert int(hit.sum()) > 1000


def test_gradients_match_jax():
    """d sum(image * weights) / d (vertices, texture) against `jax.grad` of
    the JAX `rasterize` (identity model). JAX's chunk is 16 here: 400 faces
    need no padding then. At its default chunk of 64 the 48 padding faces
    (index 0, area 0) make its vertex gradient NaN at vertex 0: the backward
    of `where(|area| > 1e-8, 1 / area, 0)` multiplies a zero cotangent by
    1 / area^2 = inf (`pipeline.py:185`). The port's gradient is finite."""
    V, F, n, uv, tex = _mesh()
    view, proj = _mesh_cam()
    weights = np.random.default_rng(6).uniform(0.0, 1.0, (N, N, 3)).astype(np.float32)
    jl = _lights(JR, *MESH_LIGHTS)

    def jloss(v, t, chunk):
        img = JR.rasterize(v, jnp.asarray(F), jnp.asarray(n), jnp.asarray(uv),
                           jnp.eye(4, dtype=jnp.float32), jnp.asarray(view),
                           jnp.asarray(proj), t, N, N, lights=jl, chunk=chunk,
                           perspective_correct=True)
        return jnp.sum(img * weights)

    gv16, gt16 = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(V), jnp.asarray(tex), 16)
    gv64 = np.asarray(jax.grad(jloss)(jnp.asarray(V), jnp.asarray(tex), 64))
    assert np.isnan(gv64).any(axis=1).nonzero()[0].tolist() == [0]

    args = list(_port_mesh_args(V, F, n, uv, tex))
    args[0].requires_grad_(True)
    args[7].requires_grad_(True)
    img = R.rasterize(*args, N, N, lights=_lights(R, *MESH_LIGHTS), perspective_correct=True)
    (img * torch.from_numpy(weights)).sum().backward()
    gv, gt = args[0].grad.numpy(), args[7].grad.numpy()
    assert np.isfinite(gv).all() and np.abs(gv).max() > 0 and np.abs(gt).max() > 0
    np.testing.assert_allclose(gv, np.asarray(gv16), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gt, np.asarray(gt16), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gv[1:], gv64[1:], rtol=1e-4, atol=1e-5)


def test_shade_rejects_unknown_light():
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="spot"):
        R._shade((R.RasterLight("spot"),), x, x, x)


def test_point_light_matches_jax():
    rs = np.random.default_rng(7)
    pts, nrm, base = (rs.normal(size=(32, 3)).astype(np.float32) for _ in range(3))
    spec = (("point", (0.8, 0.7, 0.6), (0.0, -1.0, 0.0), (0.3, 2.0, 0.5)),
            ("ambient", (0.1, 0.1, 0.1)))
    got = R._shade(_lights(R, *spec), *(torch.from_numpy(a) for a in (pts, nrm, base)))
    want = JR._shade(_lights(JR, *spec), *(jnp.asarray(a) for a in (pts, nrm, base)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# --- the two corrections of the reference -----------------------------------

def test_rotated_normals_follow_apply_normal():
    """A quad under rotation_y(90), seen from +x and lit by one directional
    light. The port's colour is the Lambert value of the normal that the JAX
    `apply_normal` gives; the JAX `rasterize` (`pipeline.py:150`, the
    inverse where the inverse-transpose belongs) gives the Lambert value of
    the mirrored normal."""
    V = np.array([[-0.5, -0.5, 0], [0.5, -0.5, 0], [0.5, 0.5, 0], [-0.5, 0.5, 0]], np.float32)
    F = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    n_obj = np.array([0.6, 0.5, 0.8], np.float32) / np.float32(np.sqrt(1.25))
    n = np.tile(n_obj, (4, 1))
    view = np.asarray(JR.look_at((5.0, 0.0, 0.0), (0.0, 0.0, 0.0)))
    proj = np.asarray(JR.orthographic(1.0, 1.0, near=0.1, far=100.0))
    d = np.array([-0.3, -1.0, 0.0], np.float32)
    lights = (("directional", (1.0, 1.0, 1.0), tuple(d)),)
    model = np.array(JT.rotation_y(90.0))
    img, ref = _both(V, F, view, proj, n=n, model=model, lights=lights,
                     cull_backfaces=False)
    d = d / np.linalg.norm(d)
    right = np.asarray(JT.apply_normal(jnp.asarray(model), jnp.asarray(n_obj)))
    mirrored = n_obj @ np.linalg.inv(model[:3, :3]).T
    lam = [max(-float(x / np.linalg.norm(x) @ d), 0.0) for x in (right, mirrored)]
    assert abs(lam[0] - lam[1]) > 0.3
    covered = img.sum(-1) > 0
    assert covered.mean() > 0.2
    np.testing.assert_allclose(img[covered], lam[0], atol=1e-5)
    np.testing.assert_allclose(ref[covered], lam[1], atol=1e-5)
    # the port's normal matrix is apply_normal's
    np.testing.assert_allclose(
        T.apply_normal(torch.from_numpy(model), torch.from_numpy(n_obj)).numpy(), right,
        atol=1e-6)


@pytest.mark.parametrize("winding,cull", [((0, 1, 2), True), ((0, 2, 1), True),
                                          ((0, 1, 2), False), ((0, 2, 1), False)])
def test_sliver_covers_nothing(winding, cull):
    """A 1e-3 x 5e-6 px triangle: its doubled screen area lies between the
    JAX version's 1e-12 (front) and 1e-8 (inverse area zeroed) limits
    (`pipeline.py:181-185`), so there w0 = w1 = 0, w2 = 1 at every pixel and
    it covers the whole frame whenever it counts as front: in three of the
    four cases. The port, as the golden, draws nothing."""
    s = 1.0 / 12.0                        # world units a pixel: 24 px over 2
    V = np.array([[0.0, 0.0, 0.0], [1e-3 * s, 0.0, 0.0], [0.0, 5e-6 * s, 0.0]], np.float32)
    F = np.array([winding], np.int32)
    view, proj = _ortho_cam()
    img, ref = _both(V, F, view, proj, cull_backfaces=cull)
    best, _ = _np_raster(V, F, view, proj, W, H, cull=cull)
    ref_covered = int((ref.sum(-1) > 0).sum())
    print(f"winding {winding}, cull {cull}: JAX covers {ref_covered} of {W * H}")
    assert ref_covered == (0 if (winding == (0, 2, 1) and cull) else W * H)
    assert (best < 0).all()
    assert img.sum() == 0.0
    assert (_port_faces(V, F, view, proj, cull_backfaces=cull) < 0).all()


# --- devices ----------------------------------------------------------------

def test_operands_on_two_devices_are_refused():
    args = list(_port_mesh_args(*_mesh(nf=4)))
    args[7] = args[7].to("meta")
    with pytest.raises(ValueError, match="different devices"):
        R.rasterize(*args, 8, 8)


@pytest.mark.parametrize("factory", [
    lambda: R.look_at((0.0, 0.0, 1.0), (0.0, 0.0, 0.0)),
    lambda: R.perspective(40.0, 1.0),
    lambda: R.orthographic(1.0, 1.0)])
def test_camera_factories_need_a_card_without_device(monkeypatch, factory):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        factory()
