"""The port's example entry points (`mafrixraytracing_torch/examples/`) on
the CPU:
- the rasterizer demo on a seeded OBJ and the progressive Cornell render
  with its live preview, at 16x16;
- `render_spheres`: its scene equal to the JAX package's with the sky
  background, two passes at its depth 8 against JAX's
  `render_sample_batch` (rtol 1e-4 / atol 1e-5, the tolerance of
  `tests/test_torch_inverse.py`: the port sums in another order), its PNG;
- `baseline_matrix`: `frame` against JAX's `render_image` under the same
  seeds in one and two passes (the same tolerance), the record's keys, and
  `main` writing into its `--out-dir` and nothing into `docs/artifacts/`;
- `fit_inverse`: the floor's arrays from both packages, the ground-row
  selection against the JAX script's, each fit at 8x8 and 2 steps bit-equal
  to `opt.inverse.fit` called directly, a rerun that does not resume;
- the usage errors (exit 2) of a malformed `--size` or a non-positive
  count, and every entry point raising without a card unless given `--cpu`.
"""
import hashlib
import json
import os
import re
import tempfile
import urllib.request

import jax
import numpy as np
import pytest
import torch

from mafrixraytracing_torch import bench_scaling
from mafrixraytracing_torch.core import rng as trng
from mafrixraytracing_torch.examples import (
    baseline_matrix,
    fit_inverse,
    rasterize,
    render_cornell,
    render_spheres,
)
from mafrixraytracing_torch.film.image import read_image
from mafrixraytracing_torch.integrator import path as TP
from mafrixraytracing_torch.opt import inverse as tinv
from mafrixraytracing_torch.parallel.mesh import make_mesh
from mafrixraytracing_torch.parallel.render import render_image_sharded
from mafrixraytracing_torch.profile_walk import write_sphere_obj
from mafrixraytracing_torch.scene import assets as tassets
from mafrixraytracing_torch.scene.compiler import STATIC_FLAGS, TENSOR_FIELDS
from mafrixraytracing_torch.scene.compiler import compile_scene as tcompile
from mafrixraytracing_tpu.integrator import path as JP
from mafrixraytracing_tpu.scene import assets as jassets
from mafrixraytracing_tpu.scene import builtin as jbuiltin
from mafrixraytracing_tpu.scene import spec as JS
from mafrixraytracing_tpu.scene.compiler import compile_scene as jcompile
from torch_port_helpers import carry_camera, carry_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def write_uv_sphere_obj(path, n=8, radius=0.5, seed=0):
    """A seeded displaced UV sphere of 2 n^2 faces with a uv per vertex."""
    rs = np.random.default_rng(seed)
    th = np.linspace(0.05, np.pi - 0.05, n + 1)[:, None]
    ph = np.linspace(0.0, 2.0 * np.pi, n + 1)[None, :]
    r = radius * (1.0 + 0.05 * rs.normal(size=(n + 1, n + 1)))
    v = np.stack([r * np.sin(th) * np.cos(ph), r * np.cos(th),
                  r * np.sin(th) * np.sin(ph)], -1).reshape(-1, 3)
    uv = np.stack(np.broadcast_arrays(ph / (2 * np.pi), 1 - th / np.pi), -1).reshape(-1, 2)
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    a = (i * (n + 1) + j).ravel()
    b, c, d = a + 1, a + n + 1, a + n + 2
    faces = np.concatenate([np.stack([a, c, b], 1), np.stack([b, c, d], 1)]) + 1
    with open(path, "w") as f:
        f.writelines("v %.7f %.7f %.7f\n" % tuple(p) for p in v)
        f.writelines("vt %.7f %.7f\n" % tuple(t) for t in uv)
        f.writelines("f %d/%d %d/%d %d/%d\n" % (x, x, y, y, z, z) for x, y, z in faces)


def test_rasterize_main_writes_its_png(tmp_path, capsys):
    obj, out = tmp_path / "sphere.obj", tmp_path / "raster.png"
    write_uv_sphere_obj(str(obj))
    assert rasterize.main([str(out), "--size", "16x16", "--cpu", "--obj", str(obj),
                           "--angle", "30"]) == 0
    assert "wrote" in capsys.readouterr().out
    img = read_image(str(out))
    assert img.shape == (16, 16, 3)
    background = np.floor(np.array(rasterize.BACKGROUND) * 255.99) / 255.0
    drawn = np.abs(img - background.astype(np.float32)).max(-1) > 1.5 / 255
    assert 0.2 < drawn.mean() < 0.9


def test_rasterize_main_refuses_an_unreadable_texture(tmp_path):
    obj = tmp_path / "sphere.obj"
    write_sphere_obj(str(obj), quads=4)
    with pytest.raises(SystemExit) as e:
        rasterize.main([str(tmp_path / "r.png"), "--size", "8x8", "--cpu", "--obj",
                        str(obj), "--texture", str(tmp_path / "absent.png")])
    assert e.value.code == 2


def test_render_cornell_main_with_preview(tmp_path, capsys):
    out = tmp_path / "cornell.png"
    assert render_cornell.main([str(out), "--size", "16x16", "--spp", "2", "--cpu",
                                "--preview-port", "0"]) == 0
    text = capsys.readouterr().out
    assert "spp 2/2" in text
    port = int(re.search(r"http://127\.0\.0\.1:(\d+)/", text).group(1))
    assert out.read_bytes()[:8] == SIGNATURE
    assert read_image(str(out)).shape == (16, 16, 3)
    with pytest.raises(OSError):            # main closed the preview's server
        urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=5)


@pytest.mark.parametrize("module", [rasterize, render_cornell, render_spheres])
@pytest.mark.parametrize("size", ["16by16", "16x", "0x16"])
def test_malformed_size_is_a_usage_error(module, size, capsys):
    with pytest.raises(SystemExit) as e:
        module.main(["--size", size, "--cpu"])
    assert e.value.code == 2
    assert "--size" in capsys.readouterr().err


@pytest.mark.parametrize("flag,value", [("--spp", "0"), ("--spp", "two"),
                                        ("--dump-every", "0"), ("--dump-every", "-4")])
def test_non_positive_count_is_a_usage_error(flag, value, capsys):
    with pytest.raises(SystemExit) as e:
        render_cornell.main([flag, value, "--size", "16x16", "--cpu"])
    assert e.value.code == 2
    assert flag in capsys.readouterr().err


@pytest.mark.parametrize("flag,value", [("--spp", "0"), ("--depth", "-1"),
                                        ("--dump-every", "x")])
def test_render_spheres_non_positive_count_is_a_usage_error(flag, value, capsys):
    with pytest.raises(SystemExit) as e:
        render_spheres.main([flag, value, "--size", "16x8", "--cpu"])
    assert e.value.code == 2
    assert flag in capsys.readouterr().err


@pytest.mark.parametrize("module", [rasterize, render_cornell, render_spheres,
                                    baseline_matrix, fit_inverse, bench_scaling])
def test_main_without_a_card_raises(module, tmp_path, monkeypatch):
    """No fallback to the CPU: without `--cpu` every entry point needs a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {baseline_matrix: ["--out-dir", str(tmp_path)],
            fit_inverse: [str(tmp_path / "fit")]}.get(module, [str(tmp_path / "o.png")])
    if module is bench_scaling:
        argv = []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)
    assert not list(tmp_path.iterdir())


# --- render_spheres ------------------------------------------------------------


def _jax_spheres(W, H):
    jcs = jcompile(jbuiltin.sphere_triad(W, H))
    sky = np.array(render_spheres.SKY, np.float32)
    return jcs.scene.replace(background=sky), jcs.camera


def test_render_spheres_build_matches_jax():
    js, _ = _jax_spheres(16, 8)
    want = carry_scene(js)
    scene, camera = render_spheres.build(16, 8, "cpu")
    for k in TENSOR_FIELDS:
        assert torch.equal(getattr(scene, k), getattr(want, k)), k
    for k in STATIC_FLAGS:
        assert getattr(scene, k) == getattr(want, k), k
    assert scene.background.tolist() == pytest.approx(render_spheres.SKY)


def test_render_spheres_passes_match_jax():
    W, H = 16, 8
    js, jcam = _jax_spheres(W, H)
    jcfg = JP.PathTracerConfig(max_depth=render_spheres.DEPTH, backend="jnp")
    step = jax.jit(lambda s: JP.render_sample_batch(
        js, jcam, W, H, s, jax.random.key(render_spheres.SEED), jcfg))
    scene, _ = render_spheres.build(W, H, "cpu")
    cam = carry_camera(jcam)
    tcfg = TP.PathTracerConfig(max_depth=render_spheres.DEPTH)
    for s in range(2):
        want = np.asarray(step(s))
        with torch.no_grad():
            got = TP.render_sample_batch(scene, cam, W, H, s,
                                         trng.root_key(render_spheres.SEED, "cpu"),
                                         tcfg).numpy()
        assert np.isfinite(got).all() and got.mean() > 0.05
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_render_spheres_main_writes_its_png(tmp_path, capsys):
    out = tmp_path / "spheres.png"
    assert render_spheres.main([str(out), "--size", "16x8", "--spp", "2",
                                "--cpu"]) == 0
    assert "spp 2/2" in capsys.readouterr().out
    assert read_image(str(out)).shape == (8, 16, 3)


# --- baseline_matrix -----------------------------------------------------------

RECORD_KEYS = {"scene", "width", "height", "spp", "depth", "seconds",
               "mean_radiance", "finite", "png"}       # the JAX script's


@pytest.fixture(scope="module")
def cornell8():
    """(JAX scene, JAX camera, the port's compiled scene) of Cornell at 8x8."""
    jcs = jcompile(jbuiltin.cornell_box(8, 8))
    cs = tcompile(baseline_matrix.cornell_box(8, 8), device="cpu")
    cs.scene, cs.camera = carry_scene(jcs.scene), carry_camera(jcs.camera)
    return jcs.scene, jcs.camera, cs


@pytest.mark.parametrize("passes", [1, 2])
def test_baseline_run_matches_jax(cornell8, passes, tmp_path, capsys):
    js, jcam, cs = cornell8
    cfg = JP.PathTracerConfig(max_depth=5, backend="jnp")
    want = sum(np.asarray(JP.render_image(js, jcam, 8, 8, 4 // passes,
                                          jax.random.key(1 + p), cfg))
               for p in range(passes)) / passes
    got = baseline_matrix.frame(cs, 8, 8, 4, passes=passes)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    rec = baseline_matrix.run("cornell", cs, 8, 8, 4, passes=passes,
                              out_dir=str(tmp_path))
    assert set(rec) == RECORD_KEYS | {"device", "power_limit"}
    assert (rec["device"], rec["power_limit"]) == ("cpu", "not measured")
    assert rec["finite"] and rec["png"] == "cornell_8x8_spp4.png"
    assert rec["mean_radiance"] == pytest.approx(float(want.mean()), rel=1e-4)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    assert read_image(str(tmp_path / rec["png"])).shape == (8, 8, 3)


def _tree_digest(path):
    h = hashlib.sha256()
    for root, dirs, files in sorted(os.walk(path)):
        dirs.sort()
        for name in sorted(files):
            p = os.path.join(root, name)
            h.update(p.encode())
            with open(p, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def test_baseline_main_writes_only_into_its_out_dir(tmp_path, monkeypatch, capsys):
    # the Cornell row at 16x16 x 2 spp: 256^2 x 16 spp takes minutes on the CPU
    monkeypatch.setattr(baseline_matrix, "CORNELL", (16, 16, 2, 1))
    art = os.path.join(REPO, "docs", "artifacts")
    before = _tree_digest(art)
    out = tmp_path / "out"
    assert baseline_matrix.main(["--quick", "--cpu", "--out-dir", str(out)]) == 0
    assert _tree_digest(art) == before
    results = json.loads((out / "RESULTS.json").read_text())
    assert [r["scene"] for r in results] == ["cornell"]
    assert set(results[0]) == RECORD_KEYS | {"device", "power_limit"}
    assert sorted(os.listdir(out)) == ["RESULTS.json", "cornell_16x16_spp2.png"]
    assert "wrote 1 artifacts" in capsys.readouterr().out
    assert baseline_matrix.OUT_DIR == os.path.join(REPO, "build", "artifacts_torch")


# --- fit_inverse ---------------------------------------------------------------


@pytest.fixture(scope="module")
def model_obj(tmp_path_factory):
    """A seeded displaced sphere of 32 faces (the fits' model, small)."""
    path = tmp_path_factory.mktemp("model") / "sphere.obj"
    write_sphere_obj(str(path), quads=4, seed=3)
    return str(path)


def test_floor_spec_compiles_to_the_jax_arrays():
    """The JAX script builds this spec inline (`examples/fit_inverse.py:78-89`)."""
    floor = JS.make_rect_mesh((-2, 0, 2), (2, 0, 2), (2, 0, -2), (-2, 0, -2))
    light = JS.make_rect_mesh((-0.6, 2.0, -0.6), (0.6, 2.0, -0.6),
                              (0.6, 2.0, 0.6), (-0.6, 2.0, 0.6))
    spec = JS.SceneSpec(
        camera=JS.CameraSpec(position=(0.0, 1.2, 3.0), direction=(0.0, -0.3, -1.0),
                             fov=60.0, fov_convention="standard"),
        materials=[JS.MaterialSpec(albedo=(0.7, 0.7, 0.7))],
        shapes=[JS.ShapeSpec(floor, 0)],
        area_lights=[JS.AreaLightSpec(light, radiance=(12.0,) * 3, visible=False)],
        film=JS.FilmSpec(width=32, height=32))
    want = carry_scene(jcompile(spec).scene)
    got = tcompile(fit_inverse.floor_spec(32, 32), device="cpu").scene
    for k in TENSOR_FIELDS:
        assert torch.equal(getattr(got, k), getattr(want, k)), k


def test_ground_rows_match_the_jax_selection(model_obj):
    """`examples/fit_inverse.py:142-147` on the JAX package's scene, against
    the port's `ground_rows` (which also checks that they are the ground's
    four corners)."""
    js = jcompile(jassets.mesh_scene(model_obj, 8, 8)).scene
    true_mv = np.asarray(js.mesh_vertices)
    faces = np.asarray(js.tri_face_vi)[np.asarray(js.tri_mask)]
    used = np.unique(faces)
    want = used[np.isin(used, np.nonzero(
        np.abs(true_mv[:, 1] - true_mv[used, 1].min()) < 1e-5)[0])]
    scene = tcompile(tassets.mesh_scene(model_obj, 8, 8), device="cpu").scene
    got = fit_inverse.ground_rows(scene)
    np.testing.assert_array_equal(got, want)
    assert got.size == 4
    # a model that reaches down to the ground's height is refused
    low = scene.mesh_vertices.clone()
    low[int(faces[0, 0]), 1] = low[int(got[0]), 1]
    with pytest.raises(RuntimeError, match="four corners"):
        fit_inverse.ground_rows(scene.replace(mesh_vertices=low))


def _direct_fit(name, obj):
    """The fit `name` of the JAX script at 8x8 and 2 steps, built here and
    run through `opt.inverse.fit` without a mesh -> its losses."""
    cfg, mesh, W = fit_inverse.CONFIG, make_mesh(1), 8

    def render(scene, camera, spp, seed):
        return render_image_sharded(scene, camera, mesh, W, W, spp,
                                    trng.root_key(seed, "cpu"), cfg)

    spec = (fit_inverse.floor_spec(W, W) if name == "geometry"
            else tassets.mesh_scene(obj, W, W))
    cs = tcompile(spec, device="cpu")
    scene, camera = cs.scene, cs.camera
    up = torch.tensor([0.0, 0.25, 0.0])
    if name == "albedo":
        alb = scene.mat_albedo.clone()
        alb[0] = torch.tensor([0.2, 0.8, 0.2])
        args = (scene.replace(mat_albedo=alb), render(scene, camera, 16, 7),
                ("mat_albedo",))
        kw = dict(lr=5e-2, key=trng.root_key(11, "cpu"))
    elif name == "geometry":
        v0 = scene.tri_v0 + torch.where(scene.tri_mask[:, None], up, 0.0)
        args = (scene.replace(tri_v0=v0), render(scene, camera, 32, 7), ("tri_v0",))
        kw = dict(lr=3e-2, key=trng.root_key(11, "cpu"))
    else:
        sel = torch.zeros(scene.mesh_vertices.shape[0], dtype=torch.bool)
        sel[torch.as_tensor(fit_inverse.ground_rows(scene))] = True
        mv = scene.mesh_vertices + torch.where(sel[:, None], up, 0.0)
        args = (tinv.apply_params(scene, {"mesh_vertices": mv}),
                render(scene, camera, 32, 7), ("mesh_vertices",))
        kw = dict(lr=8e-3, key=trng.root_key(13, "cpu"))
    return tinv.fit(args[0], camera, args[1], args[2], steps=2, spp=8, config=cfg,
                    **kw)[1]


FITS = {"albedo": fit_inverse.fit_albedo, "geometry": fit_inverse.fit_geometry,
        "vertices": fit_inverse.fit_vertices}


@pytest.mark.parametrize("name", list(FITS))
def test_fit_is_opt_inverse_fit(name, model_obj, capsys):
    run = FITS[name](fit_inverse.Fits(None, make_mesh(1), model_obj, "cpu"),
                     W=8, H=8, steps=2)
    assert run["losses"] == _direct_fit(name, model_obj)
    assert len(run["losses"]) == 2 and run["setup_s"] >= 0.0
    out = capsys.readouterr().out
    assert "loss:" in out and "set-up" in out and "wrote" not in out


def test_vertex_fit_rerun_does_not_resume(model_obj, tmp_path, monkeypatch):
    """The checkpoint lives in a fresh temporary directory that the fit
    removes: a second run repeats the first, step for step."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    f = fit_inverse.Fits(None, make_mesh(1), model_obj, "cpu")
    first = fit_inverse.fit_vertices(f, W=8, H=8, steps=2)["losses"]
    assert not list(tmp_path.iterdir())
    assert fit_inverse.fit_vertices(f, W=8, H=8, steps=2)["losses"] == first
    assert len(first) == 2 and not list(tmp_path.iterdir())


def test_stand_in_has_spots_face_count(tmp_path):
    path = fit_inverse.stand_in_obj(str(tmp_path))
    with open(path) as fh:
        faces = sum(line.startswith("f ") for line in fh)
    assert faces == fit_inverse.SPOT_FACES == 5856
