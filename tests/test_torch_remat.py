"""`PathTracerConfig.remat`: memory-bounded gradients, on the CPU.

The port against itself, on Cornell 16x16 at 4 spp with a wavefront of 256
rays (four checkpointed groups), depth 3 and 5, with the benchmark's compaction
(each bounce's live share in one 1-spp pass from the pixel centres, x1.12 +
0.01): the image and the gradients to
`mat_albedo`, `light_radiance` and `tri_v0` are `torch.equal` with `remat`
on and off. The searches (`ops.intersect._prep`) run as often in a fwd+bwd
with `remat` as without; the attribute fetch (`ops.unpack.gather_unpack`,
kernel C on the card) once more a fetch, in the backward. With `remat`
unset, `render_image` follows `ops.remat.needed`, whose choice is held on
both sides of its threshold with the card's free memory patched.

Beyond Cornell, `remat` on against off at 16x16 x 4 spp, depth 3, wavefront
256, without compaction: `sphere_triad` with gradients to the spheres'
centres and radii and the albedo; the moving sphere of
`tests/test_torch_motion_blur.py` with `motion_blur=True`; a Cornell box
with a checker-textured floor and back wall, once with gradients to
`tri_v0` (the texture lookup kept by the checkpoint, `remat.keep`) and once
to `tex_atlas` (the lookup with a graph, computed again in the recompute).
Image and gradients are `torch.equal`.

The port against JAX: `remat=True` against JAX's default (`remat=True`),
depth 5 without compaction, at the tolerances of `tests/test_torch_path.py`:
the image within rtol 1e-3 / atol 1e-4 on at least 99.5% of the pixels and
its mean within 1e-4 relative; the gradients within rtol 1e-3 / atol 1e-5 of
`jax.grad`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafrixraytracing_torch.core import rng as trng
from mafrixraytracing_torch.integrator import path as TP
from mafrixraytracing_torch.ops import intersect as oi
from mafrixraytracing_torch.ops import remat
from mafrixraytracing_torch.ops import unpack as ou
from mafrixraytracing_torch.geometry import intersect as tgi
from mafrixraytracing_torch.materials import texture as ttex
from mafrixraytracing_torch.scene import builtin as tbuiltin
from mafrixraytracing_torch.scene import spec as TS
from mafrixraytracing_torch.scene.compiler import compile_scene as tcompile
from mafrixraytracing_tpu.integrator import path as JP
from mafrixraytracing_tpu.scene import builtin as jbuiltin
from mafrixraytracing_tpu.scene.compiler import compile_scene as jcompile
from test_torch_motion_blur import moving_scene
from torch_port_helpers import carry_camera, carry_scene

W = H = 16
SPP = 4
WAVEFRONT = 256
LEAVES = ("mat_albedo", "light_radiance", "tri_v0")


@pytest.fixture(scope="module")
def cornell():
    jcs = jcompile(jbuiltin.cornell_box(W, H))
    return jcs, carry_scene(jcs.scene), carry_camera(jcs.camera)


@pytest.fixture(scope="module")
def configs(cornell):
    """The benchmark's compaction at depth 3 and 5, on a wavefront of 256:
    each bounce's live share in `trace_stats` of one 1-spp pass from the
    pixel centres (keys of seed 123), x1.12 + 0.01."""
    _, ts, tcam = cornell
    px, py = TP.make_pixel_uv(W, H, "cpu")
    keys = trng.pixel_keys(trng.root_key(123, "cpu"), px.shape[0])
    o, d = tcam.get_rays((px + 0.5) / W, (py + 0.5) / H)
    out = {}
    for depth in (3, 5):
        base = TP.PathTracerConfig(max_depth=depth, wavefront=1 << 19)
        _, prof = TP.trace_stats(ts, o, d, keys, base, return_profile=True)
        sched = [1.0] + [min(1.0, float(p) * 1.12 + 0.01) for p in prof[1:]]
        out[depth] = dataclasses.replace(base, compact=tuple(sched), wavefront=WAVEFRONT)
    return out


def fwd_bwd(ts, tcam, config, counts=None, names=LEAVES):
    """(image, the gradients to `names`, the counts after the forward) of
    the mean image at seed 3."""
    leaves = [getattr(ts, n).clone().requires_grad_() for n in names]
    s = ts.replace(**dict(zip(names, leaves)))
    img = TP.render_image(s, tcam, W, H, SPP, trng.root_key(3, "cpu"), config)
    forward = None if counts is None else dict(counts)
    img.mean().backward()
    return img.detach(), [x.grad for x in leaves], forward


def count_calls(mp, counts):
    """Count `_prep` (one a search) and the attribute fetch into `counts`."""
    prep, fetch = oi._prep, ou.gather_unpack

    def on_prep(*a, **k):
        counts["prep"] += 1
        return prep(*a, **k)

    def on_fetch(*a, **k):
        counts["fetch"] += 1
        return fetch(*a, **k)

    mp.setattr(oi, "_prep", on_prep)
    mp.setattr(ou, "gather_unpack", on_fetch)


@pytest.fixture
def counted(monkeypatch):
    counts = {"prep": 0, "fetch": 0}
    count_calls(monkeypatch, counts)
    return counts


@pytest.fixture(scope="module")
def plain_runs(cornell, configs):
    """remat off, per depth: (image, gradients, counts of the fwd+bwd)."""
    _, ts, tcam = cornell
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for depth, cfg in configs.items():
            counts = {"prep": 0, "fetch": 0}
            count_calls(mp, counts)
            img, grads, _ = fwd_bwd(ts, tcam, cfg)
            mp.undo()
            out[depth] = (img, grads, counts)
    return out


@pytest.mark.parametrize("depth", [3, 5])
def test_remat_is_bit_equal_and_runs_no_search_again(cornell, configs, plain_runs,
                                                     counted, depth):
    _, ts, tcam = cornell
    cfg = configs[depth]
    assert cfg.compact and cfg.remat is None
    img0, grads0, counts0 = plain_runs[depth]
    img, grads, forward = fwd_bwd(ts, tcam, dataclasses.replace(cfg, remat=True),
                                  counted)
    assert torch.equal(img, img0)
    for n, g, g0 in zip(LEAVES, grads, grads0):
        assert g0.abs().max() > 0, n
        assert torch.equal(g, g0), n
    # the forward makes one search a query; the backward none, and fetches
    # the attributes again
    assert forward["prep"] == counted["prep"] == counts0["prep"] > 0
    assert forward["fetch"] == counts0["fetch"] > 0
    assert counted["fetch"] == 2 * counts0["fetch"]


def test_render_follows_the_size_decision(cornell, configs, plain_runs, counted,
                                          monkeypatch):
    """With `remat` unset, `render_image` asks `remat.needed` with the
    frame's spp and pixels and checkpoints when it says so; the result does
    not change."""
    _, ts, tcam = cornell
    asked = []

    def decide(config, spp, pixels, device):
        asked.append((config.remat, spp, pixels, device.type))
        return True

    monkeypatch.setattr(remat, "needed", decide)
    img, grads, _ = fwd_bwd(ts, tcam, configs[3], counted)
    img0, grads0, counts0 = plain_runs[3]
    assert asked == [(None, SPP, W * H, "cpu")]
    assert counted["fetch"] == 2 * counts0["fetch"]
    assert counted["prep"] == counts0["prep"]
    assert torch.equal(img, img0)
    assert all(torch.equal(g, g0) for g, g0 in zip(grads, grads0))


GIB = 2 ** 30


@pytest.mark.parametrize("remat_field,device,grad,free_gib,spp,want", [
    (True, "cpu", True, None, 1, True),
    (False, "cuda", True, 1.0, 4096, False),
    (True, "cuda", False, None, 1, False),      # no graph to bound
    (None, "cpu", True, None, 4096, False),     # the CPU never decides
    (None, "cuda", True, 79.0, 64, False),      # the 64-spp cell: 6.53 GB
    (None, "cuda", True, 79.0, 512, True),      # 52.27 GB against 42.41
    (None, "cuda", True, 13.0, 64, False),      # 6.53 GB against 6.98 (GB)
    (None, "cuda", True, 12.0, 64, True),       # 6.53 GB against 6.44
])
def test_needed_decides_by_the_graph_and_free_memory(
        monkeypatch, remat_field, device, grad, free_gib, spp, want):
    """256x256 with the mesh cell's compaction (2.2255 lane-bounces a pixel):
    the estimated graph against half the card's free memory."""
    def mem_get_info(dev):
        assert free_gib is not None
        return int(free_gib * GIB), 80 * GIB

    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    cfg = TP.PathTracerConfig(compact=(1.0, 0.7054, 0.2773, 0.2009, 0.0419),
                              remat=remat_field)
    with torch.set_grad_enabled(grad):
        assert remat.needed(cfg, spp, 256 * 256, torch.device(device)) is want


def textured_cornell():
    """Cornell with a checker texture on the floor (two tiles a side) and
    on the back wall."""
    spec = tbuiltin.cornell_box(W, H)
    uv = np.float32([[0, 0], [1, 0], [1, 1], [0, 1]])
    fu = np.int32([[0, 1, 2], [0, 2, 3]])
    shapes = list(spec.shapes)
    for i, scale in ((0, 2.0), (2, 1.0)):       # the floor, the back wall
        m = shapes[i].mesh
        shapes[i] = TS.ShapeSpec(TS.Mesh(vertices=m.vertices, faces=m.faces,
                                         uvs=uv * scale, face_uvs=fu),
                                 len(spec.materials))
    return dataclasses.replace(
        spec, shapes=shapes,
        materials=[*spec.materials, TS.MaterialSpec(albedo=(1.0, 1.0, 1.0),
                                                    texture_id=0)],
        textures=[ttex.checker_texture((0.9, 0.9, 0.9), (0.1, 0.3, 0.1))])


def beyond_cornell(case):
    """(scene, camera, config, the gradients' names in each run)."""
    cfg = TP.PathTracerConfig(max_depth=3, wavefront=WAVEFRONT)
    if case == "motion_blur":
        _, ts, tcam = moving_scene((1.6, 0.0, 0.0))
        return (ts, tcam, dataclasses.replace(cfg, motion_blur=True),
                [("sph_center", "mat_albedo", "light_radiance")])
    spec = tbuiltin.sphere_triad(W, H) if case == "sphere_triad" else textured_cornell()
    cs = tcompile(spec, device="cpu")
    if case == "sphere_triad":
        return cs.scene, cs.camera, cfg, [("sph_center", "sph_radius", "mat_albedo")]
    return cs.scene, cs.camera, cfg, [("tri_v0", "mat_albedo"), ("tex_atlas",)]


@pytest.mark.parametrize("case", ["sphere_triad", "motion_blur", "textured"])
def test_remat_is_bit_equal_beyond_cornell(monkeypatch, case):
    ts, tcam, cfg, runs = beyond_cornell(case)
    kept, looked_up = [], []
    keep, sample = remat.keep, tgi.sample_atlas

    def on_keep(kind, fn):
        kept.append(kind)
        return keep(kind, fn)

    def on_sample(atlas, *a, **k):
        looked_up.append(atlas.requires_grad)
        return sample(atlas, *a, **k)

    monkeypatch.setattr(remat, "keep", on_keep)
    monkeypatch.setattr(tgi, "sample_atlas", on_sample)
    for names in runs:
        img0, grads0, _ = fwd_bwd(ts, tcam, dataclasses.replace(cfg, remat=False),
                                  names=names)
        kept.clear()
        looked_up.clear()
        img, grads, _ = fwd_bwd(ts, tcam, dataclasses.replace(cfg, remat=True),
                                names=names)
        assert torch.isfinite(img0).all() and img0.mean() > 0
        assert torch.equal(img, img0), names
        for n, g, g0 in zip(names, grads, grads0):
            assert g0.abs().max() > 0, n
            assert torch.equal(g, g0), n
        assert "closest" in kept
        if case == "textured":
            # the lookup is kept while the atlas needs no gradient, and
            # computed with a graph (in the forward and the recompute) once
            # it does
            grad_atlas = "tex_atlas" in names
            assert ("texture" in kept) is not grad_atlas
            assert looked_up and all(r is grad_atlas for r in looked_up)
        else:
            assert "texture" not in kept and not looked_up


def test_remat_without_grad_records_nothing(cornell, configs, monkeypatch):
    """Under no_grad there is no graph to bound: the steps run plainly."""
    _, ts, tcam = cornell
    monkeypatch.setattr(remat, "checkpointed", None)
    with torch.no_grad():
        img = TP.render_image(ts, tcam, W, H, SPP, trng.root_key(3, "cpu"),
                              dataclasses.replace(configs[3], remat=True))
    assert not img.requires_grad and bool(torch.isfinite(img).all())


def test_replay_refuses_a_different_order():
    tape = remat.Tape()
    tape.values.append(("closest", torch.zeros(1)))
    tape.recorded = True
    with remat._using(tape):
        with pytest.raises(RuntimeError, match="'anyhit' where the forward"):
            remat.keep("anyhit", lambda: torch.ones(1))
        tape.pos = 1
        with pytest.raises(RuntimeError, match="more kept values"):
            remat.keep("closest", lambda: torch.ones(1))


def test_remat_matches_jax(cornell):
    """The port with remat against JAX's default (remat with its policy) on
    the same scene, camera and key, depth 5 without compaction (JAX unrolls
    the compaction loop, which doubles its compile)."""
    jcs, ts, tcam = cornell
    cfg = TP.PathTracerConfig(max_depth=5, wavefront=WAVEFRONT, remat=True)
    jcfg = JP.PathTracerConfig(max_depth=5, wavefront=WAVEFRONT)
    assert jcfg.remat
    js = jcs.scene

    def loss(a, r, v):
        s = js.replace(mat_albedo=a, light_radiance=r, tri_v0=v)
        img = JP.render_image(s, jcs.camera, W, H, SPP, jax.random.key(3), jcfg)
        return jnp.mean(img), img

    (_, jimg), jg = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        js.mat_albedo, js.light_radiance, js.tri_v0)
    timg, tg, _ = fwd_bwd(ts, tcam, cfg)
    timg, jimg = timg.numpy(), np.asarray(jimg)
    close = np.isclose(timg, jimg, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert close.mean() >= 0.995, close.mean()
    assert abs(timg.mean() - jimg.mean()) <= 1e-4 * abs(jimg.mean())
    for n, g_t, g_j in zip(LEAVES, tg, jg):
        g_j = np.asarray(g_j)
        assert np.abs(g_j).max() > 0, n
        np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-3, atol=1e-5, err_msg=n)
