"""The port's kernel wrappers, and on a CUDA card the kernels themselves.

This file imports no JAX, so the card's machine (which has none) runs it:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

On the CPU, the wrappers take the plain PyTorch versions and the kernels'
entry points refuse CPU tensors. The tests marked `cuda` hold each kernel
against its plain version on the card: closest-hit `idx` equal and `t`
within rtol 1e-4 / atol 1e-5 (the search contract; the kernels are built
to agree bit for bit), any-hit and the gather exactly, for the flat walks
(A, B) and the two-level walks (D, E: small scenes with `SUPER_MIN_C`
patched to 0, a mesh of 20,000 triangles, and hand-built inputs of E: a
tile whose rays each ask for another child, a NaN ray, a dead tile, every
ray blocked in the first child, a ray that asks for all 16; and of D, bit
for bit, with H bit-equal to D: the same fan-out, NaN ray and dead tile,
every lane hitting every ray, ties across children and superclusters, the
nearest of 16 stacked children last, a hit at exactly tmax, a negative
t_min whose answer lies behind the origin); on the CPU the same inputs of D
against what they are built to give, and a step-by-step model of D's
pair-parallel walk against its plain version;
the gather (C)
at ragged sizes, with clamped indices and as a pure unpack, bit for bit;
the fused-cull searches (F, G,
H, I) bit for bit against their plain versions and against A, B, D, E fed by
the PyTorch cull on the same rays; the cull kernel (K, the cull of `_prep`
on the card) bit for bit against `cull_reference` and `_cull` on 1 to 128
boxes, and the list walks fed by it against the same walks fed by `_cull`; the counting walk and the walk without early exit bit for
bit against A and against their step-by-step plain versions; the scatter-add (J)
bit for bit against `scatter_rows_ordered_reference` (its own sum order), and J
and `index_add_` (float atomics) each within 1e-5 of the sum of |terms| of a
float64 sum, J bit-equal across launches;
a gradient evaluation of `opt.inverse` bit-equal when repeated; and a small render
through the kernels against the same render on the CPU (image rtol 1e-3 /
atol 1e-4 on 99.5% of pixels: the two devices' sin/cos/sqrt round
differently, which can flip a grazing branch).
"""
from unittest import mock

import numpy as np
import pytest
import torch

from mafrixraytracing_torch.core import rng
from mafrixraytracing_torch.core.v3 import V3
from mafrixraytracing_torch.geometry import intersect as gi
from mafrixraytracing_torch.integrator import path as P
from mafrixraytracing_torch.ops import cuda
from mafrixraytracing_torch.ops import intersect as oi
from mafrixraytracing_torch.ops import unpack as ou
from mafrixraytracing_torch.scene import builtin
from mafrixraytracing_torch.scene import spec as S
from mafrixraytracing_torch.scene.compiler import compile_scene
import torch_port_helpers  # noqa: F401  (sizes torch's threads to the run)

T_MIN = 1e-3


def soup(n=1024, seed=3):
    rs = np.random.default_rng(seed)
    centers = rs.uniform(-1.0, 1.0, (n, 1, 3))
    verts = (centers + rs.normal(0.0, 0.08, (n, 3, 3))).reshape(-1, 3)
    mesh = S.Mesh(vertices=verts.astype(np.float32),
                  faces=np.arange(3 * n, dtype=np.int32).reshape(n, 3))
    return S.SceneSpec(shapes=[S.ShapeSpec(mesh=mesh, material=0)])


CASES = {
    "cornell": (builtin.cornell_box, (0.0, 1.0, 1.5)),
    "sphere_triad": (builtin.sphere_triad, (0.0, 0.7, 2.0)),
    "soup": (soup, (0.0, 0.0, 0.0)),
}


def bumpy_sphere(rows=100, cols=100, seed=5):
    """A displaced UV sphere of 20,000 triangles (padded to 32,768: 256
    clusters, 16 superclusters), so the two-level path without a patch."""
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
    return S.SceneSpec(shapes=[S.ShapeSpec(mesh=mesh, material=0)])


BUMPY = (bumpy_sphere, (0.0, 0.0, 2.5))


def rays(n, origin, seed, device, dead_frac=0.1, aimed=False):
    """Random rays from around `origin`; `aimed`: toward points of the cube
    [-0.9, 0.9]^3 around the world's origin, so that most hit a mesh there."""
    rs = np.random.default_rng(seed)
    o = (np.asarray(origin, np.float32) + rs.normal(0.0, 0.2, (n, 3))).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    if aimed:
        d = (rs.uniform(-0.9, 0.9, (n, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(rs.random(n) < dead_frac, 0.0, 1e8).astype(np.float32)
    to = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return V3.of(to(o)), V3.of(to(d)), to(t_max)


def scene_on(name, device):
    return compile_scene(CASES[name][0](), device=device).scene


@pytest.mark.parametrize("name", list(CASES))
def test_cluster_path_matches_brute_force(name):
    ts = scene_on(name, "cpu")
    o, d, t_max = rays(300, CASES[name][1], seed=1, device="cpu")
    t_c, i_c = oi.find_closest_soa(ts, o, d, T_MIN, t_max)
    t_b, i_b = gi.find_closest(ts, o, d, T_MIN, t_max)
    assert torch.equal(i_c, i_b)
    torch.testing.assert_close(t_c, t_b, rtol=1e-4, atol=1e-5)
    assert torch.equal(oi.occluded_soa(ts, o, d, T_MIN, t_max * 0.5),
                       gi.occluded(ts, o, d, T_MIN, t_max * 0.5))


def test_wrappers_take_plain_versions_on_cpu():
    cuda.reset_launches()
    ts = scene_on("soup", "cpu")
    o, d, t_max = rays(200, CASES["soup"][1], seed=9, device="cpu")
    oi.find_closest_soa(ts, o, d, T_MIN, t_max)
    oi.occluded_soa(ts, o, d, T_MIN, t_max)
    table = torch.zeros(8, 36, requires_grad=True)
    ou.fetch_cols(table, torch.zeros(4, dtype=torch.long)).sum().backward()
    assert table.grad[0].eq(4.0).all() and table.grad[1:].eq(0.0).all()
    ou.scatter_rows(torch.ones(3, 4), torch.zeros(4, dtype=torch.long), 8)
    big = compile_scene(bumpy_sphere(), device="cpu").scene
    assert big.cluster_min.shape[0] > oi.SUPER_MIN_C
    oi.find_closest_soa(big, o, d, T_MIN, t_max)
    oi.occluded_soa(big, o, d, T_MIN, t_max)
    with mock.patch.object(oi, "FUSED_CULL", True):
        oi.find_closest_soa(ts, o, d, T_MIN, t_max)
        oi.occluded_soa(ts, o, d, T_MIN, t_max)
        oi.find_closest_soa(big, o, d, T_MIN, t_max)
        oi.occluded_soa(big, o, d, T_MIN, t_max)
    walk, *_ = oi._prep(ts, o, d, T_MIN, t_max, anyhit=False)
    oi.cull_lists(ts.cluster_min, ts.cluster_max, walk[-1])
    oi.closest_dbg_hit(*walk, T_MIN)
    oi.closest_full_hit(*walk, T_MIN)
    keys = rng.pixel_keys(rng.root_key(3, "cpu"), 5)
    rng.uniforms(rng.sample_key(keys[:, None, :], torch.arange(2)[None, :]).reshape(10, 2),
                 1000, (2,))
    assert cuda.LAUNCHES == {"closest": 0, "anyhit": 0, "unpack": 0,
                             "closest_super": 0, "anyhit_super": 0,
                             "scatter": 0, "fused_closest": 0,
                             "fused_anyhit": 0, "fused_closest_super": 0,
                             "fused_anyhit_super": 0, "cull": 0,
                             "closest_dbg": 0, "closest_full": 0,
                             "rng_fold": 0, "rng_uniform": 0}


def test_kernel_entry_points_refuse_cpu_tensors():
    ts = scene_on("cornell", "cpu")
    o, d, t_max = rays(128, CASES["cornell"][1], seed=0, device="cpu")
    walk, *_ = oi._prep(ts, o, d, T_MIN, t_max, anyhit=False)
    with pytest.raises(ValueError, match="CUDA"):
        oi.closest_kernel(*walk, T_MIN)
    with pytest.raises(ValueError, match="CUDA"):
        oi.anyhit_kernel(*walk, T_MIN)
    with pytest.raises(ValueError, match="CUDA"):
        ou.unpack_kernel(torch.zeros(8, 36), torch.zeros(4, dtype=torch.long))
    with pytest.raises(ValueError, match="CUDA"):
        ou.scatter_kernel(torch.zeros(36, 4), torch.zeros(4, dtype=torch.long), 8)
    big = compile_scene(bumpy_sphere(), device="cpu").scene
    walk, *_ = oi._prep(big, o, d, T_MIN, t_max, anyhit=False)
    with pytest.raises(ValueError, match="CUDA"):
        oi.closest_super_kernel(*walk, T_MIN)
    with pytest.raises(ValueError, match="CUDA"):
        oi.anyhit_super_kernel(*walk, T_MIN)
    walk, *_ = oi._prep(big, o, d, T_MIN, t_max, anyhit=False, fused=True)
    assert oi._is_super(walk) and oi._is_fused(walk)
    with pytest.raises(ValueError, match="CUDA"):
        oi.fused_closest_super_kernel(*walk, T_MIN)
    with pytest.raises(ValueError, match="CUDA"):
        oi.fused_anyhit_super_kernel(*walk, T_MIN)
    walk, *_ = oi._prep(ts, o, d, T_MIN, t_max, anyhit=False, fused=True)
    assert oi._is_fused(walk) and not oi._is_super(walk)
    with pytest.raises(ValueError, match="CUDA"):
        oi.fused_closest_kernel(*walk, T_MIN)
    with pytest.raises(ValueError, match="CUDA"):
        oi.fused_anyhit_kernel(*walk, T_MIN)
    walk, *_ = oi._prep(ts, o, d, T_MIN, t_max, anyhit=False)
    with pytest.raises(ValueError, match="CUDA"):
        oi.cull_kernel(ts.cluster_min, ts.cluster_max, walk[-1])
    with pytest.raises(ValueError, match="CUDA"):
        oi.closest_dbg_kernel(*walk, T_MIN)
    with pytest.raises(ValueError, match="CUDA"):
        oi.closest_full_kernel(*walk, T_MIN)


def test_too_many_clusters_raises():
    """More than SUPER_MIN_C clusters no longer raise: they take the
    two-level path. What raises is a two-level launch whose child bounds do
    not cover the triangle table (a staged read past it otherwise)."""
    big = compile_scene(bumpy_sphere(), device="cpu").scene
    o, d, _ = rays(8, BUMPY[1], seed=0, device="cpu")
    walk, *_ = oi._prep(big, o, d, T_MIN, 1e8, anyhit=False)
    assert oi._is_super(walk)
    t, i = oi.find_closest_soa(big, o, d, T_MIN, 1e8)
    assert torch.equal(i, gi.find_closest(big, o, d, T_MIN, 1e8)[1])
    tri, bounds, *rest = walk
    with pytest.raises(ValueError, match="do not cover"):
        oi.closest_super_kernel(tri, bounds[:8], *rest, T_MIN)
    with pytest.raises(ValueError, match="do not cover"):
        oi.anyhit_super_kernel(tri, bounds[:8], *rest, T_MIN)


def test_library_name_tracks_sources():
    name = cuda.library_path().name
    assert name.startswith("libmfx_kernels_") and name.endswith(".so")
    assert cuda.library_path() == cuda.library_path()
    assert {p.name for p in cuda._sources()} == {
        "cull.cu", "intersect.cu", "intersect_fused.cu", "intersect_stats.cu",
        "intersect_super.cu", "rng.cu", "scatter.cu", "unpack.cu"}


# --- on the card -----------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("n", [100, 1000])
def test_kernels_match_plain_versions(card, name, n):
    ts = scene_on(name, card)
    o, d, t_max = rays(n, CASES[name][1], seed=n, device=card)
    walk, *_ = oi._prep(ts, o, d, T_MIN, t_max, anyhit=False)
    tk, ik = oi.closest_kernel(*walk, T_MIN)
    tp, ip = oi.closest_reference(*walk, T_MIN)
    assert torch.equal(ik, ip)
    assert torch.equal(tk, tp)      # A is built to agree bit for bit
    walk, *_ = oi._prep(ts, o, d, T_MIN, t_max * 0.4, anyhit=True)
    assert torch.equal(oi.anyhit_kernel(*walk, T_MIN),
                       oi.anyhit_reference(*walk, T_MIN))
    table = gi.packed_attr_table(ts).contiguous()
    idx = torch.randint(0, table.shape[0], (n,), device=card)
    assert torch.equal(ou.unpack_kernel(table, idx),
                       ou.fetch_cols_reference(table, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("name", [*CASES, "bumpy"])
@pytest.mark.parametrize("n", [100, 1000])
def test_super_kernels_match_plain_versions(card, monkeypatch, name, n):
    monkeypatch.setattr(oi, "SUPER_MIN_C", 0)
    spec, origin = BUMPY if name == "bumpy" else CASES[name]
    ts = compile_scene(spec(), device=card).scene
    o, d, t_max = rays(n, origin, seed=n, device=card, aimed=name == "bumpy")
    walk, *_ = oi._prep(ts, o, d, T_MIN, t_max, anyhit=False)
    assert oi._is_super(walk)
    tk, ik = oi.closest_super_kernel(*walk, T_MIN)
    tp, ip = oi.closest_super_reference(*walk, T_MIN)
    assert torch.equal(ik, ip)
    if name in ("soup", "bumpy"):   # the others keep most triangles as mega
        assert (ik >= 0).sum() > n // 20
    assert torch.equal(tk, tp)      # D is built to agree bit for bit
    t_near = torch.where(ik[:n] >= 0, tk[:n] * 1.01, t_max)
    for t_far in (t_max * 0.4, t_near):
        walk, *_ = oi._prep(ts, o, d, T_MIN, t_far, anyhit=True)
        assert torch.equal(oi.anyhit_super_kernel(*walk, T_MIN),
                           oi.anyhit_super_reference(*walk, T_MIN))


def fused_and_list(ts, o, d, t_far, anyhit):
    """The fused kernels' and the list kernels' operands for the same rays."""
    fw, *_ = oi._prep(ts, o, d, T_MIN, t_far, anyhit=anyhit, fused=True)
    lw, *_ = oi._prep(ts, o, d, T_MIN, t_far, anyhit=anyhit)
    assert torch.equal(fw[-1][:7].nan_to_num(), lw[-1][:7].nan_to_num())
    return fw, lw


@pytest.mark.cuda
@pytest.mark.parametrize("two_level,name", [
    *[(lv, c) for lv in (False, True) for c in CASES],
    (True, "bumpy")])    # bumpy has more than 128 clusters: no flat path
@pytest.mark.parametrize("n", [100, 1000])
def test_fused_kernels_match_plain_and_list_kernels(card, monkeypatch, name,
                                                    two_level, n):
    """F, G (flat) and H, I (two-level) bit for bit against their plain
    versions and against A, B, D, E on the PyTorch cull's lists; ~10% dead
    rays, non-aligned batches, per-ray t_max."""
    if two_level:
        monkeypatch.setattr(oi, "SUPER_MIN_C", 0)
    spec, origin = BUMPY if name == "bumpy" else CASES[name]
    ts = compile_scene(spec(), device=card).scene
    o, d, t_max = rays(n, origin, seed=n, device=card, aimed=name == "bumpy")
    fw, lw = fused_and_list(ts, o, d, t_max, anyhit=False)
    assert oi._is_super(fw) == two_level == oi._is_super(lw)
    if two_level:
        fused, plain, lst = (oi.fused_closest_super_kernel,
                             oi.fused_closest_super_reference,
                             oi.closest_super_kernel)
    else:
        fused, plain, lst = (oi.fused_closest_kernel, oi.fused_closest_reference,
                             oi.closest_kernel)
    tk, ik = fused(*fw, T_MIN)
    torch.cuda.synchronize()
    tp, ip = plain(*fw, T_MIN)
    tl, il = lst(*lw, T_MIN)
    assert torch.equal(ik, ip) and torch.equal(tk, tp)
    assert torch.equal(ik, il) and torch.equal(tk, tl)
    if name in ("soup", "bumpy"):
        assert (ik >= 0).sum() > n // 20
    t_near = torch.where(ik[:n] >= 0, tk[:n] * 1.01, t_max)
    for t_far in (t_max * 0.4, t_near):
        fw, lw = fused_and_list(ts, o, d, t_far, anyhit=True)
        if two_level:
            occ = oi.fused_anyhit_super_kernel(*fw, T_MIN)
            assert torch.equal(occ, oi.fused_anyhit_super_reference(*fw, T_MIN))
            assert torch.equal(occ, oi.anyhit_super_kernel(*lw, T_MIN))
        else:
            occ = oi.fused_anyhit_kernel(*fw, T_MIN)
            assert torch.equal(occ, oi.fused_anyhit_reference(*fw, T_MIN))
            assert torch.equal(occ, oi.anyhit_kernel(*lw, T_MIN))


@pytest.mark.cuda
def test_fused_all_dead_tile_and_nan_ray(card):
    """A tile whose every ray is dead walks nothing; a NaN ray hits nothing
    and does not disturb its tile."""
    ts = scene_on("soup", card)
    o, d, t_max = rays(384, CASES["soup"][1], seed=4, device=card, dead_frac=0.0)
    t_max[128:256] = 0.0
    o.x[300] = float("nan")
    fw, lw = fused_and_list(ts, o, d, t_max, anyhit=False)
    tk, ik = oi.fused_closest_kernel(*fw, T_MIN)
    tl, il = oi.closest_kernel(*lw, T_MIN)
    assert torch.equal(ik, il) and torch.equal(tk, tl)
    assert (ik[128:256] == -1).all() and ik[300] == -1 and (ik >= 0).sum() > 50
    assert not oi.fused_anyhit_kernel(*fw, T_MIN)[128:256].any()


@pytest.mark.cuda
def test_fused_queries_launch_kernels_and_match_list_path(card, monkeypatch):
    """`FUSED_CULL` sends the queries through F-I and no list kernel, with
    the list path's results."""
    on = lambda v: v.map(lambda c: c.to(card))  # noqa: E731
    for spec, origin, names in (
            (CASES["soup"][0], CASES["soup"][1], ("fused_closest", "fused_anyhit")),
            (bumpy_sphere, BUMPY[1], ("fused_closest_super", "fused_anyhit_super"))):
        ts = compile_scene(spec(), device=card).scene
        o, d, t_max = rays(777, origin, seed=5, device="cpu", aimed=spec is bumpy_sphere)
        args = (ts, on(o), on(d), T_MIN, t_max.to(card))
        want = oi.find_closest_soa(*args), oi.occluded_soa(*args[:4], args[4] * 0.4)
        cuda.reset_launches()
        monkeypatch.setattr(oi, "FUSED_CULL", True)
        got = oi.find_closest_soa(*args), oi.occluded_soa(*args[:4], args[4] * 0.4)
        monkeypatch.setattr(oi, "FUSED_CULL", False)
        assert {k for k, v in cuda.LAUNCHES.items() if v} == set(names)
        assert torch.equal(got[0][0], want[0][0]) and torch.equal(got[0][1], want[0][1])
        assert torch.equal(got[1], want[1])


def assert_cull_equal(got, want):
    for g, w, what in zip(got, want, ("lists", "counts", "entries", "far")):
        assert g.dtype == w.dtype and g.shape == w.shape, what
        assert torch.equal(g, w), what


def cull_boxes(walk, scene):
    """The boxes the cull of `walk` took: superclusters or clusters."""
    return ((scene.super_min, scene.super_max) if oi._is_super(walk)
            else (scene.cluster_min, scene.cluster_max))


def pytorch_cull_walk(scene, walk):
    """The list walk's operands with the lists of `_cull` itself on the same
    rays: int32 lists and counts, the entries, far in the rays' row 7."""
    *head, _, _, _, r = walk
    lists, counts, entries, far = oi._cull(V3(r[0], r[1], r[2]), V3(r[3], r[4], r[5]),
                                           r[6], *cull_boxes(walk, scene))
    return (*head, lists.to(torch.int32), counts.to(torch.int32), entries.contiguous(),
            torch.cat([r[:7], far[None]]))


@pytest.mark.cuda
@pytest.mark.parametrize("two_level,name", [
    *[(lv, c) for lv in (False, True) for c in CASES], (True, "bumpy")])
@pytest.mark.parametrize("n", [100, 1000])
def test_cull_kernel_matches_plain_version(card, monkeypatch, name, two_level, n):
    """K, the cull of `_prep` on the card, bit for bit against
    `cull_reference` and against `_cull` itself, and A, B, D, E fed by K
    against the same walks fed by `_cull`; ~10% dead rays, non-aligned
    batches."""
    if two_level:
        monkeypatch.setattr(oi, "SUPER_MIN_C", 0)
    spec, origin = BUMPY if name == "bumpy" else CASES[name]
    ts = compile_scene(spec(), device=card).scene
    o, d, t_max = rays(n, origin, seed=n, device=card, aimed=name == "bumpy")
    for anyhit, t_far in ((False, t_max), (True, t_max * 0.4)):
        cuda.reset_launches()
        kw, *_ = oi._prep(ts, o, d, T_MIN, t_far, anyhit=anyhit)
        assert cuda.LAUNCHES["cull"] == 1 and oi._is_super(kw) == two_level
        lw = pytorch_cull_walk(ts, kw)
        for a, b in zip(kw, lw):
            assert a.dtype == b.dtype and torch.equal(a.nan_to_num(), b.nan_to_num())
        boxes = cull_boxes(kw, ts)
        got = oi.cull_kernel(*boxes, kw[-1])
        torch.cuda.synchronize()
        assert_cull_equal(got, oi.cull_reference(*boxes, kw[-1]))
        closest, anyh = oi._searches(lw)
        fn = anyh if anyhit else closest
        out_k, out_l = fn(*kw, T_MIN), fn(*lw, T_MIN)
        for a, b in zip(out_k if not anyhit else (out_k,),
                        out_l if not anyhit else (out_l,)):
            assert torch.equal(a, b)


def random_boxes(n, seed, device, empty_frac=0.2):
    """n boxes (n, 3), some of them flat and some empty (the +-3e38
    sentinels)."""
    rs = np.random.default_rng(seed)
    c = rs.uniform(-1.0, 1.0, (n, 3))
    h = rs.uniform(0.0, 0.4, (n, 3)) * (rs.random((n, 3)) > 0.1)
    cmin, cmax = (c - h).astype(np.float32), (c + h).astype(np.float32)
    empty = rs.random(n) < empty_frac
    empty[0] = False
    cmin[empty], cmax[empty] = 3e38, -3e38
    return torch.as_tensor(cmin, device=device), torch.as_tensor(cmax, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5, 32, 64, 128])
@pytest.mark.parametrize("tiles", [1, 5, 4097])
def test_cull_kernel_on_random_boxes(card, n, tiles):
    """K bit for bit against `cull_reference` on 1 to 128 seeded boxes (some
    flat, some empty) and batches of 1, 5 and 4,097 tiles (none a multiple of
    the kernel's tiles a block): ~10% dead rays, some axis-aligned, a dead
    tile among the boxes, a tile that misses every box, a NaN origin, a NaN
    direction and a NaN tmax."""
    cmin, cmax = random_boxes(n, n, card)
    B = tiles * oi.TILE
    rs = np.random.default_rng(tiles)
    o = rs.uniform(-1.5, 1.5, (3, B)).astype(np.float32)
    d = rs.normal(size=(3, B)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    d[:, 7::11] = np.float32([[0.0], [-1.0], [0.0]])
    tmax = np.where(rs.random(B) < 0.1, 0.0, rs.uniform(0.2, 5.0, B)).astype(np.float32)
    tmax[::5] = 1e8
    if tiles > 1:
        tmax[128:256] = 0.0                   # a dead tile among the boxes
        o[:, 256:384] += 50.0                 # a tile that misses every box
        d[:, 256:384] = np.float32([[1.0], [0.0], [0.0]])
    o[0, 3], d[1, 9], tmax[12] = np.nan, np.nan, np.nan
    r = torch.as_tensor(np.concatenate([o, d, tmax[None], np.zeros((1, B), np.float32)]),
                        device=card)
    cuda.reset_launches()
    got = oi.cull_kernel(cmin, cmax, r)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["cull"] == 1
    want = oi.cull_reference(cmin, cmax, r)
    assert_cull_equal(got[:3], want[:3])
    assert torch.equal(got[3].nan_to_num(nan=-7.0), want[3].nan_to_num(nan=-7.0))
    assert got[3][12].isnan() and got[3][3] == -oi.BIG and int(got[1][0]) > 0
    if tiles > 1:
        assert int(got[1][2]) == 0 and (got[3][128:256] <= 0).all()
    far = torch.empty(B, device=card)
    assert oi.cull_kernel(cmin, cmax, r, far=far)[3] is far
    assert torch.equal(far.nan_to_num(nan=-7.0), want[3].nan_to_num(nan=-7.0))


@pytest.mark.cuda
def test_cull_kernel_dead_tile_nan_origin_nan_tmax(card):
    """A tile of dead rays (far capped at tmax = 0), a NaN origin (passes no
    box) and a NaN tmax (a NaN far): all as `_cull`, through `_prep`."""
    ts = scene_on("soup", card)
    o, d, t_max = rays(512, CASES["soup"][1], seed=4, device=card, dead_frac=0.0)
    t_max[128:256] = 0.0
    o.x[300] = float("nan")
    t_max[400] = float("nan")
    d.y[401] = 0.0
    kw, *_ = oi._prep(ts, o, d, T_MIN, t_max, anyhit=False)
    lw = pytorch_cull_walk(ts, kw)
    for a, b in zip(kw[-4:-1], lw[-4:-1]):
        assert torch.equal(a, b)
    far = kw[-1][7]
    assert torch.equal(far.nan_to_num(nan=-7.0), lw[-1][7].nan_to_num(nan=-7.0))
    assert (far[128:256] <= 0).all() and kw[-3][0] > 0
    assert far[400].isnan() and far[300] == -oi.BIG


@pytest.mark.cuda
def test_cull_kernel_route_launches_kernel_and_matches_list_path(card, monkeypatch):
    """A query on the card with at most 128 boxes launches K and never calls
    `_cull`, with the results of the walks fed by `_cull`; more than 128
    boxes take `_cull`, never K."""
    on = lambda v: v.map(lambda c: c.to(card))  # noqa: E731
    culls = []
    real_cull = oi._cull
    monkeypatch.setattr(oi, "_cull", lambda *a: culls.append(1) or real_cull(*a))
    for spec, origin, names in (
            (CASES["soup"][0], CASES["soup"][1], ("cull", "closest", "anyhit")),
            (bumpy_sphere, BUMPY[1], ("cull", "closest_super", "anyhit_super"))):
        ts = compile_scene(spec(), device=card).scene
        o, d, t_max = rays(777, origin, seed=5, device="cpu", aimed=spec is bumpy_sphere)
        args = (ts, on(o), on(d), T_MIN, t_max.to(card))
        cuda.reset_launches()
        got = oi.find_closest_soa(*args), oi.occluded_soa(*args[:4], args[4] * 0.4)
        assert cuda.LAUNCHES["cull"] == 2 and not culls
        assert {k for k, v in cuda.LAUNCHES.items() if v} == set(names)
        with mock.patch.object(oi, "cull_lists", oi.cull_reference):
            want = oi.find_closest_soa(*args), oi.occluded_soa(*args[:4], args[4] * 0.4)
        assert len(culls) == 2 and cuda.LAUNCHES["cull"] == 2
        culls.clear()
        assert torch.equal(got[0][0], want[0][0]) and torch.equal(got[0][1], want[0][1])
        assert torch.equal(got[1], want[1])
    big = torch.zeros((129, 3), device=card)
    rays8 = torch.zeros((8, 128), device=card)
    cuda.reset_launches()
    oi.cull_lists(big, big + 1.0, rays8)
    assert cuda.LAUNCHES["cull"] == 0 and len(culls) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("n", [100, 1000, 4096])
def test_walk_stats_kernels_match_kernel_a_and_plain_versions(card, name, n):
    """The counting walk and the walk without early exit return kernel A's
    (t, idx) bit for bit; `walked` equals the step-by-step model's and never
    exceeds the count."""
    ts = scene_on(name, card)
    o, d, t_max = rays(n, CASES[name][1], seed=n, device=card)
    walk, *_ = oi._prep(ts, o, d, T_MIN, t_max, anyhit=False)
    ta, ia = oi.closest_kernel(*walk, T_MIN)
    td, id_, walked = oi.closest_dbg_kernel(*walk, T_MIN)
    tf, if_ = oi.closest_full_kernel(*walk, T_MIN)
    torch.cuda.synchronize()
    assert torch.equal(td, ta) and torch.equal(id_, ia)
    assert torch.equal(tf, ta) and torch.equal(if_, ia)
    tp, ip, wp = oi.closest_dbg_reference(*walk, T_MIN)
    assert torch.equal(tp, ta) and torch.equal(ip, ia)
    assert walked.dtype == torch.int32 and torch.equal(walked, wp)
    assert (walked <= walk[-3]).all()
    tq, iq = oi.closest_full_reference(*walk, T_MIN)
    assert torch.equal(tq, ta) and torch.equal(iq, ia)
    if name == "soup":      # unrelated rays: nearly every listed cluster is walked
        assert (walked > 0).any()


@pytest.mark.cuda
def test_two_level_queries_launch_kernels_and_match_cpu(card):
    cpu = compile_scene(bumpy_sphere(), device="cpu").scene
    ts = compile_scene(bumpy_sphere(), device=card).scene
    o, d, t_max = rays(777, BUMPY[1], seed=5, device="cpu", aimed=True)
    on = lambda v: v.map(lambda c: c.to(card))  # noqa: E731
    cuda.reset_launches()
    t_g, i_g = oi.find_closest_soa(ts, on(o), on(d), T_MIN, t_max.to(card))
    occ_g = oi.occluded_soa(ts, on(o), on(d), T_MIN, t_max.to(card) * 1e-8)
    assert cuda.LAUNCHES["closest_super"] == 1 == cuda.LAUNCHES["anyhit_super"]
    assert cuda.LAUNCHES["closest"] == 0 == cuda.LAUNCHES["anyhit"]
    t_c, i_c = oi.find_closest_soa(cpu, o, d, T_MIN, t_max)
    assert torch.equal(i_g.cpu(), i_c) and (i_c >= 0).sum() > 100
    torch.testing.assert_close(t_g.cpu(), t_c, rtol=1e-4, atol=1e-5)
    assert torch.equal(occ_g.cpu(), oi.occluded_soa(cpu, o, d, T_MIN, t_max * 1e-8))


@pytest.mark.cuda
def test_queries_launch_kernels_and_match_cpu(card):
    ts_cpu = scene_on("soup", "cpu")
    ts = scene_on("soup", card)
    o, d, t_max = rays(777, CASES["soup"][1], seed=5, device="cpu")
    cuda.reset_launches()
    t_g, i_g = oi.find_closest_soa(ts, o.map(lambda c: c.to(card)),
                                   d.map(lambda c: c.to(card)), T_MIN, t_max.to(card))
    assert cuda.LAUNCHES["closest"] == 1
    t_c, i_c = oi.find_closest_soa(ts_cpu, o, d, T_MIN, t_max)
    assert torch.equal(i_g.cpu(), i_c)
    torch.testing.assert_close(t_g.cpu(), t_c, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_fetch_cols_backward_on_card(card):
    rs = np.random.default_rng(0)
    table = torch.as_tensor(rs.normal(size=(40, 36)).astype(np.float32))
    idx = torch.as_tensor(rs.integers(0, 40, 5000))
    ct = torch.as_tensor(rs.normal(size=(36, 5000)).astype(np.float32))
    grads = []
    cuda.reset_launches()
    for dev in ("cpu", card, card):
        t = table.to(dev, copy=True).requires_grad_()
        (ou.fetch_cols(t, idx.to(dev)) * ct.to(dev)).sum().backward()
        grads.append(t.grad.cpu())
    assert cuda.LAUNCHES["scatter"] == 2
    # the kernel sums in another order than the CPU's index_add_
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-5, atol=1e-5)
    assert torch.equal(grads[1], grads[2])


def scatter_case(name, cols, device):
    """(ct (K, B), idx (B,), P): inputs of the scatter-add, from a seed."""
    rs = np.random.default_rng(len(name) + cols)
    B, P = {"few_rows": (100_000, 17), "many_rows": (70_001, 65_544),
            "one_row": (50_000, 136), "tiny": (7, 5),
            "runs": (40_960, 5_000), "one_row_wavefront": ((1 << 19) - 1, 136),
            "light_rows": (1 << 19, 2)}[name]
    if name in ("one_row", "one_row_wavefront"):
        idx = np.full(B, 77)
    elif name == "runs":   # sorted runs of 1..600, as primary hits give
        idx = np.repeat(np.arange(P), rs.integers(1, 600, P))[:B]
        idx = np.concatenate([idx, rs.integers(0, P, B - idx.size)])
    else:
        idx = rs.integers(0, P, B)
    ct = rs.normal(size=(cols, B)).astype(np.float32)
    ct[:, rs.random(B) < 0.1] = 0.0   # dead lanes carry zero cotangent
    return (torch.as_tensor(ct).to(device),
            torch.as_tensor(idx, dtype=torch.int64).to(device), P)


def float64_sum(ct, idx, P):
    """(the float64 scatter-add of ct (K, B) by idx, its bound per entry:
    1e-5 * the float64 sum of |terms| + 1e-6)."""
    oracle = torch.zeros((P, ct.shape[0]), dtype=torch.float64, device=ct.device)
    oracle.index_add_(0, idx, ct.t().double())
    mass = torch.zeros_like(oracle).index_add_(0, idx, ct.t().double().abs())
    return oracle, 1e-5 * mass + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [1, 3, 16, 36])
@pytest.mark.parametrize("name", ["few_rows", "many_rows", "one_row", "tiny",
                                  "runs", "one_row_wavefront", "light_rows"])
def test_scatter_kernel_matches_plain_version(card, name, cols):
    """Kernel J bit-equal to `scatter_rows_ordered_reference` (its own sum
    order) in both layouts; J and `index_add_` each against a float64 sum
    (|error| <= 1e-5 * sum of |terms| + 1e-6 per entry: float32 sums in
    another order); J bit-equal across two launches."""
    ct, idx, P = scatter_case(name, cols, card)
    out = ou.scatter_kernel(ct, idx, P)
    torch.cuda.synchronize()
    assert torch.equal(out, ou.scatter_rows_ordered_reference(ct, idx, P))
    oracle, tol = float64_sum(ct, idx, P)
    assert bool(((out.double() - oracle).abs() <= tol).all())
    # the plain version is `index_add_` with float atomics, whose order
    # changes from run to run: it is held to the same float64 sum by the same
    # bound, not to the kernel
    plain = ou.scatter_rows_reference(ct, idx, P)
    assert bool(((plain.double() - oracle).abs() <= tol).all())
    assert torch.equal(out, ou.scatter_kernel(ct, idx, P))
    rows = ct.t().contiguous()           # the same values as (B, K) rows
    assert torch.equal(out, ou.scatter_kernel(rows.t(), idx, P))


@pytest.mark.cuda
def test_scatter_kernel_refuses_other_column_counts(card):
    """J is built for `SCATTER_COLS`; another K raises before any launch."""
    cuda.reset_launches()
    idx = torch.zeros(300, dtype=torch.int64, device=card)
    for cols in (2, 4, 37):
        with pytest.raises(ValueError, match="built for"):
            ou.scatter_kernel(torch.zeros((cols, 300), device=card), idx, 8)
    assert cuda.LAUNCHES["scatter"] == 0


UNPACK_B = [1, 3, 127, 128, 129, 4097, 524_288]


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 136, 65_544])
@pytest.mark.parametrize("B", UNPACK_B)
def test_unpack_kernel_bit_equal_to_plain_version(card, B, P):
    """C at ragged batch sizes (B not a multiple of the block, nor of 4) and
    table sizes, indices outside [0, P) clamped, bit for bit."""
    gen = torch.Generator(device=card).manual_seed(B + P)
    table = torch.randn((P, 36), generator=gen, device=card)
    idx = torch.randint(-3, P + 3, (B,), generator=gen, device=card)
    got = ou.unpack_kernel(table, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, ou.fetch_cols_reference(table, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("B", UNPACK_B)
def test_unpack_kernel_pure_unpack_is_the_transpose(card, B):
    """C with idx = arange(B) over a (B, 36) table: the Pallas unpack
    kernels' contract, bit-equal to the transpose."""
    rows = torch.randn((B, 36), generator=torch.Generator(device=card).manual_seed(B),
                       device=card)
    got = ou.unpack_kernel(rows, torch.arange(B, device=card))
    torch.cuda.synchronize()
    assert torch.equal(got, rows.t())


@pytest.mark.cuda
def test_unpack_kernel_refuses_a_misaligned_table(card):
    """A table view whose base is 4 bytes past a 16-byte boundary is refused
    (the kernel reads 16-byte pieces), never sent to the plain version; its
    aligned copy launches."""
    P, B = 1000, 5001
    flat = torch.randn(P * 36 + 1, device=card)
    table = flat[1:].view(P, 36)
    assert table.data_ptr() % 16 == 4 and table.is_contiguous()
    idx = torch.randint(0, P, (B,), device=card)
    cuda.reset_launches()
    with pytest.raises(ValueError, match="16-byte aligned"):
        ou.gather_unpack(table, idx)
    assert cuda.LAUNCHES["unpack"] == 0
    copy = table.clone()
    assert torch.equal(ou.gather_unpack(copy, idx), ou.fetch_cols_reference(copy, idx))
    assert cuda.LAUNCHES["unpack"] == 1


def hand_scene(corners, device):
    """Clusters of right triangles, legs of 1 along x and y in the plane z =
    corner z. `corners` (C, 3): one triangle a cluster, in its first slot;
    (C, K, 3): K triangles a cluster, in its first K slots. C is a multiple
    of 16; the other slots of a cluster are degenerate (never hit). A
    cluster's box is the union of the unit squares above its corners, so a
    ray through a square's far half enters the box and misses the triangle.
    Superclusters of 16 consecutive clusters. What `_prep` reads of a
    compiled scene."""
    from types import SimpleNamespace

    corners = torch.as_tensor(np.asarray(corners, np.float32), device=device)
    if corners.dim() == 2:
        corners = corners[:, None]
    C, K = corners.shape[:2]
    v0 = torch.zeros((C, oi.CLUSTER_SIZE, 3), device=device)
    v0[:, :K] = corners
    v0[:, K:] = corners[:, :1]
    e1 = torch.zeros_like(v0)
    e2 = torch.zeros_like(v0)
    e1[:, :K, 0] = 1.0
    e2[:, :K, 1] = 1.0
    cmin = corners.amin(dim=1)
    cmax = (corners + torch.tensor([1.0, 1.0, 0.0], device=device)).amax(dim=1)
    return SimpleNamespace(
        tri_v0=v0.reshape(-1, 3), tri_e1=e1.reshape(-1, 3), tri_e2=e2.reshape(-1, 3),
        num_mega=0, num_live_spheres=0, cluster_min=cmin, cluster_max=cmax,
        super_min=cmin.reshape(C // 16, 16, 3).amin(dim=1),
        super_max=cmax.reshape(C // 16, 16, 3).amax(dim=1))


def _along_z(xy, t_max, device):
    """Rays from (x, y, 0) along +z."""
    xy = np.asarray(xy, np.float32)
    n = xy.shape[0]
    o = V3.of(torch.as_tensor(np.concatenate([xy, np.zeros((n, 1), np.float32)], 1),
                              device=device))
    d = V3.of(torch.as_tensor(np.tile(np.float32([0.0, 0.0, 1.0]), (n, 1)), device=device))
    return o, d, torch.as_tensor(np.asarray(t_max, np.float32), device=device)


ANYHIT_CASES = ["fan_out", "nan_ray", "all_dead", "blocked_first_child", "all_children"]


def anyhit_case(name, device):
    """(scene, o, d, t_max, dead tile) of one hand-built input of kernel E.
    fan_out: 128 clusters in a row along x (8 superclusters), ray r through
    cluster r's square, so the tile's 128 rays each ask for another child;
    even rays hit, odd rays pass the far half. nan_ray: as fan_out with a NaN
    origin and a NaN direction. all_dead: as fan_out with a second tile of
    dead rays, whose list the test fills with every supercluster. Then 16
    clusters stacked along z (one supercluster): blocked_first_child, every
    ray through the near half, blocked by the first child; all_children, ray
    0 through the far half of every square, asking for all 16 children and
    hitting none, ray 1 the same with a tmax between the fourth and the fifth
    child, the others hit."""
    rs = np.random.default_rng(len(name))
    r = np.arange(oi.TILE)
    if name in ("fan_out", "nan_ray", "all_dead"):
        scene = hand_scene([(2.0 * c, 0.0, 5.0) for c in range(128)], device)
        off = np.where(r % 2, 0.75, 0.25).astype(np.float32)
        xy = np.stack([2.0 * r + off, off], 1)
        t_max = np.full(oi.TILE, 10.0)
        if name == "all_dead":
            xy = np.concatenate([xy, xy])
            t_max = np.concatenate([t_max, np.zeros(oi.TILE)])
        o, d, tm = _along_z(xy, t_max, device)
        if name == "nan_ray":
            o.x[5] = float("nan")
            d.z[6] = float("nan")
        return scene, o, d, tm, name == "all_dead"
    scene = hand_scene([(0.0, 0.0, 5.0 + j) for j in range(16)], device)
    xy = rs.uniform(0.02, 0.45, (oi.TILE, 2))
    t_max = np.full(oi.TILE, 100.0)
    if name == "all_children":
        xy[:2] = 0.75
        t_max[1] = 8.5
    o, d, tm = _along_z(xy, t_max, device)
    return scene, o, d, tm, False


def anyhit_case_walks(name, device, monkeypatch):
    """E's and I's operands for one hand-built input (`_prep`, list and
    fused); for all_dead, the dead tile lists every supercluster."""
    monkeypatch.setattr(oi, "SUPER_MIN_C", 0)
    scene, o, d, t_max, dead_tile = anyhit_case(name, device)
    walk, *_ = oi._prep(scene, o, d, T_MIN, t_max, anyhit=True)
    fwalk, *_ = oi._prep(scene, o, d, T_MIN, t_max, anyhit=True, fused=True)
    assert oi._is_super(walk) and oi._is_super(fwalk) and oi._is_fused(fwalk)
    if dead_tile:
        tri, bounds, lists, counts, entries, rays = walk
        S = bounds.shape[0]
        lists, counts, entries = lists.clone(), counts.clone(), entries.clone()
        lists[1] = torch.arange(S, dtype=torch.int32, device=device)
        counts[1] = S
        entries[1] = 0.0
        walk = (tri, bounds, lists, counts, entries, rays)
    return walk, fwalk


@pytest.mark.parametrize("name", ANYHIT_CASES)
def test_hand_built_anyhit_inputs_ask_as_designed(name, monkeypatch):
    """On the CPU: the hand-built inputs of E ask for the children they are
    built to ask for (`refine_children`), and the plain version occludes the
    rays they are built to occlude."""
    walk, _ = anyhit_case_walks(name, "cpu", monkeypatch)
    tri, bounds, lists, counts, entries, rays = walk
    asks = oi.refine_children(bounds, rays, rays[6]).reshape(rays.shape[1], -1)
    occ = oi.anyhit_super_reference(*walk, T_MIN)
    n = asks[:oi.TILE].sum(dim=1)
    even = torch.arange(oi.TILE) % 2 == 0
    if name == "fan_out":
        assert (n == 1).all() and torch.equal(asks[:oi.TILE].float().argmax(dim=1),
                                              torch.arange(oi.TILE))
        assert torch.equal(occ, even)
    elif name == "nan_ray":
        assert n[5] == 0 and n[6] == 0 and not occ[5] and not occ[6]
        keep = torch.ones(oi.TILE, dtype=torch.bool)
        keep[5:7] = False
        assert torch.equal(occ[keep], even[keep])
    elif name == "all_dead":
        assert int(counts[1]) == bounds.shape[0] and not occ[oi.TILE:].any()
        assert torch.equal(occ[:oi.TILE], even)
    elif name == "blocked_first_child":
        assert (n == 16).all() and occ.all()
    else:
        assert n[0] == 16 and n[1] == 4 and not occ[0] and not occ[1] and occ[2:].all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ANYHIT_CASES)
def test_anyhit_super_kernel_on_hand_built_inputs(card, monkeypatch, name):
    """E equal to its plain version, and I bit-equal to E, on the hand-built
    inputs: a tile of 128 rays that each ask for another child, a NaN ray, a
    dead tile that lists every supercluster, every ray blocked in the first
    child, a ray that asks for all 16 children."""
    walk, fwalk = anyhit_case_walks(name, card, monkeypatch)
    occ = oi.anyhit_super_kernel(*walk, T_MIN)
    torch.cuda.synchronize()
    assert torch.equal(occ, oi.anyhit_super_reference(*walk, T_MIN))
    assert torch.equal(oi.fused_anyhit_super_kernel(*fwalk, T_MIN), occ)


CLOSEST_CASES = ["fan_out", "contention", "ties", "stacked", "at_tmax", "nan_ray",
                 "dead_tile"]


def closest_case(name, device):
    """(scene, o, d, t_max, dead tile, expected t, expected idx) of one
    hand-built input of kernel D. All rays run along +z from z = 0.
    fan_out: 128 clusters in a row along x (8 superclusters), ray r through
    cluster r's square, so the tile's 128 rays each ask for another child;
    even rays hit at t = 5, odd rays pass the far half. nan_ray: as fan_out
    with a NaN origin (ray 5) and a NaN direction (ray 6). dead_tile: as
    fan_out with a second tile of dead rays, whose list the test fills with
    every supercluster. contention: every ray through cluster 0, which holds
    128 triangles at distinct depths but three at the nearest (slots 64, 65
    and 100: a tie inside a warp and across warps), so every lane of the
    block hits every ray. ties: rays 0-63 meet the same triangle in clusters
    2 and 9 (one supercluster), rays 64-127 in clusters 5 and 20 (two
    superclusters; supercluster 1 is listed first, as cluster 31 puts its
    box nearer); the smallest index wins. stacked: 16 clusters stacked along
    z, child 15 the nearest, so every ray asks for all 16 and the last child
    in ascending order holds the answer. at_tmax: the triangle at t = 5
    exactly; even rays have tmax = 5 (a miss), odd rays the next float up (a
    hit)."""
    rs = np.random.default_rng(len(name))
    r = np.arange(oi.TILE)
    near = rs.uniform(0.05, 0.45, (oi.TILE, 2))       # inside a triangle
    far_ = rs.uniform(0.55, 0.95, (oi.TILE, 2))       # in its box, outside it
    dead_tile = False
    if name in ("fan_out", "nan_ray", "dead_tile"):
        scene = hand_scene([(2.0 * c, 0.0, 5.0) for c in range(128)], device)
        xy = np.where((r % 2 == 0)[:, None], near, far_) + np.stack([2.0 * r, 0 * r], 1)
        t_max = np.full(oi.TILE, 10.0, np.float32)
        t_want = np.where(r % 2 == 0, 5.0, 10.0).astype(np.float32)
        i_want = np.where(r % 2 == 0, r * oi.CLUSTER_SIZE, -1)
        if name == "nan_ray":
            t_want[5:7], i_want[5:7] = 10.0, -1
        if name == "dead_tile":
            xy = np.concatenate([xy, xy])
            t_max = np.concatenate([t_max, np.zeros(oi.TILE, np.float32)])
            t_want = np.concatenate([t_want, np.zeros(oi.TILE, np.float32)])
            i_want = np.concatenate([i_want, np.full(oi.TILE, -1)])
            dead_tile = True
    elif name == "contention":
        k = np.arange(oi.CLUSTER_SIZE)
        z = 5.0 + 0.01 * ((k + 64) % 128)
        z[[65, 100]] = 5.0
        slots = np.stack([0 * k, 0 * k, z], 1)
        others = np.repeat(np.asarray([(3.0 * c, 3.0, 5.0) for c in range(1, 16)])[:, None],
                           oi.CLUSTER_SIZE, axis=1)
        scene = hand_scene(np.concatenate([slots[None], others]), device)
        xy, t_max = near, np.full(oi.TILE, 100.0, np.float32)
        t_want, i_want = np.full(oi.TILE, 5.0, np.float32), np.full(oi.TILE, 64)
    elif name == "ties":
        corners = [(100.0 + 2.0 * c, 50.0, 5.0) for c in range(32)]
        corners[2] = corners[9] = (0.0, 0.0, 5.0)
        corners[5] = corners[20] = (3.0, 0.0, 5.0)
        corners[31] = (2.5, -0.5, 1.0)   # entered by rays 64-127, never hit
        scene = hand_scene(corners, device)
        xy = np.where((r < 64)[:, None], near, near + [3.0, 0.0])
        t_max = np.full(oi.TILE, 100.0, np.float32)
        t_want = np.full(oi.TILE, 5.0, np.float32)
        i_want = np.where(r < 64, 2, 5) * oi.CLUSTER_SIZE
    elif name == "stacked":
        scene = hand_scene([(0.0, 0.0, 20.0 - j) for j in range(16)], device)
        xy, t_max = near, np.full(oi.TILE, 100.0, np.float32)
        t_want, i_want = np.full(oi.TILE, 5.0, np.float32), np.full(oi.TILE, 15 * 128)
    else:   # at_tmax
        scene = hand_scene([(3.0 * c, 0.0, 5.0) for c in range(16)], device)
        xy = near
        t_max = np.where(r % 2 == 0, np.float32(5.0),
                         np.nextafter(np.float32(5.0), np.float32(np.inf)))
        t_want = t_max.astype(np.float32)
        t_want[1::2] = 5.0
        i_want = np.where(r % 2 == 0, -1, 0)
    o, d, tm = _along_z(xy, t_max, device)
    if name == "nan_ray":
        o.x[5] = float("nan")
        d.z[6] = float("nan")
    return (scene, o, d, tm, dead_tile, torch.as_tensor(t_want, dtype=torch.float32),
            torch.as_tensor(i_want, dtype=torch.int32))


def closest_case_walks(name, device, monkeypatch):
    """D's and H's operands for one hand-built input (`_prep`, list and
    fused), with the expected (t, idx); for dead_tile, the dead tile lists
    every supercluster."""
    monkeypatch.setattr(oi, "SUPER_MIN_C", 0)
    scene, o, d, t_max, dead_tile, t_want, i_want = closest_case(name, device)
    walk, *_ = oi._prep(scene, o, d, T_MIN, t_max, anyhit=False)
    fwalk, *_ = oi._prep(scene, o, d, T_MIN, t_max, anyhit=False, fused=True)
    assert oi._is_super(walk) and oi._is_super(fwalk) and oi._is_fused(fwalk)
    if dead_tile:
        tri, bounds, lists, counts, entries, rays = walk
        S = bounds.shape[0]
        lists, counts, entries = lists.clone(), counts.clone(), entries.clone()
        lists[1] = torch.arange(S, dtype=torch.int32, device=device)
        counts[1] = S
        entries[1] = 0.0
        walk = (tri, bounds, lists, counts, entries, rays)
    return walk, fwalk, t_want, i_want


def key_bits(t):
    """`key_bits` of csrc/intersect_common.cuh: the bits of float32 t as
    integers in the order of the floats (negative t too)."""
    b = np.asarray(t, np.float32).view(np.uint32).astype(np.int64)
    return np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)


def key_float(k):
    """The float32 whose `key_bits` are k."""
    k = np.asarray(k, np.int64)
    return np.where(k & 0x80000000, k & 0x7FFFFFFF, ~k & 0xFFFFFFFF).astype(
        np.uint32).view(np.float32)


def pair_walk_model(walk, t_min):
    """The pair-parallel walk of kernel D step by step, on the CPU: per tile
    a 64-bit key a ray (`key_bits(t)` << 32 | index, from (tmax, ~0)); per listed
    supercluster the exit against max over rays of min(best, far) (only with
    t_min >= 0: the cull's entries and far bound the hits ahead of the
    origin), the children each ray asks for (`refine_children` at its best from the key),
    then for each asked child and each ray listed for it the 128 lanes' tests,
    reduced a warp at a time (hits strictly inside (t_min, tmax), the least t
    bits, the lowest lane) and folded into the key by min. Returns (t, idx)
    as the kernel writes them."""
    tri, bounds, lists, counts, entries, rays = walk
    B = rays.shape[1]
    comp = tri.permute(1, 0, 2)                       # (12, C, 128)
    t_out = torch.empty(B, dtype=torch.float32)
    i_out = torch.empty(B, dtype=torch.int32)
    for tile in range(B // oi.TILE):
        r = rays[:, tile * oi.TILE:(tile + 1) * oi.TILE]
        key = [(int(key_bits(x)) << 32) | 0xFFFFFFFF for x in r[6].numpy()]
        for k in range(int(counts[tile])):
            best = torch.as_tensor(key_float([kk >> 32 for kk in key]))
            limit = torch.fmin(best, r[7])
            worst = torch.where(limit.isnan(), -torch.inf, limit).max()
            if t_min >= 0 and not bool(entries[tile, k] <= worst):
                break
            s = int(lists[tile, k])
            dead = r[6] <= t_min
            asks = oi.refine_children(bounds[s:s + 1], r, best, t_min)[:, 0] & ~dead[:, None]
            for j in range(oi.SUPER):
                c = s * oi.SUPER + j
                for q in asks[:, j].nonzero()[:, 0].tolist():
                    cols = tuple(r[a, q].reshape(1, 1) for a in range(6))
                    t, ok = oi._plane_terms(cols, tuple(comp[m, c][None] for m in range(12)))
                    t, ok = t[0], ok[0]
                    hit = ok & (t > t_min) & (t < r[6, q])
                    bits = key_bits(t.numpy() + np.float32(0.0))   # -0 as +0
                    for w in range(oi.TILE // 32):
                        h = hit[w * 32:(w + 1) * 32].numpy()
                        if not h.any():
                            continue
                        b = bits[w * 32:(w + 1) * 32]
                        least = int(b[h].min())
                        first = int(np.flatnonzero(h & (b == least))[0]) + w * 32
                        key[q] = min(key[q], (least << 32) | (c * oi.CLUSTER_SIZE + first))
        lo = np.asarray([kk & 0xFFFFFFFF for kk in key], np.uint32)
        t_out[tile * oi.TILE:(tile + 1) * oi.TILE] = torch.as_tensor(
            key_float([kk >> 32 for kk in key]))
        i_out[tile * oi.TILE:(tile + 1) * oi.TILE] = torch.as_tensor(lo.view(np.int32))
    return t_out, i_out


@pytest.mark.parametrize("name", CLOSEST_CASES)
def test_hand_built_closest_inputs_ask_as_designed(name, monkeypatch):
    """On the CPU: the hand-built inputs of D ask for the children they are
    built to ask for (`refine_children` at tmax), and the plain version and
    a step-by-step model of the pair-parallel walk give the (t, idx) they are
    built to give, bit for bit."""
    walk, _, t_want, i_want = closest_case_walks(name, "cpu", monkeypatch)
    tri, bounds, lists, counts, entries, rays = walk
    asks = oi.refine_children(bounds, rays, rays[6]).reshape(rays.shape[1], -1)
    n = asks[:oi.TILE].sum(dim=1)
    if name in ("fan_out", "dead_tile"):
        assert (n == 1).all() and torch.equal(asks[:oi.TILE].float().argmax(dim=1),
                                              torch.arange(oi.TILE))
    elif name == "nan_ray":
        keep = torch.ones(oi.TILE, dtype=torch.bool)
        keep[5:7] = False
        assert n[5] == 0 and n[6] == 0 and (n[keep] == 1).all()
    elif name == "contention":
        assert (n == 1).all() and asks[:, 0].all()
    elif name == "ties":
        assert asks[:64, [2, 9]].all() and (n[:64] == 2).all()
        assert asks[64:, [5, 20, 31]].all() and (n[64:] == 3).all()
        assert torch.equal(lists[0, :2], torch.tensor([1, 0], dtype=torch.int32))
    elif name == "stacked":
        assert (n == 16).all()
    else:
        assert (n == 1).all() and asks[:, 0].all()
    if name == "dead_tile":
        assert int(counts[1]) == bounds.shape[0] and (rays[6, oi.TILE:] == 0).all()
    t, i = oi.closest_super_reference(*walk, T_MIN)
    assert torch.equal(t, t_want) and torch.equal(i, i_want)
    tm, im = pair_walk_model(walk, T_MIN)
    assert torch.equal(tm, t_want) and torch.equal(im, i_want)


def test_pair_walk_model_matches_plain_version(monkeypatch):
    """The step-by-step model of D's walk equals `closest_super_reference` bit
    for bit on random rays against the displaced sphere (16 superclusters),
    10% of them dead."""
    big = compile_scene(bumpy_sphere(), device="cpu").scene
    o, d, t_max = rays(256, BUMPY[1], seed=4, device="cpu", aimed=True)
    walk, *_ = oi._prep(big, o, d, T_MIN, t_max, anyhit=False)
    assert oi._is_super(walk)
    t, i = oi.closest_super_reference(*walk, T_MIN)
    assert (i >= 0).sum() > 100
    tm, im = pair_walk_model(walk, T_MIN)
    assert torch.equal(tm, t) and torch.equal(im, i)


def behind_case(device):
    """Kernel D's input for the exit at t_min = -3: two superclusters, the
    triangle of cluster 0 at z = 1 and that of cluster 16 at z = -1 (the
    others far aside). Rays 0-126 run along +z from z = 0: cluster 0 ahead
    at t = 1, cluster 16 behind at t = -1, which is the answer; ray 127 runs
    along -z from z = 5: cluster 0 at t = 4, cluster 16 at t = 6. Only ray
    127 enters supercluster 1 ahead, so the tile lists it second with entry
    6, beyond max over rays of min(best, far) = 4 after supercluster 0: a
    walk that exits there loses the hits behind rays 0-126."""
    corners = [(0.0, 0.0, 1.0)] + [(50.0 + 3.0 * c, 50.0, 1.0) for c in range(15)]
    corners += [(0.0, 0.0, -1.0)] + [(50.0 + 3.0 * c, 50.0, -1.0) for c in range(15)]
    scene = hand_scene(corners, device)
    xy = np.random.default_rng(7).uniform(0.05, 0.45, (oi.TILE, 2))
    o, d, t_max = _along_z(xy, np.full(oi.TILE, 100.0), device)
    o.z[127] = 5.0
    d.z[127] = -1.0
    t_want = np.full(oi.TILE, -1.0, np.float32)
    t_want[127] = 4.0
    i_want = np.full(oi.TILE, 16 * oi.CLUSTER_SIZE)
    i_want[127] = 0
    return (scene, o, d, t_max, -3.0, torch.as_tensor(t_want),
            torch.as_tensor(i_want, dtype=torch.int32))


def negative_t_min_walk(name, device, monkeypatch):
    """D's and H's operands at a negative t_min (`SUPER_MIN_C` 0): the flat
    walks' negative_t_min input as one supercluster, or `behind_case`."""
    monkeypatch.setattr(oi, "SUPER_MIN_C", 0)
    if name == "behind":
        scene, o, d, t_max, t_min, *_ = behind_case(device)
    else:
        scene, o, d, t_max, t_min, _ = flat_case(name, device)
    walk, *_ = oi._prep(scene, o, d, t_min, t_max, anyhit=False)
    fwalk, *_ = oi._prep(scene, o, d, t_min, t_max, anyhit=False, fused=True)
    assert oi._is_super(walk) and oi._is_super(fwalk) and t_min < 0
    return walk, fwalk, t_min


@pytest.mark.parametrize("name", ["negative_t_min", "behind"])
def test_pair_walk_model_takes_a_negative_t_min(name, monkeypatch):
    """On the CPU: the step-by-step model of D's walk equals
    `closest_super_reference` bit for bit at t_min = -3, where hits behind
    the origin count, so the exit between superclusters must not read the
    cull's entries and far. On `behind_case` the exit would fire (the second
    entry lies beyond every ray's min(best, far) after the first
    supercluster) and drop the answer of rays 0-126."""
    walk, _, t_min = negative_t_min_walk(name, "cpu", monkeypatch)
    t, i = oi.closest_super_reference(*walk, t_min)
    tm, im = pair_walk_model(walk, t_min)
    assert torch.equal(tm, t) and torch.equal(im, i) and (i >= 0).all()
    if name == "behind":
        _, _, _, _, _, t_want, i_want = behind_case("cpu")
        assert torch.equal(t[:oi.TILE], t_want) and torch.equal(i[:oi.TILE], i_want)
        tri, bounds, lists, counts, entries, rays = walk
        assert int(counts[0]) == 2
        first = oi.closest_super_reference(tri, bounds, lists, counts.clamp(max=1),
                                           entries, rays, t_min)[0]
        assert float(entries[0, 1]) > float(torch.minimum(first, rays[7]).max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", CLOSEST_CASES)
def test_closest_super_kernel_on_hand_built_inputs(card, monkeypatch, name):
    """D bit-equal to its plain version, and H bit-equal to D, on the
    hand-built inputs: 128 rays that each ask for another child, every lane
    of the block hitting every ray of one child, equal t in two children and
    in two superclusters, the nearest child last of 16, a hit at exactly
    tmax, a NaN ray, a dead tile that lists every supercluster."""
    walk, fwalk, t_want, i_want = closest_case_walks(name, card, monkeypatch)
    t, i = oi.closest_super_kernel(*walk, T_MIN)
    torch.cuda.synchronize()
    tp, ip = oi.closest_super_reference(*walk, T_MIN)
    assert torch.equal(t, tp) and torch.equal(i, ip)
    assert torch.equal(t.cpu(), t_want) and torch.equal(i.cpu(), i_want)
    tf, i_f = oi.fused_closest_super_kernel(*fwalk, T_MIN)
    assert torch.equal(tf, t) and torch.equal(i_f, i)


# --- the flat walks (A, B, F, G) on hand-built inputs -----------------------

FLAT_CASES = CLOSEST_CASES + ["widening", "grazing", "flat_quad", "flat_quad_oblique",
                              "negative_t_min", "behind"]

# NEE shadow rays of a Cornell wavefront (o, d, tmax after the mega test) that
# start a few 1e-5 above the plane of the light and cross it at a grazing
# angle: the plane test's t (numerator cancelling at the scale of the
# coordinates) lies ~1e-3 before the slab test's entry into the cluster's box
# and before tmax, so the plain version finds the light where a box test
# widened only relative to t does not enter the box.
GRAZING = [
    (0.9991334676742554, 1.980046272277832, -0.7189832329750061, -0.8665096163749695,
     -3.729339368874207e-05, 0.4991602599620819, 1.2382519245147705),
    (-0.9991319179534912, 1.9800630807876587, 0.6230401396751404, 0.8680808544158936,
     -6.785901496186852e-05, -0.49642279744148254, 0.9290615916252136),
    (0.22592441737651825, 1.980096697807312, -0.9990527629852295, -0.3205081820487976,
     -9.132928244071081e-05, 0.9472457766532898, 1.0578784942626953),
    (-0.9990018606185913, 1.98011314868927, -0.11836139857769012, 0.9981546998023987,
     -9.374127694172785e-05, -0.060722727328538895, 1.2060998678207397),
    (0.6900237202644348, 1.9800310134887695, -0.9992057681083679, -0.607640266418457,
     -2.175340341636911e-05, 0.7942124009132385, 1.4228076934814453)]


def flat_quad_scene(device):
    """A 1 x 1 quad at y = 0 (one cluster of zero thickness in y) over a
    20 x 20 ground at y = -5 that becomes a mega triangle: the scene of
    tests/test_pallas.py:101-124 in the port."""
    floor = S.make_rect_mesh((-10.0, -5.0, -10.0), (10.0, -5.0, -10.0),
                             (10.0, -5.0, 10.0), (-10.0, -5.0, 10.0))
    quad = S.make_rect_mesh((-0.5, 0.0, -0.5), (0.5, 0.0, -0.5),
                            (0.5, 0.0, 0.5), (-0.5, 0.0, 0.5))
    spec = S.SceneSpec(shapes=[S.ShapeSpec(mesh=quad, material=0),
                               S.ShapeSpec(mesh=floor, material=0)])
    scene = compile_scene(spec, device=device).scene
    assert scene.num_mega >= 2 and scene.cluster_min.shape[0] == 1
    return scene


def flat_case(name, device):
    """(scene, o, d, t_max, t_min, dead tile) of one hand-built input of the
    flat walks. The names of CLOSEST_CASES are D's inputs (`closest_case`),
    whose at most 128 clusters take the flat path as they are. widening: the
    triangle of corner (0, 0, 5) in cluster 1 and again in cluster 3, whose
    second triangle (corner (-3, -3, 1)) puts its box nearer, so the tile
    lists 3 before 1; 128 oblique rays from z = 0 hit both copies at the same
    t, and cluster 1 (the smaller index) must win; its box's entry, 5 times
    the reciprocal of dz, lies one rounding above t = 5 / dz for some rays,
    whose box test against the best from cluster 3 passes only by the
    widening. grazing: Cornell with the GRAZING rays and 123 rays from inside
    its cluster's box, which list the cluster for the tile. flat_quad and
    flat_quad_oblique: `flat_quad_scene` under
    vertical rays and under oblique rays aimed through the quad, as
    tests/test_pallas.py:126 and :142. negative_t_min (t_min = -3): rays
    0-63 from z = 0 meet cluster 0 (z = 5) ahead, rays 64-126 start at z = 7,
    between cluster 0 behind them (t = -2) and cluster 1 (z = 9) ahead, and
    ray 127 starts in cluster 0's plane and runs along -z (a hit at t = -0,
    cluster 1 at t = -4 beyond t_min). behind: `behind_case` on the flat path
    (32 clusters): the tile lists clusters 0 and 16 with entries 1 and 6, and
    a walk that exits on them at t_min = -3 loses the hits behind rays
    0-126."""
    rs = np.random.default_rng(len(name) + 100)
    t_min = T_MIN
    if name in CLOSEST_CASES:
        scene, o, d, t_max, dead_tile, _, _ = closest_case(name, device)
        return scene, o, d, t_max, t_min, dead_tile
    if name == "behind":
        scene, o, d, t_max, t_min, _, _ = behind_case(device)
        return scene, o, d, t_max, t_min, False
    if name == "widening":
        corners = np.asarray([(50.0 + 3.0 * c, 50.0, 5.0) for c in range(16)] * 2,
                             np.float32).reshape(2, 16, 3).transpose(1, 0, 2).copy()
        corners[1] = [(0.0, 0.0, 5.0), (0.0, 0.0, 5.0)]
        corners[3] = [(0.0, 0.0, 5.0), (-3.0, -3.0, 1.0)]
        scene = hand_scene(corners, device)
        xy = rs.uniform(0.05, 0.4, (oi.TILE, 2))
        dxy = rs.uniform(-0.1, 0.1, (oi.TILE, 2))
        dirs = np.concatenate([dxy, np.ones((oi.TILE, 1))], 1)
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        org = np.concatenate([xy - 5.0 * dirs[:, :2] / dirs[:, 2:],
                              np.zeros((oi.TILE, 1))], 1)
        to = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
        return (scene, V3.of(to(org)), V3.of(to(dirs)), to(np.full(oi.TILE, 100.0)),
                t_min, False)
    if name == "grazing":
        scene = compile_scene(builtin.cornell_box(16, 16), device=device).scene
        o, d, t_max = rays(oi.TILE - len(GRAZING), (0.0, 1.0, 0.0), seed=3, device=device,
                           dead_frac=0.0)
        g = torch.as_tensor(np.asarray(GRAZING, np.float32), device=device)
        cat = lambda v, k: torch.cat([g[:, k], v])  # noqa: E731
        return (scene, V3(cat(o.x, 0), cat(o.y, 1), cat(o.z, 2)),
                V3(cat(d.x, 3), cat(d.y, 4), cat(d.z, 5)), cat(t_max, 6), t_min, False)
    if name in ("flat_quad", "flat_quad_oblique"):
        scene = flat_quad_scene(device)
        n = 256
        xz = rs.uniform(-0.45, 0.45, (n, 2))
        if name == "flat_quad":
            dirs = np.tile([0.0, -1.0, 0.0], (n, 1))
            org = np.stack([xz[:, 0], np.full(n, 2.0), xz[:, 1]], 1)
        else:
            d1 = np.asarray([0.3, -1.0, 0.2]) / np.linalg.norm([0.3, -1.0, 0.2])
            dirs = np.tile(d1, (n, 1))
            t_plane = 2.0 / -d1[1]
            org = np.stack([xz[:, 0] * 0.66 - d1[0] * t_plane, np.full(n, 2.0),
                            xz[:, 1] * 0.66 - d1[2] * t_plane], 1)
        to = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
        return scene, V3.of(to(org)), V3.of(to(dirs)), to(np.full(n, 1e8)), t_min, False
    # negative_t_min
    scene = hand_scene([(0.0, 0.0, 5.0), (0.0, 0.0, 9.0)]
                       + [(50.0 + 3.0 * c, 50.0, 5.0) for c in range(14)], device)
    xy = rs.uniform(0.05, 0.45, (oi.TILE, 2))
    o, d, t_max = _along_z(xy, np.full(oi.TILE, 100.0), device)
    o.z[64:] = 7.0
    o.z[127] = 5.0
    d.z[127] = -1.0
    return scene, o, d, t_max, -3.0, False


def flat_walks(scene, o, d, t_max, t_min, anyhit, dead_tile):
    """The flat walks' operands for one input (`_prep`, list and fused); with
    `dead_tile`, the dead second tile lists every cluster."""
    walk, *_ = oi._prep(scene, o, d, t_min, t_max, anyhit=anyhit)
    fwalk, *_ = oi._prep(scene, o, d, t_min, t_max, anyhit=anyhit, fused=True)
    assert not oi._is_super(walk) and not oi._is_fused(walk)
    assert oi._is_fused(fwalk) and not oi._is_super(fwalk)
    if dead_tile:
        *head, lists, counts, entries, rays = walk
        C = lists.shape[1]
        lists, counts, entries = lists.clone(), counts.clone(), entries.clone()
        lists[1] = torch.arange(C, dtype=torch.int32, device=lists.device)
        counts[1] = C
        entries[1] = 0.0
        walk = (*head, lists, counts, entries, rays)
    return walk, fwalk


@pytest.mark.cuda
@pytest.mark.parametrize("name", FLAT_CASES)
def test_flat_kernels_on_hand_built_inputs(card, name):
    """A and B `torch.equal` to their plain versions, F and G to A and B, and
    the instrumented walks (M) to A, on the hand-built inputs of the flat
    walks: 128 rays that each ask for another cluster, every lane hitting
    every ray of one cluster, equal t in two clusters, the nearest cluster
    last, a hit at exactly tmax, a NaN ray, a dead tile that lists every
    cluster, a box test that passes only by its widening, a flat cluster hit
    straight on and obliquely, a negative t_min (twice: the second input
    loses the hits behind the origin to a walk that exits); any hit at tmax
    and just beyond each ray's closest hit."""
    scene, o, d, t_max, t_min, dead_tile = flat_case(name, card)
    walk, fwalk = flat_walks(scene, o, d, t_max, t_min, False, dead_tile)
    t, i = oi.closest_kernel(*walk, t_min)
    torch.cuda.synchronize()
    tp, ip = oi.closest_reference(*walk, t_min)
    assert torch.equal(t, tp) and torch.equal(i, ip)
    tf, i_f = oi.fused_closest_kernel(*fwalk, t_min)
    assert torch.equal(tf, t) and torch.equal(i_f, i)
    td, id_, walked = oi.closest_dbg_kernel(*walk, t_min)
    assert torch.equal(td, t) and torch.equal(id_, i)
    assert torch.equal(walked, oi.closest_dbg_reference(*walk, t_min)[2])
    tu, iu = oi.closest_full_kernel(*walk, t_min)
    assert torch.equal(tu, t) and torch.equal(iu, i)
    n = o.x.shape[0]
    t_near = torch.where(i[:n] >= 0, t[:n].abs() * 1.01 + 1e-3, t_max)
    for t_far in (t_max, t_near):
        walk, fwalk = flat_walks(scene, o, d, t_far, t_min, True, dead_tile)
        occ = oi.anyhit_kernel(*walk, t_min)
        torch.cuda.synchronize()
        assert torch.equal(occ, oi.anyhit_reference(*walk, t_min))
        assert torch.equal(oi.fused_anyhit_kernel(*fwalk, t_min), occ)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["negative_t_min", "behind"])
def test_walk_stats_kernels_take_a_negative_t_min(card, name):
    """The instrumented walks (M) at t_min = -3 and NaN on the flat
    negative_t_min and behind inputs: `(t, idx)` `torch.equal` to A's and to
    their plain versions', and `walked` to the plain version's, which is the
    count: with t_min < 0 the exit does not read the cull's entries and far,
    so every listed cluster is reached."""
    scene, o, d, t_max, t_min, dead_tile = flat_case(name, card)
    walk, _ = flat_walks(scene, o, d, t_max, t_min, False, dead_tile)
    for tm in (t_min, float("nan")):
        t, i = oi.closest_kernel(*walk, tm)
        td, id_, walked = oi.closest_dbg_kernel(*walk, tm)
        tf, if_ = oi.closest_full_kernel(*walk, tm)
        torch.cuda.synchronize()
        assert torch.equal(td, t) and torch.equal(id_, i)
        assert torch.equal(tf, t) and torch.equal(if_, i)
        tp, ip, wp = oi.closest_dbg_reference(*walk, tm)
        assert torch.equal(tp, t) and torch.equal(ip, i)
        assert torch.equal(walked, wp) and torch.equal(walked, walk[-3])
        tq, iq = oi.closest_full_reference(*walk, tm)
        assert torch.equal(tq, t) and torch.equal(iq, i)
    assert (ip < 0).all()
    t, i, _ = oi.closest_dbg_kernel(*walk, t_min)
    assert (i >= 0).all()
    if name == "behind":
        *_, t_want, i_want = behind_case(card)
        assert torch.equal(t, t_want.to(card)) and torch.equal(i, i_want.to(card))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["negative_t_min", "behind"])
def test_two_level_closest_kernels_take_a_negative_t_min(card, monkeypatch, name):
    """D `torch.equal` to `closest_super_reference` and H to D at t_min = -3
    (and with t_min NaN, where nothing is hit), on the negative_t_min input
    as one supercluster and on `behind_case`, whose exit would drop the hits
    behind the origin."""
    walk, fwalk, t_min = negative_t_min_walk(name, card, monkeypatch)
    for tm in (t_min, float("nan")):
        t, i = oi.closest_super_kernel(*walk, tm)
        torch.cuda.synchronize()
        tp, ip = oi.closest_super_reference(*walk, tm)
        assert torch.equal(t, tp) and torch.equal(i, ip)
        th, ih = oi.fused_closest_super_kernel(*fwalk, tm)
        assert torch.equal(th, t) and torch.equal(ih, i)
    assert (ip < 0).all()
    t, i = oi.closest_super_kernel(*walk, t_min)
    assert (i >= 0).all()


@pytest.mark.cuda
def test_two_level_anyhit_kernels_take_a_negative_t_min(card, monkeypatch):
    """E and I on the negative_t_min input as one supercluster: the hits
    behind the origin count, so their exit does not read the cull's far; E
    equal to its plain version, I to E."""
    monkeypatch.setattr(oi, "SUPER_MIN_C", 0)
    scene, o, d, t_max, t_min, _ = flat_case("negative_t_min", card)
    walk, *_ = oi._prep(scene, o, d, t_min, t_max, anyhit=True)
    fwalk, *_ = oi._prep(scene, o, d, t_min, t_max, anyhit=True, fused=True)
    assert oi._is_super(walk) and oi._is_super(fwalk)
    occ = oi.anyhit_super_kernel(*walk, t_min)
    torch.cuda.synchronize()
    want = oi.anyhit_super_reference(*walk, t_min)
    assert torch.equal(occ, want) and want.all()
    assert torch.equal(oi.fused_anyhit_super_kernel(*fwalk, t_min), occ)


@pytest.mark.cuda
def test_two_level_kernels_keep_grazing_hits(card, monkeypatch):
    """D, E, H and I on the grazing input as one supercluster: the rays that
    graze the light's plane keep their hit (the child refinement's margin),
    D and E `torch.equal` to their plain versions, H to D and I to E."""
    monkeypatch.setattr(oi, "SUPER_MIN_C", 0)
    scene, o, d, t_max, t_min, _ = flat_case("grazing", card)
    walk, *_ = oi._prep(scene, o, d, t_min, t_max, anyhit=False)
    fwalk, *_ = oi._prep(scene, o, d, t_min, t_max, anyhit=False, fused=True)
    assert oi._is_super(walk) and oi._is_super(fwalk)
    t, i = oi.closest_super_kernel(*walk, t_min)
    torch.cuda.synchronize()
    tp, ip = oi.closest_super_reference(*walk, t_min)
    assert torch.equal(t, tp) and torch.equal(i, ip) and (ip[:5] >= 0).all()
    th, ih = oi.fused_closest_super_kernel(*fwalk, t_min)
    assert torch.equal(th, t) and torch.equal(ih, i)
    walk, *_ = oi._prep(scene, o, d, t_min, t_max, anyhit=True)
    fwalk, *_ = oi._prep(scene, o, d, t_min, t_max, anyhit=True, fused=True)
    occ = oi.anyhit_super_kernel(*walk, t_min)
    torch.cuda.synchronize()
    want = oi.anyhit_super_reference(*walk, t_min)
    assert torch.equal(occ, want) and want[:5].all()
    assert torch.equal(oi.fused_anyhit_super_kernel(*fwalk, t_min), occ)


@pytest.mark.cuda
def test_gather_rows_backward_on_card(card):
    rs = np.random.default_rng(1)
    for cols, P in ((16, 8), (3, 300)):
        table = torch.as_tensor(rs.normal(size=(P, cols)).astype(np.float32))
        idx = torch.as_tensor(rs.integers(0, P, 20_000))
        ct = torch.as_tensor(rs.normal(size=(20_000, cols)).astype(np.float32))
        grads = []
        for dev in ("cpu", card, card):
            t = table.to(dev, copy=True).requires_grad_()
            (ou.gather_rows(t, idx.to(dev)) * ct.to(dev)).sum().backward()
            grads.append(t.grad.cpu())
        torch.testing.assert_close(grads[1], grads[0], rtol=1e-5, atol=1e-4)
        assert torch.equal(grads[1], grads[2])


@pytest.mark.cuda
def test_train_step_on_card_is_reproducible(card):
    """Two gradient evaluations from the same state are bit-equal on the
    card, and close to the CPU's."""
    from mafrixraytracing_torch.opt import inverse

    cfg = P.PathTracerConfig(max_depth=3, compact=(1.0, 0.7, 0.3))
    out = []
    for dev in ("cpu", card, card):
        cs = compile_scene(builtin.cornell_box(32, 32), device=dev)
        with torch.no_grad():
            target = P.render_image(cs.scene, cs.camera, 32, 32, 4,
                                    rng.root_key(7, dev), cfg)
        params = {n: getattr(cs.scene, n).detach().clone().requires_grad_()
                  for n in ("mat_albedo", "light_radiance", "mesh_vertices")}
        out.append(inverse.loss_and_grads(params, cs.scene, cs.camera, target,
                                          rng.root_key(3, dev), 2, cfg))
    (l_c, g_c), (l_1, g_1), (l_2, g_2) = out
    assert torch.equal(l_1, l_2)
    for n in g_1:
        assert torch.equal(g_1[n], g_2[n]), n
    torch.testing.assert_close(l_1.cpu(), l_c, rtol=1e-3, atol=1e-6)
    torch.testing.assert_close(g_1["mat_albedo"].cpu(), g_c["mat_albedo"],
                               rtol=2e-2, atol=1e-4)


@pytest.mark.cuda
def test_render_on_card_matches_cpu(card):
    cfg = P.PathTracerConfig(max_depth=5, compact=(1.0, 0.7, 0.3, 0.15, 0.05))
    imgs = []
    for dev in ("cpu", card):
        cs = compile_scene(builtin.cornell_box(32, 32), device=dev)
        imgs.append(P.render_image(cs.scene, cs.camera, 32, 32, 2,
                                   rng.root_key(7, dev), cfg).cpu().numpy())
    close = np.isclose(imgs[1], imgs[0], rtol=1e-3, atol=1e-4).all(axis=-1)
    assert close.mean() >= 0.995, close.mean()
    assert abs(imgs[1].mean() - imgs[0].mean()) <= 1e-4 * abs(imgs[0].mean())



def rng_keys(n, device, seed=0):
    """n keys of random uint32 words, the first with the high bits set."""
    g = torch.Generator().manual_seed(seed)
    k = torch.randint(0, 2**32, (max(n, 4), 2), generator=g, dtype=torch.int64)
    k[:4] = torch.tensor([[2**32 - 1, 2**32 - 1], [2**31, 0], [0, 2**31 + 1], [0, 0]])
    return k[:n].to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 257, 70_001])
def test_rng_kernels_match_plain_version(card, n):
    """Every public draw on a CUDA key is one kernel launch with the plain
    version's bits, on the same card tensors."""
    keys = rng_keys(n, card)
    g = torch.Generator().manual_seed(n)
    data = torch.randint(-2**40, 2**40, (n,), generator=g, dtype=torch.int64).to(card)
    root = keys[0]
    sidx = 7 + torch.arange(4, device=card)
    cuda.reset_launches()
    folds = [
        (rng.bounce_key(keys, 3), rng._fold_in(keys, 3)),
        (rng.split_dim(keys, 2**32 - 1), rng._fold_in(keys, 2**32 - 1)),
        (rng.sample_key(keys, -5), rng._fold_in(keys, -5)),
        (rng.fold_in(keys, data), rng._fold_in(keys, data)),
        (rng.fold_in(root, data), rng._fold_in(root, data)),
        (rng.pixel_keys(root, n), rng._fold_in(root, torch.arange(n, device=card))),
        (rng.split(root, 3), rng._fold_in(root, torch.arange(3, device=card))),
        (rng.sample_key(keys[:, None, :], sidx[None, :]),
         rng._fold_in(keys[:, None, :], sidx[None, :])),
    ]
    draws = [(rng.uniforms(keys, dim, shape), rng._uniforms(keys, dim, shape))
             for dim, shape in ((0, ()), (10, (2,)), (47, (3,)), (1002, (1,)))]
    assert cuda.LAUNCHES["rng_fold"] == len(folds)
    assert cuda.LAUNCHES["rng_uniform"] == len(draws)
    for got, want in folds + draws:
        assert got.shape == want.shape and got.dtype == want.dtype
        assert torch.equal(got, want)
