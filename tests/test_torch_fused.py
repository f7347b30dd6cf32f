"""The port's fused-cull search (kernels F, G, H, I) against the JAX package.

With `FUSED_CULL` patched on in both packages the JAX queries run the Pallas
fused kernels in interpret mode (as tests/test_pallas.py:238 does) and the
port's run the plain versions of F-I: `_cull` on the packed box table, then
the list walk's plain version. Contract: `idx` equal, `t` within rtol 1e-4 /
atol 1e-5 (the Pallas cull divides by an approximate reciprocal), occlusion
equal. Inside the port the fused path must equal the list path bit for bit.

The CUDA kernels cull inside the block with integer-bit minima and a rank
sort; `block_cull_model` states that procedure in numpy and is held against
`_cull`, so that the bookkeeping the card runs is tested here too. The
kernels themselves are held against their plain versions and against A, B,
D, E on the card in tests/test_torch_kernels.py.
"""
import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafrixraytracing_torch.core import rng as trng
from mafrixraytracing_torch.core.v3 import V3 as TV3
from mafrixraytracing_torch.integrator import path as TP
from mafrixraytracing_torch.ops import intersect as ti
from mafrixraytracing_torch.scene import builtin as tbuiltin
from mafrixraytracing_torch.scene.compiler import compile_scene as tcompile
from mafrixraytracing_tpu.ops import intersect_pallas as ip
from mafrixraytracing_tpu.scene import spec as JS
from mafrixraytracing_tpu.scene.compiler import compile_scene as jcompile

from test_torch_super import (
    CASES,
    aimed_rays,
    both_v3,
    bumpy_sphere,
    carry_over,
    rays,
    scenes,
)
import torch_port_helpers  # noqa: F401  (sizes torch's threads to the run)

T_MIN = 1e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def fused(monkeypatch):
    monkeypatch.setattr(ip, "FUSED_CULL", True)
    monkeypatch.setattr(ti, "FUSED_CULL", True)


@pytest.fixture
def two_level(monkeypatch):
    monkeypatch.setattr(ip, "SUPER_MIN_C", 0)
    monkeypatch.setattr(ti, "SUPER_MIN_C", 0)


@pytest.fixture(scope="module")
def bumpy():
    js = jcompile(bumpy_sphere(JS))
    return js, carry_over(js.scene)


# --- pack_aabbs ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["cornell", "soup", "bumpy"])
def test_pack_aabbs_matches_pallas(name, bumpy):
    """Exactly the JAX table, on cluster boxes and on supercluster boxes."""
    js, ts = (bumpy[0].scene, bumpy[1]) if name == "bumpy" else scenes(name)
    pairs = [("super_min", "super_max")]
    if ts.cluster_min.shape[0] <= ti.CP:
        pairs.append(("cluster_min", "cluster_max"))
    for lo, hi in pairs:
        want = np.asarray(ip.pack_aabbs(getattr(js, lo), getattr(js, hi)))
        got = ti.pack_aabbs(getattr(ts, lo), getattr(ts, hi))
        assert got.shape == (ti.AABB_ROWS, ti.CP) and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)
        n = getattr(ts, lo).shape[0]
        assert got[6, n:].sum() == 0        # slots past the last box are not live
        # the plain versions read the table back as `_cull`'s boxes
        cmin, cmax = ti._unpack_aabbs(got, n)
        live = got[6, :n] > 0.5
        assert torch.equal(cmin[live], getattr(ts, lo)[live])
        assert torch.equal(cmax[live], getattr(ts, hi)[live])
        assert (cmin[~live] > cmax[~live]).all()


def test_more_than_128_boxes_raise(bumpy, monkeypatch):
    """256 clusters do not fit the flat fused kernels' table: `pack_aabbs`,
    the wrappers' argument check and a flat fused query raise, and the query
    never drops to the list path."""
    _, ts = bumpy
    assert ts.cluster_min.shape[0] == 256
    with pytest.raises(ValueError, match="at most 128 boxes"):
        ti.pack_aabbs(ts.cluster_min, ts.cluster_max)
    tri = ti.pack_tris(ts)
    good = ti.pack_aabbs(ts.super_min, ts.super_max)
    rays8 = torch.zeros((8, 128))
    with pytest.raises(ValueError, match="at most 128 boxes"):
        ti._check_fused_args(tri, good, rays8)
    big_bounds = torch.zeros((129, ti.BOUNDS_ROWS, 16))
    with pytest.raises(ValueError, match="at most 128 boxes"):
        ti._check_fused_args(tri, good, rays8, big_bounds)
    o, d = aimed_rays(64, seed=1)
    _, (to, td) = both_v3(o, d)
    monkeypatch.setattr(ti, "FUSED_CULL", True)
    monkeypatch.setattr(ti, "SUPER_MIN_C", 10**6)   # force the flat path
    with pytest.raises(ValueError, match="at most 128 boxes"):
        ti.find_closest_soa(ts, to, td, T_MIN, 1e8)
    with pytest.raises(ValueError, match="at most 128 boxes"):
        ti.occluded_soa(ts, to, td, T_MIN, 1e8)


# --- queries against the JAX package's fused path ---------------------------------


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("n", [256, 205])
@pytest.mark.parametrize("levels", ["flat", "two_level"])
def test_fused_closest_matches_pallas(fused, monkeypatch, name, n, levels):
    """Aligned and non-aligned batches with ~10% dead rays."""
    if levels == "two_level":
        monkeypatch.setattr(ip, "SUPER_MIN_C", 0)
        monkeypatch.setattr(ti, "SUPER_MIN_C", 0)
    js, ts = scenes(name)
    o, d, t_max = rays(n, CASES[name][1], seed=n)
    (jo, jd), (to, td) = both_v3(o, d)
    t_j, i_j = ip.find_closest_soa(js, jo, jd, T_MIN, jnp.asarray(t_max),
                                   interpret=True)
    walk, *_ = ti._prep(ts, to, td, T_MIN, torch.as_tensor(t_max), anyhit=False,
                        fused=True)
    assert ti._is_fused(walk) and ti._is_super(walk) == (levels == "two_level")
    t_t, i_t = ti.find_closest_soa(ts, to, td, T_MIN, torch.as_tensor(t_max))
    i_j, t_j = np.asarray(i_j), np.asarray(t_j)
    np.testing.assert_array_equal(i_t.numpy(), i_j)
    hit = i_j >= 0
    assert hit.sum() > n // 10
    np.testing.assert_allclose(t_t.numpy()[hit], t_j[hit], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("levels", ["flat", "two_level"])
def test_fused_occluded_matches_pallas(fused, monkeypatch, name, levels):
    """Per-ray t_max just above the closest hit, with dead rays."""
    if levels == "two_level":
        monkeypatch.setattr(ip, "SUPER_MIN_C", 0)
        monkeypatch.setattr(ti, "SUPER_MIN_C", 0)
    js, ts = scenes(name)
    o, d, _ = rays(200, CASES[name][1], seed=11, dead_frac=0.0)
    (jo, jd), (to, td) = both_v3(o, d)
    t_hit, i_hit = ti.find_closest_soa(ts, to, td, T_MIN, 1e8)
    t_far = np.where(i_hit.numpy() >= 0, t_hit.numpy() * 1.01, 1e8)
    t_far = t_far.astype(np.float32)
    t_far[::9] = 0.0
    occ_j = ip.occluded_soa(js, jo, jd, T_MIN, jnp.asarray(t_far), interpret=True)
    occ_t = ti.occluded_soa(ts, to, td, T_MIN, torch.as_tensor(t_far))
    np.testing.assert_array_equal(occ_t.numpy(), np.asarray(occ_j))
    want = (i_hit.numpy() >= 0) & (t_far > 0)
    np.testing.assert_array_equal(occ_t.numpy(), want)
    assert 0 < occ_t.sum() < 200


def test_fused_large_scene_matches_pallas(fused, bumpy):
    """256 clusters: kernels H and I's path without a patch (16 boxes in a
    table of 128 slots)."""
    jcs, ts = bumpy
    o, d = aimed_rays(128, seed=3)
    (jo, jd), (to, td) = both_v3(o, d)
    t_j, i_j = ip.find_closest_soa(jcs.scene, jo, jd, T_MIN, 1e8, interpret=True)
    t_t, i_t = ti.find_closest_soa(ts, to, td, T_MIN, 1e8)
    i_j, t_j = np.asarray(i_j), np.asarray(t_j)
    np.testing.assert_array_equal(i_t.numpy(), i_j)
    hit = i_j >= 0
    assert hit.sum() > 64
    np.testing.assert_allclose(t_t.numpy()[hit], t_j[hit], rtol=1e-4, atol=1e-5)
    t_far = np.where(hit, t_j * 1.01, 1e8).astype(np.float32)
    occ_t = ti.occluded_soa(ts, to, td, T_MIN, torch.as_tensor(t_far))
    np.testing.assert_array_equal(occ_t.numpy(), hit)


# --- fused on == fused off inside the port ------------------------------------


# bumpy has more than 128 clusters: no flat path
@pytest.mark.parametrize("levels,name", [
    *[(lv, n) for lv in ("flat", "two_level") for n in CASES], ("two_level", "bumpy")])
def test_fused_equals_list_path(monkeypatch, bumpy, name, levels):
    if levels == "two_level":
        monkeypatch.setattr(ti, "SUPER_MIN_C", 0)
    if name == "bumpy":
        ts = bumpy[1]
        o, d = aimed_rays(333, seed=6)
        t_max = np.where(np.arange(333) % 7 == 0, 0.0, 1e8).astype(np.float32)
    else:
        ts = scenes(name)[1]
        o, d, t_max = rays(333, CASES[name][1], seed=21)
    _, (to, td) = both_v3(o, d)
    t_max = torch.as_tensor(t_max)
    want = (ti.find_closest_soa(ts, to, td, T_MIN, t_max),
            ti.occluded_soa(ts, to, td, T_MIN, t_max.clamp(max=1.5)))
    monkeypatch.setattr(ti, "FUSED_CULL", True)
    got = (ti.find_closest_soa(ts, to, td, T_MIN, t_max),
           ti.occluded_soa(ts, to, td, T_MIN, t_max.clamp(max=1.5)))
    assert torch.equal(got[0][0], want[0][0]) and torch.equal(got[0][1], want[0][1])
    assert torch.equal(got[1], want[1])
    assert (want[0][1] >= 0).sum() > 20


@pytest.mark.parametrize("levels", ["flat", "two_level"])
def test_fused_render_equals_list_render(monkeypatch, levels):
    """32x32 x 2 spp through the compacted loop: the same bits."""
    if levels == "two_level":
        monkeypatch.setattr(ti, "SUPER_MIN_C", 0)
    cs = tcompile(tbuiltin.cornell_box(32, 32), device="cpu")
    cfg = TP.PathTracerConfig(max_depth=4, compact=(1.0, 0.7, 0.3, 0.15))
    render = lambda: TP.render_image(cs.scene, cs.camera, 32, 32, 2,  # noqa: E731
                                     trng.root_key(5, "cpu"), cfg)
    want = render()
    monkeypatch.setattr(ti, "FUSED_CULL", True)
    calls = []
    real = ti._cull
    monkeypatch.setattr(ti, "_cull", lambda *a: calls.append(1) or real(*a))
    got = render()
    assert torch.equal(got, want) and float(want.mean()) > 0.01
    assert calls    # on the CPU the fused plain versions cull for themselves


def test_fused_prep_skips_the_cull(monkeypatch):
    """With `fused` `_prep` makes no (B, C) temporaries: `_cull` is not called,
    the operands are (tri, [bounds,] aabbs, rays) and the rays' far row is 0."""
    ts = scenes("soup")[1]
    o, d, t_max = rays(200, CASES["soup"][1], seed=2)
    _, (to, td) = both_v3(o, d)
    monkeypatch.setattr(ti, "_cull", lambda *a: pytest.fail("_prep culled"))
    walk, B, *_ = ti._prep(ts, to, td, T_MIN, torch.as_tensor(t_max), anyhit=False,
                           fused=True)
    assert B == 200 and len(walk) == 3
    assert walk[1].shape == (ti.AABB_ROWS, ti.CP) and walk[2].shape == (8, 256)
    assert (walk[2][7] == 0).all() and (walk[2][6, 200:] == 0).all()
    monkeypatch.setattr(ti, "SUPER_MIN_C", 0)
    walk, *_ = ti._prep(ts, to, td, T_MIN, torch.as_tensor(t_max), anyhit=True,
                        fused=True)
    assert len(walk) == 4 and walk[1].shape[1:] == (ti.BOUNDS_ROWS, 16)


# --- a numpy model of the in-block cull of csrc/intersect_fused.cu --------------


def block_cull_model(aabbs, rays8, n):
    """`tile_cull` of csrc/intersect_fused.cu for every 128-ray tile, in
    float32 numpy: per-ray slab tests in `_cull`'s arithmetic, a ray with a
    NaN origin passing no box, entries clamped at +0, the tile's minimum taken on
    the entries' bit patterns as unsigned integers, a rank sort of the 128
    (entry, id) pairs, the count of entries below BIG, `far` per ray."""
    f = np.float32
    big = f(ti.BIG)
    o, d, tmax = rays8[0:3], rays8[3:6], rays8[6]
    B = tmax.shape[0]
    sane = ~np.isnan(o).any(0)      # a NaN direction becomes inv = -1e12
    tn = np.full((B, n), -big, f)
    tf = np.full((B, n), big, f)
    with np.errstate(over="ignore", invalid="ignore"):
        for a in range(3):
            safe = np.where(np.abs(d[a]) > f(1e-12), d[a],
                            np.where(d[a] >= 0, f(1e-12), f(-1e-12))).astype(f)
            inv = (f(1.0) / safe)[:, None]
            t0 = (aabbs[a, None, :n] - o[a][:, None]) * inv
            t1 = (aabbs[3 + a, None, :n] - o[a][:, None]) * inv
            tn = np.fmax(tn, np.fmin(t0, t1))
            tf = np.fmin(tf, np.fmax(t0, t1))
        hit = (sane[:, None] & (aabbs[6, None, :n] > 0.5) & (tn <= tf)
               & (tf > 0) & (tn < tmax[:, None]))
    entry = np.full((B, ti.CP), big, f)
    entry[:, :n] = np.where(hit, np.where(tn > 0, tn, f(0.0)), big)
    far = np.fmin(np.where(hit, tf, -big).max(axis=1, initial=-big), tmax)
    keys = entry.view(np.uint32).reshape(-1, ti.TILE, ti.CP).min(axis=1)
    ids = np.arange(ti.CP)
    lists = np.stack([np.lexsort((ids, k)) for k in keys])
    entries = np.take_along_axis(keys, lists, axis=1).view(f)
    counts = (keys < big.view(np.uint32)).sum(axis=1)
    return lists, counts, entries, far


def random_boxes(n, seed, empty_frac=0.2):
    """n boxes, some of them empty (the +-3e38 sentinels), packed."""
    rs = np.random.default_rng(seed)
    c = rs.uniform(-1.0, 1.0, (n, 3))
    h = rs.uniform(0.0, 0.4, (n, 3)) * (rs.random((n, 3)) > 0.1)   # some flat
    cmin, cmax = (c - h).astype(np.float32), (c + h).astype(np.float32)
    empty = rs.random(n) < empty_frac
    cmin[empty], cmax[empty] = 3e38, -3e38
    return torch.as_tensor(cmin), torch.as_tensor(cmax)


@pytest.mark.parametrize("n,seed", [(128, 0), (32, 1), (64, 2), (16, 3)])
def test_block_cull_model_equals_cull(n, seed):
    """Seeded tiles: dead rays among the boxes, a tile of rays that miss
    everything, an all-dead tile (count 0), rays that start on a box's face
    (entry -0 in `_cull`), NaN rays, and fewer than 128 boxes."""
    cmin, cmax = random_boxes(n, seed)
    aabbs = ti.pack_aabbs(cmin, cmax)
    rs = np.random.default_rng(100 + seed)
    B = 5 * ti.TILE
    o = rs.uniform(-1.5, 1.5, (3, B)).astype(np.float32)
    d = rs.normal(size=(3, B)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    d[:, 7::11] = np.float32([[0.0], [-1.0], [0.0]])      # axis-aligned
    tmax = np.where(rs.random(B) < 0.1, 0.0, rs.uniform(0.2, 5.0, B)).astype(np.float32)
    tmax[::5] = 1e8
    tmax[128:256] = 0.0                 # dead rays among the boxes
    o[:, 256:384] += 50.0               # a tile that misses every box
    d[:, 256:384] = np.float32([[1.0], [0.0], [0.0]])
    o[:, 512:640] -= 50.0               # an all-dead tile outside the boxes
    tmax[512:640] = 0.0
    # origins on a max face, heading inward along negative axes: the entry
    # of `_cull` is (max - o) * (1 / d) = +0 * negative = -0 there
    thick = np.flatnonzero(((cmax - cmin).numpy() > 0.05).all(axis=1))
    for k, r in enumerate(range(384, 512, 4)):
        b = thick[k % thick.size]
        o[:, r] = cmax[b].numpy() - 0.01
        o[0, r] = cmax[b, 0]
        d[:, r] = np.float32([-0.6, -0.48, -0.64])
        tmax[r] = 1e8
    o[1, 5] = np.nan
    d[2, 6] = np.nan
    rays8 = np.concatenate([o, d, tmax[None], np.zeros((1, B), np.float32)])
    m_lists, m_counts, m_entries, m_far = block_cull_model(aabbs.numpy(), rays8, n)
    t = torch.as_tensor(rays8)
    lists, counts, entries, far = ti._cull(
        TV3(t[0], t[1], t[2]), TV3(t[3], t[4], t[5]), t[6],
        *ti._unpack_aabbs(aabbs, ti.CP))
    np.testing.assert_array_equal(m_counts, counts.numpy())
    np.testing.assert_array_equal(m_lists, lists.numpy())
    np.testing.assert_array_equal(m_entries, entries.numpy())   # -0 == +0
    ok = ~np.isnan(far.numpy())
    np.testing.assert_array_equal(m_far[ok], far.numpy()[ok])
    assert m_counts[2] == 0 and m_counts[4] == 0 and m_counts[0] > 0
    # a dead ray (tmax 0) still passes the boxes that hold its origin, entry 0
    assert (m_entries[1][:m_counts[1]] == 0).all()
    assert (m_entries >= 0).all() and not np.signbit(m_entries).any()
    # the seeded rays do start on faces: `_cull` itself has a -0 there
    assert (m_entries[3] == 0).any() and np.signbit(entries.numpy()[3]).any()


# --- the port stays free of JAX -----------------------------------------------


def _port_sources():
    root = os.path.join(REPO, "mafrixraytracing_torch")
    for base, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_no_jax():
    """No module of the port, and not chip_smoke.py, imports jax or the JAX
    package, at top level or inside a function."""
    seen = 0
    for path in _port_sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "optax",
                                   "mafrixraytracing_tpu"), (path, name)
        seen += 1
    assert seen > 40
