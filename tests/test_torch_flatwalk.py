"""The pair-parallel flat walks (kernels A, B, F, G) on the CPU.

`flat_closest_model` and `flat_anyhit_model` follow the walks of
`csrc/intersect_common.cuh` step by step: per tile the list front to back,
the exit before each cluster (none from the cull's entries and far when
t_min < 0), each live ray's own box test (`refine_clusters`:
the closest-hit walk against its best at the start of the cluster, read
from its 64-bit key; the any-hit walk against tmax), and for the asking rays
the 128 lanes' tests, reduced a warp at a time into the key (closest hit) or
the blocked flag (any hit). A kernel's visit that holds a ray a thread makes
the same tests and keeps the same minimum, so one model stands for both
kinds of visit. They must be `torch.equal` to the dense plain
versions `closest_reference` and `anyhit_reference` on a soup with 10% dead
rays and on the hand-built inputs of `test_torch_kernels.flat_case`, and the
closest-hit model must agree with the JAX package's `_closest_impl` in
interpret mode under the contract of tests/test_pallas.py:26-42 (idx equal,
t within rtol 1e-4 / atol 1e-5). The kernels themselves are held against the
plain versions on the card in tests/test_torch_kernels.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafrixraytracing_torch.core.v3 import V3
from mafrixraytracing_torch.ops import intersect as oi
from mafrixraytracing_torch.scene import spec as S
from mafrixraytracing_torch.scene.compiler import compile_scene
from mafrixraytracing_tpu.ops import intersect_pallas as ip
from mafrixraytracing_tpu.scene.compiler import compile_scene as jcompile

from test_torch_kernels import (CLOSEST_CASES, FLAT_CASES, behind_case, closest_case, flat_case,
                                flat_walks, pair_walk_model)
from test_torch_super import both_v3, carry_over, soup_spec
import torch_port_helpers  # noqa: F401  (sizes torch's threads to the run)

T_MIN = 1e-3
MASK32 = np.uint64(0xFFFFFFFF)


def key_bits(t: np.ndarray) -> np.ndarray:
    """`key_bits` of intersect_common.cuh: float32 -> its bits in float
    order, as uint64."""
    b = np.asarray(t, np.float32).view(np.uint32).astype(np.uint64)
    return np.where(b & np.uint64(0x80000000), ~b & MASK32, b | np.uint64(0x80000000))


def key_float(k: np.ndarray) -> np.ndarray:
    k = np.asarray(k, np.uint64)
    b = np.where(k & np.uint64(0x80000000), k & np.uint64(0x7FFFFFFF), ~k & MASK32)
    return b.astype(np.uint32).view(np.float32)


def _tile(rays, tile):
    return rays[:, tile * oi.TILE:(tile + 1) * oi.TILE]


def _lanes(tri, c, r, q, t_min):
    """The 128 lanes' tests of cluster c against rays q of tile rays r:
    (t, hit) as (m, 128)."""
    comp = tri[c]                                     # (12, 128)
    cols = tuple(r[a, q][:, None] for a in range(6))
    t, ok = oi._plane_terms(cols, tuple(comp[m][None] for m in range(oi.COMP)))
    return t, ok & (t > t_min) & (t < r[6, q][:, None])


def flat_closest_model(walk, t_min):
    """Kernels A and F step by step -> (t, idx, pairs asked)."""
    tri, cmin, cmax, lists, counts, entries, rays = walk
    B = rays.shape[1]
    t_out = torch.empty(B, dtype=torch.float32)
    i_out = torch.empty(B, dtype=torch.int32)
    asked = 0
    for tile in range(B // oi.TILE):
        r = _tile(rays, tile)
        key = (key_bits(r[6].numpy()) << np.uint64(32)) | MASK32
        dead = r[6] <= t_min
        for k in range(int(counts[tile])):
            best = torch.as_tensor(key_float(key >> np.uint64(32)))
            limit = torch.fmin(best, r[7])
            worst = torch.where(limit.isnan(), -torch.inf, limit).max()
            if t_min >= 0 and not bool(entries[tile, k] <= worst):
                break
            c = int(lists[tile, k])
            asks = oi.refine_clusters(cmin, cmax, r, best, t_min)[:, c] & ~dead
            q = asks.nonzero()[:, 0]
            if q.numel() == 0:
                continue
            asked += q.numel()
            t, hit = _lanes(tri, c, r, q, t_min)
            bits = key_bits((t + 0.0).numpy())
            h = hit.numpy()
            for w in range(oi.TILE // 32):
                hw = h[:, w * 32:(w + 1) * 32]
                bw = np.where(hw, bits[:, w * 32:(w + 1) * 32], MASK32)
                least = bw.min(axis=1)
                first = np.argmax(hw & (bw == least[:, None]), axis=1).astype(np.uint64)
                cand = (least << np.uint64(32)) | (np.uint64(c * oi.CLUSTER_SIZE + w * 32)
                                                   + first)
                some = hw.any(axis=1)
                qs = q.numpy()[some]
                key[qs] = np.minimum(key[qs], cand[some])
        sl = slice(tile * oi.TILE, (tile + 1) * oi.TILE)
        t_out[sl] = torch.as_tensor(key_float(key >> np.uint64(32)))
        i_out[sl] = torch.as_tensor((key & MASK32).astype(np.uint32).view(np.int32))
    return t_out, i_out, asked


def flat_anyhit_model(walk, t_min):
    """Kernels B and G step by step -> (occluded, pairs asked)."""
    tri, cmin, cmax, lists, counts, entries, rays = walk
    B = rays.shape[1]
    occ = torch.zeros(B, dtype=torch.bool)
    asked = 0
    for tile in range(B // oi.TILE):
        r = _tile(rays, tile)
        blocked = torch.zeros(oi.TILE, dtype=torch.bool)
        dead = r[6] <= t_min
        for k in range(int(counts[tile])):
            past = r[7] < entries[tile, k] if t_min >= 0 else False
            if bool((blocked | dead | past).all()):
                break
            c = int(lists[tile, k])
            asks = oi.refine_clusters(cmin, cmax, r, r[6], t_min)[:, c] & ~(blocked | dead)
            q = asks.nonzero()[:, 0]
            if q.numel() == 0:
                continue
            asked += q.numel()
            blocked[q] |= _lanes(tri, c, r, q, t_min)[1].any(dim=1)
        occ[tile * oi.TILE:(tile + 1) * oi.TILE] = blocked
    return occ, asked


def soup_scene(n=2048, seed=1234):
    """n small random triangles in [-1, 1]^3 (n / 128 clusters): phase 2's
    soup of `chip_smoke.py` at a smaller size."""
    rs = np.random.default_rng(seed)
    centers = rs.uniform(-1.0, 1.0, (n, 1, 3))
    verts = (centers + rs.normal(0.0, 0.04, (n, 3, 3))).reshape(-1, 3)
    mesh = S.Mesh(vertices=verts.astype(np.float32),
                  faces=np.arange(3 * n, dtype=np.int32).reshape(n, 3))
    return compile_scene(S.SceneSpec(shapes=[S.ShapeSpec(mesh=mesh, material=0)]),
                         device="cpu").scene


def soup_rays(n, seed, anyhit):
    """Unrelated rays through the soup, ~10% dead; any hit: tmax in (0, 2)."""
    rs = np.random.default_rng(seed)
    o = rs.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dead = rs.random(n) < 0.1
    t_max = np.where(dead, 0.0, rs.uniform(0.0, 2.0, n) if anyhit else 1e8)
    return V3.of(torch.as_tensor(o)), V3.of(torch.as_tensor(d)), torch.as_tensor(
        t_max.astype(np.float32))


@pytest.fixture(scope="module")
def soup():
    return soup_scene()


@pytest.mark.parametrize("anyhit", [False, True])
def test_model_matches_plain_versions_on_the_soup(soup, anyhit):
    """Unrelated rays, a batch that is not a multiple of the tile, 10% dead:
    the model equals the dense plain version bit for bit and asks for far
    fewer pairs than the tile's lists times its live rays."""
    assert soup.cluster_min.shape[0] == 16
    o, d, t_max = soup_rays(512 - 37, seed=5 + anyhit, anyhit=anyhit)
    walk, *_ = oi._prep(soup, o, d, T_MIN, t_max, anyhit=anyhit)
    rays, counts = walk[-1], walk[-3]
    live = (rays[6] > T_MIN).reshape(-1, oi.TILE).sum(dim=1)
    listed_pairs = int((live * counts).sum())
    if anyhit:
        occ, asked = flat_anyhit_model(walk, T_MIN)
        want = oi.anyhit_reference(*walk, T_MIN)
        assert torch.equal(occ, want) and want.sum() > 20
    else:
        t, i, asked = flat_closest_model(walk, T_MIN)
        tp, ip_ = oi.closest_reference(*walk, T_MIN)
        assert torch.equal(t, tp) and torch.equal(i, ip_) and (ip_ >= 0).sum() > 50
    assert 0 < asked < 0.5 * listed_pairs


@pytest.mark.parametrize("name", FLAT_CASES)
def test_model_on_hand_built_inputs(name):
    """The hand-built inputs of the flat walks: the models equal the plain
    versions bit for bit (closest hit, any hit at tmax and just beyond each
    closest hit), and give what the inputs are built to give."""
    scene, o, d, t_max, t_min, dead_tile = flat_case(name, "cpu")
    walk, _ = flat_walks(scene, o, d, t_max, t_min, False, dead_tile)
    t, i, _ = flat_closest_model(walk, t_min)
    tp, ip_ = oi.closest_reference(*walk, t_min)
    assert torch.equal(t, tp) and torch.equal(i, ip_)
    n = o.x.shape[0]
    if name in CLOSEST_CASES:
        *_, t_want, i_want = closest_case(name, "cpu")
        assert torch.equal(t, t_want) and torch.equal(i, i_want)
    elif name == "widening":
        assert (i == oi.CLUSTER_SIZE).all()
    elif name == "grazing":     # the light's two triangles
        assert ((i[:5] == 16) | (i[:5] == 17)).all()
    elif name.startswith("flat_quad"):     # the quad, never the ground below
        assert (i[:n] >= 0).all() and (i[:n] < 2).all()
        if name == "flat_quad":
            assert ((t[:n] - 2.0).abs() <= 1e-5).all()
    elif name == "behind":      # the hits behind the origin, and ray 127's ahead
        *_, t_want, i_want = behind_case("cpu")
        assert torch.equal(t, t_want) and torch.equal(i, i_want)
    else:   # negative_t_min
        assert (i == 0).all()
        assert (t[:64] == 5.0).all() and (t[64:127] == -2.0).all() and t[127] == 0.0
    t_near = torch.where(i[:n] >= 0, t[:n].abs() * 1.01 + 1e-3, t_max)
    for t_far in (t_max, t_near):
        walk, _ = flat_walks(scene, o, d, t_far, t_min, True, dead_tile)
        occ, _ = flat_anyhit_model(walk, t_min)
        assert torch.equal(occ, oi.anyhit_reference(*walk, t_min))


def bare_slab(lo, hi, rays, limit):
    """The slab test on the box (lo, hi) as it is, the two comparisons
    widened relative to t as the walks widen theirs, but no margin: (B,)
    bool, True where the ray enters the box before `limit` and leaves it
    after t = 0."""
    tn = tf = None
    for a in range(3):
        inv = oi._safe_inverse(rays[3 + a])
        t0, t1 = (lo[a] - rays[a]) * inv, (hi[a] - rays[a]) * inv
        tn = torch.minimum(t0, t1) if tn is None else torch.maximum(tn, torch.minimum(t0, t1))
        tf = torch.maximum(t0, t1) if tf is None else torch.minimum(tf, torch.maximum(t0, t1))
    w = lambda x: x + (oi.REFINE_REL * x.abs() + oi.REFINE_ABS)  # noqa: E731
    return (tn <= w(tf)) & (tf > 0) & (tn <= w(limit))


def test_grazing_case_needs_the_margin(monkeypatch):
    """The GRAZING rays' box test against tmax fails without the box's
    margin (the same slab test widened only relative to t), though the plain
    version finds their hit on the light; with it they ask for the cluster."""
    scene, o, d, t_max, t_min, _ = flat_case("grazing", "cpu")
    walk, _ = flat_walks(scene, o, d, t_max, t_min, True, False)
    cmin, cmax, rays = walk[1], walk[2], walk[-1]
    assert oi.anyhit_reference(*walk, t_min)[:5].all()
    assert oi.refine_clusters(cmin, cmax, rays, rays[6], t_min)[:5, 0].all()
    assert not bare_slab(cmin[0], cmax[0], rays, rays[6])[:5].any()


def test_two_level_grazing_case_needs_the_margin(monkeypatch):
    """The same rays on the two-level path (Cornell's one cluster as child 0
    of one supercluster): without the margin the child refinement of D and
    E drops the child that holds their hit on the light, which the dense
    plain versions find; with it the rays ask for the child, and the
    step-by-step model of D's walk equals D's plain version."""
    monkeypatch.setattr(oi, "SUPER_MIN_C", 0)
    scene, o, d, t_max, t_min, _ = flat_case("grazing", "cpu")
    walk, *_ = oi._prep(scene, o, d, t_min, t_max, anyhit=True)
    assert oi._is_super(walk)
    bounds, rays = walk[1], walk[-1]
    assert oi.anyhit_super_reference(*walk, t_min)[:5].all()
    assert oi.refine_children(bounds, rays, rays[6])[:5, 0, 0].all()
    assert not bare_slab(bounds[0, 0:3, 0], bounds[0, 3:6, 0], rays, rays[6])[:5].any()
    walk, *_ = oi._prep(scene, o, d, t_min, t_max, anyhit=False)
    t, i = oi.closest_super_reference(*walk, t_min)
    assert ((i[:5] == 16) | (i[:5] == 17)).all()
    tm, im = pair_walk_model(walk, t_min)
    assert torch.equal(tm, t) and torch.equal(im, i)


def test_widening_case_needs_the_widening(monkeypatch):
    """Without the widening the box test drops cluster 1 for some rays of the
    widening input, and the walk would keep cluster 3's copy of the tie (a
    larger index); with it the model is the plain version's."""
    scene, o, d, t_max, t_min, _ = flat_case("widening", "cpu")
    walk, _ = flat_walks(scene, o, d, t_max, t_min, False, False)
    assert walk[-4][0, :2].tolist() == [3, 1]
    monkeypatch.setattr(oi, "REFINE_REL", 0.0)
    monkeypatch.setattr(oi, "REFINE_ABS", 0.0)
    _, i, _ = flat_closest_model(walk, t_min)
    wrong = i == 3 * oi.CLUSTER_SIZE
    assert wrong.any() and ((i == oi.CLUSTER_SIZE) | wrong).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_box_test_keeps_every_hit(soup, seed):
    """On random rays the per-ray box test on the flat table keeps every
    cluster that holds a hit in (t_min, tmax) (any hit, at tmax) and every
    cluster that holds a ray's closest hit (closest hit, at that hit's t)."""
    o, d, t_max = soup_rays(2048, seed=20 + seed, anyhit=False)
    walk, *_ = oi._prep(soup, o, d, T_MIN, t_max, anyhit=False)
    tri, cmin, cmax, rays = walk[0], walk[1], walk[2], walk[-1]
    C = tri.shape[0]
    comp = tri.permute(1, 0, 2).reshape(oi.COMP, 1, -1).unbind(0)
    t, ok = oi._plane_terms(tuple(rays[k][:, None] for k in range(6)), comp)
    hit = (ok & (t > T_MIN) & (t < rays[6][:, None])).reshape(-1, C, oi.CLUSTER_SIZE)
    holds = hit.any(dim=2)
    asks = oi.refine_clusters(cmin, cmax, rays, rays[6], T_MIN)
    assert holds.sum() > 100 and not (holds & ~asks).any()
    best = torch.where(hit.reshape(hit.shape[0], -1), t, torch.inf).amin(dim=1)
    found = best < torch.inf
    at_best = oi.refine_clusters(cmin, cmax, rays, torch.where(found, best, -oi.BIG), T_MIN)
    closest = (hit & (t.reshape(hit.shape) == best[:, None, None])).any(dim=2)
    assert found.sum() > 100 and not (closest & ~at_best).any()
    assert at_best.sum() < asks.sum()


def test_model_matches_jax_closest_impl():
    """The closest-hit model against the JAX package's `_closest_impl` in
    interpret mode on one small input (8 clusters, 256 rays, 10% dead)."""
    js = jcompile(soup_spec(1024, seed=3)).scene
    ts = carry_over(js)
    rs = np.random.default_rng(8)
    n = 256
    o = rs.normal(0.0, 0.2, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(rs.random(n) < 0.1, 0.0, 1e8).astype(np.float32)
    (jo, jd), (to, td) = both_v3(o, d)
    (_, tri_pack, bounds, sargs, rays8, B, *_) = ip._prep(
        js, jo, jd, T_MIN, jnp.asarray(t_max), True)
    assert bounds is None
    t_j, i_j = ip._closest_impl(tri_pack, *sargs, rays8, T_MIN, interpret=True)
    t_j, i_j = np.asarray(t_j)[:n], np.asarray(i_j)[:n]
    walk, *_ = oi._prep(ts, to, td, T_MIN, torch.as_tensor(t_max), anyhit=False)
    t, i, _ = flat_closest_model(walk, T_MIN)
    np.testing.assert_array_equal(i[:n].numpy(), i_j)
    hit = i_j >= 0
    assert hit.sum() > 50
    np.testing.assert_allclose(t[:n].numpy()[hit], t_j[hit], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("route", ["list", "fused"])
@pytest.mark.parametrize("two_level", [False, True])
def test_walk_kind_is_stated(soup, monkeypatch, route, two_level):
    """`_is_super` reads the second operand's shape (the (C, 3) cluster boxes
    of the flat list walks, the (8, CP) box table of the flat fused walks,
    the (S, 7, 16) child bounds of the two-level ones) and
    `_is_fused` the absence of lists, so `_searches` picks the walk `_prep`
    made on every route."""
    if two_level:
        monkeypatch.setattr(oi, "SUPER_MIN_C", 0)
    o, d, t_max = soup_rays(256, seed=3, anyhit=False)
    walk, *_ = oi._prep(soup, o, d, T_MIN, t_max, anyhit=False, fused=route == "fused")
    assert oi._is_super(walk) == two_level and oi._is_fused(walk) == (route == "fused")
    want = {(False, False): (oi.closest_hit, oi.any_hit),
            (True, False): (oi.closest_super_hit, oi.any_super_hit),
            (False, True): (oi.fused_closest_hit, oi.fused_any_hit),
            (True, True): (oi.fused_closest_super_hit, oi.fused_any_super_hit)}
    assert oi._searches(walk) == want[two_level, route == "fused"]
    if two_level:
        return
    if route == "fused":
        assert torch.equal(walk[1], oi.pack_aabbs(soup.cluster_min, soup.cluster_max))
    else:
        assert walk[1] is soup.cluster_min and walk[2] is soup.cluster_max
