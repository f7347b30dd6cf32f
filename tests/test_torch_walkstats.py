"""The instrumented closest-hit walks and the walk-profile entry point.

On the CPU `closest_dbg_hit` and `closest_full_hit` run their plain versions,
a step-by-step model of kernel A's walk per tile (`ops.intersect._walk_model`).
They must give kernel A's `(t, idx)` exactly (the dense `closest_reference`)
and the JAX package's search in interpret mode within its contract
(`tests/test_pallas.py:26-42`: idx equal, t within rtol 1e-4 / atol 1e-5).
`walked` is held against an independent count: the first k at which the
k-th entry lies beyond the tile's limit after the dense closest hit over the
first k listed clusters. At t_min < 0 (and NaN) the walks have no exit, as
A has none there, and `walked` is the count. The CUDA kernels are held
against these plain versions and against A on the card in
tests/test_torch_kernels.py.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafrixraytracing_torch import profile_walk
from mafrixraytracing_torch.ops import cuda
from mafrixraytracing_torch.ops import intersect as ti
from mafrixraytracing_tpu.ops import intersect_pallas as ip
from mafrixraytracing_tpu.scene.compiler import compile_scene as jcompile

from mafrixraytracing_tpu.scene import spec as JS

from test_torch_kernels import behind_case, flat_case, flat_walks
from test_torch_super import both_v3, carry_over
import torch_port_helpers  # noqa: F401  (sizes torch's threads to the run)

T_MIN = 1e-3


@pytest.fixture(scope="module")
def soup():
    """2,048 random triangles, large enough to hide one another: 16 clusters,
    the flat path."""
    rs = np.random.default_rng(8)
    centers = rs.uniform(-1.0, 1.0, (2048, 1, 3))
    verts = (centers + rs.normal(0.0, 0.3, (2048, 3, 3))).reshape(-1, 3)
    mesh = JS.Mesh(vertices=verts.astype(np.float32),
                   faces=np.arange(3 * 2048, dtype=np.int32).reshape(2048, 3))
    js = jcompile(JS.SceneSpec(shapes=[JS.ShapeSpec(mesh=mesh, material=0)])).scene
    return js, carry_over(js)


def tile_rays(tiles, seed, dead_frac=0.1, origin_z=4.0):
    """Coherent tiles: the 128 rays of a tile leave one point outside the soup
    toward one small patch of it, so a tile's front clusters hide the rest."""
    rs = np.random.default_rng(seed)
    n = tiles * ti.TILE
    eye = np.repeat(rs.normal(0.0, 0.3, (tiles, 3)) + [0.0, 0.0, origin_z], ti.TILE, 0)
    patch = np.repeat(rs.uniform(-0.8, 0.8, (tiles, 3)), ti.TILE, 0)
    target = patch + rs.normal(0.0, 0.03, (n, 3))
    d = (target - eye).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(rs.random(n) < dead_frac, 0.0, 1e8).astype(np.float32)
    return eye.astype(np.float32), d, t_max


def walk_of(ts, o, d, t_max):
    _, (to, td) = both_v3(o, d)
    walk, *_ = ti._prep(ts, to, td, T_MIN, torch.as_tensor(t_max), anyhit=False)
    assert not ti._is_super(walk)
    return walk


@pytest.mark.parametrize("tiles,seed", [(4, 0), (3, 1), (6, 2)])
def test_dbg_and_full_equal_closest_and_match_jax(soup, tiles, seed):
    js, ts = soup
    assert ts.cluster_min.shape[0] == 16
    o, d, t_max = tile_rays(tiles, seed)
    walk = walk_of(ts, o, d, t_max)
    ta, ia = ti.closest_reference(*walk, T_MIN)
    td_, id_, walked = ti.closest_dbg_reference(*walk, T_MIN)
    tf, if_ = ti.closest_full_reference(*walk, T_MIN)
    assert torch.equal(td_, ta) and torch.equal(id_, ia)
    assert torch.equal(tf, ta) and torch.equal(if_, ia)
    assert walked.dtype == torch.int32 and walked.shape == (tiles,)
    assert (walked <= walk[-3]).all()
    assert (walked < walk[-3]).any(), "the early exit never fired on coherent tiles"
    (jo, jd), _ = both_v3(o, d)
    t_j, i_j = ip.find_closest_soa(js, jo, jd, T_MIN, jnp.asarray(t_max),
                                   interpret=True)
    i_j, t_j = np.asarray(i_j), np.asarray(t_j)
    np.testing.assert_array_equal(id_.numpy(), i_j)     # no mega, no spheres
    hit = i_j >= 0
    assert hit.sum() > tiles * 32
    np.testing.assert_allclose(td_.numpy()[hit], t_j[hit], rtol=1e-4, atol=1e-5)


def independent_walked(walk):
    """walked[tile] from dense searches: after the first k listed clusters the
    tile's limit is max over its rays of min(best t, far); the walk stops at
    the first k whose entry lies beyond it."""
    *head, lists, counts, entries, rays = walk
    tiles = lists.shape[0]
    far = rays[7].reshape(tiles, ti.TILE).numpy()
    out = counts.numpy().copy()
    done = np.zeros(tiles, bool)
    for k in range(int(counts.max())):
        t_k, _ = ti.closest_reference(*head, lists, counts.clamp(max=k), entries,
                                      rays, T_MIN)          # tmax on a miss
        worst = np.fmin(t_k.reshape(tiles, ti.TILE).numpy(), far).max(axis=1)
        stop = ~done & (k < counts.numpy()) & ~(entries[:, k].numpy() <= worst)
        out[stop] = k
        done |= stop
    return out


@pytest.mark.parametrize("tiles,seed,dead", [(4, 3, 0.1), (5, 4, 0.0), (2, 5, 0.5)])
def test_walked_equals_independent_count(soup, tiles, seed, dead):
    _, ts = soup
    o, d, t_max = tile_rays(tiles, seed, dead_frac=dead)
    walk = walk_of(ts, o, d, t_max)
    walked = ti.closest_dbg_reference(*walk, T_MIN)[2]
    np.testing.assert_array_equal(walked.numpy(), independent_walked(walk))
    assert (walked > 0).any()


@pytest.mark.parametrize("name", ["negative_t_min", "behind"])
def test_walks_take_a_negative_t_min(name):
    """At t_min = -3 and NaN the two plain versions equal `closest_reference`
    bit for bit and `walked` is the count: the cull's entries and far bound
    only the hits ahead of the origin, so the exit is off, as in A. On the
    flat `behind` input the exit would fire before cluster 16 (its entry 6
    lies beyond every ray's min(best, far) after cluster 0) and lose the hits
    behind rays 0-126."""
    scene, o, d, t_max, t_min, dead_tile = flat_case(name, "cpu")
    walk, _ = flat_walks(scene, o, d, t_max, t_min, False, dead_tile)
    *head, lists, counts, entries, rays = walk
    for tm in (t_min, float("nan")):
        ta, ia = ti.closest_reference(*walk, tm)
        td_, id_, walked = ti.closest_dbg_reference(*walk, tm)
        tf, if_ = ti.closest_full_reference(*walk, tm)
        assert torch.equal(td_, ta) and torch.equal(id_, ia)
        assert torch.equal(tf, ta) and torch.equal(if_, ia)
        assert torch.equal(walked, counts)
    assert (ia < 0).all()
    ta, ia = ti.closest_reference(*walk, t_min)
    assert (ia >= 0).all() and t_min < 0
    if name == "behind":
        *_, t_want, i_want = behind_case("cpu")
        assert torch.equal(ta, t_want) and torch.equal(ia, i_want)
        assert lists[0, :2].tolist() == [0, 16] and int(counts[0]) == 2
        first = ti.closest_reference(*head, lists, counts.clamp(max=1), entries, rays,
                                     t_min)[0]
        assert float(entries[0, 1]) > float(torch.fmin(first, rays[7]).max())


def test_dead_tile_walks_nothing_and_unsorted_rays_walk_more(soup):
    _, ts = soup
    o, d, t_max = tile_rays(3, 6, dead_frac=0.0)
    t_max[128:256] = 0.0
    # a dead tile far from the soup lists nothing
    o[128:256] += 100.0
    walk = walk_of(ts, o, d, t_max)
    t, i, walked = ti.closest_dbg_reference(*walk, T_MIN)
    assert walk[-3][1] == 0 and walked[1] == 0 and (i[128:256] == -1).all()
    # the same rays shuffled across tiles: longer lists, at least as many walked
    perm = np.random.default_rng(0).permutation(384)
    mixed = walk_of(ts, o[perm], d[perm], t_max[perm])
    assert mixed[-3].sum() > walk[-3].sum()
    assert ti.closest_dbg_reference(*mixed, T_MIN)[2].sum() >= walked.sum()


def test_dispatchers_take_plain_versions_on_cpu(soup):
    _, ts = soup
    walk = walk_of(ts, *tile_rays(2, 7))
    cuda.reset_launches()
    a = ti.closest_dbg_hit(*walk, T_MIN)
    b = ti.closest_full_hit(*walk, T_MIN)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and len(a) == 3
    assert cuda.LAUNCHES["closest_dbg"] == 0 == cuda.LAUNCHES["closest_full"]


def test_profile_walk_main_at_a_tiny_size(tmp_path, monkeypatch, capsys):
    """`main()` on a sphere of 1,152 faces at 16x16: both wavefronts, the
    equalities, the statistics and the JSON line."""
    monkeypatch.setattr(profile_walk.tempfile, "gettempdir", lambda: str(tmp_path))
    monkeypatch.delenv("BENCH_OBJ", raising=False)
    spec, name = profile_walk.flat_spec(16, quads=24)
    assert name == "sphere1152" and (
        tmp_path / "mafrix_torch_sphere24_seed2025.obj").exists()
    record = profile_walk.main([], size=16, device="cpu", reps=1, spec=spec,
                               scene_name=name)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == record
    assert record["device"] == "cpu" and record["clusters"] <= 128
    for w in ("primary", "bounce1"):
        r = record[w]
        assert r["rays"] == 16 * 16 * 8
        assert r["cull_kernel_equals_cull"] and r["dbg_equals_closest"]
        assert r["full_equals_closest"] and r["walked_within_listed"]
        assert r["walked_per_tile"]["mean"] <= r["listed_per_tile"]["mean"]
        assert set(r["host_ms"]) == {"cull", "cull_kernel", "closest", "closest_dbg",
                                     "closest_full"} and "ms" not in r
    assert record["primary"]["live_rays"] == 2048 > record["bounce1"]["live_rays"] > 0
    assert 0.05 < record["primary"]["hit_rate"] < 1.0


def test_profile_walk_refuses_a_two_level_scene(monkeypatch):
    monkeypatch.setattr(ti, "SUPER_MIN_C", 0)
    from mafrixraytracing_torch.scene.builtin import cornell_box

    with pytest.raises(ValueError, match="flat scene"):
        profile_walk.main([], size=16, device="cpu", reps=1, spec=cornell_box(16, 16),
                          scene_name="cornell")
