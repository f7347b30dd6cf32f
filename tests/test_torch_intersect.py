"""The port's searches and attribute fetch against the JAX package.

On the CPU the port's wrappers run the plain PyTorch versions of the three
CUDA kernels; they are held against the Pallas kernels run in interpret mode
(`ip.find_closest_soa` / `ip.occluded_soa`), as tests/test_pallas.py runs
them. Contract (test_pallas.py:26-42): `idx` equal, `t` within rtol 1e-4 /
atol 1e-5 (the Pallas kernel divides by an approximate reciprocal).

The kernels themselves are held against their plain versions on the card in
tests/test_torch_kernels.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafrixraytracing_torch.core.v3 import V3 as TV3
from mafrixraytracing_torch.geometry import intersect as tisect
from mafrixraytracing_torch.ops import intersect as ti
from mafrixraytracing_torch.ops import unpack as tu
from mafrixraytracing_torch.scene.compiler import (
    STATIC_FLAGS,
    TENSOR_FIELDS,
    from_jax_arrays,
)
from mafrixraytracing_tpu.core.types import Rays
from mafrixraytracing_tpu.core.v3 import V3 as JV3
from mafrixraytracing_tpu.geometry import intersect as jisect
from mafrixraytracing_tpu.ops import intersect_pallas as ip
from mafrixraytracing_tpu.ops import unpack_pallas as jup
from mafrixraytracing_tpu.scene import builtin as jbuiltin
from mafrixraytracing_tpu.scene import spec as JS
from mafrixraytracing_tpu.scene.compiler import compile_scene as jcompile
import torch_port_helpers  # noqa: F401  (sizes torch's threads to the run)

T_MIN = 1e-3


def soup_spec(n=1024, seed=3):
    """n small random triangles in [-1, 1]^3 (n / 128 clusters)."""
    rs = np.random.default_rng(seed)
    centers = rs.uniform(-1.0, 1.0, (n, 1, 3))
    verts = (centers + rs.normal(0.0, 0.08, (n, 3, 3))).reshape(-1, 3)
    mesh = JS.Mesh(vertices=verts.astype(np.float32),
                   faces=np.arange(3 * n, dtype=np.int32).reshape(n, 3))
    return JS.SceneSpec(shapes=[JS.ShapeSpec(mesh=mesh, material=0)])


CASES = {
    "cornell": (lambda: jbuiltin.cornell_box(), (0.0, 1.0, 1.5)),
    "sphere_triad": (lambda: jbuiltin.sphere_triad(), (0.0, 0.7, 2.0)),
    "soup": (soup_spec, (0.0, 0.0, 0.0)),
}


def scenes(name):
    """(JAX scene, the port's scene from the same arrays)."""
    js = jcompile(CASES[name][0]()).scene
    d = {k: np.asarray(getattr(js, k)) for k in TENSOR_FIELDS}
    ts = from_jax_arrays(d, {k: getattr(js, k) for k in STATIC_FLAGS},
                         device="cpu")
    return js, ts


def rays(n, origin, seed, dead_frac=0.1, t_far=1e8):
    rs = np.random.default_rng(seed)
    o = (np.asarray(origin, np.float32)
         + rs.normal(0.0, 0.2, (n, 3))).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(rs.random(n) < dead_frac, 0.0, t_far).astype(np.float32)
    return o, d, t_max


def both_v3(o, d):
    jo, jd = JV3.of(jnp.asarray(o)), JV3.of(jnp.asarray(d))
    to, td = TV3.of(torch.as_tensor(o)), TV3.of(torch.as_tensor(d))
    return (jo, jd), (to, td)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("n", [100, 384])
def test_closest_matches_pallas(name, n):
    js, ts = scenes(name)
    assert ts.cluster_min.shape[0] == {"cornell": 1, "sphere_triad": 1,
                                       "soup": 8}[name]
    o, d, t_max = rays(n, CASES[name][1], seed=n)
    (jo, jd), (to, td) = both_v3(o, d)
    t_j, i_j = ip.find_closest_soa(js, jo, jd, T_MIN, jnp.asarray(t_max),
                                   interpret=True)
    t_t, i_t = ti.find_closest_soa(ts, to, td, T_MIN, torch.as_tensor(t_max))
    i_j, t_j = np.asarray(i_j), np.asarray(t_j)
    np.testing.assert_array_equal(i_t.numpy(), i_j)
    hit = i_j >= 0
    assert hit.sum() > n // 10
    np.testing.assert_allclose(t_t.numpy()[hit], t_j[hit], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_occluded_matches_pallas(name):
    js, ts = scenes(name)
    o, d, _ = rays(300, CASES[name][1], seed=11)
    t_far = np.random.default_rng(5).uniform(0.0, 3.0, 300).astype(np.float32)
    t_far[::9] = 0.0
    (jo, jd), (to, td) = both_v3(o, d)
    occ_j = ip.occluded_soa(js, jo, jd, T_MIN, jnp.asarray(t_far),
                            interpret=True)
    occ_t = ti.occluded_soa(ts, to, td, T_MIN, torch.as_tensor(t_far))
    np.testing.assert_array_equal(occ_t.numpy(), np.asarray(occ_j))
    assert 0 < occ_t.sum() < 300


@pytest.mark.parametrize("name", list(CASES))
def test_brute_force_matches_jax(name):
    """The port's brute-force oracle equals the JAX jnp reference path, and
    the cluster path equals the oracle."""
    js, ts = scenes(name)
    o, d, _ = rays(256, CASES[name][1], seed=2, dead_frac=0.0)
    (to, td) = both_v3(o, d)[1]
    t_j, i_j = jisect.find_closest(
        js, Rays(origin=jnp.asarray(o), direction=jnp.asarray(d)), T_MIN, 1e8)
    t_b, i_b = tisect.find_closest(ts, to, td, T_MIN, 1e8)
    np.testing.assert_array_equal(i_b.numpy(), np.asarray(i_j))
    hit = np.asarray(i_j) >= 0
    np.testing.assert_allclose(t_b.numpy()[hit], np.asarray(t_j)[hit],
                               rtol=1e-4, atol=1e-5)
    t_c, i_c = ti.find_closest_soa(ts, to, td, T_MIN, 1e8)
    np.testing.assert_array_equal(i_c.numpy(), i_b.numpy())


def test_t_min_honoured():
    js, ts = scenes("cornell")
    o = np.tile(np.float32([[0.3, 1.9, -0.4]]), (128, 1))
    d = np.tile(np.float32([[0.0, -1.0, 0.0]]), (128, 1))
    (jo, jd), (to, td) = both_v3(o, d)
    got = {}
    for t_min in (1e-3, 1.95):
        t_j, i_j = ip.find_closest_soa(js, jo, jd, t_min, 1e8, interpret=True)
        t_t, i_t = ti.find_closest_soa(ts, to, td, t_min, 1e8)
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), rtol=1e-5)
        got[t_min] = float(t_t[0])
    assert got[1.95] > got[1e-3] + 0.01


def test_pack_tris_matches_pallas_layout():
    js, ts = scenes("soup")
    jp = np.asarray(ip.pack_tris(js)).reshape(-1, 16, 128)[:, :12]
    np.testing.assert_allclose(ti.pack_tris(ts).numpy(), jp, rtol=1e-6,
                               atol=1e-7)


def test_cull_lists_match_pallas():
    js, ts = scenes("soup")
    o, d, t_max = rays(512, CASES["soup"][1], seed=4)
    (jo, jd), (to, td) = both_v3(o, d)
    jl, jc, je, jf = ip._cull(jo, jd, jnp.asarray(t_max), js.cluster_min,
                              js.cluster_max)
    tl, tc, te, tf = ti._cull(to, td, torch.as_tensor(t_max), ts.cluster_min,
                              ts.cluster_max)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for row in range(tc.shape[0]):
        n = int(tc[row])
        np.testing.assert_array_equal(tl[row, :n].numpy(), np.asarray(jl)[row, :n])
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6)


def _table_and_idx(seed=0, P=136, B=1000):
    rs = np.random.default_rng(seed)
    table = rs.normal(size=(P, 36)).astype(np.float32)
    idx = rs.integers(0, P, B).astype(np.int32)
    return table, idx


def test_fetch_cols_forward_matches_jax():
    table, idx = _table_and_idx()
    j = np.stack([np.asarray(c) for c in jup.fetch_cols(jnp.asarray(table),
                                                        jnp.asarray(idx))])
    t = tu.fetch_cols(torch.as_tensor(table), torch.as_tensor(idx).long())
    assert t.shape == (36, 1000)
    np.testing.assert_array_equal(t.numpy(), j)


def test_fetch_cols_backward_matches_jax():
    """The port's backward (index_add_) equals the JAX package's backward
    rule `_fetch_bwd` and `jax.vjp` of its CPU fetch, for repeated rows."""
    table, idx = _table_and_idx(seed=1, P=40, B=700)
    ct = np.random.default_rng(2).normal(size=(36, 700)).astype(np.float32)
    jt, ji = jnp.asarray(table), jnp.asarray(idx)
    ct_rule = np.asarray(jup._fetch_bwd((ji, 40), tuple(jnp.asarray(ct)))[0])
    _, vjp = jax.vjp(lambda tb: jup.fetch_cols(tb, ji), jt)
    ct_vjp = np.asarray(vjp(tuple(jnp.asarray(ct)))[0])
    tt = torch.as_tensor(table).requires_grad_()
    cols = tu.fetch_cols(tt, torch.as_tensor(idx).long())
    (cols * torch.as_tensor(ct)).sum().backward()
    np.testing.assert_allclose(tt.grad.numpy(), ct_rule, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tt.grad.numpy(), ct_vjp, rtol=1e-6, atol=1e-6)
