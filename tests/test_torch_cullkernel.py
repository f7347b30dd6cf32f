"""Kernel K, the cull as a kernel of its own, and the route that uses it.

On the CPU `cull_lists` runs K's plain version, `cull_reference` (`_cull` on
the packed box table). It is held against the JAX package's `_cull` on the
same seeded rays and boxes with the yardstick of the TPU experiment
(`experiments/exp_cullkernel.py:147-159`): counts and the lists up to the
count exactly (as sets where two boxes' entries round differently), entries
and far within rtol 1e-5. What the CUDA kernel writes to global memory (rows
of `stride` columns, the count, far) is stated in numpy on top of the
in-block cull's model (`tests/test_torch_fused.py::block_cull_model`) and
held against `cull_reference` exactly. With `CULL_KERNEL` on, queries and
renders must equal the port's default path bit for bit and the JAX render
within the path tolerance of `tests/test_torch_path.py`.

The kernel itself is held against `cull_reference` on the card in
tests/test_torch_kernels.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafrixraytracing_torch.core import rng as trng
from mafrixraytracing_torch.integrator import path as TP
from mafrixraytracing_torch.ops import cuda
from mafrixraytracing_torch.ops import intersect as ti
from mafrixraytracing_tpu.core.v3 import V3 as JV3
from mafrixraytracing_tpu.integrator import path as JP
from mafrixraytracing_tpu.ops import intersect_pallas as ip

from test_torch_fused import block_cull_model, random_boxes
from test_torch_path import COMPACT, cornell
from test_torch_super import CASES, aimed_rays, both_v3, rays, scenes

T_MIN = 1e-3


def seeded_rays(B, seed):
    """(8, B) rays among boxes in [-1.4, 1.4]^3: ~10% dead, some axis-aligned,
    a tile that misses everything, an all-dead tile."""
    rs = np.random.default_rng(seed)
    o = rs.uniform(-1.5, 1.5, (3, B)).astype(np.float32)
    d = rs.normal(size=(3, B)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    d[:, 7::11] = np.float32([[0.0], [-1.0], [0.0]])
    tmax = np.where(rs.random(B) < 0.1, 0.0, rs.uniform(0.2, 5.0, B)).astype(np.float32)
    tmax[::5] = 1e8
    o[:, 128:256] += 50.0
    d[:, 128:256] = np.float32([[1.0], [0.0], [0.0]])
    o[:, 256:384] -= 50.0
    tmax[256:384] = 0.0
    return np.concatenate([o, d, tmax[None], np.zeros((1, B), np.float32)])


@pytest.mark.parametrize("n,seed", [(128, 0), (32, 1), (64, 2), (5, 3)])
def test_cull_reference_matches_jax_cull(n, seed):
    cmin, cmax = random_boxes(n, seed)
    aabbs = ti.pack_aabbs(cmin, cmax)
    r = seeded_rays(4 * ti.TILE, 50 + seed)
    lists, counts, entries, far = (x.numpy() for x in ti.cull_reference(
        aabbs, torch.as_tensor(r), n))
    assert lists.dtype == np.int32 and counts.dtype == np.int32
    assert lists.shape == entries.shape == (4, n) and far.shape == (512,)
    j = jnp.asarray(r)
    jl, jc, je, jf = (np.asarray(x) for x in ip._cull(
        JV3(j[0], j[1], j[2]), JV3(j[3], j[4], j[5]), j[6],
        jnp.asarray(cmin.numpy()), jnp.asarray(cmax.numpy())))
    np.testing.assert_array_equal(counts, jc)
    assert counts[1] == 0 and counts[0] > 0
    for t in range(4):
        k = counts[t]
        assert set(lists[t, :k]) == set(jl[t, :k])
        np.testing.assert_allclose(entries[t, :k], je[t, :k], rtol=1e-5)
        # past the count: the other boxes by ascending id, entry BIG
        rest = lists[t, k:]
        assert (np.diff(rest) > 0).all() and (entries[t, k:] == np.float32(ti.BIG)).all()
        assert sorted(lists[t]) == list(range(n))
    np.testing.assert_allclose(far, jf, rtol=1e-5)


def cull_kernel_model(aabbs, rays8, n_box):
    """What `cull_kernel` of csrc/cull.cu writes for every tile: thread s <
    n_box stores slot s of the block's ordered list (all 128 slots ranked) and
    entries in a row of n_box columns, thread 0 the count, every thread its
    far."""
    lists, counts, entries, far = block_cull_model(aabbs, rays8, n_box)
    tiles = lists.shape[0]
    out_l = np.full((tiles, n_box), -1, np.int32)
    out_e = np.full((tiles, n_box), np.nan, np.float32)
    for s in range(n_box):
        out_l[:, s] = lists[:, s]
        out_e[:, s] = entries[:, s]
    return out_l, counts.astype(np.int32), out_e, far


@pytest.mark.parametrize("n,seed", [(128, 0), (32, 1), (64, 2), (5, 3)])
@pytest.mark.parametrize("wide", [False, True])
def test_cull_kernel_model_equals_cull_reference(n, seed, wide):
    """Rows of n_box columns (what the route asks for) and of CP columns."""
    cmin, cmax = random_boxes(n, seed)
    aabbs = ti.pack_aabbs(cmin, cmax)
    r = seeded_rays(4 * ti.TILE, 70 + seed)
    width = ti.CP if wide else n
    m = cull_kernel_model(aabbs.numpy(), r, width)
    want = [x.numpy() for x in ti.cull_reference(aabbs, torch.as_tensor(r), width)]
    for got, w, what in zip(m, want, ("lists", "counts", "entries", "far")):
        np.testing.assert_array_equal(got, w, err_msg=what)
    # the first n columns do not depend on the row width
    narrow = [x.numpy() for x in ti.cull_reference(aabbs, torch.as_tensor(r), n)]
    np.testing.assert_array_equal(want[0][:, :n], narrow[0])
    np.testing.assert_array_equal(want[2][:, :n], narrow[2])
    np.testing.assert_array_equal(want[1], narrow[1])


def test_cull_lists_takes_plain_version_on_cpu_and_checks_operands():
    cmin, cmax = random_boxes(16, 4)
    aabbs = ti.pack_aabbs(cmin, cmax)
    r = torch.as_tensor(seeded_rays(384, 9))
    cuda.reset_launches()
    got = ti.cull_lists(aabbs, r, 16)
    want = ti.cull_reference(aabbs, r, 16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert cuda.LAUNCHES["cull"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        ti.cull_kernel(aabbs, r, 16)
    with pytest.raises(ValueError, match="at most 128"):
        ti.cull_kernel(aabbs, r, 129)
    with pytest.raises(ValueError, match="multiple of 128"):
        ti.cull_kernel(aabbs, r[:, :100], 16)


@pytest.mark.parametrize("levels,name", [
    *[(lv, n) for lv in ("flat", "two_level") for n in CASES]])
def test_cull_kernel_route_equals_default_path(monkeypatch, name, levels):
    """Queries with `CULL_KERNEL` on: the walk's operands equal the default
    path's (int32 lists of the same width, the same far) and so do the
    results, and the PyTorch cull is reached only through `cull_reference`."""
    if levels == "two_level":
        monkeypatch.setattr(ti, "SUPER_MIN_C", 0)
    ts = scenes(name)[1]
    o, d, t_max = rays(333, CASES[name][1], seed=21)
    _, (to, td) = both_v3(o, d)
    t_max = torch.as_tensor(t_max)
    want = (ti.find_closest_soa(ts, to, td, T_MIN, t_max),
            ti.occluded_soa(ts, to, td, T_MIN, t_max.clamp(max=1.5)))
    lw, *_ = ti._prep(ts, to, td, T_MIN, t_max, anyhit=False)
    kw, *_ = ti._prep(ts, to, td, T_MIN, t_max, anyhit=False, cull_kernel=True)
    assert len(kw) == len(lw)
    for a, b in zip(kw, lw):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    calls = []
    real = ti.cull_lists
    monkeypatch.setattr(ti, "cull_lists", lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(ti, "CULL_KERNEL", True)
    got = (ti.find_closest_soa(ts, to, td, T_MIN, t_max),
           ti.occluded_soa(ts, to, td, T_MIN, t_max.clamp(max=1.5)))
    assert len(calls) == 2
    assert torch.equal(got[0][0], want[0][0]) and torch.equal(got[0][1], want[0][1])
    assert torch.equal(got[1], want[1])


def test_cull_kernel_route_refuses_both_flags_and_too_many_boxes(monkeypatch):
    ts = scenes("soup")[1]
    o, d, t_max = rays(100, CASES["soup"][1], seed=2)
    _, (to, td) = both_v3(o, d)
    monkeypatch.setattr(ti, "CULL_KERNEL", True)
    monkeypatch.setattr(ti, "FUSED_CULL", True)
    with pytest.raises(ValueError, match="at most one"):
        ti.find_closest_soa(ts, to, td, T_MIN, torch.as_tensor(t_max))
    with pytest.raises(ValueError, match="at most one"):
        ti.occluded_soa(ts, to, td, T_MIN, torch.as_tensor(t_max))
    monkeypatch.setattr(ti, "FUSED_CULL", False)
    # 129 boxes on the flat path: the route raises, as the fused one does
    monkeypatch.setattr(ti, "SUPER_MIN_C", 1 << 20)
    big = ts.replace(cluster_min=ts.cluster_min[:1].repeat(129, 1),
                     cluster_max=ts.cluster_max[:1].repeat(129, 1))
    with pytest.raises(ValueError, match="at most 128 boxes"):
        ti._prep(big, to, td, T_MIN, torch.as_tensor(t_max), anyhit=False,
                 cull_kernel=True)
    assert ti.CULL_KERNEL is True
    monkeypatch.undo()
    assert ti.CULL_KERNEL is False and ti.FUSED_CULL is False   # the defaults


@pytest.mark.parametrize("levels", ["flat", "two_level"])
def test_cull_kernel_render_equals_default_and_matches_jax(monkeypatch, levels):
    """32x32 x 2 spp through the compacted loop: the same bits as the port's
    default path, and the JAX render within the path tolerance."""
    if levels == "two_level":
        monkeypatch.setattr(ti, "SUPER_MIN_C", 0)
    W = H = 32
    jcs, ts, tcam = cornell(W, H)
    cfg = TP.PathTracerConfig(max_depth=5, compact=COMPACT)
    render = lambda: TP.render_image(ts, tcam, W, H, 2,  # noqa: E731
                                     trng.root_key(7, "cpu"), cfg)
    want = render()
    monkeypatch.setattr(ti, "CULL_KERNEL", True)
    got = render()
    assert torch.equal(got, want) and float(want.mean()) > 0.01
    if levels == "flat":
        jimg = np.asarray(JP.render_image(
            jcs.scene, jcs.camera, W, H, 2, jax.random.key(7),
            JP.PathTracerConfig(max_depth=5, compact=COMPACT)))
        close = np.isclose(got.numpy(), jimg, rtol=1e-3, atol=1e-4).all(axis=-1)
        assert close.mean() >= 0.995, close.mean()
        assert abs(got.numpy().mean() - jimg.mean()) <= 1e-4 * abs(jimg.mean())


def test_cull_kernel_gradients_equal_default(monkeypatch):
    """The gradient of the mean image with the route on, bit for bit."""
    W = H = 16
    _, ts, tcam = cornell(W, H)
    cfg = TP.PathTracerConfig(max_depth=3)

    def grads():
        leaves = [ts.mat_albedo.clone().requires_grad_(),
                  ts.tri_v0.clone().requires_grad_()]
        s = ts.replace(mat_albedo=leaves[0], tri_v0=leaves[1])
        TP.render_image(s, tcam, W, H, 1, trng.root_key(3, "cpu"), cfg).mean().backward()
        return [x.grad for x in leaves]

    want = grads()
    monkeypatch.setattr(ti, "CULL_KERNEL", True)
    got = grads()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert float(want[0].abs().max()) > 0
