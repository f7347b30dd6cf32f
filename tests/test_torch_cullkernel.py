"""Kernel K, the cull of every query of at most 128 boxes, and `_prep` on it.

`_prep` takes its lists from `cull_lists`: kernel K for CUDA tensors and at
most 128 boxes, its plain version `cull_reference` (`_cull` and the walks'
integer types) otherwise. On the CPU `cull_reference` is held against the
JAX package's `_cull` on the same seeded rays and boxes with the yardstick of
the TPU experiment (`experiments/exp_cullkernel.py:147-159`): counts and the
lists up to the count exactly (as sets where two boxes' entries round
differently), entries and far within rtol 1e-5. What the CUDA kernel does,
block by block (the live boxes staged, a minimum a warp, the tile's key of
each box, a rank by counting, rows of n columns), is stated in numpy by
`cull_kernel_model` and held against `cull_reference` exactly. `_prep`'s
operands must equal those of `_cull` itself on every case, more than 128
boxes must take `_cull`, and a render and its gradients with the model as
the cull must equal the default path's bit for bit and match the JAX
package's within the tolerances of `tests/test_torch_path.py`.

The kernel itself is held against `cull_reference` and `_cull` on the card in
tests/test_torch_kernels.py.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafrixraytracing_torch.core import rng as trng
from mafrixraytracing_torch.core.v3 import V3 as TV3
from mafrixraytracing_torch.integrator import path as TP
from mafrixraytracing_torch.ops import cuda
from mafrixraytracing_torch.ops import intersect as ti
from mafrixraytracing_tpu.core.v3 import V3 as JV3
from mafrixraytracing_tpu.integrator import path as JP
from mafrixraytracing_tpu.ops import intersect_pallas as ip

from test_torch_fused import random_boxes
from test_torch_path import COMPACT, cornell
from test_torch_super import CASES, both_v3, rays, scenes
import torch_port_helpers  # noqa: F401  (sizes torch's threads to the run)

T_MIN = 1e-3
CULL_TILES = 4          # tiles a block of csrc/cull.cu


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
    r = seeded_rays(4 * ti.TILE, 50 + seed)
    lists, counts, entries, far = (x.numpy() for x in ti.cull_reference(
        cmin, cmax, torch.as_tensor(r)))
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


def cull_kernel_model(cmin, cmax, rays8):
    """What `cull_kernel` of csrc/cull.cu writes, block by block of
    CULL_TILES tiles, in float32 numpy:
    1. warp 0 stages the live boxes (min x <= max x), compacted in ascending
       id;
    2. each real ray slab-tests the staged boxes in `_cull`'s arithmetic (a
       NaN origin passes no box, entries clamped at +0, the entry BIG on a
       miss), a warp of 32 rays keeps the least entry bits of each staged
       box, and the ray writes its far (a NaN tmax gives a NaN far);
    3. a tile's key of each box is the least of its four warps' minima, BIG
       for an empty box;
    4. slot s < n of a tile goes to its rank among the tile's n (key, id)
       pairs, into a row of n columns; the count is the keys below BIG.
    The tiles of the last block past the batch write nothing."""
    f = np.float32
    big = f(ti.BIG)
    big_bits = big.view(np.uint32)
    n, B = cmin.shape[0], rays8.shape[1]
    tiles = B // ti.TILE
    staged = np.flatnonzero(cmin[:, 0] <= cmax[:, 0])
    lo, hi = cmin[staged], cmax[staged]
    ids = np.arange(n)
    lists = np.full((tiles, n), -1, np.int32)
    entries = np.full((tiles, n), np.nan, f)
    counts = np.full(tiles, -1, np.int32)
    far = np.full(B, np.nan, f)
    for block in range(-(-tiles // CULL_TILES)):
        real = [t for t in range(block * CULL_TILES, (block + 1) * CULL_TILES) if t < tiles]
        r = slice(real[0] * ti.TILE, (real[-1] + 1) * ti.TILE)
        o, d, tmax = rays8[0:3, r], rays8[3:6, r], rays8[6, r]
        sane = ~np.isnan(o).any(0)
        tn = np.full((tmax.shape[0], staged.size), -big, f)
        tf = np.full((tmax.shape[0], staged.size), big, f)
        with np.errstate(over="ignore", invalid="ignore"):
            for a in range(3):
                safe = np.where(np.abs(d[a]) > f(1e-12), d[a],
                                np.where(d[a] >= 0, f(1e-12), f(-1e-12))).astype(f)
                inv = (f(1.0) / safe)[:, None]
                t0 = (lo[None, :, a] - o[a][:, None]) * inv
                t1 = (hi[None, :, a] - o[a][:, None]) * inv
                tn = np.fmax(tn, np.fmin(t0, t1))
                tf = np.fmin(tf, np.fmax(t0, t1))
            hit = sane[:, None] & (tn <= tf) & (tf > 0) & (tn < tmax[:, None])
        e = np.where(hit, np.where(tn > 0, tn, f(0.0)), big).astype(f).view(np.uint32)
        last = np.where(hit, tf, -big).max(axis=1, initial=-big)
        far[r] = np.where(np.isnan(tmax), tmax, np.fmin(last, tmax))
        wmin = e.reshape(4 * len(real), 32, staged.size).min(axis=1)   # a row per warp
        key = np.full((len(real), n), big_bits, np.uint32)
        key[:, staged] = wmin.reshape(len(real), 4, staged.size).min(axis=1)
        below = key[:, None, :] < key[:, :, None]
        tie = (key[:, None, :] == key[:, :, None]) & (ids[None, :] < ids[:, None])
        rank = (below | tie).sum(axis=2)                             # rank[tile, slot]
        for k, t in enumerate(real):
            lists[t, rank[k]] = ids
            entries[t, rank[k]] = key[k].view(f)
            counts[t] = (key[k] < big_bits).sum()
    return lists, counts, entries, far


@pytest.mark.parametrize("n,seed", [(128, 0), (32, 1), (64, 2), (5, 3), (1, 4)])
@pytest.mark.parametrize("tiles", [4, 5])
def test_cull_kernel_model_equals_cull_reference(n, seed, tiles):
    """Batches of one block and of a block and a tile (not a multiple of the
    tiles a block), with a NaN origin, a NaN direction and a NaN tmax."""
    cmin, cmax = random_boxes(n, seed)
    if n == 1:
        cmin, cmax = cmin * 0.0 - 1.0, cmax * 0.0 + 1.0     # one live box
    r = seeded_rays(tiles * ti.TILE, 70 + seed)
    r[0, 3] = np.nan
    r[4, 9] = np.nan
    r[6, 12] = np.nan
    m = cull_kernel_model(cmin.numpy(), cmax.numpy(), r)
    want = [x.numpy() for x in ti.cull_reference(cmin, cmax, torch.as_tensor(r))]
    for got, w, what in zip(m, want, ("lists", "counts", "entries", "far")):
        np.testing.assert_array_equal(got, w, err_msg=what)
    assert np.isnan(m[3][12]) and m[3][3] == -np.float32(ti.BIG)
    assert m[1][0] > 0 and m[1][1] == 0 and m[1][2] == 0


def test_cull_lists_takes_plain_version_on_cpu_and_checks_operands():
    cmin, cmax = random_boxes(16, 4)
    r = torch.as_tensor(seeded_rays(384, 9))
    cuda.reset_launches()
    got = ti.cull_lists(cmin, cmax, r)
    want = ti.cull_reference(cmin, cmax, r)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    far = torch.empty(384)
    out = ti.cull_lists(cmin, cmax, r, far=far)
    assert out[3] is far and torch.equal(far, want[3])
    assert cuda.LAUNCHES["cull"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        ti.cull_kernel(cmin, cmax, r)
    big = cmin[:1].repeat(129, 1)
    with pytest.raises(ValueError, match="1 to 128 boxes"):
        ti.cull_kernel(big, big, r)
    with pytest.raises(ValueError, match="1 to 128 boxes"):
        ti.cull_kernel(cmin[:0], cmax[:0], r)
    with pytest.raises(ValueError, match="multiple of 128"):
        ti.cull_kernel(cmin, cmax, r[:, :100])


def test_cull_lists_chooses_by_device_and_box_count(monkeypatch):
    """Kernel K for rays on the card and 1 to 128 boxes; the plain version
    for rays on the CPU and for more boxes. The choice reads the device and
    the box count only, never a failure."""
    calls = []
    monkeypatch.setattr(ti, "cull_kernel", lambda *a: calls.append("kernel"))
    monkeypatch.setattr(ti, "cull_reference", lambda *a: calls.append("plain"))
    card, host = SimpleNamespace(is_cuda=True), SimpleNamespace(is_cuda=False)
    for n, on in ((1, card), (128, card), (129, card), (5, host), (129, host)):
        ti.cull_lists(torch.zeros(n, 3), torch.zeros(n, 3), on)
    assert calls == ["kernel", "kernel", "plain", "plain", "plain"]


def pytorch_cull_walk(scene, walk):
    """The list walk's operands with the lists of `_cull` itself on the same
    rays: int32 lists and counts, the entries, far in the rays' row 7."""
    *head, _, _, _, r = walk
    boxes = ((scene.super_min, scene.super_max) if ti._is_super(walk)
             else (scene.cluster_min, scene.cluster_max))
    lists, counts, entries, far = ti._cull(TV3(r[0], r[1], r[2]), TV3(r[3], r[4], r[5]),
                                           r[6], *boxes)
    return (*head, lists.to(torch.int32), counts.to(torch.int32), entries.contiguous(),
            torch.cat([r[:7], far[None]]))


@pytest.mark.parametrize("levels,name", [
    *[(lv, n) for lv in ("flat", "two_level") for n in CASES]])
def test_cull_kernel_route_equals_default_path(monkeypatch, name, levels):
    """`_prep`'s lists come from `cull_lists`, once a query: its operands
    equal those made with `_cull` itself (int32 lists of n columns, the same
    entries and far), for closest-hit and any-hit queries."""
    if levels == "two_level":
        monkeypatch.setattr(ti, "SUPER_MIN_C", 0)
    ts = scenes(name)[1]
    o, d, t_max = rays(333, CASES[name][1], seed=21)
    _, (to, td) = both_v3(o, d)
    t_max = torch.as_tensor(t_max)
    calls = []
    real = ti.cull_lists
    monkeypatch.setattr(ti, "cull_lists",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for anyhit, t_far in ((False, t_max), (True, t_max.clamp(max=1.5))):
        walk, *_ = ti._prep(ts, to, td, T_MIN, t_far, anyhit=anyhit)
        assert ti._is_super(walk) == (levels == "two_level")
        want = pytorch_cull_walk(ts, walk)
        assert len(walk) == len(want)
        for a, b in zip(walk, want):
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    assert len(calls) == 2


def test_more_than_128_boxes_take_the_pytorch_cull(monkeypatch):
    """129 cluster boxes on the flat path: `_prep` culls them with `_cull`
    (kernel K takes at most 128) into the same operands; the fused route,
    which culls only inside its kernels, raises."""
    ts = scenes("soup")[1]
    o, d, t_max = rays(300, CASES["soup"][1], seed=2)
    _, (to, td) = both_v3(o, d)
    monkeypatch.setattr(ti, "SUPER_MIN_C", 1 << 20)
    big = ts.replace(cluster_min=ts.cluster_min[:1].repeat(129, 1),
                     cluster_max=ts.cluster_max[:1].repeat(129, 1))
    culls = []
    real = ti._cull
    monkeypatch.setattr(ti, "_cull", lambda *a: culls.append(a[3].shape[0]) or real(*a))
    walk, *_ = ti._prep(big, to, td, T_MIN, torch.as_tensor(t_max), anyhit=False)
    assert culls == [129] and walk[-4].shape == (3, 129)
    want = pytorch_cull_walk(big, walk)
    assert all(torch.equal(a, b) for a, b in zip(walk, want))
    assert int(walk[-3].max()) > 0
    with pytest.raises(ValueError, match="at most 128 boxes"):
        ti._prep(big, to, td, T_MIN, torch.as_tensor(t_max), anyhit=False, fused=True)
    assert ti.FUSED_CULL is False   # the default


def model_cull_lists(cmin, cmax, rays, far=None):
    """`cull_lists` with `cull_kernel_model` in place of kernel K."""
    lists, counts, entries, f = (torch.as_tensor(x) for x in cull_kernel_model(
        cmin.detach().numpy(), cmax.detach().numpy(), rays.numpy()))
    if far is not None:
        far.copy_(f)
        f = far
    return lists, counts, entries, f


@pytest.mark.parametrize("levels", ["flat", "two_level"])
def test_cull_kernel_render_equals_default_and_matches_jax(monkeypatch, levels):
    """32x32 x 2 spp through the compacted loop with the kernel's model as
    the cull: the same bits as the default path, and the JAX render within
    the path tolerance."""
    if levels == "two_level":
        monkeypatch.setattr(ti, "SUPER_MIN_C", 0)
    W = H = 32
    jcs, ts, tcam = cornell(W, H)
    cfg = TP.PathTracerConfig(max_depth=5, compact=COMPACT)
    render = lambda: TP.render_image(ts, tcam, W, H, 2,  # noqa: E731
                                     trng.root_key(7, "cpu"), cfg)
    want = render()
    monkeypatch.setattr(ti, "cull_lists", model_cull_lists)
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
    """The gradient of the mean image to albedo and vertices with the
    kernel's model as the cull: bit for bit the default path's, and within
    rtol 1e-3 / atol 1e-5 of `jax.grad`'s."""
    W = H = 16
    jcs, ts, tcam = cornell(W, H)
    cfg = TP.PathTracerConfig(max_depth=3)

    def grads():
        leaves = [ts.mat_albedo.clone().requires_grad_(),
                  ts.tri_v0.clone().requires_grad_()]
        s = ts.replace(mat_albedo=leaves[0], tri_v0=leaves[1])
        TP.render_image(s, tcam, W, H, 1, trng.root_key(3, "cpu"), cfg).mean().backward()
        return [x.grad for x in leaves]

    want = grads()
    monkeypatch.setattr(ti, "cull_lists", model_cull_lists)
    got = grads()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert float(want[0].abs().max()) > 0
    js = jcs.scene

    def loss(a, v):
        s = js.replace(mat_albedo=a, tri_v0=v)
        return jnp.mean(JP.render_image(s, jcs.camera, W, H, 1, jax.random.key(3),
                                        JP.PathTracerConfig(max_depth=3, remat=False)))

    for g_j, g in zip(jax.grad(loss, argnums=(0, 1))(js.mat_albedo, js.tri_v0), got):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=1e-3, atol=1e-5)
