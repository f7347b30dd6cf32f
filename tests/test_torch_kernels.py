"""The port's kernel wrappers, and on a CUDA card the kernels themselves.

This file imports no JAX, so the card's machine (which has none) runs it:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

On the CPU, the wrappers take the plain PyTorch versions and the kernels'
entry points refuse CPU tensors. The tests marked `cuda` hold each kernel
against its plain version on the card: closest-hit `idx` equal and `t`
within rtol 1e-4 / atol 1e-5 (the search contract; the kernels are built
to agree bit for bit), any-hit and the gather exactly, for the flat walks
(A, B) and the two-level walks (D, E: small scenes with `SUPER_MIN_C`
patched to 0, and a mesh of 20,000 triangles); and a small render
through the kernels against the same render on the CPU (image rtol 1e-3 /
atol 1e-4 on 99.5% of pixels: the two devices' sin/cos/sqrt round
differently, which can flip a grazing branch).
"""
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
    ou.fetch_cols(torch.zeros(8, 36), torch.zeros(4, dtype=torch.long))
    big = compile_scene(bumpy_sphere(), device="cpu").scene
    assert big.cluster_min.shape[0] > oi.SUPER_MIN_C
    oi.find_closest_soa(big, o, d, T_MIN, t_max)
    oi.occluded_soa(big, o, d, T_MIN, t_max)
    assert cuda.LAUNCHES == {"closest": 0, "anyhit": 0, "unpack": 0,
                             "closest_super": 0, "anyhit_super": 0}


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
    big = compile_scene(bumpy_sphere(), device="cpu").scene
    walk, *_ = oi._prep(big, o, d, T_MIN, t_max, anyhit=False)
    with pytest.raises(ValueError, match="CUDA"):
        oi.closest_super_kernel(*walk, T_MIN)
    with pytest.raises(ValueError, match="CUDA"):
        oi.anyhit_super_kernel(*walk, T_MIN)


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
        "intersect.cu", "intersect_super.cu", "unpack.cu"}


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
    torch.testing.assert_close(tk, tp, rtol=1e-4, atol=1e-5)
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
    torch.testing.assert_close(tk, tp, rtol=1e-4, atol=1e-5)
    t_near = torch.where(ik[:n] >= 0, tk[:n] * 1.01, t_max)
    for t_far in (t_max * 0.4, t_near):
        walk, *_ = oi._prep(ts, o, d, T_MIN, t_far, anyhit=True)
        assert torch.equal(oi.anyhit_super_kernel(*walk, T_MIN),
                           oi.anyhit_super_reference(*walk, T_MIN))


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
    for dev in ("cpu", card):
        t = table.to(dev, copy=True).requires_grad_()
        (ou.fetch_cols(t, idx.to(dev)) * ct.to(dev)).sum().backward()
        grads.append(t.grad.cpu())
    # the card's index_add_ sums with atomics, in no fixed order
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-5, atol=1e-5)


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

