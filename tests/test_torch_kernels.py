"""The port's kernel wrappers, and on a CUDA card the kernels themselves.

This file imports no JAX, so the card's machine (which has none) runs it:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

On the CPU, the wrappers take the plain PyTorch versions and the kernels'
entry points refuse CPU tensors. The tests marked `cuda` hold each kernel
against its plain version on the card: closest-hit `idx` equal and `t`
within rtol 1e-4 / atol 1e-5 (the search contract; the kernels are built
to agree bit for bit), any-hit and the gather exactly; and a small render
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


def rays(n, origin, seed, device, dead_frac=0.1):
    rs = np.random.default_rng(seed)
    o = (np.asarray(origin, np.float32) + rs.normal(0.0, 0.2, (n, 3))).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
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
    assert cuda.LAUNCHES == {"closest": 0, "anyhit": 0, "unpack": 0}


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


def test_too_many_clusters_raises():
    ts = scene_on("cornell", "cpu")
    big = ts.replace(cluster_min=ts.cluster_min.repeat(129, 1),
                     cluster_max=ts.cluster_max.repeat(129, 1))
    o, d, _ = rays(8, (0, 1, 1), seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        oi.find_closest_soa(big, o, d, T_MIN, 1e8)


def test_library_name_tracks_sources():
    name = cuda.library_path().name
    assert name.startswith("libmfx_kernels_") and name.endswith(".so")
    assert cuda.library_path() == cuda.library_path()
    assert {p.name for p in cuda._sources()} == {"intersect.cu", "unpack.cu"}


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
                                   rng.root_key(7), cfg).cpu().numpy())
    close = np.isclose(imgs[1], imgs[0], rtol=1e-3, atol=1e-4).all(axis=-1)
    assert close.mean() >= 0.995, close.mean()
    assert abs(imgs[1].mean() - imgs[0].mean()) <= 1e-4 * abs(imgs[0].mean())

