"""The port's `core/transform.py` against `mafrixraytracing_tpu/core/transform.py`
on the same numpy inputs, made from a seed.

Tolerance rtol 1e-6, atol 1e-6: ATen's and XLA's float32 `cos` and `sin`
may differ by an ulp, and their 4x4 products sum in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafrixraytracing_torch.core import transform as T
from mafrixraytracing_tpu.core import transform as JT
import torch_port_helpers  # noqa: F401  (sizes torch's threads to the run)

TOL = dict(rtol=1e-6, atol=1e-6)
ANGLES = (0.0, 90.0, -37.5, 180.0, 271.3)


def close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


@pytest.mark.parametrize("axis", ["x", "y", "z"])
def test_rotations(axis):
    for deg in ANGLES:
        close(getattr(T, f"rotation_{axis}")(deg, device="cpu"),
              getattr(JT, f"rotation_{axis}")(deg))


def test_identity_translation_scale():
    rs = np.random.default_rng(0)
    o = rs.normal(size=3).astype(np.float32)
    f = rs.uniform(0.2, 3.0, 3).astype(np.float32)
    np.testing.assert_array_equal(T.identity(device="cpu"), JT.identity())
    np.testing.assert_array_equal(T.translation(o, device="cpu"), JT.translation(o))
    np.testing.assert_array_equal(T.scale(f, device="cpu"), JT.scale(f))
    np.testing.assert_array_equal(T.scale(2.5, device="cpu"), JT.scale(2.5))


def _three(mod, rs_seed=1, **dev):
    rs = np.random.default_rng(rs_seed)
    o = rs.normal(size=3).astype(np.float32)
    f = rs.uniform(0.5, 2.0, 3).astype(np.float32)
    return mod.compose(mod.scale(f, **dev), mod.rotation_y(-37.5, **dev),
                       mod.translation(o, **dev))


def test_compose_and_inverse():
    m, jm = _three(T, device="cpu"), _three(JT)
    close(m, jm)
    close(T.inverse(m), JT.inverse(jm))
    close(T.inverse(m) @ m, np.eye(4, dtype=np.float32))
    # compose(A, B) applies A first
    a, b = T.rotation_x(30.0, device="cpu"), T.translation((1.0, 2.0, 3.0), device="cpu")
    np.testing.assert_array_equal(T.compose(a, b), b @ a)


def test_apply_point_vector_normal():
    rs = np.random.default_rng(2)
    m, jm = _three(T, device="cpu"), _three(JT)
    p = rs.normal(size=(4, 5, 3)).astype(np.float32)
    close(T.apply_point(m, torch.from_numpy(p)), JT.apply_point(jm, jnp.asarray(p)))
    close(T.apply_vector(m, torch.from_numpy(p)), JT.apply_vector(jm, jnp.asarray(p)))
    close(T.apply_normal(m, torch.from_numpy(p)), JT.apply_normal(jm, jnp.asarray(p)))


def test_apply_point_at_w_near_zero():
    """A projective matrix whose w is ~0 at some points: the guard keeps
    w = 1 there, as in the JAX package."""
    proj = np.eye(4, dtype=np.float32)
    proj[3] = [0.0, 0.0, 1.0, 0.0]            # w = z
    p = np.array([[1.0, 2.0, 0.0], [1.0, 2.0, 1e-13], [1.0, 2.0, 2.0],
                  [3.0, -1.0, -1e-3]], np.float32)
    got = T.apply_point(torch.from_numpy(proj), torch.from_numpy(p))
    want = JT.apply_point(jnp.asarray(proj), jnp.asarray(p))
    close(got, want)
    np.testing.assert_array_equal(got[:2], p[:2])     # |w| <= 1e-12: no divide


def test_normals_stay_perpendicular_under_nonuniform_scale():
    rs = np.random.default_rng(3)
    m = T.compose(T.scale((3.0, 0.5, 1.0), device="cpu"), T.rotation_z(20.0, device="cpu"))
    t1 = torch.from_numpy(rs.normal(size=(6, 3)).astype(np.float32))
    t2 = torch.from_numpy(rs.normal(size=(6, 3)).astype(np.float32))
    n = torch.linalg.cross(t1, t2)
    nw = T.apply_normal(m, n)
    close(nw, JT.apply_normal(jnp.asarray(m.numpy()), jnp.asarray(n.numpy())))
    for t in (t1, t2):
        tw = T.apply_vector(m, t)
        cos = (nw * tw).sum(-1) / (nw.norm(dim=-1) * tw.norm(dim=-1))
        assert float(cos.abs().max()) < 1e-5


def test_gradients_match_jax():
    rs = np.random.default_rng(4)
    p = rs.normal(size=(7, 3)).astype(np.float32)
    o = rs.normal(size=3).astype(np.float32)
    d = np.float32(-37.5)

    def jloss(d, o):
        return jnp.sum(JT.apply_point(JT.compose(JT.rotation_y(d), JT.translation(o)),
                                      jnp.asarray(p)))

    jd, jo = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(d), jnp.asarray(o))
    td = torch.tensor(d, requires_grad=True)
    to = torch.tensor(o, requires_grad=True)
    loss = T.apply_point(T.compose(T.rotation_y(td, device="cpu"),
                                   T.translation(to, device="cpu")),
                         torch.from_numpy(p)).sum()
    loss.backward()
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to.grad.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-5)
    assert float(td.grad) != 0.0


@pytest.mark.parametrize("factory", [
    lambda: T.identity(), lambda: T.translation((1.0, 2.0, 3.0)), lambda: T.scale(2.0),
    lambda: T.rotation_x(10.0), lambda: T.rotation_y(10.0), lambda: T.rotation_z(10.0)])
def test_factories_need_a_card_without_device(monkeypatch, factory):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        factory()
