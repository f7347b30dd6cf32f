"""The training slice's gradients against the JAX package, and a recovery.

The floor + area light scene of `tests/test_checkpoint.py`, carried over as
numpy arrays, from a start with one albedo off and the floor's vertices moved
(`torch_port_helpers.bad_start`):
- the port's loss and gradients within rtol 1e-4 (atol 1e-6 for the loss,
  1e-7 for the gradients: float32 sums in another order) of
  `jax.value_and_grad` of the JAX package's own loss, for `mat_albedo` and
  for `mesh_vertices`, with 1 and 2 microbatches;
- the displaced floor of `tests/test_inverse.py::test_recover_floor_vertices`
  recovered with that test's own criterion, at 16x16 x 4 spp.
The train step itself is held against JAX's in `test_torch_train_step.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import bad_start, floor_scene
from mafrixraytracing_torch.core import rng as trng
from mafrixraytracing_torch.integrator import path as TP
from mafrixraytracing_torch.opt import inverse as tinv
from mafrixraytracing_tpu.integrator import path as JP
from mafrixraytracing_tpu.opt import inverse as jinv
from mafrixraytracing_tpu.parallel.render import _render_flat_pixels
from mafrixraytracing_tpu.scene import spec as S

W = H = 16
SUB = 2                 # samples per microbatch: spp = SUB * M
NAMES = ("mat_albedo", "mesh_vertices")
JCFG = JP.PathTracerConfig(max_depth=2, rr_enable=False, backend="jnp")
TCFG = TP.PathTracerConfig(max_depth=2, rr_enable=False)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are tiny: more intra-op threads only contend with
    the other test workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    js, jcam, ts, tcam = floor_scene()
    target = np.array(JP.render_image(js, jcam, W, H, 8, jax.random.key(7), JCFG))
    ids = jnp.arange(W * H, dtype=jnp.int32)
    tflat = jnp.asarray(target).reshape(W * H, 3)

    @jax.jit
    def jax_loss_and_grads(params, offset):
        def loss_fn(p):
            s = jinv.apply_params(js, p)
            img = _render_flat_pixels(s, jcam, ids, W, H, SUB, jax.random.key(3),
                                      JCFG, sample_offset=offset)
            return jinv.image_loss(img, tflat)
        return jax.value_and_grad(loss_fn)(params)

    start = bad_start(js)
    jparams = {n: jnp.asarray(start[n]) for n in NAMES}
    jax_out = [jax_loss_and_grads(jparams, m * SUB) for m in range(2)]
    return dict(ts=ts, tcam=tcam, target=torch.as_tensor(target), start=start,
                jax_out=jax_out)


@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradients_match_jax(setup, name, M):
    st = setup
    jl = sum(float(l) for l, _ in st["jax_out"][:M]) / M
    jg = sum(np.asarray(g[name]) for _, g in st["jax_out"][:M]) / M
    params = {n: torch.as_tensor(st["start"][n].copy()).requires_grad_()
              for n in NAMES}
    loss, grads = tinv.loss_and_grads(
        params, st["ts"], st["tcam"], st["target"], trng.root_key(3, "cpu"),
        SUB * M, TCFG, overlap_microbatches=M)
    assert np.abs(jg).max() > 1e-3 and not grads[name].requires_grad
    np.testing.assert_allclose(float(loss), jl, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(grads[name].numpy(), jg, rtol=1e-4, atol=1e-7)


def test_microbatches_must_divide_spp(setup):
    st = setup
    params = {"mat_albedo": st["ts"].mat_albedo.clone().requires_grad_()}
    with pytest.raises(ValueError, match="must divide"):
        tinv.loss_and_grads(params, st["ts"], st["tcam"], st["target"],
                            trng.root_key(3, "cpu"), 4, TCFG,
                            overlap_microbatches=3)


def test_recover_floor_vertices(capsys):
    """A floor displaced 0.25 upward under an area light: vertex-position
    gradients pull it back (the loss drops below a fifth, the error by more
    than 60%)."""
    cam = S.CameraSpec(position=(0.0, 1.2, 3.0), direction=(0.0, -0.3, -1.0),
                       fov=60.0, fov_convention="standard")
    _, _, ts, tcam = floor_scene(camera=cam, radiance=12.0, albedo=(0.7, 0.7, 0.7))
    with torch.no_grad():
        target = TP.render_image(ts, tcam, W, H, 32, trng.root_key(7, "cpu"), TCFG)
    true_v0 = ts.tri_v0.numpy().copy()
    mask = ts.tri_mask.numpy()
    pert = true_v0 + np.where(mask[:, None], [[0.0, 0.25, 0.0]], 0.0).astype(np.float32)
    bad = ts.replace(tri_v0=torch.as_tensor(pert))
    seen = []
    fitted, losses = tinv.fit(bad, tcam, target, ("tri_v0",), steps=60, lr=3e-2,
                              spp=4, key=trng.root_key(11, "cpu"), config=TCFG,
                              log_every=30,
                              callback=lambda i, loss, p: seen.append(i))
    assert seen == list(range(60))
    assert capsys.readouterr().out.count("[fit] step") == 3   # 0, 30 and 59
    assert np.mean(losses[-5:]) < 0.2 * np.mean(losses[:3]), losses
    d_before = np.linalg.norm(pert - true_v0, axis=1)[mask].mean()
    d_after = np.linalg.norm(fitted.tri_v0.numpy() - true_v0, axis=1)[mask].mean()
    assert d_after < 0.4 * d_before, (d_after, d_before)
    assert not fitted.tri_v0.requires_grad
