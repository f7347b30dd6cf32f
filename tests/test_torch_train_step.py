"""The port's train step against the JAX package's, step by step, on the CPU.

The floor + area light scene of `tests/test_checkpoint.py`; both packages
start from the same parameters (`mat_albedo` and `mesh_vertices` together)
and walk the same key chain. The JAX step runs on a one-device mesh, so its
`pmean` is the identity. After each of 3 Adam steps the loss and the
gradient norm agree within rtol 1e-4, and after the third the parameters
within 1e-4 absolute, with one microbatch (and the vertex gradient smoothed)
and with two. Then the JAX fit's state after 2 steps is carried over with
`state_from_jax`, and the third step is taken in the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from torch_port_helpers import bad_start, floor_scene
from mafrixraytracing_torch.core import rng as trng
from mafrixraytracing_torch.integrator import path as TP
from mafrixraytracing_torch.opt import inverse as tinv
from mafrixraytracing_tpu.integrator import path as JP
from mafrixraytracing_tpu.opt import inverse as jinv
from mafrixraytracing_tpu.parallel.mesh import RAY_AXIS

W = H = 16
SPP = 4
LR = 2e-2
NAMES = ("mat_albedo", "mesh_vertices")
JCFG = JP.PathTracerConfig(max_depth=2, rr_enable=False, backend="jnp")
TCFG = TP.PathTracerConfig(max_depth=2, rr_enable=False)
CASES = {"one_microbatch_smoothed": (1, 2), "two_microbatches": (2, 0)}


@pytest.fixture(scope="module")
def scenes():
    js, jcam, ts, tcam = floor_scene()
    target = np.array(JP.render_image(js, jcam, W, H, 8, jax.random.key(7), JCFG))
    return dict(js=js, jcam=jcam, ts=ts, tcam=tcam, target=target,
                start=bad_start(js), jax_runs={})


def jax_run(st, case):
    """Three JAX train steps: [(params, opt_state, next key, loss, gnorm)]."""
    if case not in st["jax_runs"]:
        M, smooth = CASES[case]
        mesh = Mesh(np.array(jax.devices()[:1]), (RAY_AXIS,))
        opt = optax.adam(LR)
        params = {n: jnp.asarray(st["start"][n]) for n in NAMES}
        opt_state = opt.init(params)
        step = jinv.make_train_step(mesh, opt, W, H, SPP, JCFG,
                                    smooth_geometry=smooth,
                                    overlap_microbatches=M)
        key, out = jax.random.key(11), []
        for _ in range(3):
            key, sub = jax.random.split(key)
            params, opt_state, loss, gnorm = step(
                params, opt_state, st["js"], st["jcam"],
                jnp.asarray(st["target"]), sub)
            out.append((params, opt_state, key, float(loss), float(gnorm)))
        st["jax_runs"][case] = out
    return st["jax_runs"][case]


def torch_steps(st, params, optimizer, key, n, case):
    M, smooth = CASES[case]
    step = tinv.make_train_step(optimizer, SPP, TCFG, smooth_geometry=smooth,
                                overlap_microbatches=M)
    out = []
    for _ in range(n):
        key, sub = trng.split(key)
        loss, gnorm = step(params, st["ts"], st["tcam"],
                           torch.as_tensor(st["target"]), sub)
        assert all(p.grad is None for p in params.values())
        out.append((float(loss), float(gnorm)))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_three_train_steps_match_jax(scenes, case):
    st = scenes
    jout = jax_run(st, case)
    params = {n: torch.as_tensor(st["start"][n].copy()).requires_grad_()
              for n in NAMES}
    tout = torch_steps(st, params, tinv._adam(params, LR),
                       trng.root_key(11, "cpu"), 3, case)
    np.testing.assert_allclose(np.asarray(tout),
                               np.asarray([o[3:] for o in jout]), rtol=1e-4)
    assert tout[-1][0] < tout[0][0]
    for n in NAMES:
        moved = np.abs(params[n].detach().numpy() - st["start"][n]).max()
        assert moved > 0.5 * LR, (n, moved)
        np.testing.assert_allclose(params[n].detach().numpy(),
                                   np.asarray(jout[-1][0][n]), atol=1e-4,
                                   err_msg=n)


def test_state_carried_over_from_jax(scenes):
    """Two steps in JAX, the state carried over, the third step in the port."""
    st, case = scenes, "one_microbatch_smoothed"
    jout = jax_run(st, case)
    jparams, jopt, jkey, _, _ = jout[1]
    adam = jopt[0]
    params, optimizer, step, key = tinv.state_from_jax(
        {n: np.asarray(jparams[n]) for n in NAMES},
        {n: np.asarray(adam.mu[n]) for n in NAMES},
        {n: np.asarray(adam.nu[n]) for n in NAMES}, int(adam.count), 2,
        np.asarray(jax.random.key_data(jkey)), LR, device="cpu")
    assert step == 2 and all(p.requires_grad for p in params.values())
    tout = torch_steps(st, params, optimizer, key, 1, case)
    np.testing.assert_allclose(np.asarray(tout[0]), np.asarray(jout[2][3:]),
                               rtol=1e-4)
    for n in NAMES:
        np.testing.assert_allclose(params[n].detach().numpy(),
                                   np.asarray(jout[2][0][n]), atol=1e-5)


def test_state_from_jax_before_the_first_step():
    params, optimizer, step, key = tinv.state_from_jax(
        {"mat_albedo": np.full((8, 3), 0.5, np.float32)}, {}, {}, 0, 0,
        np.array([0, 9], np.uint32), LR, device="cpu")
    assert step == 0 and key.tolist() == [0, 9] and not optimizer.state
