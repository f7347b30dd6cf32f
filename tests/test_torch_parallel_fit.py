"""The port's sharded train step (`opt.inverse` with `mesh=`) on two real
processes, against the one-process step and against the JAX package's step on
a 2-device mesh.

The floor + area light scene and the start of tests/test_torch_train_step.py
(`torch_port_helpers.bad_start`: every gradient component well above rounding
noise, so Adam's normalised step is well-conditioned). 16x16 pixels divide
evenly over two ranks and both shards take the whole image's sample group, so
every pixel's radiance is the same bits wherever it is rendered; what differs
is the order of the float sums (the mean over a shard's pixels, then over the
ranks, against the mean over the image) and, against JAX, the two packages'
rounding. Tolerances, as in tests/test_torch_train_step.py: loss and gradient
norm rtol 1e-4, parameters after the Adam step atol 1e-4 (1e-5 against the
port's own one-process step). The two ranks' parameters must be equal bit for
bit. With one microbatch and with two (the per-microbatch all-reduce).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_worker as worker
from mafrixraytracing_torch import entry
from mafrixraytracing_torch.core import rng as trng
from mafrixraytracing_torch.integrator import path as TP
from mafrixraytracing_torch.opt import inverse as tinv
from mafrixraytracing_torch.parallel import launch, mesh as tmesh
from mafrixraytracing_torch.scene.compiler import STATIC_FLAGS, TENSOR_FIELDS
from mafrixraytracing_tpu.integrator import path as JP
from mafrixraytracing_tpu.opt import inverse as jinv
from mafrixraytracing_tpu.parallel.mesh import make_mesh as jmake_mesh

from torch_port_helpers import CAMERA_FIELDS, bad_start, floor_scene

W = H = 16
SPP = 4
LR = 2e-2
SEED = 11
NAMES = ("mat_albedo", "mesh_vertices")
JCFG = JP.PathTracerConfig(max_depth=2, rr_enable=False, backend="jnp")
TCFG = dict(max_depth=2, rr_enable=False)
SMOOTH = {1: 2, 2: 0}       # microbatches -> smoothing iterations


@pytest.fixture(scope="module")
def scenes():
    js, jcam, ts, tcam = floor_scene()
    target = np.array(JP.render_image(js, jcam, W, H, 8, jax.random.key(7), JCFG))
    return dict(js=js, jcam=jcam, ts=ts, tcam=tcam, target=target,
                start=bad_start(js), runs={})


def jax_two_steps(st, M):
    """Two JAX train steps on a 2-device mesh:
    [(params, opt_state, next key, loss, gnorm)]."""
    opt = optax.adam(LR)
    params = {n: jnp.asarray(st["start"][n]) for n in NAMES}
    opt_state = opt.init(params)
    step = jinv.make_train_step(jmake_mesh(2), opt, W, H, SPP, JCFG,
                                smooth_geometry=SMOOTH[M], overlap_microbatches=M)
    key, out = jax.random.key(SEED), []
    for _ in range(2):
        key, sub = jax.random.split(key)
        params, opt_state, loss, gnorm = step(params, opt_state, st["js"],
                                              st["jcam"], jnp.asarray(st["target"]), sub)
        out.append((params, opt_state, key, float(loss), float(gnorm)))
    return out


def runs(st, M, tmp_path_factory):
    """(JAX steps, the two ranks' results) for M microbatches, made once."""
    if M not in st["runs"]:
        jout = jax_two_steps(st, M)
        jparams, jopt, jkey, _, _ = jout[0]
        adam = jopt[0]
        out_dir = tmp_path_factory.mktemp(f"train{M}")
        ts, tcam = st["ts"], st["tcam"]
        worker.save_job(
            out_dir / "job.pt",
            scene={k: getattr(ts, k).numpy() for k in TENSOR_FIELDS},
            flags={k: getattr(ts, k) for k in STATIC_FLAGS},
            camera={k: getattr(tcam, k).numpy() for k in CAMERA_FIELDS},
            target=st["target"], start={n: st["start"][n] for n in NAMES},
            spp=SPP, lr=LR, seed=SEED, M=M, smooth=SMOOTH[M], config=TCFG,
            carried=dict(params={n: np.asarray(jparams[n]) for n in NAMES},
                         mu={n: np.asarray(adam.mu[n]) for n in NAMES},
                         nu={n: np.asarray(adam.nu[n]) for n in NAMES},
                         count=int(adam.count), step=1,
                         key_data=np.asarray(jax.random.key_data(jkey))),
            fit_steps=2 if M == 2 else 0)
        launch.spawn_local(worker.train_worker, 2, (2, str(out_dir)), timeout_s=200.0)
        st["runs"][M] = (jout, [worker.load_result(str(out_dir), r) for r in range(2)])
    return st["runs"][M]


def one_process_step(st, M, mesh=None):
    params = {n: torch.as_tensor(st["start"][n].copy()).requires_grad_()
              for n in NAMES}
    step = tinv.make_train_step(tinv._adam(params, LR), SPP,
                                TP.PathTracerConfig(**TCFG),
                                smooth_geometry=SMOOTH[M], overlap_microbatches=M,
                                mesh=mesh)
    _, sub = trng.split(trng.root_key(SEED, "cpu"))
    loss, gnorm = step(params, st["ts"], st["tcam"], torch.as_tensor(st["target"]), sub)
    return (float(loss), float(gnorm)), {n: p.detach().numpy() for n, p in params.items()}


@pytest.mark.parametrize("M", [1, 2])
def test_two_process_step_matches_one_process_step(scenes, tmp_path_factory, M):
    _, (r0, r1) = runs(scenes, M, tmp_path_factory)
    assert r0["first"] == r1["first"]
    for n in NAMES:      # every rank took the same Adam step
        np.testing.assert_array_equal(r0["first_params"][n], r1["first_params"][n])
    (loss, gnorm), params = one_process_step(scenes, M)
    np.testing.assert_allclose(r0["first"][0], (loss, gnorm), rtol=1e-4)
    for n in NAMES:
        moved = np.abs(params[n] - scenes["start"][n]).max()
        assert moved > 0.5 * LR, (n, moved)
        np.testing.assert_allclose(r0["first_params"][n], params[n], atol=1e-5,
                                   err_msg=n)


@pytest.mark.parametrize("M", [1, 2])
def test_two_process_step_matches_jax_on_two_devices(scenes, tmp_path_factory, M):
    """The first step from the start, and the second from the JAX state after
    its first step, carried over with `state_from_jax` on both ranks."""
    jout, (r0, r1) = runs(scenes, M, tmp_path_factory)
    for which, j in (("first", jout[0]), ("second", jout[1])):
        assert r0[which] == r1[which]
        np.testing.assert_allclose(r0[which][0], j[3:], rtol=1e-4)
        for n in NAMES:
            np.testing.assert_array_equal(r0[f"{which}_params"][n],
                                          r1[f"{which}_params"][n])
            np.testing.assert_allclose(r0[f"{which}_params"][n], np.asarray(j[0][n]),
                                       atol=1e-4, err_msg=f"{which} {n}")


def test_sharded_fit_writes_one_checkpoint_and_resumes_on_every_rank(
        scenes, tmp_path_factory):
    """Two steps of `fit(mesh=...)` on two ranks: equal on both, and equal to
    one step, a checkpoint written by rank 0, and the rest resumed from it by
    both."""
    _, (r0, r1) = runs(scenes, 2, tmp_path_factory)
    assert r0["fit_losses"] == r1["fit_losses"] and len(r0["fit_losses"]) == 2
    assert r0["fit_tail"] == r1["fit_tail"] == r0["fit_losses"][1:]
    assert r0["fit_equal"] and r1["fit_equal"]
    assert r0["checkpoint_exists"] and r1["checkpoint_exists"]
    for n in NAMES:
        np.testing.assert_array_equal(r0["fit_params"][n], r1["fit_params"][n])
    np.testing.assert_allclose(r0["fit_losses"][0], r0["first"][0][0], rtol=1e-6)


@pytest.mark.parametrize("M", [1, 2])
def test_mesh_of_one_gives_the_bits_of_no_mesh(scenes, M):
    a = one_process_step(scenes, M)
    b = one_process_step(scenes, M, mesh=tmesh.make_mesh(1))
    assert a[0] == b[0]
    for n in NAMES:
        np.testing.assert_array_equal(a[1][n], b[1][n])


def test_padded_shards_of_a_frame_that_does_not_divide(scenes):
    """15x15 = 225 pixels over 2 ranks: 226 ids, the first pixel twice; a
    mesh of two ranks without a process group cannot take the step."""
    st = scenes
    target = torch.as_tensor(st["target"][:15, :15].copy())
    params = {n: torch.as_tensor(st["start"][n].copy()).requires_grad_() for n in NAMES}
    shards = []
    for r in range(2):
        m = tmesh.make_mesh(2, r)
        shards.append((torch.arange(226) % 225)[m.shard(226)])
        with pytest.raises(RuntimeError, match="process group"):
            tinv.loss_and_grads(params, st["ts"], st["tcam"], target,
                                trng.root_key(5, "cpu"), 2,
                                TP.PathTracerConfig(**TCFG), mesh=m)
    assert shards[0].shape == shards[1].shape == (113,)
    assert torch.equal(torch.cat(shards)[:225], torch.arange(225))
    assert int(shards[1][-1]) == 0


def test_dryrun_multiprocess(capfd):
    entry.dryrun_multiprocess(2, "cpu")
    assert "dryrun_multiprocess(2) ok" in capfd.readouterr().out


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without a card")
def test_the_cpu_must_be_asked_for(tmp_path):
    """Without a card the multi-process entry points raise as the rest of the
    port does, rather than quietly taking gloo and the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.dryrun_multiprocess(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.sharded_train_step(tmesh.make_mesh(1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.init(f"file://{tmp_path / 'store'}", 1, 0)
    assert not torch.distributed.is_initialized()


def test_entry_forward_step():
    fn, args = entry.entry(device="cpu")
    out = fn(*args)
    assert out.shape == (64, 64, 3) and bool(torch.isfinite(out).all())
    assert float(out.mean()) > 0.01


def test_launch_init_false_and_fit_without_mesh_unchanged(scenes, monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert launch.init() is False
    st = scenes
    start = tinv.apply_params(st["ts"], {n: torch.as_tensor(st["start"][n])
                                         for n in NAMES})
    common = dict(param_names=NAMES, steps=2, lr=LR, spp=2,
                  key=trng.root_key(1, "cpu"), config=TP.PathTracerConfig(**TCFG))
    a, la = tinv.fit(start, st["tcam"], torch.as_tensor(st["target"]), **common)
    b, lb = tinv.fit(start, st["tcam"], torch.as_tensor(st["target"]),
                     mesh=launch.global_mesh(), **common)
    assert la == lb and all(torch.equal(getattr(a, n), getattr(b, n)) for n in NAMES)
