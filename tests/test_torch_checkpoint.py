"""Checkpoint and resume in the port, on the CPU.

The cases of `tests/test_checkpoint.py`: a progressive render interrupted and
resumed from an npz checkpoint is bit-identical to the uninterrupted one, a
scene survives a round trip, and a fit of 8 steps equals 4 steps + a restart
from the checkpoint + 4 steps, bit for bit (parameters, Adam state and the
key chain are stored exactly).
"""
import os

import jax
import numpy as np
import pytest
import torch

from torch_port_helpers import carry_scene, floor_spec
from mafrixraytracing_torch.core import rng
from mafrixraytracing_torch.film.film import FilmState
from mafrixraytracing_torch.integrator.path import (
    PathTracerConfig,
    render_image,
    render_sample_batch,
)
from mafrixraytracing_torch.opt import inverse
from mafrixraytracing_torch.scene.builtin import cornell_box
from mafrixraytracing_torch.scene.compiler import (
    STATIC_FLAGS,
    TENSOR_FIELDS,
    compile_scene,
)
from mafrixraytracing_torch.utils import checkpoint as ckpt
from mafrixraytracing_tpu.film.film import FilmState as JFilmState
from mafrixraytracing_tpu.scene.compiler import compile_scene as jcompile

W = H = 16
CFG = PathTracerConfig(max_depth=2, rr_enable=False)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def accumulate(scene, camera, film, seed, start, count):
    key = rng.root_key(seed, "cpu")
    for s in range(start, start + count):
        flat = render_sample_batch(scene, camera, W, H, s, key, CFG)
        film = film.add_frame(flat.reshape(H, W, 3))
    return film


def test_resume_bit_exact(tmp_path):
    cs = compile_scene(cornell_box(width=W, height=H), device="cpu")
    scene, camera = cs.scene, cs.camera
    seed = 42
    with torch.no_grad():
        full = accumulate(scene, camera, FilmState.create(H, W, "cpu"), seed, 0, 4)
        half = accumulate(scene, camera, FilmState.create(H, W, "cpu"), seed, 0, 2)
        path = os.path.join(tmp_path, "render.npz")
        ckpt.save_render_state(path, half, next_sample=2, seed=seed)
        film2, next_sample, seed2 = ckpt.load_render_state(path, device="cpu")
        assert (next_sample, seed2) == (2, seed)
        assert film2.frame_count.dtype == torch.int32
        resumed = accumulate(scene, camera, film2, seed2, next_sample, 2)
    assert torch.equal(full.radiance_sum, resumed.radiance_sum)
    assert int(resumed.frame_count) == int(full.frame_count) == 4
    assert torch.equal(full.display(), resumed.display())
    assert float(full.radiance_sum.mean()) > 0.01


def test_film_state_matches_jax():
    rs = np.random.default_rng(0)
    frames = rs.uniform(0.0, 4.0, (3, H, W, 3)).astype(np.float32)
    tf, jf = FilmState.create(H, W, "cpu"), JFilmState.create(H, W)
    assert int(tf.frame_count) == 0 and float(tf.mean.sum()) == 0.0
    for f in frames:
        tf, jf = tf.add_frame(torch.as_tensor(f)), jf.add_frame(jax.numpy.asarray(f))
    np.testing.assert_array_equal(tf.radiance_sum.numpy(), np.asarray(jf.radiance_sum))
    np.testing.assert_allclose(tf.mean.numpy(), np.asarray(jf.mean), rtol=1e-6)
    np.testing.assert_allclose(tf.display().numpy(), np.asarray(jf.display()),
                               rtol=1e-5, atol=1e-6)
    # bytes may differ by one where the float image rounds across a step
    diff = np.abs(tf.to_bytes().numpy().astype(int) - np.asarray(jf.to_bytes()).astype(int))
    assert tf.to_bytes().dtype == torch.uint8 and diff.max() <= 1
    cleared = tf.reset()
    assert int(cleared.frame_count) == 0 and float(cleared.radiance_sum.abs().sum()) == 0.0
    assert int(tf.frame_count) == 3      # states are values: `tf` is untouched


def test_scene_roundtrip(tmp_path):
    scene = compile_scene(cornell_box(width=W, height=H), device="cpu").scene
    path = os.path.join(tmp_path, "scene")
    ckpt.save_scene(path, scene)
    back = ckpt.load_scene(path, device="cpu")
    for k in TENSOR_FIELDS:
        a, b = getattr(scene, k), getattr(back, k)
        assert a.dtype == b.dtype and torch.equal(a, b), k
    for k in STATIC_FLAGS:
        assert getattr(scene, k) == getattr(back, k)
        assert type(getattr(scene, k)) is type(getattr(back, k)), k


def fit_setup():
    ts = carry_scene(jcompile(floor_spec()).scene)
    cam = compile_scene(floor_spec(), device="cpu").camera
    with torch.no_grad():
        target = render_image(ts, cam, W, H, 4, rng.root_key(7, "cpu"), CFG)
    alb = ts.mat_albedo.clone()
    alb[0] = torch.tensor([0.8, 0.2, 0.2])
    return ts.replace(mat_albedo=alb), cam, target


@pytest.mark.parametrize("names,kw", [
    (("mat_albedo",), {}),
    (("mat_albedo", "mesh_vertices"), dict(smooth_geometry=2,
                                           overlap_microbatches=2)),
])
def test_fit_restart_bit_exact(tmp_path, names, kw):
    """8 steps uninterrupted; 4 steps with checkpoints, everything dropped,
    restarted from the checkpoint for the other 4: the final parameters and
    the loss trace are equal bit for bit."""
    bad, cam, target = fit_setup()
    common = dict(param_names=names, lr=5e-2, spp=2, key=rng.root_key(3, "cpu"),
                  config=CFG, **kw)
    ref_scene, ref_losses = inverse.fit(bad, cam, target, steps=8, **common)
    ck = str(tmp_path / "fit_ck")
    inverse.fit(bad, cam, target, steps=4, checkpoint_path=ck,
                checkpoint_every=2, **common)
    assert os.listdir(tmp_path) == ["fit_ck.npz"]     # no temporary left
    res_scene, res_losses = inverse.fit(bad, cam, target, steps=8,
                                        checkpoint_path=ck, checkpoint_every=2,
                                        **common)
    assert len(res_losses) == 4      # only the resumed half ran
    assert res_losses == ref_losses[4:]
    for n in names + ("tri_v0", "cluster_max"):
        assert torch.equal(getattr(res_scene, n), getattr(ref_scene, n)), n
    assert not torch.equal(ref_scene.mat_albedo, bad.mat_albedo)
    # a finished fit's checkpoint resumes to no step at all
    _, none = inverse.fit(bad, cam, target, steps=8, checkpoint_path=ck, **common)
    assert none == []


def test_fit_state_roundtrip_restores_adam_exactly(tmp_path):
    rs = np.random.default_rng(1)
    params = {"a": torch.as_tensor(rs.normal(size=(5, 3)).astype(np.float32)).requires_grad_(),
              "b": torch.as_tensor(rs.normal(size=(7,)).astype(np.float32)).requires_grad_()}
    opt = inverse._adam(params, 1e-2)
    for _ in range(3):
        for p in params.values():
            p.grad = torch.as_tensor(rs.normal(size=p.shape).astype(np.float32))
        opt.step()
    path = str(tmp_path / "state")
    key = torch.tensor([0xFFFFFFFF, 7], dtype=torch.int64)
    ckpt.save_fit_state(path, params, opt, 3, key)
    fresh = {n: torch.zeros_like(p).requires_grad_() for n, p in params.items()}
    opt2 = inverse._adam(fresh, 1e-2)
    assert ckpt.load_fit_state(str(tmp_path / "absent"), fresh, opt2) is None
    step, key2 = ckpt.load_fit_state(path, fresh, opt2)
    assert step == 3 and torch.equal(key2, key)
    for n in params:
        assert torch.equal(fresh[n], params[n])
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(torch.as_tensor(opt2.state[fresh[n]][k]),
                               torch.as_tensor(opt.state[params[n]][k])), (n, k)
    # the next update is the same update
    g = {n: torch.as_tensor(rs.normal(size=p.shape).astype(np.float32))
         for n, p in params.items()}
    for ps, o in ((params, opt), (fresh, opt2)):
        for n, p in ps.items():
            p.grad = g[n].clone()
        o.step()
    for n in params:
        assert torch.equal(fresh[n], params[n])


def test_training_state_defaults_to_the_card(tmp_path):
    """Film, loaders and `state_from_jax` build on the CUDA card unless told
    otherwise, and raise without one; `fit` runs where its scene lives."""
    film = FilmState.create(4, 4, "cpu")
    path = str(tmp_path / "r.npz")
    ckpt.save_render_state(path, film, 0, 1)
    scene = compile_scene(cornell_box(8, 8), device="cpu").scene
    ckpt.save_scene(str(tmp_path / "s"), scene)
    calls = [lambda: FilmState.create(4, 4),
             lambda: ckpt.load_render_state(path),
             lambda: ckpt.load_scene(str(tmp_path / "s")),
             lambda: inverse.state_from_jax({"a": np.zeros(3)}, {}, {}, 0, 0,
                                            np.zeros(2, np.uint32), 1e-2)]
    if torch.cuda.is_available():
        assert all(call() is not None for call in calls)
        assert FilmState.create(4, 4).radiance_sum.is_cuda
    else:
        for call in calls:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
    bad, cam, target = fit_setup()
    fitted, losses = inverse.fit(bad, cam, target, ("mat_albedo",), steps=1,
                                 spp=1, config=CFG)      # key=None
    assert len(losses) == 1 and fitted.mat_albedo.device.type == "cpu"
