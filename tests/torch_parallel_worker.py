"""Worker processes of the port's multi-process tests. Not a test module.

`torch.multiprocessing.spawn` imports the module that defines the worker in
every child, so this one imports no JAX: the tests hand scenes over as files
of numpy arrays (`save_job`) and read results back as files (`load_result`).
Every worker takes the test run's count of torch threads (`torch_port_helpers`,
which it imports without JAX), joins a gloo group through a file store
under the test's temp directory, and leaves the group when done; the parent
joins with a time limit (`parallel.launch.spawn_local`).
"""
import os

import numpy as np
import torch

from mafrixraytracing_torch.camera.camera import Camera
from mafrixraytracing_torch.core import rng
from mafrixraytracing_torch.integrator import path as P
from mafrixraytracing_torch.opt import inverse
from mafrixraytracing_torch.parallel import launch, render
from mafrixraytracing_torch.scene.compiler import from_jax_arrays
import torch_port_helpers  # noqa: F401  (sizes torch's threads to the run)


def save_job(path, **job):
    torch.save(job, path)


def load_result(out_dir, rank):
    return torch.load(os.path.join(out_dir, f"result{rank}.pt"), weights_only=False)


def hang(rank):
    """A rank that never finishes, for the time limit's test."""
    import time

    time.sleep(600)


def _join(rank, n, out_dir):
    assert launch.init(f"file://{os.path.join(out_dir, 'store')}", n, rank,
                       device="cpu")
    assert launch.init() is True        # idempotent
    mesh = launch.global_mesh()
    assert (mesh.rank, mesh.world) == (rank, n)
    info = launch.process_info()
    assert info["process_count"] == n and info["backend"] == "gloo"
    return mesh


def _scene(job):
    scene = from_jax_arrays(job["scene"], job["flags"], device="cpu")
    camera = Camera(**{k: torch.as_tensor(v) for k, v in job["camera"].items()})
    return scene, camera


def render_worker(rank, n, out_dir):
    """Sharded renders of the job's scene at each of its sizes."""
    mesh = _join(rank, n, out_dir)
    job = torch.load(os.path.join(out_dir, "job.pt"), weights_only=False)
    scene, _ = _scene(job)
    cfg = P.PathTracerConfig(**job["config"])
    key = rng.root_key(job["seed"], "cpu")
    out = {}
    for size in job["sizes"]:
        camera = Camera(**{k: torch.as_tensor(v)
                           for k, v in job["cameras"][size].items()})
        out[f"image{size}"] = render.render_image_sharded(
            scene, camera, mesh, size, size, job["spp"], key, cfg).numpy()
    size = job["sizes"][0]
    out["spp_sharded"] = render.render_spp_sharded(
        scene, camera, mesh, size, size, 1, key, cfg).numpy()
    out["own_half"] = render.render_flat_pixels(
        scene, camera, torch.arange(size * size), size, size, 1,
        rng.fold_in(key, rank), cfg).numpy()
    torch.save(out, os.path.join(out_dir, f"result{rank}.pt"))
    launch.shutdown()


def _steps(job, state, mesh, n_steps):
    """Train steps from `state` = (params, optimizer, key) -> [(loss, gnorm)]."""
    scene, camera = _scene(job)
    params, optimizer, key = state
    step = inverse.make_train_step(
        optimizer, job["spp"], P.PathTracerConfig(**job["config"]),
        smooth_geometry=job["smooth"], overlap_microbatches=job["M"], mesh=mesh)
    out = []
    target = torch.as_tensor(job["target"])
    for _ in range(n_steps):
        key, sub = rng.split(key)
        loss, gnorm = step(params, scene, camera, target, sub)
        out.append((float(loss), float(gnorm)))
    return out


def train_worker(rank, n, out_dir):
    """The job's train steps on this rank of n: one step from the start, one
    step from a carried-over JAX state, and a short sharded `fit` with a
    checkpoint that is then resumed."""
    mesh = _join(rank, n, out_dir)
    job = torch.load(os.path.join(out_dir, "job.pt"), weights_only=False)
    out = {}
    params = {k: torch.as_tensor(v.copy()).requires_grad_()
              for k, v in job["start"].items()}
    out["first"] = _steps(job, (params, inverse._adam(params, job["lr"]),
                                rng.root_key(job["seed"], "cpu")), mesh, 1)
    out["first_params"] = {k: p.detach().numpy().copy() for k, p in params.items()}
    if job.get("carried") is not None:
        c = job["carried"]
        params, optimizer, step, key = inverse.state_from_jax(
            c["params"], c["mu"], c["nu"], c["count"], c["step"], c["key_data"],
            job["lr"], device="cpu")
        out["second"] = _steps(job, (params, optimizer, key), mesh, 1)
        out["second_params"] = {k: p.detach().numpy().copy()
                                for k, p in params.items()}
    if job.get("fit_steps"):
        scene, camera = _scene(job)
        ck = os.path.join(out_dir, "fit_ck")
        common = dict(param_names=tuple(job["start"]), lr=job["lr"], spp=job["spp"],
                      key=rng.root_key(job["seed"], "cpu"),
                      config=P.PathTracerConfig(**job["config"]),
                      overlap_microbatches=job["M"], mesh=mesh)
        target = torch.as_tensor(job["target"])
        start = inverse.apply_params(scene, {k: torch.as_tensor(v)
                                             for k, v in job["start"].items()})
        whole, losses = inverse.fit(start, camera, target, steps=job["fit_steps"],
                                    **common)
        inverse.fit(start, camera, target, steps=1, checkpoint_path=ck, **common)
        # the barrier after rank 0's save: every rank finds the file whole
        out["checkpoint_exists"] = os.path.exists(ck + ".npz")
        resumed, tail = inverse.fit(start, camera, target, steps=job["fit_steps"],
                                    checkpoint_path=ck, **common)
        out["fit_losses"], out["fit_tail"] = losses, tail
        out["fit_equal"] = all(
            torch.equal(getattr(whole, k), getattr(resumed, k)) for k in job["start"])
        out["fit_params"] = {k: getattr(whole, k).detach().numpy().copy()
                             for k in job["start"]}
    torch.save(out, os.path.join(out_dir, f"result{rank}.pt"))
    launch.shutdown()
