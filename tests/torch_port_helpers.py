"""Helpers of the port's tests. Not a test module.

Every `tests/test_torch_*.py` imports this module, so that torch's intra-op
threads are sized to the test run at its import: `pytest -n N` starts N
worker processes on the machine's CPUs, and each worker's torch would
otherwise start a pool of one thread a CPU, N times as many threads as CPUs
in all, which spin against each other. Each worker takes its share
(`worker_threads`), and the processes a test starts (the gloo worlds of
`tests/torch_parallel_worker.py`, the port's CPU entry points) get the same
count through `OMP_NUM_THREADS`. A lone `pytest` keeps every CPU.

The rest carries a JAX scene and camera over to the port as numpy arrays,
and builds the floor + area light scene of `tests/test_checkpoint.py`. The
JAX package is imported only inside those functions: the card's machine,
which has no JAX, runs `tests/test_torch_kernels.py` and
`tests/test_torch_device.py` with this module too.
"""
import os

import numpy as np
import torch

from mafrixraytracing_torch.camera.camera import Camera as TCamera
from mafrixraytracing_torch.scene.compiler import (
    STATIC_FLAGS,
    TENSOR_FIELDS,
    from_jax_arrays,
)


def worker_threads(cpus: int, workers: int) -> int:
    """Torch threads for one of `workers` processes that share `cpus`."""
    return max(1, cpus // workers)


def run_threads() -> int:
    """This test process's share: the CPUs over pytest-xdist's workers."""
    return worker_threads(os.cpu_count() or 1,
                          int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))


torch.set_num_threads(run_threads())
os.environ["OMP_NUM_THREADS"] = str(run_threads())

CAMERA_FIELDS = ("position", "topleft", "right_vec", "down_vec", "lens_right",
                 "lens_up", "lens_radius", "focus_scale")


def carry_scene(js):
    """A JAX scene as a `TorchScene` on the CPU."""
    d = {k: np.asarray(getattr(js, k)) for k in TENSOR_FIELDS}
    return from_jax_arrays(d, {k: getattr(js, k) for k in STATIC_FLAGS},
                           device="cpu")


def carry_camera(jcam):
    """A JAX camera's vectors as the port's camera (no 2-ulp `tan` gap)."""
    return TCamera(**{k: torch.as_tensor(np.array(getattr(jcam, k)))
                      for k in CAMERA_FIELDS})


def floor_spec(albedo=(0.4, 0.6, 0.5), radiance=10.0, camera=None, light=True):
    from mafrixraytracing_tpu.scene import spec as S

    floor = S.make_rect_mesh((-2, 0, 2), (2, 0, 2), (2, 0, -2), (-2, 0, -2))
    lamp = S.make_rect_mesh((-0.6, 2.0, -0.6), (0.6, 2.0, -0.6),
                            (0.6, 2.0, 0.6), (-0.6, 2.0, 0.6))
    kw = dict(camera=camera) if camera is not None else {}
    return S.SceneSpec(
        materials=[S.MaterialSpec(albedo=albedo)],
        shapes=[S.ShapeSpec(floor, 0)],
        area_lights=[S.AreaLightSpec(lamp, radiance=(radiance,) * 3,
                                     visible=False)] if light else [], **kw)


def floor_scene(**kw):
    """(JAX scene, JAX camera, port scene, port camera) of `floor_spec`."""
    from mafrixraytracing_tpu.scene.compiler import compile_scene as jcompile

    jcs = jcompile(floor_spec(**kw))
    return jcs.scene, jcs.camera, carry_scene(jcs.scene), carry_camera(jcs.camera)


def bad_start(js, seed=0):
    """A start for a fit: one albedo off, and the live vertices moved by a
    seeded field in x, y and z (a tilted floor: every component of the vertex
    gradient is then well above rounding noise, so Adam's normalised step is
    well-conditioned and two packages can be compared step by step)."""
    alb = np.array(js.mat_albedo)
    alb[0] = (0.8, 0.2, 0.2)
    mv = np.array(js.mesh_vertices)
    live = np.unique(np.asarray(js.tri_face_vi)[np.asarray(js.tri_mask)])
    mv[live] += np.random.default_rng(seed).normal(
        0.0, 0.15, (live.size, 3)).astype(np.float32)
    return {"mat_albedo": alb, "mesh_vertices": mv}
