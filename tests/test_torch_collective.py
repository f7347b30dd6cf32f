"""The `collective` layer of the port's tracing (`parallel/mesh.py`), on the
CPU, over a gloo group of one process:

- off, the span is the shared no-op and `sum_start`, `finish`, `all_gather`
  and `barrier` leave no `mfx.` event under an active profiler; on, each
  opens one `mfx.collective`;
- `allreduce_bytes` counts the bytes of the tensors `sum_start` all-reduces
  (a train step on the mesh: its loss and every gradient), from their
  shapes; `collective_calls` one a collective; a world of one without a
  group counts nothing;
- on NCCL the barrier names this process's card (the current device).
"""
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

import torch_port_helpers  # noqa: F401  (sizes torch's threads to the run)
from mafrixraytracing_torch.core import rng
from mafrixraytracing_torch.examples.fit_inverse import floor_spec
from mafrixraytracing_torch.integrator import path as P
from mafrixraytracing_torch.opt import inverse
from mafrixraytracing_torch.parallel import mesh as pmesh
from mafrixraytracing_torch.scene.compiler import compile_scene
from mafrixraytracing_torch.utils import trace


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo process group of this process alone, and its mesh."""
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield pmesh.make_mesh()
    finally:
        dist.destroy_process_group()
        trace.disable()


def _collectives(mesh):
    a, b = torch.ones(5), torch.ones(2, 3, dtype=torch.float64)
    mesh.finish(mesh.sum_start([a, b]))
    mesh.all_gather(torch.zeros(4))
    mesh.barrier()
    return a, b


def _mfx(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events() if e.name.startswith(trace.PREFIX)]


def test_collective_span_off_is_the_shared_no_op(world_of_one):
    trace.disable()
    assert trace.span("collective") is trace.span("render")
    assert _mfx(lambda: _collectives(world_of_one)) == []


def test_collective_span_on_wraps_each_collective(world_of_one):
    trace.enable()
    names = _mfx(lambda: _collectives(world_of_one))
    assert names == ["mfx.collective"] * 4     # sum_start, finish, all_gather, barrier
    assert "collective" in trace.LAYERS


def test_counters_count_the_summed_bytes_and_the_calls(world_of_one):
    n0 = dict(trace.COUNTERS)
    a, b = _collectives(world_of_one)
    assert torch.equal(a, torch.ones(5)) and torch.equal(b, torch.ones(2, 3, dtype=torch.float64))
    assert trace.COUNTERS["allreduce_bytes"] - n0["allreduce_bytes"] == 5 * 4 + 6 * 8
    assert trace.COUNTERS["collective_calls"] - n0["collective_calls"] == 2 + 1 + 1


@pytest.mark.parametrize("micro", [1, 2])
def test_a_train_step_all_reduces_its_loss_and_every_gradient(world_of_one, micro):
    """What the benchmark's `allreduce_bytes_per_step` reads: a step's loss
    and gradients, once a microbatch; the world of one gives the bits of no
    mesh."""
    cs = compile_scene(floor_spec(8, 8), device="cpu")
    sc = cs.scene
    cfg = P.PathTracerConfig(max_depth=2)
    with torch.no_grad():
        target = P.render_image(sc, cs.camera, 8, 8, 2, rng.root_key(1, "cpu"), cfg)
    params = {n: getattr(sc, n).detach().clone().requires_grad_()
              for n in ("mat_albedo", "light_radiance", "mesh_vertices")}
    n0 = dict(trace.COUNTERS)
    key = rng.root_key(2, "cpu")
    loss, grads = inverse.loss_and_grads(params, sc, cs.camera, target, key, 2, cfg,
                                         micro, world_of_one)
    want = micro * (4 + sum(p.numel() * p.element_size() for p in params.values()))
    assert trace.COUNTERS["allreduce_bytes"] - n0["allreduce_bytes"] == want
    assert trace.COUNTERS["collective_calls"] - n0["collective_calls"] == micro * 4
    alone, g_alone = inverse.loss_and_grads(params, sc, cs.camera, target, key, 2, cfg, micro)
    assert torch.equal(loss, alone)
    assert all(torch.equal(grads[n], g_alone[n]) for n in params)


def test_a_world_of_one_without_a_group_counts_nothing():
    n0 = dict(trace.COUNTERS)
    _collectives(pmesh.make_mesh(1))
    assert trace.COUNTERS == n0


def test_barrier_on_nccl_names_the_current_card(monkeypatch):
    calls = []
    monkeypatch.setattr(pmesh.dist, "get_backend", lambda group=None: "nccl")
    monkeypatch.setattr(pmesh.dist, "barrier", lambda **kw: calls.append(kw))
    monkeypatch.setattr(pmesh.torch.cuda, "current_device", lambda: 2)
    group = object()
    pmesh.RayMesh(2, 4, group).barrier()
    assert calls == [{"group": group, "device_ids": [2]}]
    monkeypatch.setattr(pmesh.dist, "get_backend", lambda group=None: "gloo")
    pmesh.RayMesh(2, 4, group).barrier()
    assert calls[1] == {"group": group}
