"""The plain reference against the measured program at tiny sizes on the
CPU, the result line's keys, and the control (the reference in bfloat16 in
the program's place) failing the comparison."""
import json
import time

import pytest
import torch

from benchmark import faults, loops, manifest, run
from benchmark.kinds import fit as fit_kind
from benchmark.reference import compare

from benchmark.tests.small import small_cell

CELLS = ["mesh36996.fit8", "cornell.preview1", "cornell.grad16", "mesh36996.grad16"]
SEED = 2**33 + 12345


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port(cell, trace):
    c = small_cell(cell)
    out = run.execute(c, SEED, 0.5, trace, "cpu", time.perf_counter())
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["checks"]) == set(c["cell"]["limits"])
    names = {m["name"] for m in (c["per_layer"] if trace else c["end_to_end"])}
    assert set(out["metrics"]) <= names
    if not trace:
        assert set(out["metrics"]) == names
    for chk in out["checks"].values():
        assert chk["value"] <= 1e-5
    json.dumps(out)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_comparison(cell):
    """The reference computed in bfloat16, put in the program's place."""
    c = small_cell(cell)
    r = manifest.kind(c["traffic"]["kind"])(c, SEED + 1, 0.3, _off(c), "cpu",
                                            time.perf_counter())
    r.setup()
    r.window()
    r.program_outputs()
    ref = r.reference_outputs(torch.float32)
    ctrl = r.reference_outputs(torch.bfloat16)
    ok, checks = compare.judge(r.numbers(ctrl, ref), c["cell"]["limits"])
    assert not ok, checks


def _off(c):
    from benchmark import tracing

    return tracing.Tracer(False, c["traffic"]["kind"], False)


FAULTY = [(cell, f) for cell in CELLS for f in faults.FAULTS[small_cell(cell)["traffic"]["kind"]]]


@pytest.mark.parametrize("cell,fault", FAULTY)
def test_a_planted_fault_is_not_correct(cell, fault):
    """A whole run with the timed path broken underneath: correct is false."""
    c = small_cell(cell, width=40, height=40)
    with faults.planted(c["traffic"]["kind"], fault):
        out = run.execute(c, SEED + 2, 0.3, False, "cpu", time.perf_counter())
    assert not out["correct"], out["checks"]


def test_large_seeds_give_the_same_inputs():
    key = loops.seed_key
    a, b = key(2**40 + 3, 7, "cpu"), key(2**40 + 3, 7, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, key(2**40 + 4, 7, "cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card_is_correct_and_its_control_is_not(cell, card):
    c = manifest.cell(cell)
    r = manifest.kind(c["traffic"]["kind"])(c, SEED, 3.0, _off(c), card, time.perf_counter())
    r.setup()
    r.window()
    p = r.program_outputs()
    ref = r.reference_outputs(torch.float32)
    assert compare.judge(r.numbers(p, ref), c["cell"]["limits"])[0]
    ctrl = r.reference_outputs(torch.bfloat16)
    assert not compare.judge(r.numbers(ctrl, ref), c["cell"]["limits"])[0]


def test_reference_cull_keeps_every_hit_of_a_moved_mesh():
    """The search's boxes follow the triangles: after the fit's perturbation
    of a mesh of several runs of 128, and a lift of the whole buffer, the
    culled search equals a dense test of every ray against every
    triangle."""
    import math

    from benchmark import scenes
    from benchmark.reference import fit as ref_fit, tracer

    c = small_cell("mesh36996.fit8", rows=12)
    sc, cam = scenes.reference_scene(c["config"], "cpu", torch.float32, 8.0)
    assert sc.tri_mask.sum() > 2 * 128
    phases = torch.tensor([1.0, 2.0])
    start = fit_kind.perturbed_start(sc.verts, sc.mat_albedo, sc.light_radiance, phases, 8.0)
    start["mesh_vertices"] = start["mesh_vertices"] + torch.tensor([0.0, 3.0, 0.0])
    moved = ref_fit.overlay(sc, start)
    g = torch.Generator().manual_seed(3)
    n = 4096
    u, v = torch.rand(n, generator=g), torch.rand(n, generator=g)
    o, d = tracer.camera_rays(cam, u, v, torch.rand(n, 2, generator=g))
    t_max = torch.full((n,), 1e8)
    got = tracer.closest(moved, o, d, 1e-3, t_max)
    rec = tracer.plane_records(moved)
    t, inside = tracer.plane_hit(o.map(lambda x: x[:, None]), d.map(lambda x: x[:, None]),
                                 rec[None])
    t = torch.where(inside & (t > 1e-3) & (t < 1e8), t, math.inf)
    m_t, m_i = tracer.mega_hits(moved, o, d, 1e-3, t_max)
    best = t.amin(1)
    idx = torch.where(t <= best[:, None], torch.arange(rec.shape[0])[None], 2**62).amin(1)
    want = torch.where(best < m_t, idx, m_i)
    assert torch.equal(got, torch.where(torch.isfinite(torch.minimum(best, m_t)), want, -1))
    assert (got >= 0).sum() > n // 4
