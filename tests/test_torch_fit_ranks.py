"""The data-parallel fit's benchmark cell (`mesh36996.fit8x4`: `opt.inverse.fit`
with `mesh=` on four ranks) on the CPU, cut to 16x16 pixels and a sphere of
12 rows:

- (a) the reference that follows the shards (`benchmark/reference/fit_ranks.py`)
  with four shards and no compaction gives the whole frame's reference steps
  (`benchmark/reference/fit.py`) within rounding;
- (b) the program on four gloo processes (`launch.spawn_local`), 2 steps, one
  window step and the late step, against the sharded reference: inside the
  cell's limits, the four ranks' parameters equal bit for bit;
- (c) the bfloat16 control and the two rank faults of
  `benchmark/rank_faults.py` (a rank's gradient left out of the sum, two ranks
  on one shard) each fail the comparison;
- each rank's CPUs on the card (`fit_ranks.cpu_plan`): whole cores, none
  shared between ranks, local to the rank's card where the machine says so;
- a rank that dies or hangs ends the run's process with exit code 1, soon;
  rank 0 leaves the process group before it waits for the other ranks (on
  NCCL the teardown waits for every rank).

One spawn of four processes runs the three cases (`torch_fit_ranks_worker`).
"""
import math
import os
import subprocess
import sys
import time

import pytest
import torch

import torch_fit_ranks_worker as worker
import torch_port_helpers  # noqa: F401  (sizes torch's threads to the run)
from benchmark import rank_faults, scenes
from benchmark.kinds import fit_ranks
from benchmark.kinds.fit import perturbed_start
from benchmark.reference import compare, fit as ref_fit, fit_ranks as ref_ranks
from benchmark.reference import rng as ref_rng, tracer as ref_tracer
from benchmark.tests.small import small_cell
from mafrixraytracing_torch.parallel import launch

CELL = "mesh36996.fit8x4"
SEED = 2**33 + 4321


def cell():
    c = small_cell(CELL)
    c["traffic"]["reference_steps"] = 2
    return c


def test_shard_ids_are_the_programs_shards():
    n, world = 10, 4
    ids = torch.cat([ref_ranks.shard_ids(n, world, r) for r in range(world)])
    assert ids.tolist() == [i % n for i in range(12)]


def test_four_shards_without_compaction_give_the_whole_frame():
    """(a) The shards' mean loss and gradient are the whole frame's (equal
    shards), so the steps agree within float32 rounding."""
    c = cell()
    W, H = scenes.film(c["config"])
    tf = c["traffic"]
    sc, cam = scenes.reference_scene(c["config"], "cpu", torch.float32, tf["scene_scale"])
    start = perturbed_start(sc.verts, sc.mat_albedo, sc.light_radiance,
                            torch.tensor([0.5, 2.0]), tf["scene_scale"])
    target = ref_tracer.render_pixels(sc, cam, torch.arange(W * H), W, H, 4,
                                   ref_rng.root_key(3, "cpu")).reshape(H, W, 3)
    common = dict(cam=cam, target=target, start=start, steps=2,
                  key=ref_rng.root_key(9, "cpu"), spp=2, lr=tf["lr"],
                  smooth_iters=tf["smooth_geometry"], width=W, height=H, depth=5)
    whole = ref_fit.fit_steps(sc, **common)
    shards = ref_ranks.fit_steps(sc, world=4, **common)
    for a, b in zip(whole[0], shards[0]):
        assert math.isclose(a, b, rel_tol=1e-5)
    for part in (1, 2):
        for n in whole[part]:
            torch.testing.assert_close(shards[part][n], whole[part][n], rtol=1e-4, atol=1e-6)
    assert compare.norm_gap(shards[1], whole[1]) < 1e-5


def test_gather_must_bring_every_shard():
    c = cell()
    W, H = scenes.film(c["config"])
    sc, cam = scenes.reference_scene(c["config"], "cpu", torch.float32, 8.0)
    params = {"mat_albedo": sc.mat_albedo}
    with pytest.raises(ValueError):
        ref_ranks.fit_steps(sc, cam, torch.ones(H, W, 3), params, 1, ref_rng.root_key(1, "cpu"),
                            1, 0.01, 0, W, H, world=4, depth=1, ranks=[0],
                            gather=lambda flats: flats)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three cases on four gloo ranks, in one spawn."""
    out = tmp_path_factory.mktemp("fit_ranks")
    cases = [("sound", cell(), None)] + [(f, cell(), f) for f in rank_faults.FAULTS]
    for name, _, _ in cases:
        (out / name).mkdir()
    launch.spawn_local(worker.fit_ranks_worker, 4, args=(cases, SEED, str(out)),
                       timeout_s=400)
    return {name: torch.load(out / f"{name}.pt", weights_only=False) for name, _, _ in cases}


def test_four_gloo_ranks_follow_the_sharded_reference(runs):
    """(b) Inside every limit of the cell, the ranks equal; 2 steps, one
    window step and the late step."""
    r = runs["sound"]
    limits = cell()["cell"]["limits"]
    ok, checks = compare.judge(r["numbers"], limits)
    assert ok, checks
    assert r["numbers"]["ranks_gap"] == 0.0
    assert r["steps"] == 1 and len(r["losses"]) == 4
    assert set(r["numbers"]) == set(limits)


@pytest.mark.parametrize("case", ["control", *rank_faults.FAULTS])
def test_control_and_rank_faults_fail_the_comparison(runs, case):
    """(c) The reference in bfloat16 in the program's place, a rank's
    gradient left out of the all-reduce, two ranks rendering one shard."""
    nums = runs["sound"]["control"] if case == "control" else runs[case]["numbers"]
    ok, checks = compare.judge(nums, cell()["cell"]["limits"])
    assert not ok, checks


def siblings(half):
    """A machine whose CPU c and c + half are one core's two hyperthreads."""
    return lambda c: [c % half, c % half + half]


@pytest.mark.parametrize("allowed,local,core,plan", [
    # one set for all: four runs of four whole cores, hyperthreads together
    (range(32), lambda r: None, siblings(16),
     [[0, 1, 2, 3, 16, 17, 18, 19], [4, 5, 6, 7, 20, 21, 22, 23],
      [8, 9, 10, 11, 24, 25, 26, 27], [12, 13, 14, 15, 28, 29, 30, 31]]),
    # two cards a node: each pair splits its node's cores
    (range(16), lambda r: [0, 1, 2, 3, 8, 9, 10, 11] if r < 2 else [4, 5, 6, 7, 12, 13, 14, 15],
     siblings(8), [[0, 1, 8, 9], [2, 3, 10, 11], [4, 5, 12, 13], [6, 7, 14, 15]]),
    # the card's CPUs outside what the run may use: the run's CPUs
    (range(8), lambda r: [40, 41], lambda c: [c], [[0, 1], [2, 3], [4, 5], [6, 7]]),
    # fewer cores than ranks: they share them
    ([0, 1], lambda r: None, lambda c: [c], [[0, 1]] * 4),
])
def test_each_rank_takes_whole_cores_of_its_own(allowed, local, core, plan):
    assert fit_ranks.cpu_plan(4, allowed, local, core) == plan


def test_cpu_lists_are_read_as_the_kernel_writes_them():
    assert fit_ranks._cpu_list("0-3,8,10-11\n") == [0, 1, 2, 3, 8, 10, 11]
    assert fit_ranks._cpu_list("5") == [5]


def test_unknown_rank_fault_is_refused():
    with pytest.raises(ValueError):
        with rank_faults.planted("no_such_fault"):
            pass


LEAD = """
import sys, time
sys.path[:0] = [{root!r}, {tests!r}]
from benchmark import run
from benchmark.kinds import fit_ranks
from benchmark.tests.small import small_cell
import torch_fit_ranks_worker as worker

fit_ranks.STALL_S = {stall}
fit_ranks.rank_main = worker.{fault}
if __name__ == "__main__":
    run.execute(small_cell("mesh36996.fit8x4"), 1, 0.1, False, "cpu", time.perf_counter())
    print("the run returned")
"""


@pytest.mark.parametrize("fault,stall,says", [("dies", 60.0, "exited with code 1"),
                                              ("hangs", 3.0, "no progress for 3 s")])
def test_a_rank_that_dies_or_hangs_ends_the_run(tmp_path, fault, stall, says):
    """Rank 0's process (the run's) starts ranks that fail at once or never
    join: it stops them and exits with 1, on the death at once, on the hang
    after its stall limit (here 3 s)."""
    tests = os.path.dirname(os.path.abspath(__file__))
    lead = tmp_path / "lead.py"
    lead.write_text(LEAD.format(root=os.path.dirname(tests), tests=tests, fault=fault,
                                 stall=stall))
    t = time.monotonic()
    out = subprocess.run([sys.executable, str(lead)], capture_output=True, text=True,
                         timeout=120, cwd=tmp_path)
    assert out.returncode == 1, out.stderr[-2000:]
    assert says in out.stderr and "the run returned" not in out.stdout
    assert time.monotonic() - t < 60


def test_rank_0_leaves_the_group_before_it_waits_for_the_ranks(monkeypatch, tmp_path):
    order = []

    class Rank:
        exitcode = 0

        def join(self, timeout):
            order.append("join")

        def is_alive(self):
            return False

    run = object.__new__(fit_ranks.FitRanksRun)
    run.procs, run.lead, run.run_dir = [Rank(), Rank()], True, str(tmp_path)
    run._done = fit_ranks.threading.Event()
    monkeypatch.setattr(launch, "shutdown", lambda: order.append("shutdown"))
    run.close()
    assert order == ["shutdown", "join", "join"] and run._done.is_set()
    assert not tmp_path.exists()
