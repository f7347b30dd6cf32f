"""Worker processes of the data-parallel fit cell's tests. Not a test module.

Every rank runs `benchmark/kinds/fit_ranks.py`'s run of a cell cut to a size
the CPU runs in seconds, on four gloo processes joined through a file store
(`parallel.launch.spawn_local` starts them), once a case: the sound program,
then each fault of `benchmark/rank_faults.py` planted. Rank 0 writes, a case,
the numbers of the comparison against the float32 reference, and in the
sound case also the numbers of the control (the reference in bfloat16 in the
program's place). Imports no JAX: `spawn` imports this module in every rank.
"""
import contextlib
import os
import time

import torch

import torch_port_helpers
from benchmark import rank_faults, tracing
from benchmark.kinds.fit_ranks import FitRanksRun


def fit_ranks_worker(rank, cases, seed, out_dir):
    """`cases`: (name, cell, fault or None); each run's directory is
    `out_dir/name`, its rank 0's numbers `out_dir/name.pt`. The four ranks
    share the test process's share of the CPUs."""
    torch.set_num_threads(torch_port_helpers.worker_threads(torch_port_helpers.run_threads(), 4))
    for name, c, fault in cases:
        planted = rank_faults.planted(fault) if fault else contextlib.nullcontext()
        with planted:
            run = FitRanksRun(c, seed, 0.0, tracing.Tracer(False, "fit_ranks", False), "cpu",
                              time.perf_counter(), rank=rank,
                              run_dir=os.path.join(out_dir, name))
            run.setup()
            run.window()
            p = run.program_outputs()
            ref = run.reference_outputs(torch.float32)
            ctrl = None if fault else run.reference_outputs(torch.bfloat16)
            run.close()
        if rank == 0:
            torch.save({"numbers": run.numbers(p, ref), "steps": run.steps,
                        "losses": run.losses,
                        "control": None if ctrl is None else run.numbers(ctrl, ref)},
                       os.path.join(out_dir, f"{name}.pt"))


def dies(rank, *args):
    """A rank that fails at its start, in place of `fit_ranks.rank_main`."""
    raise RuntimeError(f"rank {rank} fails at its start")


def hangs(rank, *args):
    """A rank that never joins, in place of `fit_ranks.rank_main`."""
    time.sleep(600)
