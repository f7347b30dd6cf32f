"""Device ms a train step of rank 0's NCCL kernels (the all-reduces, the all-gather, the barrier), their wait for the slowest rank included: an NCCL kernel runs from its launch until every rank has joined. The `nccl:<op>` ranges that the profiler also lays on the device's timeline are not kernels and are left out."""
import re

from benchmark.tracing import per_unit

NCCL_KERNEL = re.compile(r"^(void\s+)?nccl\w*Kernel")


def read(trace):
    def ms():
        s = [t for n, t in trace.kernels if NCCL_KERNEL.match(n)]
        return sum(s) * 1e3 if s else None
    return per_unit(trace, "fit_ranks", ms)
