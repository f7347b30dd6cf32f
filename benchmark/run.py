"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is looked up in BENCHMARK.json at the repository's root. The run
builds its inputs from the seed, warms up the cell's shapes (set-up), runs
the cell's closed loop for `--seconds` (with `--trace 1`: a fixed slice of
units under torch.profiler), checks what the window produced against the
plain reference (benchmark/reference/), and prints, as the last line of its
standard output, one JSON object: correct, attempted, failed, metrics,
device, with `--trace 1` breakdown, and last the numbers compared beside
their limits (also the last lines of standard error). It exits with 2 and
prints no result without a CUDA card, and with 3 if a module of JAX or of
the JAX package is loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import guard  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(c: dict, seed: int, seconds: float, trace: bool, dev, t0: float) -> dict:
    """Set-up, window, comparison and metrics of one run on `dev`; returns
    the result line as a dict (without the device's own fields)."""
    import torch

    from benchmark import manifest, tracing
    from benchmark.reference import compare

    tr = tracing.Tracer(trace, c["traffic"]["kind"], torch.device(dev).type == "cuda")
    run = manifest.kind(c["traffic"]["kind"])(c, seed, seconds, tr, dev, t0)
    run.setup()
    units = run.window(c["traffic"]["trace_units"] if trace else None)
    tr.stop(units)
    attempted, failed, e2e = run.outcome()
    cuda = torch.device(dev).type == "cuda"
    peak = max(torch.cuda.max_memory_allocated() if cuda else 0, tr.peak_bytes)
    metrics = {}
    if trace:
        for m in c["per_layer"]:
            value = manifest.reader(m["name"])(tr.trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e["setup_s"] = run.setup_s
        for m in c["end_to_end"]:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    t_check = time.perf_counter()
    numbers = run.check()
    print(f"run: set-up {run.setup_s:.3f} s, window {run.window_s:.3f} s, "
          f"comparison {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    correct, checks = compare.judge(numbers, c["cell"]["limits"])
    out = {"correct": bool(correct and failed == 0), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": {"memory_peak_bytes": peak}}
    if trace:
        out["device"].update(busy_s=tr.trace.busy_s, window_s=tr.trace.window_s)
        out["breakdown"] = {"device_ops": tr.trace.device_ops,
                            "idle_gaps": tr.trace.idle_gaps}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from benchmark import manifest

    c = manifest.cell(args.workload)
    chips = c["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    guard.check("start")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = execute(c, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T0)
    guard.check("end")
    if args.trace:
        from mafrixraytracing_torch.ops import cuda as kernels

        print("kernel launches: " + json.dumps(kernels.LAUNCHES), file=sys.stderr)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    out["device"] = {**device, **out["device"]}
    for name, chk in out["checks"].items():
        print(f"check {name}: {chk['value']!r} (limit {chk['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
