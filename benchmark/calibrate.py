"""Readings for the benchmark's data files, made once on the card when a
cell is defined; the benchmark's own runs do not run this.

    python3 benchmark/calibrate.py schedule <workload>...
        The survival profile of each cell's wavefront at 1 spp (the program's
        `trace_stats`, seed 123) and the compaction schedule frozen from it:
        1, then each bounce's live share x 1.12 + 0.01 (the arithmetic of
        mafrixraytracing_torch/bench.py::calibrated_config).

    python3 benchmark/calibrate.py readings <workload> <seed,seed,...> <seconds> [fault...]
        For each seed, a run of the cell with a window of <seconds>; then the
        numbers of the comparison for the program against the float32
        reference (the lower readings), for the control, the reference in
        bfloat16 in the program's place (the upper readings), and for the
        program with each named fault planted (faults.py). One JSON line
        per seed and side.
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def schedule(names):
    import torch

    from benchmark import loops, manifest, scenes
    from benchmark.reference import rng as ref_rng
    from mafrixraytracing_torch.integrator import path as P

    for name in names:
        c = manifest.cell(name)
        W, H = scenes.film(c["config"])
        cs = scenes.program_scene(c["config"], "cuda",
                                  c["traffic"].get("scene_scale", 1.0))
        cfg = loops.program_config(c, compact=())
        px, py = P.make_pixel_uv(W, H, "cuda")
        keys = ref_rng.fold_in(ref_rng.root_key(123, "cuda"),
                               torch.arange(px.shape[0], device="cuda"))
        o, d = cs.camera.get_rays((px + 0.5) / W, (py + 0.5) / H)
        _, prof = P.trace_stats(cs.scene, o, d, keys, cfg, return_profile=True)
        prof = [float(p) for p in prof]
        sched = [1.0] + [round(min(1.0, p * 1.12 + 0.01), 4) for p in prof[1:]]
        print(json.dumps({"workload": name, "survival": [round(p, 4) for p in prof],
                          "compact": sched}), flush=True)


def readings(name, seeds, seconds, faults, dev="cuda", c=None):
    import torch

    from benchmark import faults as F
    from benchmark import manifest, tracing

    c = c or manifest.cell(name)
    kind = c["traffic"]["kind"]

    def program_run(seed):
        tr = tracing.Tracer(False, kind, dev != "cpu")
        run = manifest.kind(kind)(c, seed, seconds, tr, dev, time.perf_counter())
        run.setup()
        run.window()
        return run, run.program_outputs()

    for seed in seeds:
        t = time.perf_counter()
        run, p = program_run(seed)
        ref = run.reference_outputs(torch.float32)
        t_ref = time.perf_counter()
        ctrl = run.reference_outputs(torch.bfloat16)
        rows = [("program", run.numbers(p, ref)), ("control", run.numbers(ctrl, ref))]
        for fault in faults:
            with F.planted(kind, fault):
                frun, fp = program_run(seed)
            rows.append((fault, run.numbers(fp, frun.reference_outputs(torch.float32))))
            del frun
        for side, nums in rows:
            print(json.dumps({"workload": name, "seed": seed, "side": side,
                              "numbers": nums}), flush=True)
        if kind == "fit":   # each leaf's gradient and change norms
            print(json.dumps({"workload": name, "seed": seed, "steps": run.steps,
                              "late_step": run.late_from["index"], "leaf_norms": {
                side: {k: {n: float(v.double().norm()) for n, v in o[k].items()}
                       for k in ("first", "change", "late_grad", "late_change")}
                for side, o in (("program", p), ("reference", ref), ("control", ctrl))}}),
                flush=True)
        print(json.dumps({"workload": name, "seed": seed,
                          "reference_s": time.perf_counter() - t_ref,
                          "seed_s": time.perf_counter() - t}), flush=True)
        del run


def main(argv) -> int:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if argv[0] == "schedule":
        schedule(argv[1:])
    else:
        readings(argv[1], [int(s) for s in argv[2].split(",")], float(argv[3]), argv[4:])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
