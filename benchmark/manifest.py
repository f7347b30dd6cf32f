"""`BENCHMARK.json` and the files it names, found by name: a cell's
configuration (`configs[].file`), its traffic mix (`traffic/<traffic>.json`),
the loop of the mix's kind (`kinds/<kind>.py`), its cell file
(`cells/<workload>.json`: the frozen compaction schedule and the limits of
the comparison) and the reader of each per-layer metric
(`metrics/<metric>.py`, a function `read(trace)`)."""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, bench: dict | None = None, root: Path = ROOT) -> dict:
    """Everything a run of workload `name` needs: the workload entry, its
    configuration, traffic and cell file, and its end-to-end and per-layer
    metric entries."""
    bench = bench or load(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def reports(m):
        return name in m.get("workloads", [name])

    return {
        "workload": w,
        "config": _json(root / conf["file"]),
        "traffic": _json(HERE / "traffic" / f"{w['traffic']}.json"),
        "cell": _json(HERE / "cells" / f"{name}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
        "per_layer": [m for m in bench["per_layer"] if reports(m)],
    }


def reader(metric: str):
    """The `read(trace)` function of `metrics/<metric>.py`."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kind(name: str):
    """The run class (`RUN`) of `kinds/<name>.py`."""
    if not (HERE / "kinds" / f"{name}.py").is_file():
        raise KeyError(f"no kind {name!r} in benchmark/kinds/")
    return importlib.import_module(f"benchmark.kinds.{name}").RUN
