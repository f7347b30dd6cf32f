"""BENCHMARK.json against the format it is written to, and the files it
names found by name."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import guard, manifest

ROOT = Path(manifest.ROOT)
BENCH = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_sizes():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for word in BENCH["command"]:
        assert LINE.match(word) and not word.startswith("/") and ".." not in word


def test_a_full_check_of_24_cells_fits_its_time():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_lines():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert LINE.match(w["why"]) and NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert w["chips"] == 1


def test_metrics_follow_the_format():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(m["layer"])
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", CELLS), (m["name"], w)
        layers.setdefault(m["layer"], []).append(m["name"])
    for cell in CELLS:
        c = manifest.cell(cell)
        assert any(m["name"] == "setup_s" for m in c["end_to_end"])
        assert len(c["end_to_end"]) >= 2 and c["per_layer"], cell


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    from benchmark import loops

    c = manifest.cell(cell)
    assert issubclass(manifest.kind(c["traffic"]["kind"]), loops.Run)
    assert set(c["cell"]) == {"compact", "limits"}
    if c["cell"]["compact"]:
        assert len(c["cell"]["compact"]) == c["config"]["integrator"]["max_depth"]
        assert c["cell"]["compact"][0] == 1.0
    for m in c["per_layer"]:
        assert callable(manifest.reader(m["name"]))
    conf = {x["name"]: x for x in BENCH["configs"]}[c["workload"]["config"]]
    assert conf["file"].startswith("benchmark/")
    assert c["config"]["name"] == conf["name"] and c["config"]["source"] == conf["source"]
    assert c["config"]["reduced"] == conf["reduced"]


def test_every_kind_is_a_module_found_by_name():
    from benchmark import loops

    kinds = sorted(p.stem for p in (ROOT / "benchmark" / "kinds").glob("*.py")
                   if p.stem != "__init__")
    assert kinds == ["fit", "grad", "preview"]
    for k in kinds:
        assert issubclass(manifest.kind(k), loops.Run)
    with pytest.raises(KeyError):
        manifest.kind("no_such_kind")


@pytest.mark.parametrize("setting,value", [("estimator", "mafrix"), ("nee", False),
                                           ("mis", False), ("rr_enable", False),
                                           ("motion_blur", True), ("t_min", 1e-4),
                                           ("no_such_setting", 1)])
def test_reference_refuses_a_setting_it_does_not_follow(setting, value):
    from benchmark.reference import tracer

    integ = dict(manifest.cell(CELLS[0])["config"]["integrator"], **{setting: value})
    with pytest.raises(ValueError):
        tracer.follow(integ)


@pytest.mark.parametrize("cell", CELLS)
def test_the_integrator_settings_reach_both_sides_whole(cell):
    """Every setting of the configuration's integrator is the program's,
    and the reference takes depth, roulette and wavefront from it."""
    from benchmark import loops
    from benchmark.reference import tracer

    c = manifest.cell(cell)
    integ = c["config"]["integrator"]
    cfg = loops.program_config(c)
    for k, v in integ.items():
        assert getattr(cfg, k) == v, k
    assert cfg.compact == tuple(c["cell"]["compact"])
    assert tracer.follow(integ) == {"depth": integ["max_depth"],
                                    "rr_start": integ["rr_start"],
                                    "wavefront": integ["wavefront"]}
    with pytest.raises(TypeError):
        loops.program_config({**c, "config": {**c["config"],
                                              "integrator": {**integ, "no_such": 1}}})


def test_every_file_is_named_from_name_characters():
    for p in (ROOT / "benchmark").rglob("*"):
        if "work" in p.parts or "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel


def test_guard_compares_whole_top_level_names():
    mods = {"jax": 1, "jax.numpy": 1, "jaxlib.xla": 1, "flax": 1, "mafrixraytracing_tpu.ops": 1,
            "mafrixraytracing_torch": 1, "mafrixraytracing_torch.ops": 1, "jaxtyping": 1,
            "flaxen": 1}
    assert guard.forbidden_loaded(mods) == ["flax", "jax", "jax.numpy", "jaxlib.xla",
                                            "mafrixraytracing_tpu.ops"]


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in guard.FORBIDDEN | {"mafrixraytracing_torch",
                                                                  "benchmark"}, (path, n)
    code = ("import sys; import benchmark.reference.tracer, benchmark.reference.fit, "
            "benchmark.reference.compare, benchmark.reference.film; "
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('mafrix')"
            " or m.split('.')[0] in ('jax', 'jaxlib', 'flax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card_and_prints_nothing():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_run_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and benchmark/."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("work", "__pycache__"))
    env = {**os.environ, "PYTHONPATH": ""}
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0 and out.stdout == ""


def test_a_run_loads_no_jax():
    """A whole run of a tiny cell on the CPU, in a process of its own: no
    module of JAX or of the JAX package is loaded at its end."""
    code = ("import sys, time, torch; torch.set_num_threads(2); "
            "from benchmark import guard, run; from benchmark.tests.small import small_cell; "
            "out = run.execute(small_cell('cornell.grad16'), 7, 0.2, True, 'cpu', "
            "time.perf_counter()); print(out['correct'], guard.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"
