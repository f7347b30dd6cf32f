"""Cells cut to a size the CPU runs in seconds: a small film, few samples,
a sphere of few rows for the mesh. Only for the tests: the cells in
BENCHMARK.json run at their own sizes."""
import copy

from benchmark import manifest


def small_cell(name: str, width: int = 16, height: int = 16, rows: int = 12, spp: int = 2):
    c = copy.deepcopy(manifest.cell(name))
    c["config"]["film"] = {"x_pixels": width, "y_pixels": height}
    if "rows" in c["config"]["scene"]:
        c["config"]["scene"]["rows"] = rows
    t = c["traffic"]
    if "spp" in t:
        t["spp"] = spp
    if "target_spp" in t:
        t["target_spp"] = 4
    t["warmup_units"] = 1
    t["trace_units"] = 2
    if "check_pixels" in t:
        t["check_pixels"] = width * height
    return c
