"""The port's spans and counters (`utils/trace.py`), on the CPU.

- Tracing off, under an active `torch.profiler`: no `mfx.` event, and the
  same aten ops in the same order as a run with every spanned function
  replaced by its undecorated original.
- Tracing on, on a Cornell `render_image` with a compaction schedule and
  `.backward()`: the spans nest (`search` and `rng` inside `bounce` inside
  `render`); image and gradients bit-equal to tracing off; `search_lanes`
  equal to the padded lanes worked out from the schedule and the NEE
  queries; `scatter_rows` equal to the rows gathered with a gradient.
- Two `fit` steps on a floor mesh open `optimizer` and `refresh` once a
  step, and `fit`'s log line gives the lanes a second that `search_lanes`
  counted.
"""
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_port_helpers  # noqa: F401  (sizes torch's threads to the run)
from mafrixraytracing_torch.accel import clusters
from mafrixraytracing_torch.core import rng
from mafrixraytracing_torch.examples.fit_inverse import floor_spec
from mafrixraytracing_torch.film.film import FilmState
from mafrixraytracing_torch.integrator import path as P
from mafrixraytracing_torch.ops import intersect as oi
from mafrixraytracing_torch.ops import unpack as ou
from mafrixraytracing_torch.opt import inverse
from mafrixraytracing_torch.scene.builtin import cornell_box
from mafrixraytracing_torch.scene.compiler import compile_scene
from mafrixraytracing_torch.utils import trace

W = H = 10          # 100 pixels: one 128-lane chunk, 2 spp -> 256 lanes
SPP = 2
LEAVES = ("mat_albedo", "light_radiance", "tri_v0")
CFG = P.PathTracerConfig(max_depth=3, compact=(1.0, 0.6, 0.3))

# every function that opens a span, by module
SPANNED = [(rng, n) for n in ("fold_in", "split", "pixel_keys", "sample_key",
                              "bounce_key", "uniforms", "split_dim")] + [
    (P, "_bounce"), (P, "_bounce_mafrix"), (P, "render_image"),
    (P, "render_flat_pixels"), (oi, "find_closest_soa"), (oi, "occluded_soa"),
    (clusters, "refresh_clusters"), (FilmState, "add_frame"), (FilmState, "to_bytes")]


@pytest.fixture(scope="module")
def cornell():
    return compile_scene(cornell_box(W, H), device="cpu")


@pytest.fixture(autouse=True)
def _off():
    trace.disable()
    yield
    trace.disable()


def _frame(cs, config=CFG):
    """Image and gradients of a Cornell fwd+bwd."""
    sc = cs.scene
    leaves = {n: getattr(sc, n).detach().clone().requires_grad_() for n in LEAVES}
    img = P.render_image(sc.replace(**leaves), cs.camera, W, H, SPP,
                         rng.root_key(5, "cpu"), config)
    img.mean().backward()
    return img.detach(), {n: v.grad for n, v in leaves.items()}


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = sorted(prof.events(), key=lambda e: (e.time_range.start, -e.time_range.end))
    return out, events


def _aten(events):
    return [e.name for e in events if e.name.startswith("aten::")]


def test_spans_off_record_nothing_and_add_no_op(cornell, monkeypatch):
    cfg = P.PathTracerConfig(max_depth=2)
    _, off = _profiled(lambda: _frame(cornell, cfg))
    assert not [e.name for e in off if e.name.startswith(trace.PREFIX)]
    for owner, name in SPANNED:
        fn = owner.__dict__[name]
        assert fn.__wrapped__ is not None, name
        monkeypatch.setattr(owner, name, fn.__wrapped__)
    _, bare = _profiled(lambda: _frame(cornell, cfg))
    assert _aten(off) == _aten(bare) and len(_aten(off)) > 1000


def _inside(inner, outers):
    return any(o.time_range.start <= inner.time_range.start
               and inner.time_range.end <= o.time_range.end for o in outers)


def test_spans_on_nest_and_leave_the_bits(cornell, monkeypatch):
    want_img, want_g = _frame(cornell)
    gathered = []

    def counting(cls):
        fwd = cls.forward

        def forward(ctx, table, idx):
            if table.requires_grad:
                gathered.append(idx.shape[0])
            return fwd(ctx, table, idx)
        monkeypatch.setattr(cls, "forward", staticmethod(forward))

    counting(ou._Fetch)
    counting(ou._GatherRows)
    trace.reset_counters()
    trace.enable()
    (img, g), events = _profiled(lambda: _frame(cornell))
    trace.disable()
    assert torch.equal(img, want_img)
    for n in LEAVES:
        assert torch.equal(g[n], want_g[n]), n

    spans = {}
    for e in events:
        if e.name.startswith(trace.PREFIX):
            spans.setdefault(e.name[len(trace.PREFIX):], []).append(e)
    assert set(spans) == {"render", "bounce", "rng", "search"}
    assert len(spans["render"]) == 1 and len(spans["bounce"]) == CFG.max_depth
    assert all(_inside(b, spans["render"]) for b in spans["bounce"])
    assert all(_inside(s, spans["bounce"]) for s in spans["search"])
    assert any(_inside(r, spans["bounce"]) for r in spans["rng"])
    assert any(not _inside(r, spans["bounce"]) and _inside(r, spans["render"])
               for r in spans["rng"])  # the primary keys, the compaction's draws

    # per bounce: one closest-hit query and one area-light shadow query (no
    # point or sphere lights) of the bucket's lanes, each padded to TILE
    sc = cornell.scene
    assert sc.plight_pos.shape[0] == 0 and sc.slight_center.shape[0] == 0
    lanes = -(-W * H // oi.TILE) * oi.TILE * SPP
    buckets = P.compact_buckets(CFG, lanes)
    assert lanes == 256 and buckets == [256, 154, 77]
    padded = [-(-k // oi.TILE) * oi.TILE for k in buckets]
    assert padded == [256, 256, 128]
    assert len(spans["search"]) == 2 * CFG.max_depth
    assert trace.COUNTERS["search_lanes"] == 2 * sum(padded) == 1280
    assert trace.COUNTERS["scatter_rows"] == sum(gathered) > 0


def test_two_fit_steps_open_optimizer_and_refresh(monkeypatch, capsys):
    cs = compile_scene(floor_spec(8, 8), device="cpu")
    sc = cs.scene
    with torch.no_grad():
        target = P.render_image(sc, cs.camera, 8, 8, 2, rng.root_key(1, "cpu"),
                                P.PathTracerConfig(max_depth=2))
    start = sc.mesh_vertices + torch.tensor([0.0, 0.1, 0.0])
    bad = inverse.apply_params(sc, {"mesh_vertices": start})
    per_step = []
    clock = iter(range(10**6))
    # a clock that ticks one microsecond a reading: fit's log line then
    # reports the lanes of the step since the line before, in millions
    monkeypatch.setattr(inverse.time, "perf_counter", lambda: next(clock) * 1e-6)
    n0 = trace.COUNTERS["search_lanes"]
    trace.enable()
    (_, losses), events = _profiled(lambda: inverse.fit(
        bad, cs.camera, target, ("mesh_vertices",), steps=2, spp=2,
        key=rng.root_key(2, "cpu"), config=P.PathTracerConfig(max_depth=2),
        smooth_geometry=2, log_every=1,
        callback=lambda i, loss, p: per_step.append(trace.COUNTERS["search_lanes"])))
    trace.disable()
    names = [e.name for e in events]
    assert len(losses) == 2
    assert names.count("mfx.optimizer") == 2
    assert names.count("mfx.refresh") == 2 + 1   # once a step, once for the fitted scene
    assert names.count("mfx.render") == 2
    lanes = [per_step[0] - n0, per_step[1] - per_step[0]]
    assert lanes[0] == lanes[1] > 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[fit]")]
    assert len(lines) == 2 and not any("rays/s" in ln for ln in lines)
    got = [float(re.search(r"([0-9.]+)M lanes/s$", ln).group(1)) for ln in lines]
    assert got == pytest.approx([float(n) for n in lanes], abs=0.01)

