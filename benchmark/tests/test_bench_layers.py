"""The program's spans joined to the device trace (`benchmark/layers.py`), on
a synthetic event list: the `mfx.` marks on the device's timeline skipped,
each launch put down to the innermost program span or `evaluate_function`
around its runtime call, each idle gap to the layer of the launch that ends
it, and the sums: the layers' launches are the traced kernels, their idle
shares the idle share. Also the traced slice switching the program's spans
on and taking its counters' change."""
import pytest
import torch

from benchmark import layers, tracing

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


class Ev:
    """A Kineto event as `reduce` and `layers` read it."""

    def __init__(self, name, start, end, device=False, corr=0, tid=1):
        self._n, self._s, self._e = name, start, end
        self._d, self._c, self._t = device, corr, tid

    def name(self):
        return self._n

    def device_type(self):
        return CUDA if self._d else CPU

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def correlation_id(self):
        return self._c

    def start_thread_id(self):
        return self._t


class Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("R", (), {"events": lambda _: events})()


def launch(t, corr, tid=1):
    return Ev("cudaLaunchKernel", t, t + 5, corr=corr, tid=tid)


def kernel(name, s, e, corr):
    return Ev(name, s, e, device=True, corr=corr)


BWD = "autograd::engine::evaluate_function: MulBackward0"
EVENTS = [
    Ev("bench.window", 0, 1000), Ev("bench.forward", 0, 600),
    Ev("mfx.render", 10, 500),
    Ev("mfx.rng", 20, 60), launch(30, 1),
    Ev("mfx.bounce", 60, 400), launch(70, 2),
    Ev("mfx.search", 80, 120), launch(90, 3), Ev("aten::add", 120, 130),
    launch(450, 4),                                  # render's own: a copy
    Ev(BWD, 600, 800, tid=2), launch(610, 5, tid=2),
    Ev("mfx.rng", 700, 750, tid=2), launch(710, 6, tid=2),
    launch(900, 7),                                  # no program span: outside
    kernel("void rng_kernel<int>()", 100, 150, 1),
    kernel("void mul_kernel()", 200, 260, 2),
    kernel("closest_kernel(float const*)", 260, 300, 3),
    kernel("Memcpy DtoH (Device -> Pinned)", 460, 480, 4),
    kernel("void mul_backward()", 620, 650, 5),
    kernel("void rng_kernel<long>()", 760, 780, 6),
    kernel("void sum_kernel()", 910, 920, 7),
]
MARKS = [Ev("mfx.bounce", 60, 400, device=True), Ev("mfx.render", 10, 500, device=True),
         Ev("bench.forward", 0, 600, device=True)]
# gaps: [0,100] rng, [150,200] bounce, [300,460] render, [480,620] backward,
# [650,760] rng (the span inside evaluate_function wins), [780,910] and
# [920,1000] outside (the window's last)
IDLE_NS = {"rng": 100 + 110, "bounce": 50, "render": 160, "backward": 140,
           "outside": 130 + 80}
LAUNCHES = {"rng": 2, "bounce": 1, "search": 1, "render": 0, "backward": 1, "outside": 1}


def _reduced(events, kind="grad"):
    tr = tracing.Trace(kind, units=2, plain_s=1000e-9)
    tracing.reduce(layers.Unmarked(events), tr)
    return tr


def test_program_marks_on_the_device_are_skipped():
    plain = _reduced(EVENTS)
    marked = _reduced(EVENTS + MARKS)
    for f in ("busy_s", "window_s", "kernels", "device_ops", "idle_gaps"):
        assert getattr(marked, f) == getattr(plain, f), f
    assert plain.busy_s == pytest.approx(230e-9) and len(plain.kernels) == 6
    # without the skip `reduce` takes the program's marks for kernels
    raw = tracing.Trace("grad", units=2, plain_s=1000e-9)
    tracing.reduce(Prof(EVENTS + MARKS), raw)
    assert len(raw.kernels) == 8
    assert layers.layers(EVENTS + MARKS) == layers.layers(EVENTS)


def test_launches_and_gaps_go_to_their_layers():
    by = layers.layers(EVENTS + MARKS)
    got = {k: v["launches"] for k, v in by.items()}
    assert got == LAUNCHES
    assert sum(got.values()) == len(_reduced(EVENTS + MARKS).kernels)
    assert {k: v["spans"] for k, v in by.items() if v["spans"]} == {
        "render": 1, "rng": 2, "bounce": 1, "search": 1, "backward": 1}
    assert by["render"]["device_s"] == pytest.approx(20e-9)
    assert by["search"]["device_s"] == pytest.approx(40e-9)
    idle = {k: v["idle_s"] for k, v in by.items() if v["idle_s"]}
    assert idle == pytest.approx({k: v / 1e9 for k, v in IDLE_NS.items()})


def test_layer_idle_shares_sum_to_the_idle_share():
    tr = _reduced(EVENTS + MARKS)
    by = layers.layers(EVENTS + MARKS)
    share = tracing.idle_share(tr, "grad")
    assert share == pytest.approx(1 - 230 / 1000)
    parts = {k: layers.layer_idle_share(tr, by, k) for k in by}
    assert sum(parts.values()) == pytest.approx(share, abs=1e-12)
    assert parts["backward"] == pytest.approx(share * 140 / 770)
    assert layers.layer_idle_share(tr, by, "refresh") == 0.0
    table = layers.table(tr, by)
    assert sum(v["launches"] for v in table.values()) * tr.units == len(tr.kernels)
    assert sum(v["idle_share"] for v in table.values()) == pytest.approx(share, abs=1e-12)


@pytest.mark.parametrize("layer", sorted(LAUNCHES))
def test_each_layer_reads_its_launches_a_unit(layer):
    tr = _reduced(EVENTS + MARKS)
    table = layers.table(tr, layers.layers(EVENTS + MARKS))
    assert table[layer]["launches"] == LAUNCHES[layer] / tr.units


def test_a_program_without_spans_puts_everything_outside():
    """What a program without the spans gives: every launch and gap outside."""
    bare = [e for e in EVENTS if not e.name().startswith((layers.PROGRAM, layers.BACKWARD))]
    by = layers.layers(bare)
    assert set(by) == {"outside"}
    assert by["outside"]["launches"] == len(_reduced(bare).kernels)
    assert by["outside"]["idle_s"] == pytest.approx(770e-9)


def test_traced_slice_switches_the_program_spans_and_takes_its_counters():
    from mafrixraytracing_torch.utils import trace

    tr = layers.LayerTracer(True, "grad", False)
    trace.count("search_lanes", 7)
    tr.start()
    assert trace.enabled()
    trace.count("search_lanes", 384)
    trace.count("scatter_rows", 10)
    tr.stop(2)
    assert not trace.enabled()
    assert tr.trace.counters["mfx.search_lanes"] == 384
    assert tr.trace.counters["mfx.scatter_rows"] == 10
    assert layers.LayerTracer.last is tr


def test_the_benchmark_tracer_leaves_the_program_spans_off():
    from mafrixraytracing_torch.utils import trace

    tr = tracing.Tracer(True, "grad", False)
    tr.start()
    assert not trace.enabled()
    tr.stop(1)
