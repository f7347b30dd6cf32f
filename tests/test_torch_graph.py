"""The live preview's pass replayed as one CUDA graph (`ops/graph.py`,
`integrator/path.py::render_sample_batch`).

This file imports no JAX, so the card's machine runs it too:

    python -m pytest --noconftest tests/test_torch_graph.py -q

On the CPU:
- `pass_signature` changes when a scene or camera tensor is replaced or the
  film's width or height or the configuration changes, and not with the
  root key's value; the sample index is no part of it;
- on the CPU, and with grad, `render_sample_batch` runs eager: equal to
  `render_flat_pixels`, no capture, no replay, nothing cached;
- a 0-d int64 `sample_offset` gives the frame of the int;
- `PassGraphs`' bookkeeping with a stand-in for the capture that reruns the
  pass (and, as a graph, counts nothing): eager the first time, captured
  the second, replayed after that, bit-equal to the eager pass for two keys
  and sample indices 0-4 and 1000; every pass counts `LAUNCHES` and
  `COUNTERS` once; the cache keeps `CAPACITY` keys and forgets the oldest.

On the card (marker `cuda`): replayed passes `torch.equal` to the eager
pass under both estimators, with compaction off and on; a new
`light_radiance` tensor captures anew; an in-place edit of a scene tensor
reaches the replay; `LAUNCHES` and `COUNTERS` a pass equal in eager and
replayed passes; calls with grad stay eager and their gradients reach the
scene.
"""
import dataclasses

import pytest
import torch

import torch_port_helpers  # noqa: F401  (sizes torch's threads to the run)
from mafrixraytracing_torch.core import rng
from mafrixraytracing_torch.integrator import path as P
from mafrixraytracing_torch.ops import cuda, graph
from mafrixraytracing_torch.scene.builtin import cornell_box
from mafrixraytracing_torch.scene.compiler import compile_scene
from mafrixraytracing_torch.utils import trace

W = H = 12
CFG = P.PathTracerConfig(max_depth=3)
SAMPLES = (0, 1, 2, 3, 4, 1000)


@pytest.fixture
def cornell():
    return compile_scene(cornell_box(W, H), device="cpu")


@pytest.fixture(autouse=True)
def _fresh_cache():
    P._PASSES.entries.clear()
    yield
    P._PASSES.entries.clear()


def eager(cs, key, s, config=CFG, w=W, h=H):
    """The pass as `render_sample_batch` ran it before graphs."""
    ids = torch.arange(w * h, device=cs.scene.tri_v0.device)
    return P.render_flat_pixels(cs.scene, cs.camera, ids, w, h, 1, key, config,
                                sample_offset=s)


def graph_counts():
    return trace.COUNTERS["graph_captures"], trace.COUNTERS["graph_replays"]


def counted(fn):
    """fn()'s result and the change it made to `LAUNCHES` and `COUNTERS`
    (the graph counters left out)."""
    l0, c0 = dict(cuda.LAUNCHES), dict(trace.COUNTERS)
    out = fn()
    dl = {k: v - l0[k] for k, v in cuda.LAUNCHES.items()}
    dc = {k: v - c0[k] for k, v in trace.COUNTERS.items() if not k.startswith("graph_")}
    return out, dl, dc


# --- the signature --------------------------------------------------------


def _changed(cs, what):
    scene, cam, w, h, cfg = cs.scene, cs.camera, W, H, CFG
    if what == "scene tensor":
        scene = scene.replace(light_radiance=scene.light_radiance.clone())
    elif what == "camera tensor":
        cam = dataclasses.replace(cam, position=cam.position.clone())
    elif what == "width":
        w = W + 1
    elif what == "height":
        h = H + 1
    elif what == "config":
        cfg = P.PathTracerConfig(max_depth=4)
    elif what == "estimator":
        cfg = P.PathTracerConfig(max_depth=3, estimator="mafrix")
    return scene, cam, w, h, cfg


@pytest.mark.parametrize("what", ["scene tensor", "camera tensor", "width", "height",
                                  "config", "estimator"])
def test_signature_names_what_the_graph_bakes_in(cornell, what):
    key = rng.root_key(0, "cpu")
    base = P.pass_signature(cornell.scene, cornell.camera, W, H, key, CFG)
    assert P.pass_signature(cornell.scene, cornell.camera, W, H, key, CFG) == base
    scene, cam, w, h, cfg = _changed(cornell, what)
    assert P.pass_signature(scene, cam, w, h, key, cfg) != base


def test_signature_leaves_out_the_key_value(cornell):
    a = P.pass_signature(cornell.scene, cornell.camera, W, H, rng.root_key(0, "cpu"), CFG)
    b = P.pass_signature(cornell.scene, cornell.camera, W, H,
                         rng.root_key(2**40 + 17, "cpu"), CFG)
    assert a == b
    hash(a)


# --- the eager routes -----------------------------------------------------


@pytest.mark.parametrize("grad", [False, True])
def test_cpu_and_grad_calls_run_eager(cornell, grad):
    key = rng.root_key(5, "cpu")
    before = graph_counts()
    with torch.set_grad_enabled(grad):
        for s in (0, 1, 2):
            got = P.render_sample_batch(cornell.scene, cornell.camera, W, H, s, key, CFG)
            assert torch.equal(got, eager(cornell, key, s))
    assert graph_counts() == before
    assert not P._PASSES.entries


@pytest.mark.parametrize("spp", [1, 2])
def test_tensor_sample_offset_gives_the_int_frame(cornell, spp):
    key = rng.root_key(9, "cpu")
    ids = torch.arange(W * H)
    for s in (0, 3, 1000):
        want = P.render_flat_pixels(cornell.scene, cornell.camera, ids, W, H, spp, key,
                                    CFG, sample_offset=s)
        got = P.render_flat_pixels(cornell.scene, cornell.camera, ids, W, H, spp, key,
                                   CFG, sample_offset=torch.tensor(s, dtype=torch.int64))
        assert torch.equal(got, want)


# --- the cache's bookkeeping, with a stand-in capture ---------------------


class RerunGraph:
    """A stand-in for a captured graph: replay reruns the pass into its
    output, and counts nothing, as a graph's replay does not."""

    def __init__(self, fn, inputs, out):
        self.fn, self.inputs, self.out = fn, inputs, out

    def replay(self):
        launches, counters = dict(cuda.LAUNCHES), dict(trace.COUNTERS)
        self.out.copy_(self.fn(*self.inputs))
        cuda.LAUNCHES.update(launches)
        trace.COUNTERS.update(counters)


@pytest.fixture
def rerun(monkeypatch):
    def record(fn, inputs):
        out = fn(*inputs)
        return RerunGraph(fn, inputs, out), out
    monkeypatch.setattr(graph, "_record", record)


def test_eager_then_capture_then_replay(cornell, rerun):
    cache = graph.PassGraphs()
    ids = torch.arange(W * H)

    def one_pass(key, s):
        return P.render_flat_pixels(cornell.scene, cornell.camera, ids, W, H, 1, key,
                                    CFG, sample_offset=s)
    sig = P.pass_signature(cornell.scene, cornell.camera, W, H, rng.root_key(1, "cpu"),
                           CFG)
    c0, r0 = graph_counts()
    calls = 0
    for seed in (1, 2**33 + 5):
        key = rng.root_key(seed, "cpu")
        for s in SAMPLES:
            got, dl, dc = counted(lambda: cache.run(sig, one_pass, (key, s), "cpu"))
            want, el, ec = counted(lambda: eager(cornell, key, s))
            assert torch.equal(got, want)
            assert (dl, dc) == (el, ec)
            calls += 1
    assert graph_counts() == (c0 + 1, r0 + calls - 2)
    assert len(cache.entries) == 1


def test_returned_frames_outlive_the_next_replay(cornell, rerun):
    cache = graph.PassGraphs()
    key = rng.root_key(3, "cpu")

    def one_pass(key, s):
        return eager(cornell, key, s)
    frames = [cache.run("k", one_pass, (key, s), "cpu") for s in range(4)]
    for s, f in enumerate(frames):
        assert torch.equal(f, eager(cornell, key, s))


def test_cache_keeps_capacity_keys_and_forgets_the_oldest(rerun):
    cache = graph.PassGraphs()

    def one_pass(x, s):
        return x * 2 + s
    x = torch.arange(3.0)
    keys = [f"k{i}" for i in range(graph.CAPACITY + 1)]
    for k in keys:
        cache.run(k, one_pass, (x, 1), "cpu")
    assert list(cache.entries) == keys[1:]
    c0, _ = graph_counts()
    cache.run(keys[0], one_pass, (x, 1), "cpu")      # forgotten: eager again
    assert graph_counts()[0] == c0 and list(cache.entries) == keys[2:] + keys[:1]
    cache.run(keys[0], one_pass, (x, 1), "cpu")      # the second call captures
    assert graph_counts()[0] == c0 + 1
    assert torch.equal(cache.run(keys[0], one_pass, (x, 5), "cpu"), x * 2 + 5)


# --- on the card ----------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


CARD_W = CARD_H = 64
COMPACT = (1.0, 0.7, 0.4, 0.3, 0.1)


def card_scene(card):
    return compile_scene(cornell_box(CARD_W, CARD_H), device=card)


def preview(cs, key, s, config):
    with torch.no_grad():
        return P.render_sample_batch(cs.scene, cs.camera, CARD_W, CARD_H, s, key, config)


def card_eager(cs, key, s, config):
    with torch.no_grad():
        return eager(cs, key, s, config, CARD_W, CARD_H)


@pytest.mark.cuda
@pytest.mark.parametrize("estimator", ["physical", "mafrix"])
@pytest.mark.parametrize("compact", [(), COMPACT])
def test_replayed_passes_equal_the_eager_pass(card, estimator, compact):
    cs = card_scene(card)
    config = P.PathTracerConfig(estimator=estimator, compact=compact)
    c0, r0 = graph_counts()
    calls = 0
    for seed in (11, 2**35 + 3):
        key = rng.root_key(seed, card)
        for s in SAMPLES:
            assert torch.equal(preview(cs, key, s, config), card_eager(cs, key, s, config))
            calls += 1
    assert graph_counts() == (c0 + 1, r0 + calls - 2)


@pytest.mark.cuda
def test_a_new_light_radiance_tensor_captures_anew(card):
    cs = card_scene(card)
    key = rng.root_key(4, card)
    for s in range(3):
        preview(cs, key, s, CFG)
    c0, _ = graph_counts()
    cs.scene = cs.scene.replace(light_radiance=cs.scene.light_radiance * 2.0)
    for s in range(3):
        assert torch.equal(preview(cs, key, s, CFG), card_eager(cs, key, s, CFG))
    assert graph_counts()[0] == c0 + 1


@pytest.mark.cuda
def test_an_in_place_edit_reaches_the_replay(card):
    cs = card_scene(card)
    key = rng.root_key(6, card)
    for s in range(3):
        preview(cs, key, s, CFG)
    before = preview(cs, key, 3, CFG)
    cs.scene.light_radiance.mul_(3.0)
    cs.scene.mat_albedo.mul_(0.5)
    c0, r0 = graph_counts()
    after = preview(cs, key, 3, CFG)
    assert graph_counts() == (c0, r0 + 1)
    assert torch.equal(after, card_eager(cs, key, 3, CFG))
    assert not torch.equal(after, before)


@pytest.mark.cuda
def test_launches_and_counters_a_pass_equal_eager_and_replayed(card):
    cs = card_scene(card)
    key = rng.root_key(8, card)
    for s in range(2):
        preview(cs, key, s, CFG)
    _, el, ec = counted(lambda: card_eager(cs, key, 2, CFG))
    c0, r0 = graph_counts()
    _, rl, rc = counted(lambda: preview(cs, key, 2, CFG))
    assert graph_counts() == (c0, r0 + 1)
    assert (rl, rc) == (el, ec)
    assert el["rng_fold"] > 0 and ec["search_lanes"] > 0


@pytest.mark.cuda
def test_calls_with_grad_stay_eager_and_reach_the_scene(card):
    cs = card_scene(card)
    key = rng.root_key(12, card)
    radiance = cs.scene.light_radiance.clone().requires_grad_()
    scene = cs.scene.replace(light_radiance=radiance)
    before = graph_counts()
    for s in range(3):
        frame = P.render_sample_batch(scene, cs.camera, CARD_W, CARD_H, s, key, CFG)
        frame.mean().backward()
    assert graph_counts() == before and not P._PASSES.entries
    assert radiance.grad is not None and bool((radiance.grad.abs() > 0).any())
