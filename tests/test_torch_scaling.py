"""The port's scaling harness (`mafrixraytracing_torch/bench_scaling.py`) on
the CPU: worlds of one and two gloo processes at 8x8, 1 spp, depth 2.

Its lines against the root `bench_scaling.py`'s: the same metric names, the
upper-bound ray count W * H * SPP * DEPTH, `vs_target` = efficiency / 0.85,
`"virtual_mesh": true` with the JAX script's note on the CPU, and the
device's name and power limit in every record's `detail`; the check that
the world of two renders the world of one's image bit for bit; the usage
errors of its knobs.
"""
import json

import pytest

from mafrixraytracing_torch import bench_scaling
from mafrixraytracing_torch.integrator.path import PathTracerConfig
from mafrixraytracing_torch.parallel.render import same_image_any_world
import torch_port_helpers  # noqa: F401  (sizes torch's threads to the run)

SIZE = {"SCALE_WIDTH": "8", "SCALE_HEIGHT": "8", "SCALE_SPP": "1", "SCALE_DEPTH": "2"}


@pytest.fixture
def small(monkeypatch):
    for k, v in SIZE.items():
        monkeypatch.setenv(k, v)


def lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def test_two_worlds_on_gloo(small, capfd):
    assert bench_scaling.main(["--cpu", "--max-world", "2"]) == 0
    out = lines(capfd.readouterr().out)
    by = {}
    for rec in out:
        by.setdefault(rec.get("metric", rec.get("check")), []).append(rec)
    renders = by["scaling_render_rays_per_s"]
    assert [r["devices"] for r in renders] == [1, 2]
    for r in renders:
        assert r["virtual_mesh"] is True
        assert len(r["iteration_seconds"]) == 3
        assert r["seconds_per_frame"] == pytest.approx(sum(r["iteration_seconds"]) / 3)
        assert r["value"] == pytest.approx(8 * 8 * 1 * 2 / r["seconds_per_frame"])
        assert r["detail"] == {"backend": "gloo", "device": "cpu",
                               "power_limit": "not measured", "launches": {}}
    (check,) = by["image_equal_to_world_1"]
    assert check == {"check": "image_equal_to_world_1", "devices": 2, "equal": True,
                     "promised": True}
    (eff,) = by["scaling_efficiency"]
    assert eff["devices"] == 2 and eff["virtual_mesh"] is True
    assert eff["value"] == pytest.approx(renders[1]["value"] / (2 * renders[0]["value"]))
    assert eff["vs_target"] == pytest.approx(eff["value"] / 0.85)
    assert eff["note"] == bench_scaling.VIRTUAL_NOTE
    (train,) = by["train_step_seconds"]
    assert train["devices"] == 2 and train["value"] > 0
    assert len(train["iteration_seconds"]) == 3 and train["detail"]["backend"] == "gloo"
    assert "note" not in by                  # the card's reason is not printed here


def test_promised_equal_follows_the_sample_groups():
    # the harness's check holds the promise of `parallel.render`
    def promised(W, H, spp, world, wavefront, **kw):
        return same_image_any_world(W, H, spp, world,
                                    PathTracerConfig(wavefront=wavefront, **kw))

    # one wavefront holds the whole image and each shard: the same groups
    assert promised(64, 64, 4, 4, 1 << 19)
    # at most 2 spp the sum over a pixel's samples has one rounding
    assert promised(512, 512, 2, 2, 1 << 10)
    # the whole image at G = 1, a shard of a world of 2 at G = 2
    assert not promised(32, 32, 4, 2, 2048)
    # a compaction schedule selects over each rank's own wavefront
    assert not promised(64, 64, 4, 4, 1 << 19, max_depth=2, compact=(1.0, 0.5))


@pytest.mark.parametrize("argv,env", [(["--max-world", "0"], {}),
                                      (["--max-world", "two"], {}),
                                      ([], {"SCALE_SPP": "0"}),
                                      ([], {"SCALE_WIDTH": "wide"})])
def test_bad_knobs_are_usage_errors(argv, env, monkeypatch, capsys):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit) as e:
        bench_scaling.main(["--cpu", *argv])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert (argv[0] if argv else next(iter(env))) in err
