"""The port's sharded rendering (`parallel/`) against the JAX package's.

- `render_image_sharded` on a mesh of one rank against the JAX
  `render_image_sharded` on the 8 virtual CPU devices of tests/conftest.py:
  the path tolerance of tests/test_torch_path.py (rtol 1e-3 / atol 1e-4 on
  99% of the pixels of a 16x16 frame, the mean within 1e-3: two packages,
  float rounding, a grazing branch may flip).
- Inside the port the image must not depend on the world size: the shards of
  1, 2, 3 and 8 ranks, rendered in one process and joined, equal the unsharded
  `render_flat_pixels` image bit for bit, at 16x16 and at 15x15 (225 pixels:
  the padding with repeated pixels). No compaction and 2 spp, for which the
  module documents bit-equality.
- One real run of two processes on gloo gives the same image on both ranks.
"""
import jax
import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from mafrixraytracing_torch.core import rng as trng
from mafrixraytracing_torch.integrator import path as TP
from mafrixraytracing_torch.parallel import launch, mesh as tmesh, render as trender
from mafrixraytracing_torch.scene import builtin as tbuiltin
from mafrixraytracing_torch.scene.compiler import STATIC_FLAGS, TENSOR_FIELDS
from mafrixraytracing_torch.scene.compiler import compile_scene as tcompile
from mafrixraytracing_tpu.integrator import path as JP
from mafrixraytracing_tpu.parallel import mesh as jmesh, render as jrender

from test_torch_path import cornell
from torch_port_helpers import CAMERA_FIELDS

JCFG = JP.PathTracerConfig(backend="jnp", max_depth=3, rr_enable=False)
TCFG = TP.PathTracerConfig(max_depth=3, rr_enable=False)
SPP = 2


@pytest.fixture(scope="module")
def frames():
    """size -> (port scene, port camera, the unsharded image)."""
    out = {}
    for size in (16, 15):
        _, ts, tcam = cornell(size, size)
        ref = TP.render_flat_pixels(ts, tcam, torch.arange(size * size), size, size,
                                    SPP, trng.root_key(11, "cpu"), TCFG)
        out[size] = (ts, tcam, ref.reshape(size, size, 3))
    return out


def test_one_rank_matches_jax_on_eight_devices(frames):
    W = H = 16
    jcs, _, _ = cornell(W, H)
    jimg = np.asarray(jrender.render_image_sharded(
        jcs.scene, jcs.camera, jmesh.make_mesh(8), W, H, SPP, jax.random.key(11), JCFG))
    ts, tcam, _ = frames[16]
    timg = trender.render_image_sharded(ts, tcam, tmesh.make_mesh(1), W, H, SPP,
                                        trng.root_key(11, "cpu"), TCFG).numpy()
    assert timg.shape == (H, W, 3) and np.isfinite(timg).all() and timg.mean() > 0.01
    close = np.isclose(timg, jimg, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(timg.mean() - jimg.mean()) <= 1e-3 * abs(jimg.mean())


@pytest.mark.parametrize("size", [16, 15])
@pytest.mark.parametrize("world", [1, 2, 3, 8])
def test_shards_of_any_world_join_to_the_unsharded_image(frames, size, world):
    ts, tcam, ref = frames[size]
    key = trng.root_key(11, "cpu")
    shards = [trender.render_shard(ts, tcam, tmesh.make_mesh(world, r), size, size,
                                   SPP, key, TCFG) for r in range(world)]
    per = -(-size * size // world)
    assert all(s.shape == (per, 3) for s in shards)
    img = trender.assemble_image(torch.cat(shards), size, size, world)
    assert torch.equal(img, ref) and float(ref.mean()) > 0.01


def test_padded_pixel_ids_cover_the_frame_and_repeat_from_the_start():
    ids = trender.padded_pixel_ids(15, 15, 8)
    assert ids.shape == (232,) and sorted(ids[:225].tolist()) == list(range(225))
    assert torch.equal(ids[225:], ids[:7])
    jperm, _ = JP.tiled_pixel_order(15, 15)
    np.testing.assert_array_equal(ids[:225].numpy(), jperm)     # the JAX order


def test_mesh_of_one_needs_no_group_and_larger_ones_do(frames):
    one = tmesh.make_mesh(1)
    assert (one.rank, one.world, one.group) == (0, 1, None)
    assert one.shape == {tmesh.RAY_AXIS: 1} and tmesh.RAY_AXIS == jmesh.RAY_AXIS
    x = torch.arange(6.0).reshape(2, 3)
    assert one.all_gather(x) is x and torch.equal(one.all_mean(x), x)
    assert one.sum_start([x]) == [] and one.shard(6) == slice(0, 6)
    one.barrier()
    part = tmesh.make_mesh(3, 2)
    assert part.shard(9) == slice(6, 9)
    with pytest.raises(ValueError, match="do not divide"):
        part.shard(10)
    with pytest.raises(RuntimeError, match="process group"):
        part.all_gather(x)
    with pytest.raises(RuntimeError, match="process group"):
        part.sum_start([x])
    with pytest.raises(ValueError, match="outside a world"):
        tmesh.make_mesh(2, 2)
    ts, tcam, _ = frames[16]
    with pytest.raises(RuntimeError, match="process group"):
        trender.render_image_sharded(ts, tcam, part, 16, 16, 1,
                                     trng.root_key(0, "cpu"), TCFG)
    assert trender._render_flat_pixels is TP.render_flat_pixels


def test_spp_sharded_on_one_rank(frames):
    ts, tcam, _ = frames[16]
    key = trng.root_key(3, "cpu")
    img = trender.render_spp_sharded(ts, tcam, tmesh.make_mesh(1), 16, 16, 1, key, TCFG)
    want = TP.render_flat_pixels(ts, tcam, torch.arange(256), 16, 16, 1,
                                 trng.fold_in(key, 0), TCFG).reshape(16, 16, 3)
    assert torch.equal(img, want) and float(img.max()) > 0.0


def test_launch_init_is_false_with_nothing_configured(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert launch.init() is False
    mesh = launch.global_mesh()
    assert (mesh.rank, mesh.world, mesh.group) == (0, 1, None)
    info = launch.process_info()
    assert info["process_count"] == 1 and info["process_index"] == 0
    launch.shutdown()   # nothing to leave


def test_spawn_local_kills_a_hung_rank():
    with pytest.raises(TimeoutError, match="did not finish"):
        launch.spawn_local(worker.hang, 1, (), timeout_s=4.0)


def test_two_processes_on_gloo_render_the_one_process_image(frames, tmp_path):
    ts, _, _ = frames[16]
    cams = {s: {k: getattr(frames[s][1], k).numpy() for k in CAMERA_FIELDS}
            for s in (16, 15)}
    worker.save_job(tmp_path / "job.pt",
                    scene={k: getattr(ts, k).numpy() for k in TENSOR_FIELDS},
                    flags={k: getattr(ts, k) for k in STATIC_FLAGS},
                    camera=cams[16], cameras=cams, sizes=[16, 15], spp=SPP, seed=11,
                    config=dict(max_depth=3, rr_enable=False))
    launch.spawn_local(worker.render_worker, 2, (2, str(tmp_path)), timeout_s=150.0)
    r0, r1 = (worker.load_result(str(tmp_path), r) for r in range(2))
    for size in (16, 15):
        np.testing.assert_array_equal(r0[f"image{size}"], r1[f"image{size}"])
        np.testing.assert_array_equal(r0[f"image{size}"], frames[size][2].numpy())
    # the averaging decomposition: the mean of the ranks' own renders
    np.testing.assert_array_equal(r0["spp_sharded"], r1["spp_sharded"])
    mean = (r0["own_half"] + r1["own_half"]) / 2
    np.testing.assert_array_equal(r0["spp_sharded"], mean.reshape(16, 16, 3))
    assert np.abs(r0["own_half"] - r1["own_half"]).max() > 0   # distinct keys
