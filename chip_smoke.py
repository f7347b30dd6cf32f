#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (written for an H100).

    python3 chip_smoke.py

Phases, each fatal on failure (a traceback and a non-zero exit; the final
`ok` line is printed only when every phase passed):

1. Device and build: the card's name and power limit (nvidia-smi), the CUDA
   version, and the build of the CUDA kernels from `mafrixraytracing_torch/
   csrc/` with its seconds.
2. Kernel parity: each kernel against its plain PyTorch version on the same
   inputs, and each one's time beside its plain version's, its bound on the
   card and, where one PyTorch call computes the same function, that call's
   time (a plain version is timed over the one call that the comparison
   makes). The flat walks (closest, anyhit) and the gather on Cornell primary
   (uniform pixels, and in the render's tile order) and shadow rays at B =
   524,288 and on a seeded soup of 8,192 small triangles (64 clusters) at a
   non-aligned B with ~10% dead rays, each walk bit for bit against its plain
   version, with its bound and share on the soup and, for each input, its
   flat fan-out counted in PyTorch: the tiles that list a cluster, the pairs
   a walk holding a ray a thread tests (listed x 128), the pairs the rays ask
   for (at tmax; closest hit also at the final t) and the pairs needed. The
   two-level walks (closest_super, anyhit_super) and the gather at P =
   65,544 on a seeded mesh of 36,996 faces (512 clusters, 32 superclusters)
   that is written as an OBJ file to the temp directory and loaded through
   `scene.assets.mesh_scene`: primary and shadow rays at B = 524,288, the
   shadow rays less their last 287 (a batch that is not a multiple of the
   tile), and a non-aligned batch of unrelated rays (incoherent tiles) with
   ~10% dead rays. The two-level closest-hit kernel must equal its plain
   version bit for bit on every input. For the any-hit walk on the three
   shadow-like inputs, its fan-out counted in PyTorch: the children a tile's
   rays ask for in all (what a walk that stages every asked-for child for the
   whole tile stages: an upper bound) against the (ray, child) pairs they
   ask for and the pairs the answer needs; for the closest-hit walk on the
   primary rays and the incoherent tiles the same counts, each at the rays'
   final t (a lower bound) and at tmax (an upper bound). The gather also as
   a pure unpack
   (idx = arange(B) over a (B, 36) table, B a multiple of 1024: the contract
   of the Pallas unpack kernels), bit-equal to the transpose, and at a
   batch that is not a multiple of 4. The scatter-add
   (the backward of the gathers) `torch.equal` to
   `scatter_rows_ordered_reference` (its own sum order), and it and
   `index_add_` against a float64 sum on the card, within 1e-5 * sum |terms|
   + 1e-6 per entry, on the primary-hit rows of the mesh (P = 65,544) and of
   Cornell (P = 136) at B = 524,288, on one row for every ray, on a sliced
   non-aligned B and a compacted size with ~10% dead lanes of zero
   cotangent, on the light rows of 8 and of 2 lights (16 columns, rows) and
   the vertex gather (3 columns); two launches on the same inputs must be
   bit-equal; on each input its time and its parts (sort, searchsorted,
   pass 1, pass 2) each timed alone. The fused-cull searches (fused_closest,
   fused_anyhit on Cornell and the soup; fused_closest_super,
   fused_anyhit_super on the mesh) on the rays of every walk above: bit-equal
   to their plain versions and to the list kernels, each one's time beside
   the time of the cull kernel plus the list kernel on the same rays. The
   cull kernel (cull, the cull of `_prep` on the card) on the rays and boxes
   of every walk above: lists, counts, entries and far `torch.equal` to its
   plain version (`cull_reference`), to the operands of the PyTorch cull
   (`_cull`) and to `_prep`'s, with its time by events and on the device, the
   PyTorch cull's and its bound. The instrumented walks
   (closest_dbg, closest_full: closest's walk with a counter, and with its
   exit off) on Cornell and on the soup: `(t, idx)` bit-equal to closest's
   and to their step-by-step plain versions', `walked` equal to the plain
   version's and never above the count, each one's time by events and on the
   device; on the soup also at t_min = -3, closest bit-equal to its plain
   version and `walked` equal to the count (no exit behind the origin).
3. Forward, Cornell: 256x256, 64 spp, depth 5, NEE + MIS + Russian roulette,
   compaction calibrated from `trace_stats` as the benchmark does. The image
   must be finite with a sane mean, the launch counts of closest, anyhit and
   unpack must be > 0, the cull kernel launched once a query (80 times, as
   often as closest and anyhit together) and the PyTorch cull never, a PNG
   goes to the temp directory, and a 64x64 render
   through the kernels must match the same render through the plain
   versions.
4. Forward + backward, Cornell: the gradient of the mean image with respect
   to albedo, light radiance and vertices at the same size and compaction;
   all finite, the albedo and radiance gradients non-zero.
5. Forward, mesh: the same as 3 on the 36,996-face mesh scene; the launch
   counts of closest_super, anyhit_super and unpack must be > 0, those of
   closest and anyhit 0, and the cull kernel's 80 as in 3. Also a 64x64
   render with a checker texture on the mesh, finite and different from the
   untextured one.
6. Forward + backward, mesh: the same as 4 on the mesh scene, with the peak
   device memory.
7. Fit: `opt.inverse.fit` on the mesh scene at 256x256, 8 spp a step (one
   wavefront of 2^19 rays), depth 5, the mesh at 8 times its size (see
   FIT_SCALE), from a start with one albedo and the light radiance off and
   the vertices displaced along y by a seeded smooth field; parameters albedo, light radiance and the shared vertex buffer,
   vertex gradients smoothed. 6 steps uninterrupted, then 3 steps with a
   checkpoint, everything dropped, and a restart for the other 3. Losses and
   gradient norms finite, the mean of the last two losses below the first,
   the launch counts of closest_super, anyhit_super, unpack and scatter > 0,
   the refreshed cluster bounds contain every clustered triangle, the
   resumed run's losses and final parameters bit-equal to the uninterrupted
   run's, and one gradient evaluation repeated from the same state bit-equal.
   Prints the peak device memory and the operations that PyTorch's
   determinism check names during one gradient evaluation. Then a
   short Cornell fit (albedo, 64x64, 4 steps) through closest, anyhit, unpack
   and scatter.
8. The fused-cull search at full width (`ops.intersect.FUSED_CULL` patched
   on): the forward frames of 3 and 5 again, each `torch.equal` to the list
   path's image, with the launch counts of the fused kernels > 0 and those of
   the list kernels and the cull kernel 0, the PyTorch cull never called;
   forward + backward on the mesh as phase 6 takes it, gradients
   bit-equal to the list path's at the same seed; s/frame and kernel
   launches per frame of both paths, taken in turns (list, fused, fused,
   list).
9. The other entry points: a 128x128 Whitted render of Cornell with the
   fused search (finite, two renders bit-equal, a PNG to the temp directory),
   a 64x64 motion-blur render of a moving sphere (finite, the flag changes
   the picture), and the native OBJ loader on the mesh's OBJ file, equal to
   the Python parser's arrays, with both parse times.
10. The walk profile: `profile_walk.main()` at B = 524,288 on a seeded sphere
   of 15,488 faces (at most 128 clusters): listed and walked clusters a tile
   on the primary and the sorted bounce-1 wavefront, the five times, the
   cull kernel equal to the PyTorch cull and both instrumented walks equal to
   closest; its JSON line. The only path that launches closest_dbg and
   closest_full.
11. The multi-process path on the one card: `launch.init` with a file store
   brings up an NCCL group of one rank; `render_image_sharded` on the mesh
   scene at 256x256 x 64 spp, on a mesh of one rank without a group and on
   the NCCL group's mesh, `torch.equal` to the unsharded `render_flat_pixels`
   image (no compaction: the configuration for which the image does not
   depend on the pixel order); `render_spp_sharded` finite; one `fit` of 2
   steps, 2 microbatches, with `mesh=` (the gradients all-reduced through
   NCCL, asynchronously per microbatch) bit-equal to the same fit without.
12. The rasterizer, the transforms and the live preview (plain PyTorch: no
   TPU kernel is on this path; its backward sums through J): the mesh's
   36,996 faces at the demo's 512x512, perspective-correct, chunks of 64, a
   checker texture, the demo's two lights, under a model matrix composed on
   the card of `scale` (to a bounding radius of 0.6), `rotation_y(150)` and
   `translation`. Prints s/frame by CUDA events (a warm-up, then 3), the
   kernel launches of a frame and their device time (torch.profiler), the
   peak device memory and the covered pixels; the image must be finite,
   cover 5-95% of the pixels and be `torch.equal` across two frames. One
   backward of the mean image to the texture and the vertices: finite,
   non-zero, bit-equal when repeated, J launched twice, its peak memory.
   The same call at 64x64 on the CPU: the faces drawn equal on at least
   99.9% of the pixels, colours within 1e-4 where they are; the model
   matrix, its inverse, `apply_point` and `apply_normal` within 1e-6 of the
   CPU's. `examples.render_cornell.main` at 256x256 x 4 spp with
   `--preview-port 0`, then a `LivePreview` fed with a `FilmState` of 4
   passes: the served `/frame.png` equal to the file and to
   `encode_png(film.to_bytes())`, its IHDR 256x256, the page naming
   frame.png; `examples.rasterize.main` at 512x512 on the mesh's OBJ writes
   its PNG (copied to the temp directory).
13. The last four entry points, as a user calls them, each path's kernel
   launches read around it: `examples.render_spheres.main` at its 400x200
   and depth 8, 16 of its 64 passes (a 400x200 PNG; closest, anyhit,
   unpack and cull launched); `examples.baseline_matrix.main(["--quick"])`,
   its Cornell row at 256x256 x 16 spp (one finite record with the card's
   name and power limit), then its `run` on the mesh of phase 2 at
   1024x1024 in 16 passes of 1 spp (the two-level walks, not the flat
   ones); `examples.fit_inverse.main` at its own sizes and steps on its
   seeded stand-in for spot (5,856 faces): each fit's last loss below its
   first, the albedo, vertex and ground height errors smaller fitted than
   at the start, the set-up of the three fits printed, nine PNGs, scatter
   launched; `python -m mafrixraytracing_torch.bench_scaling` at its
   defaults in a process of its own (a world of one on a machine with one
   card, and the line that says why there is no efficiency line): the
   render and train-step lines with the card's name, power limit and NCCL,
   and the kernels launched. Each path's kernels are then held against
   their plain versions on that path's own operands, recorded as it runs
   (`recorded`, `hold_recorded`): every search (A or B, and K) and gather
   (C) of one render_spheres pass, of the Cornell row and of the harness's
   render and train step, the first closest-hit and any-hit searches (D, E,
   K) and gather of the mesh row's first pass, and every search, gather and
   scatter-add (J, on the backward's own cotangents and index sets: the
   albedo rows, the floor's attribute rows, the shared vertex rows) of each
   fit's renders and first step on the stand-in. Last, the vertex fit on the
   card against the CPU from one target: the first step's loss within 1e-4
   of the CPU's and its gradient to the ground rows within 1e-2 of the
   spread between two keys' gradients, the first 3 losses of both, and the
   whole fit on the card from its start and from the ground one ulp higher.
14. Memory-bounded gradients (`PathTracerConfig.remat`) on the mesh of
   phase 2 at 256x256: first a 64x64 x 1 spp fwd+bwd without and twice
   with it (the process's first checkpointed call), then 64 spp fwd+bwd
   with phase 6's compaction, remat off and on in turns (off, on, on,
   off): s/iter, peak memory and launches by kernel of each; image and the
   three gradients `torch.equal` in all four runs; closest_super,
   anyhit_super, cull and scatter launched as often in each, unpack more
   often with remat (the recompute fetches again). One more run with remat
   records its kernel calls: J held against its ordered plain version on
   every cotangent of the checkpointed backward, the first closest-hit and
   any-hit searches (which must hit and occlude some rays), their culls and
   the first gather against theirs. Then 128 spp off and on, and 512 spp with
   `remat` unset: `ops.remat.needed` must choose no checkpoint at 64 spp and
   checkpoints at 512, and the 512-spp peak must be below the 64-spp peak
   without remat; the growth of the peak with spp off and on. Last, the size
   estimate of `remat.needed` on three scenes: Cornell and `sphere_triad`
   (gradients also to the spheres' centres and radii) at 256x256 with
   their own calibrated compaction, remat off at 64 and 128 spp; for them
   and the mesh the peak's growth a spp and the bytes a lane-bounce it
   implies (growth / (W H lanes), lanes counted as `needed` counts them),
   printed beside `GRAPH_BYTES`; none may pass `GRAPH_BYTES / FREE_SHARE`,
   past which a graph that `remat` unset leaves whole could outgrow the
   card's free memory.
15. The threefry kernels (`csrc/rng.cu`; `phase_rng`): every public draw of `core/rng.py` on card keys
   `torch.equal` to its plain version (`_fold_in`, `_uniforms`) on the same
   card tensors, one launch a draw (`LAUNCHES`), in every broadcast form of
   the port's callers, three that take a copy first and a slice of keys, at
   1 to 2^21 keys (batches off the block size too), with keys whose words
   have the high bit set, scalar, tensor (paired with the keys, and against
   one key) and range data, data of 2^31 and above and negative, draw sites
   0, 1, 2, 10, 11, 40-47, 97, 99, 1000-1002 at n = 1, 2, 3. Then each draw
   of the main path at its wavefront sizes (360,000 and 2^19 keys, rotating
   through key buffers of twice the L2): one launch a call (`LAUNCHES`), the
   kernel's time by events and on the device (`queued_ms`: CUDA events
   around calls queued behind a spin of the card; the profiler loses device
   records in this long a process, PERF.md §7), its bound (the keys read
   over 3.35 TB/s, or the SASS's 68 instructions a hash over the dispatch
   slots of 132 SMs x 4 schedulers at 1.98 GHz; a kernel faster than its
   bound fails), and the plain version's times. One JSON line
   `{"rng_kernels": ...}`. The forward and fwd+bwd phases (3-6) also
   require both kernels launched, and the kernels line carries them with
   the launches of phase 3's Cornell frame.
16. The live preview's pass as a CUDA graph (`ops/graph.py`; `phase_graph`):
   Cornell at the preview's 300x300, 1 spp a pass, each pass as the
   benchmark's preview takes it (`render_sample_batch` under `no_grad`,
   `add_frame`, `to_bytes()` copied to the host). Two calls first: the
   first runs eager, the second captures (`graph_captures` 1). Then four
   blocks of `GRAPH_PASSES` passes in turns, eager (`render_flat_pixels`,
   the pass as it ran before graphs), replayed, replayed, eager, each
   replayed block over the sample indices of its eager twin: every replayed
   frame `torch.equal` to the eager one, every replayed pass a replay
   (`graph_replays` one a pass, no capture), `LAUNCHES` and `COUNTERS` a
   pass equal in both; each block's host ms a pass (median, p95), the
   median host ms until the render call returns, and passes a second. Then the profiler over `GRAPH_PROFILED` eager and as many
   replayed passes: kernels and device busy ms a pass, so the line says
   whether the profiler reports a replayed graph's kernels. One JSON line
   `{"graph_preview": ...}`.

Then, on lines of their own: the kernels' JSON record, the nvidia-smi line,
and last `{"ok": true, "device": {...}}`. Exits non-zero without a CUDA
device. Imports no JAX.

    python3 chip_smoke.py --walks LABEL OUT_DIR

times only the flat walks (A beside F, B beside G, A beside M) on Cornell's primary,
tile-ordered primary and shadow rays, the soup's two queries and the
primary and sorted bounce-1 wavefronts of the walk profile's sphere, with
their bounds and flat fan-outs, reached through `_prep` and `_searches`
(`time_flat_walks`); the gather and the two-level walks (D beside H, E
beside I) on the mesh's queries of phase 2 (`time_walks`), with D's
fan-out; the cull kernel (K) on the rays and boxes of every one of those
queries, by events and on the device, with its bound (`time_cull`: it calls
K through the interface of the checkout it runs in); and the scatter-add
(J) on the mesh's and Cornell's primary-hit rows, one row and the light
rows of 8 and 2 lights, with its parts; and the instrumented walks (M) on
every closest-hit query of `time_flat_walks`, by events and on the device,
beside A's time and bound (`time_walk_stats`); one JSON line tagged LABEL.
It saves hashes of A's, B's, K's and M's outputs, D's and E's outputs and
hashes of C's and J's in OUT_DIR or compares them with a run's saved there
(a difference fails the run). To compare two checkouts on one
card, copy this script into the other one's root and run the two in turns
(parent, change, change, parent) with the same OUT_DIR.

A kernel's bound is the larger of two times: the bytes of its inputs and
outputs over the card's memory rate (3.35 TB/s), and the fp32 operations of
the ray-triangle tests that these inputs need over the card's fp32 rate
outside the tensor cores (67 TFLOP/s). The tests a walk needs are counted
ray by ray from this run's data, whatever order a kernel takes them in and
whatever it shares across a tile: a live closest-hit ray needs the 128
triangles of every cluster (flat path: listed for its tile; two-level path:
child of a supercluster listed for its tile) whose box it enters no later
than its final hit; a live any-hit ray that ends unoccluded needs every such
cluster whose box it enters before tmax, and one that ends occluded needs one
cluster; a dead ray needs none. "Enters" is the slab test of `enters`, on
the box as it is: the walks' own box test grows each box by a margin and so
asks for a few more pairs than an answer needs. A fused-cull search needs the same tests as
the list walk on the same rays, plus one slab test (27 fp32 operations: per
axis two subtractions, two products, a minimum, a maximum and two running
extremes, then three comparisons) for every live ray against every live box
of its table; its bytes are its rays (7 rows), the box table, the triangle
table (and the child bounds) and its outputs, once. The cull kernel alone
needs those slab tests and moves its rays (7 rows), the box table, and its
lists, entries, counts and far, once. The instrumented walks compute closest's
function on closest's operands (plus one int a tile), so their bound is
closest's. The gather and the
scatter-add are bound by bytes: each input read once and each output written
once.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
import time
from contextlib import contextmanager
from unittest import mock

# the full-size configuration of the main path
WIDTH = HEIGHT = 256
SPP = 64
DEPTH = 5
WAVEFRONT = 1 << 19         # rays per kernel call on the main path
FIT_SPP = 8                 # samples a train step: one wavefront of 2^19 rays
FIT_LR = 2e-2
FIT_SCALE = 8.0             # Adam moves every coordinate by about lr a step,
                            # whatever its gradient: the fit's mesh is sized
                            # so that lr is small against an edge (0.37), as
                            # a user picks lr for a scene's units. At radius
                            # 1 a step is half an edge, and the noise-driven
                            # walk of 18,768 vertices roughens the mesh
                            # faster than the albedo fit gains.
SMALL = 64                  # side of the kernels-vs-plain comparison renders
GRAPH_SIDE = 300            # the live preview's film (benchmark cornell.preview1)
GRAPH_PASSES = 40           # passes a block of phase 16's turns
GRAPH_PROFILED = 5          # passes a path under the profiler in phase 16
MESH_FACES = 36996          # the face count of the reference's largest model
UNRELATED = 65536 - 37      # rays of a batch of unrelated rays (around the
                            # mesh, through the soup): not a multiple of 128

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
FP32_FLOPS = 67e12          # fp32 outside the tensor cores, same sheet
FLOPS_PER_TEST = 30         # one plane + barycentric ray-triangle test
FLOPS_PER_SLAB = 27         # one ray-box slab test of the in-block cull


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, reps: int = 10) -> float:
    """Mean device milliseconds of fn() over `reps` calls (CUDA events,
    after one warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run_once_ms(fn):
    """(fn(), device milliseconds of that one call)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


@contextmanager
def fused_cull(on=True):
    """Patch `ops.intersect.FUSED_CULL` for the block."""
    from mafrixraytracing_torch.ops import intersect as oi

    before = oi.FUSED_CULL
    oi.FUSED_CULL = on
    try:
        yield
    finally:
        oi.FUSED_CULL = before


@contextmanager
def counting_pytorch_cull(calls):
    """Append the box count of every call of the PyTorch cull (`_cull`) to
    `calls` for the block."""
    from mafrixraytracing_torch.ops import intersect as oi

    real = oi._cull
    with mock.patch.object(oi, "_cull", lambda *a: calls.append(a[3].shape[0]) or real(*a)):
        yield


@contextmanager
def plain_versions():
    """Route the forward kernels' wrappers to their plain PyTorch versions
    (for the comparison renders only, which take no gradient)."""
    from mafrixraytracing_torch.ops import intersect as oi
    from mafrixraytracing_torch.ops import unpack as ou

    with mock.patch.object(oi, "closest_hit", oi.closest_reference), \
            mock.patch.object(oi, "any_hit", oi.anyhit_reference), \
            mock.patch.object(oi, "closest_super_hit", oi.closest_super_reference), \
            mock.patch.object(oi, "any_super_hit", oi.anyhit_super_reference), \
            mock.patch.object(ou, "gather_unpack", ou.fetch_cols_reference):
        yield


def pick(walk):
    """(closest kernel, closest plain, any-hit kernel, any-hit plain) for a
    walk input of the flat or of the two-level path."""
    from mafrixraytracing_torch.ops import intersect as oi

    if oi._is_fused(walk):
        if oi._is_super(walk):
            return (oi.fused_closest_super_kernel, oi.fused_closest_super_reference,
                    oi.fused_anyhit_super_kernel, oi.fused_anyhit_super_reference)
        return (oi.fused_closest_kernel, oi.fused_closest_reference,
                oi.fused_anyhit_kernel, oi.fused_anyhit_reference)
    if oi._is_super(walk):
        return (oi.closest_super_kernel, oi.closest_super_reference,
                oi.anyhit_super_kernel, oi.anyhit_super_reference)
    return (oi.closest_kernel, oi.closest_reference,
            oi.anyhit_kernel, oi.anyhit_reference)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def listed_mask(lists, counts):
    """(tiles, N) bool from a walk's lists (tiles, N) and counts: True where
    the tile lists cluster (or supercluster) n."""
    import torch

    tiles, N = lists.shape
    slot = torch.arange(N, device=lists.device)[None, :] < counts[:, None]
    member = torch.zeros((tiles, N + 1), dtype=torch.bool, device=lists.device)
    member.scatter_(1, torch.where(slot, lists.long(), N), True)
    return member[:, :N]


def enters(bounds, rays, limit):
    """The slab test by which a bound counts the pairs an answer needs:
    (B, S, W) bool, True where ray b enters box j of group s (bounds
    (S, 7, W): min xyz, max xyz, live) no later than `limit` (B,) and leaves
    it after t = 0. The box as it is, with the cull's IEEE reciprocal and the
    two comparisons widened by REFINE_REL * x + REFINE_ABS: the child
    refinement of kernels D and E until their boxes grew a margin. It is kept
    apart from the walks' box test (`ops.intersect.refine_children`), so
    that a change to that test does not move the bound."""
    import torch

    from mafrixraytracing_torch.ops import intersect as oi

    tn = tf = None
    for a in range(3):
        oa = rays[a][:, None, None]
        inv = oi._safe_inverse(rays[3 + a])[:, None, None]
        t0 = (bounds[None, :, a, :] - oa) * inv
        t1 = (bounds[None, :, 3 + a, :] - oa) * inv
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tn = lo if tn is None else torch.maximum(tn, lo)
        tf = hi if tf is None else torch.minimum(tf, hi)
    tn = tn.clamp(min=-oi.BIG)
    tf = tf.clamp(max=oi.BIG)
    lim = limit[:, None, None]
    return ((bounds[None, :, 6, :] > 0.5)
            & (tn <= tf + (oi.REFINE_REL * tf.abs() + oi.REFINE_ABS)) & (tf > 0.0)
            & (tn <= lim + (oi.REFINE_REL * lim + oi.REFINE_ABS)))


def walk_bound(scene, walk, t_min, t_final=None, occ=None, fused_walk=None):
    """The bound of one walk call on these inputs (see the module docstring)
    -> dict(bound_ms, bound_by, ray_cluster_pairs). `t_final` (closest hit:
    the kernel's t, tmax on a miss) or `occ` (any hit) is this run's result.
    With `fused_walk` (the fused kernel's operands for the rays of `walk`)
    the bound is the fused search's: the slab tests are added and the bytes
    are those of its own operands."""
    import torch

    from mafrixraytracing_torch.ops import intersect as oi

    lists, counts, rays = walk[-4], walk[-3], walk[-1]
    tiles, N = lists.shape
    B = rays.shape[1]
    tmax = rays[6]
    bounds = oi.pack_bounds(scene)   # every cluster's box, (S, 7, 16)
    S = bounds.shape[0]
    # member[tile, s, j]: cluster s * 16 + j is listed for the tile
    member = listed_mask(lists, counts)
    if oi._is_super(walk):
        member = member[:, :, None]
    else:
        member = torch.nn.functional.pad(member, (0, S * oi.SUPER - N))
        member = member.reshape(tiles, S, oi.SUPER)
    live = tmax > t_min
    if occ is None:
        limit = torch.where(live, t_final, -oi.BIG)
        pairs = 0
    else:
        limit = torch.where(live & ~occ, tmax, -oi.BIG)
        pairs = int(occ.sum())
    step = 1 << 16
    for s in range(0, B, step):
        e = min(B, s + step)
        keep = enters(bounds, rays[:, s:e], limit[s:e])
        keep = keep.reshape(-1, oi.TILE, S, oi.SUPER)
        pairs += int((keep & member[s // oi.TILE:e // oi.TILE, None]).sum())
    flops = pairs * oi.CLUSTER_SIZE * FLOPS_PER_TEST
    out_bytes = B * (8 if occ is None else 1)
    in_bytes = nbytes(*walk)
    extra = {}
    if fused_walk is not None:
        slabs = int(live.sum()) * int((fused_walk[-2][6] > 0.5).sum())
        flops += slabs * FLOPS_PER_SLAB
        in_bytes = nbytes(*fused_walk) - 4 * B      # the far row is not read
        extra = dict(ray_box_slabs=slabs)
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S
    t_flops = flops / FP32_FLOPS
    return dict(bound_ms=1e3 * max(t_bytes, t_flops),
                bound_by="operations" if t_flops >= t_bytes else "bytes",
                ray_cluster_pairs=pairs, **extra)


def count_asks(walk, limit):
    """The children a two-level walk input's rays ask for, counted in PyTorch:
    `refine_children` at `limit` (B,) over each tile's listed superclusters ->
    ((ray, child) pairs asked, children asked by some ray of the tile, summed
    over the tiles). The second is what a walk that stages every child any
    ray of its tile asks for stages."""
    import torch

    from mafrixraytracing_torch.ops import intersect as oi

    bounds, lists, counts, rays = walk[1], walk[2], walk[3], walk[5]
    S = lists.shape[1]
    member = listed_mask(lists, counts)[:, :, None]
    staged = asked = 0
    step = 1 << 16
    for s in range(0, rays.shape[1], step):
        e = min(rays.shape[1], s + step)
        keep = oi.refine_children(bounds, rays[:, s:e], limit[s:e])
        keep = keep.reshape(-1, oi.TILE, S, oi.SUPER) & member[s // oi.TILE:e // oi.TILE, None]
        asked += int(keep.sum())
        staged += int(keep.any(dim=1).sum())
    return asked, staged


def anyhit_fanout(walk, t_min, needed_pairs):
    """The fan-out of a two-level any-hit input: per tile, the children that a
    walk staging every child any ray of the tile asks for would stage (at
    limit tmax: an upper bound, since a blocked ray stops asking and the walk
    stops at its exit), and the (ray, child) pairs those rays ask for.
    pairs / (128 x staged) is the share of a 128-lane block that such a walk
    keeps busy; `needed_pairs` (`walk_bound`'s count) is what the answer
    needs."""
    import torch

    from mafrixraytracing_torch.ops import intersect as oi

    rays = walk[5]
    asked, staged = count_asks(walk, torch.where(rays[6] > t_min, rays[6], -oi.BIG))
    tiles = walk[2].shape[0]
    return dict(tiles=tiles, children_staged=staged, pairs_asked=asked,
                pairs_needed=needed_pairs,
                lane_use=asked / max(1, oi.TILE * staged),
                needed_share=needed_pairs / max(1, oi.TILE * staged))


def print_fanout(f, label):
    print(f"  anyhit_super fan-out {label}: {f['tiles']} tiles, children staged a tile "
          f"{f['children_staged'] / f['tiles']:.2f} (upper bound), (ray, child) pairs "
          f"asked {f['pairs_asked']} ({f['pairs_asked'] / f['tiles']:.1f} a tile), "
          f"needed {f['pairs_needed']}; lanes busy a staged child "
          f"{f['lane_use']:.4f} (asked), {f['needed_share']:.4f} (needed)")


def closest_fanout(walk, t_min, t_final, needed_pairs):
    """The fan-out of a two-level closest-hit input. A ray asks for a
    supercluster's children against its best at the start of that
    supercluster, which lies between its final t and its tmax, so each count
    comes twice: at the final t (a lower bound) and at tmax (an upper bound).
    Per tile: the children a walk staging every child any ray of the tile
    asks for stages, and the (ray, child) pairs asked; `needed_pairs`
    (`walk_bound`'s count, at the final t) is what the answer needs."""
    import torch

    from mafrixraytracing_torch.ops import intersect as oi

    rays = walk[5]
    live = rays[6] > t_min
    lo = count_asks(walk, torch.where(live, t_final, -oi.BIG))
    hi = count_asks(walk, torch.where(live, rays[6], -oi.BIG))
    tiles = walk[2].shape[0]
    return dict(tiles=tiles, children_staged_lo=lo[1], children_staged_hi=hi[1],
                pairs_asked_lo=lo[0], pairs_asked_hi=hi[0], pairs_needed=needed_pairs,
                lane_use_lo=lo[0] / max(1, oi.TILE * lo[1]),
                lane_use_hi=hi[0] / max(1, oi.TILE * hi[1]))


def print_closest_fanout(f, label):
    n = f["tiles"]
    print(f"  closest_super fan-out {label}: {n} tiles, children staged a tile "
          f"{f['children_staged_lo'] / n:.2f} (at the final t) to "
          f"{f['children_staged_hi'] / n:.2f} (at tmax), (ray, child) pairs asked a tile "
          f"{f['pairs_asked_lo'] / n:.1f} to {f['pairs_asked_hi'] / n:.1f} "
          f"({f['pairs_asked_lo']} to {f['pairs_asked_hi']}), needed {f['pairs_needed']}; "
          f"lanes busy a staged child {f['lane_use_lo']:.4f} to {f['lane_use_hi']:.4f}")


def flat_fanout(scene, walk, t_min, needed_pairs, t_final=None):
    """The fan-out of a flat walk input (kernel A's or B's operands), counted
    in PyTorch: the tiles that list a cluster, the clusters listed a tile,
    the (ray, cluster) pairs that a walk holding a ray a thread tests (every
    listed cluster against the tile's 128 rays: an upper bound, since the
    exit may stop it earlier), the pairs whose ray asks for the cluster (the
    walks' box test, `refine_children` on the cluster boxes, over each
    tile's list: at tmax, an upper bound for both walks, and with `t_final`
    at the closest-hit walk's final t, a lower bound) and `needed_pairs`
    (`walk_bound`'s count). It reads only the lists, counts and rays of
    `walk`, so it counts a parent checkout's operands too (t_min >= 0)."""
    import torch

    from mafrixraytracing_torch.ops import intersect as oi

    lists, counts, rays = walk[-4], walk[-3], walk[-1]
    tiles, C = lists.shape
    boxes = oi.pack_aabbs(scene.cluster_min, scene.cluster_max)[None, :oi.BOUNDS_ROWS, :C]
    member = listed_mask(lists, counts)
    live = rays[6] > t_min

    def asked(limit):
        n = 0
        step = 1 << 16
        for s in range(0, rays.shape[1], step):
            e = min(rays.shape[1], s + step)
            keep = oi.refine_children(boxes, rays[:, s:e], limit[s:e])[:, 0]
            keep = keep.reshape(-1, oi.TILE, C) & member[s // oi.TILE:e // oi.TILE, None]
            n += int(keep.sum())
        return n

    f = dict(tiles=tiles, tiles_listing=int((counts > 0).sum()),
             listed_a_tile=float(counts.float().mean()),
             ray_a_thread_pairs=int(counts.sum()) * oi.TILE,
             asked_at_tmax=asked(torch.where(live, rays[6], -oi.BIG)),
             pairs_needed=needed_pairs)
    if t_final is not None:
        f["asked_at_final_t"] = asked(torch.where(live, t_final, -oi.BIG))
    return f


def print_flat_fanout(f, label):
    lo = f.get("asked_at_final_t")
    print(f"  flat fan-out {label}: {f['tiles_listing']} of {f['tiles']} tiles list a "
          f"cluster, {f['listed_a_tile']:.2f} listed a tile; (ray, cluster) pairs tested by "
          f"a walk that holds a ray a thread {f['ray_a_thread_pairs']} (listed x 128), "
          f"asked " + ("" if lo is None else f"{lo} (at the final t) to ")
          + f"{f['asked_at_tmax']} (at tmax), needed {f['pairs_needed']}")


def compare_closest(walk, t_min, label, same_as=None):
    """A closest-hit kernel against its plain version on one walk input, bit
    for bit, and (`same_as`: another kernel's (t, idx) on the same rays) bit
    for bit against that kernel. Returns (max |dt|, t, idx, the plain
    version's ms)."""
    import torch

    kernel, plain, _, _ = pick(walk)
    tk, ik = kernel(*walk, t_min)
    torch.cuda.synchronize()
    (tp, ip), plain_ms = run_once_ms(lambda: plain(*walk, t_min))
    tie = (tk - tp).abs() <= 1e-5
    bad_idx = int(((ik != ip) & ~tie).sum())
    t_ok = torch.isclose(tk, tp, rtol=1e-4, atol=1e-5).all().item()
    err = float((tk - tp).abs().max())
    n_hit = int((ik >= 0).sum())
    exact = bool((ik == ip).all()) and torch.equal(tk, tp)
    print(f"  closest {label}: B={tk.shape[0]} hits={n_hit} max|dt|={err:.3g} "
          f"idx mismatches (non-tie)={bad_idx} bit-equal to plain={exact}"
          + ("" if same_as is None else
             f" bit-equal to the list kernel={torch.equal(tk, same_as[0]) and torch.equal(ik, same_as[1])}"))
    check(bad_idx == 0 and t_ok, f"closest kernel disagrees on {label}")
    check(exact, f"closest kernel is not bit-equal to its plain version on {label}")
    if same_as is not None:
        check(torch.equal(tk, same_as[0]) and torch.equal(ik, same_as[1]),
              f"fused closest kernel differs from the list kernel on {label}")
    return err, tk, ik, plain_ms


def compare_anyhit(walk, t_min, label, same_as=None):
    """An any-hit kernel against its plain version and (`same_as`) against
    another kernel's result on the same rays. Returns (error flag, occ, the
    plain version's ms)."""
    import torch

    _, _, kernel, plain = pick(walk)
    ok_ = kernel(*walk, t_min)
    torch.cuda.synchronize()
    op, plain_ms = run_once_ms(lambda: plain(*walk, t_min))
    diff = int((ok_ != op).sum())
    print(f"  anyhit {label}: B={ok_.shape[0]} occluded={int(ok_.sum())} "
          f"mismatches={diff}"
          + ("" if same_as is None else
             f" equal to the list kernel={torch.equal(ok_, same_as)}"))
    check(diff == 0, f"any-hit kernel disagrees on {label}")
    if same_as is not None:
        check(torch.equal(ok_, same_as),
              f"fused any-hit kernel differs from the list kernel on {label}")
    return float(diff > 0), ok_, plain_ms


def cull_boxes(scene, walk):
    """The boxes the cull of a list walk's operands took: the superclusters'
    on the two-level path, the clusters' on the flat one."""
    from mafrixraytracing_torch.ops import intersect as oi

    return ((scene.super_min, scene.super_max) if oi._is_super(walk)
            else (scene.cluster_min, scene.cluster_max))


def cull_and_convert(scene, walk):
    """The PyTorch cull (`_cull`) on a list walk's rays, its lists and counts
    as int32, its entries contiguous and its `far` stacked into the rays:
    what `_prep` did before kernel K was its cull, and does on the CPU and
    for more than 128 boxes."""
    import torch

    from mafrixraytracing_torch.core.v3 import V3
    from mafrixraytracing_torch.ops import intersect as oi

    r = walk[-1]
    lists, counts, entries, far = oi._cull(V3(r[0], r[1], r[2]), V3(r[3], r[4], r[5]),
                                           r[6], *cull_boxes(scene, walk))
    return (lists.to(torch.int32), counts.to(torch.int32), entries.contiguous(),
            torch.stack([*r[:7], far]))


def cull_bound(boxes, rays, t_min, outputs):
    """Kernel K's bound on these operands: the larger of its bytes (the rays'
    7 rows, the boxes and its outputs, once) over the memory rate and of 27
    fp32 operations a slab test of a live ray (tmax > t_min) against a live
    box (min x <= max x) over the fp32 rate."""
    live_boxes = int((boxes[0][:, 0] <= boxes[1][:, 0]).sum())
    slabs = int((rays[6] > t_min).sum()) * live_boxes
    moved = (nbytes(rays) - 4 * rays.shape[1]) + nbytes(*boxes, *outputs)
    t_bytes, t_flops = moved / HBM_BYTES_PER_S, slabs * FLOPS_PER_SLAB / FP32_FLOPS
    return dict(bound_ms=1e3 * max(t_bytes, t_flops),
                bound_by="operations" if t_flops >= t_bytes else "bytes",
                ray_box_slabs=slabs, bytes_moved=moved)


def compare_cull(scene, lwalk, t_min, label, timed):
    """Kernel K on the rays and boxes of one list walk (the operands `_prep`
    made, its lists K's own): lists, counts, entries and far `torch.equal`
    to `cull_reference`, to the PyTorch cull's operands (`cull_and_convert`)
    and to `_prep`'s. With `timed`: its time by CUDA events and on the device
    (the profiler's time of `cull_kernel`), the plain version's, and its
    bound (`cull_bound`)."""
    import torch

    from mafrixraytracing_torch.ops import intersect as oi

    boxes, rays = cull_boxes(scene, lwalk), lwalk[-1]
    n_box = boxes[0].shape[0]
    got = oi.cull_kernel(*boxes, rays)
    torch.cuda.synchronize()
    want, plain_ms = run_once_ms(lambda: oi.cull_reference(*boxes, rays))
    names = ("lists", "counts", "entries", "far")
    same = {n: torch.equal(g, w) for n, g, w in zip(names, got, want)}
    pytorch = cull_and_convert(scene, lwalk)
    fed = all(torch.equal(g, w) for g, w in zip(got, (*pytorch[:3], pytorch[3][7])))
    prep = all(torch.equal(g, w) for g, w in zip(got, (*lwalk[-4:-1], rays[7])))
    err = max(float((got[2] - want[2]).abs().max()), float((got[3] - want[3]).abs().max()))
    print(f"  cull {label}: B={rays.shape[1]} boxes={n_box} survivors a tile "
          f"{float(got[1].float().mean()):.2f} equal to plain={same} equal to the "
          f"PyTorch cull's operands={fed} equal to _prep's={prep}")
    check(all(same.values()), f"cull kernel differs from its plain version on {label}")
    check(fed, f"cull kernel differs from the PyTorch cull's operands on {label}")
    check(prep, f"cull kernel differs from the operands of _prep on {label}")
    if not timed:
        return dict(max_abs_err=err)
    return dict(max_abs_err=err, ms=time_ms(lambda: oi.cull_kernel(*boxes, rays)),
                device_ms=kernel_device_ms(torch, lambda: oi.cull_kernel(*boxes, rays),
                                           "cull_kernel"),
                plain_ms=plain_ms, library_ms=None,
                cull_in_pytorch_ms=time_ms(lambda: oi.cull_reference(*boxes, rays)),
                **cull_bound(boxes, rays, t_min, got))


def print_cull(r, where):
    print(f"  cull: kernel {r['ms']:.4f} ms by events, {r['device_ms']:.4f} ms on the "
          f"device, against the PyTorch cull with its conversions "
          f"{r['cull_in_pytorch_ms']:.4f} ms (once: {r['plain_ms']:.4f} ms), bound "
          f"{r['bound_ms']:.5f} ms by {r['bound_by']} ({r['bound_ms'] / r['device_ms']:.3f} "
          f"of it on the device; {r['ray_box_slabs']} ray-box slab tests, "
          f"{r['bytes_moved']} bytes) ({where})")


def compare_walk_stats(scene, walk, t_min, label, closest_out, timed):
    """The counting walk and the walk without early exit on kernel A's
    operands: `(t, idx)` bit-equal to A's (`closest_out`) and to their plain
    versions', `walked` equal to the plain version's and at most the count.
    -> {name: record}; with `timed`, times and A's bound."""
    import torch

    from mafrixraytracing_torch.ops import intersect as oi

    ta, ia = closest_out
    td, id_, walked = oi.closest_dbg_kernel(*walk, t_min)
    tf, if_ = oi.closest_full_kernel(*walk, t_min)
    torch.cuda.synchronize()
    (tp, ip, wp), dbg_plain_ms = run_once_ms(lambda: oi.closest_dbg_reference(*walk, t_min))
    (tq, iq), full_plain_ms = run_once_ms(lambda: oi.closest_full_reference(*walk, t_min))
    counts = walk[-3]
    ok = dict(
        dbg_is_closest=torch.equal(td, ta) and torch.equal(id_, ia),
        full_is_closest=torch.equal(tf, ta) and torch.equal(if_, ia),
        dbg_is_plain=torch.equal(td, tp) and torch.equal(id_, ip),
        full_is_plain=torch.equal(tf, tq) and torch.equal(if_, iq),
        walked_is_plain=torch.equal(walked, wp),
        walked_within_count=bool((walked <= counts).all()))
    print(f"  walk statistics {label}: B={ta.shape[0]} listed a tile "
          f"{float(counts.float().mean()):.2f} walked a tile "
          f"{float(walked.float().mean()):.2f} (max {int(walked.max())}) {ok}")
    check(all(ok.values()), f"an instrumented walk disagrees on {label}: {ok}")
    errs = {"closest_dbg": float((td - tp).abs().max()),
            "closest_full": float((tf - tq).abs().max())}
    if not timed:
        return {k: dict(max_abs_err=e) for k, e in errs.items()}
    bound = walk_bound(scene, walk, t_min, t_final=ta)
    live = (walk[-1][6] > t_min).reshape(-1, oi.TILE).sum(dim=1)
    dbg = lambda: oi.closest_dbg_kernel(*walk, t_min)  # noqa: E731
    full = lambda: oi.closest_full_kernel(*walk, t_min)  # noqa: E731
    out = {
        "closest_dbg": dict(max_abs_err=errs["closest_dbg"], plain_ms=dbg_plain_ms,
                            ms=time_ms(dbg), device_ms=kernel_device_ms(
                                torch, dbg, "closest_stats_kernel<true>")),
        "closest_full": dict(max_abs_err=errs["closest_full"], plain_ms=full_plain_ms,
                             ms=time_ms(full), device_ms=kernel_device_ms(
                                 torch, full, "closest_stats_kernel<false>"),
                             ray_cluster_pairs_listed=int((live * counts).sum()))}
    for r in out.values():
        r.update(library_ms=None, **bound)
    return out


def fused_vs_list(scene, o, d, t_max, anyhit, lwalk, list_out, t_min, label,
                  timed=True):
    """The fused kernel of `lwalk`'s path on the same rays: bit-equal to its
    plain version and to the list kernel's `list_out`; kernel K on `lwalk`'s
    rays (`compare_cull`); with `timed`, the fused kernel's time, the list
    kernel's, K's, and the fused kernel's bound."""
    import torch

    from mafrixraytracing_torch.ops import intersect as oi

    fwalk, *_ = oi._prep(scene, o, d, t_min, t_max, anyhit=anyhit, fused=True)
    check(oi._is_fused(fwalk) and oi._is_super(fwalk) == oi._is_super(lwalk),
          "the fused operands are not those of the list walk's path")
    check(torch.equal(fwalk[-1][:7], lwalk[-1][:7]), "the two paths' rays differ")
    cull = compare_cull(scene, lwalk, t_min, label, timed)
    if anyhit:
        err, occ, plain_ms = compare_anyhit(fwalk, t_min, label + ", fused",
                                            same_as=list_out)
        result = dict(occ=occ)
    else:
        err, t, _, plain_ms = compare_closest(fwalk, t_min, label + ", fused",
                                              same_as=list_out)
        result = dict(t_final=t)
    if not timed:
        return dict(max_abs_err=err, cull=cull)
    k = 2 if anyhit else 0
    fused_kernel, list_kernel = pick(fwalk)[k], pick(lwalk)[k]
    ms_list = time_ms(lambda: list_kernel(*lwalk, t_min))
    ms = time_ms(lambda: fused_kernel(*fwalk, t_min))
    bound = walk_bound(scene, lwalk, t_min, fused_walk=fwalk, **result)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                list_kernel_ms=ms_list, cull_ms=cull["ms"], cull=cull, **bound)


def print_fused(name, r, where):
    print(f"  {name}: kernel {r['ms']:.4f} ms against the cull kernel "
          f"{r['cull_ms']:.4f} ms + list kernel {r['list_kernel_ms']:.4f} ms "
          f"= {r['cull_ms'] + r['list_kernel_ms']:.4f} ms; plain "
          f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms by {r['bound_by']} "
          f"({r['ray_cluster_pairs']} ray-cluster pairs, {r['ray_box_slabs']} "
          f"ray-box slab tests) ({where})")


def soup_scene(device):
    """8,192 small random triangles (64 clusters), from a numpy seed."""
    import numpy as np

    from mafrixraytracing_torch.scene import spec as S
    from mafrixraytracing_torch.scene.compiler import compile_scene

    rs = np.random.default_rng(1234)
    n = 8192
    centers = rs.uniform(-1.0, 1.0, (n, 1, 3))
    verts = (centers + rs.normal(0.0, 0.04, (n, 3, 3))).reshape(-1, 3)
    mesh = S.Mesh(vertices=verts.astype(np.float32),
                  faces=np.arange(3 * n, dtype=np.int32).reshape(n, 3))
    spec = S.SceneSpec(shapes=[S.ShapeSpec(mesh=mesh, material=0)])
    return compile_scene(spec, device=device).scene


def mesh_obj(scale=1.0) -> str:
    """The path of the mesh's OBJ at `scale` in the temp directory, written
    there at the first call: the benchmark's displaced sphere of 136 x 136
    quads and a tetrahedron (MESH_FACES = 36,996 faces, with uvs; bumps from
    seed 2024) of radius `scale` (`benchmark/scenes.py`)."""
    from benchmark import scenes

    name = "mafrix_torch_mesh36996" + (f"_x{scale:g}" if scale != 1.0 else "")
    path = os.path.join(tempfile.gettempdir(), name + ".obj")
    if not os.path.exists(path):
        # written under another name first: a file at `path` is complete
        part = f"{path}.{os.getpid()}.part"
        scenes.write_mesh_obj(part, 136, 2024, scale)
        os.replace(part, path)
    return path


def mesh_spec(width, height, textured=False, scale=1.0):
    """The mesh scene: the OBJ above, written to the temp directory and
    loaded through the port's OBJ loader and `mesh_scene`, which frames and
    lights it by its size, so `scale` changes the units and not the picture."""
    from mafrixraytracing_torch.materials.texture import checker_texture
    from mafrixraytracing_torch.scene.assets import mesh_scene

    spec = mesh_scene(mesh_obj(scale), width, height)
    if textured:
        spec.materials[0].texture_id = 0
        spec.textures.append(checker_texture(tiles=16))
    return spec


def time_library_gather(table, idx):
    """The one PyTorch call that computes the gather-unpack."""
    return time_ms(lambda: table.index_select(0, idx).t().contiguous())


def gather_bound(table, idx):
    out_bytes = 36 * idx.shape[0] * 4
    return dict(bound_ms=1e3 * (nbytes(table, idx) + out_bytes) / HBM_BYTES_PER_S,
                bound_by="bytes")


def scatter_bound(cols, B, P):
    """(K B + P K) 4 + 8 B bytes: the cotangents and the int64 indices read
    once, the table written once. The sort's traffic is the design's cost,
    not the function's."""
    return dict(bound_ms=1e3 * ((cols * B + P * cols) * 4 + 8 * B) / HBM_BYTES_PER_S,
                bound_by="bytes")


def compare_scatter(torch, idx, P, cols, label, gen, dead=0.0, rows_layout=False,
                    ct=None):
    """The scatter-add kernel on one input: `torch.equal` to
    `scatter_rows_ordered_reference` (its own sum order), it and its plain
    version (`index_add_`) each against a float64 sum on the card; two
    launches must be bit-equal. The cotangents are `ct` (a path's own), else
    drawn from `gen`. Returns (max |kernel - plain|, ct, kernel output)."""
    from mafrixraytracing_torch.ops import unpack as ou

    B = idx.shape[0]
    if ct is None:
        ct = torch.randn((cols, B), generator=gen, device=idx.device)
        if dead:
            live = torch.rand(B, generator=gen, device=idx.device) >= dead
            ct = ct * live
        if rows_layout:     # the same values stored as (B, K) rows: a strided view
            ct = ct.t().contiguous().t()
    out = ou.scatter_kernel(ct, idx, P)
    torch.cuda.synchronize()
    again = ou.scatter_kernel(ct, idx, P)
    ordered = torch.equal(out, ou.scatter_rows_ordered_reference(ct, idx, P))
    plain = ou.scatter_rows_reference(ct, idx, P)
    oracle = torch.zeros((P, cols), dtype=torch.float64, device=idx.device)
    oracle.index_add_(0, idx, ct.t().double())
    mass = torch.zeros_like(oracle).index_add_(0, idx, ct.t().double().abs())
    tol = 1e-5 * mass + 1e-6
    err_o = (out.double() - oracle).abs()
    err_p = (plain.double() - oracle).abs()
    diff = float((out - plain).abs().max())
    print(f"  scatter {label}: B={B} P={P} K={cols} rows hit={int((mass[:, 0] > 0).sum())} "
          f"equal to the ordered reference={ordered} "
          f"max|kernel-f64|={float(err_o.max()):.3g} max|plain-f64|={float(err_p.max()):.3g} "
          f"max|kernel-plain|={diff:.3g} bit-equal twice={bool(torch.equal(out, again))}")
    check(ordered, f"scatter kernel differs from scatter_rows_ordered_reference on {label}")
    check(bool((err_o <= tol).all()), f"scatter kernel is outside tolerance on {label}")
    check(bool((err_p <= tol).all()), f"scatter plain version is outside tolerance on {label}")
    check(torch.equal(out, again), f"scatter kernel is not reproducible on {label}")
    return diff, ct, out


def scatter_parts(torch, ct, idx, P, label):
    """Kernel J's time through its wrapper and its parts, each timed alone
    (CUDA events, `time_ms`): the stable sort, `searchsorted`, pass 1 and
    pass 2 (on what pass 1 wrote); "rest" is what the wrapper's other
    launches (`zeros`, `arange`, `clamp`, the cast) add. A part shorter than
    its launch from Python measures the host's launch rate there, so the
    same parts also come from the profiler's device time (`profiled_parts`,
    "device"). With its bound."""
    from mafrixraytracing_torch.ops import unpack as ou

    K, B = ct.shape
    values, perm, starts = ou.scatter_order(idx, P)
    out = torch.zeros((P, K), device=ct.device)
    part, span = ou.scatter_scratch(ct)
    keys = idx.clamp(0, P - 1).to(torch.int32)
    rows = torch.arange(P + 1, dtype=torch.int32, device=ct.device)
    ou.scatter_passes(ct, values, perm, starts, P, out, part, span, 1)
    r = {"J": time_ms(lambda: ou.scatter_kernel(ct, idx, P)),
         "sort": time_ms(lambda: torch.sort(keys, stable=True)),
         "searchsorted": time_ms(lambda: torch.searchsorted(values, rows)),
         "pass 1": time_ms(lambda: ou.scatter_passes(ct, values, perm, starts, P, out,
                                                     part, span, 1)),
         "pass 2": time_ms(lambda: ou.scatter_passes(ct, values, perm, starts, P, out,
                                                     part, span, 2))}
    r["rest"] = r["J"] - r["sort"] - r["searchsorted"] - r["pass 1"] - r["pass 2"]
    r["device"] = profiled_parts(torch, lambda: ou.scatter_kernel(ct, idx, P))
    r["device_ms"] = sum(r["device"].values())
    r.update(scatter_bound(K, B, P))
    print(f"  J {label} (B = {B:,}, P = {P:,}, K = {K}): {r['J']:.4f} ms = sort "
          f"{r['sort']:.4f} + searchsorted {r['searchsorted']:.4f} + pass 1 "
          f"{r['pass 1']:.4f} + pass 2 {r['pass 2']:.4f} + rest {r['rest']:.4f}; "
          f"bound {r['bound_ms']:.5f} ms ({r['bound_ms'] / r['J']:.3f} of it); on the "
          f"device {r['device_ms']:.4f} ms = "
          + " + ".join(f"{k} {v:.4f}" for k, v in sorted(r["device"].items())))
    return r


def phase_scatter(torch, dev, records, mesh_idx, mesh_P, cornell_idx, cornell_P):
    """Kernel J on the main path's index sets and on synthetic ones, each
    input compared and timed with its parts."""
    from mafrixraytracing_torch.ops import unpack as ou

    gen = torch.Generator(device=dev).manual_seed(31)
    B = mesh_idx.shape[0]
    one_row = torch.full((B,), 77, dtype=torch.int64, device=dev)
    # (label, idx, P, K, ~dead share, rows layout): the mesh's and Cornell's
    # primary-hit rows, one row for every ray, a non-aligned slice and a
    # compacted size with ~10% dead lanes of zero cotangent, the light rows of
    # 8 and of 2 lights (16 columns, rows), the vertex gather (3 columns)
    inputs = [("mesh primary hits", mesh_idx, mesh_P, 36, 0.0, False),
              ("cornell primary hits", cornell_idx, cornell_P, 36, 0.0, False),
              ("one row", one_row, cornell_P, 36, 0.0, False),
              ("non-aligned slice", mesh_idx[:500_001].contiguous(), mesh_P, 36, 0.1, False),
              ("compacted size", mesh_idx[:1024 * 137].contiguous(), mesh_P, 36, 0.1, False),
              ("light rows", torch.randint(0, 8, (B,), generator=gen, device=dev),
               8, 16, 0.0, True),
              ("light rows of one quad", torch.randint(0, 2, (B,), generator=gen, device=dev),
               2, 16, 0.0, True),
              ("vertex gather", torch.randint(0, 18_768, (3 * 65_536,), generator=gen,
                                              device=dev), 18_768, 3, 0.0, True)]
    errs, parts, cts = [], {}, {}
    for label, idx, P, K, dead, rows_layout in inputs:
        err, cts[label], _ = compare_scatter(torch, idx, P, K, label, gen, dead=dead,
                                             rows_layout=rows_layout)
        errs.append(err)
        parts[label] = scatter_parts(torch, cts[label], idx, P, label)
    ct, ct_c = cts["mesh primary hits"], cts["cornell primary hits"]
    ms_p = time_ms(lambda: ou.scatter_rows_reference(ct, mesh_idx, mesh_P))
    ms_l = time_ms(lambda: torch.zeros((mesh_P, 36), device=dev)
                   .index_add_(0, mesh_idx, ct.t()))
    ms_cl = time_ms(lambda: torch.zeros((cornell_P, 36), device=dev)
                    .index_add_(0, cornell_idx, ct_c.t()))
    mesh = parts["mesh primary hits"]
    records["scatter"] = dict(max_abs_err=max(errs), ms=mesh["J"], plain_ms=ms_p,
                              library_ms=ms_l, bound_ms=mesh["bound_ms"],
                              bound_by=mesh["bound_by"], device_ms=mesh["device_ms"])
    print(f"  scatter: kernel {mesh['J']:.4f} ms, plain {ms_p:.4f} ms, library "
          f"{ms_l:.4f} ms, bound {mesh['bound_ms']:.5f} ms by bytes (mesh, B = {B:,}, "
          f"P = {mesh_P:,}); Cornell (P = {cornell_P}): kernel "
          f"{parts['cornell primary hits']['J']:.4f} ms, library {ms_cl:.4f} ms")


def compare_pure_unpack(torch, dev):
    """The gather kernel at the contract of the Pallas unpack kernels: rows
    (B, 36) -> 36 columns, B a multiple of 1024, no gather (idx = arange)."""
    from mafrixraytracing_torch.ops import unpack as ou

    B = 512 * 1024
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = torch.randn((B, 36), generator=gen, device=dev)
    idx = torch.arange(B, device=dev)
    out = ou.unpack_kernel(rows, idx)
    torch.cuda.synchronize()
    same = torch.equal(out, rows.t())
    n = B - 3      # column segments that start off a 16-byte boundary
    same_n = torch.equal(ou.unpack_kernel(rows[:n], idx[:n]), rows[:n].t())
    ms = time_ms(lambda: ou.unpack_kernel(rows, idx))
    ms_l = time_ms(lambda: rows.t().contiguous())
    bound = 1e3 * (2 * rows.numel() * 4 + 8 * B) / HBM_BYTES_PER_S
    print(f"  unpack as a pure (B, 36) -> (36, B) unpack, B = {B:,}: bit-equal to "
          f"the transpose={same} (at B = {n:,}: {same_n}), kernel {ms:.4f} ms, library "
          f"(rows.t().contiguous()) {ms_l:.4f} ms, bound {bound:.5f} ms by bytes "
          f"({bound / ms:.3f} of it)")
    check(same and same_n, "unpack kernel is not bit-equal to the transpose")


def wavefront_uv(torch, dev, gen):
    """Film coordinates of one wavefront in the integrator's ray order: the
    pixels in tile order, each carrying G consecutive jittered samples, so a
    128-ray tile is a compact screen block (`integrator.path.render_image`)."""
    from mafrixraytracing_torch.integrator import path as P

    G = P._spp_group(SPP, WIDTH * HEIGHT, WAVEFRONT)
    perm, _ = P.tiled_pixel_order(WIDTH, HEIGHT, *P._spp_tile_shape(G))
    px, py = P.make_pixel_uv(WIDTH, HEIGHT, dev)
    perm = torch.as_tensor(perm, device=dev)
    px, py = px[perm].repeat_interleave(G), py[perm].repeat_interleave(G)
    n = px.shape[0]
    return ((px + torch.rand(n, generator=gen, device=dev)) / WIDTH,
            (py + torch.rand(n, generator=gen, device=dev)) / HEIGHT)


def cornell_rays(torch, dev, cs, t_min):
    """Cornell's queries of phase 2, made from seeds -> {name: (o, d, t_max)}:
    "primary", one wavefront of uniform random pixels (the kind of input of
    the bounces >= 1: neighbouring rays lie far apart); "tiled", one
    wavefront in the main path's size and ray order (its bounce 0);
    "shadow", NEE-like shadow rays from the primary hits toward points on the
    light; and "primary_hits", the primary rays' triangle indices."""
    from mafrixraytracing_torch.core.v3 import V3
    from mafrixraytracing_torch.ops import intersect as oi

    gen = torch.Generator(device=dev).manual_seed(7)
    B = WAVEFRONT
    u = torch.rand(B, generator=gen, device=dev)
    v = torch.rand(B, generator=gen, device=dev)
    o, d = cs.camera.get_rays(u, v)
    t_hit, i_hit = oi.find_closest_soa(cs.scene, o, d, t_min, 1e8)
    hit = i_hit >= 0
    p = o + d * torch.where(hit, t_hit, 0.0)
    lx = (torch.rand(B, generator=gen, device=dev) - 0.5) * 0.47
    lz = (torch.rand(B, generator=gen, device=dev) - 0.5) * 0.47
    to_l = V3(lx - p.x, 1.98 - p.y, lz - p.z)
    dist = torch.sqrt(to_l.x**2 + to_l.y**2 + to_l.z**2)
    sd = V3(to_l.x / dist, to_l.y / dist, to_l.z / dist)
    so = p + sd * 1e-3
    s_tmax = torch.where(hit, dist - 2e-3, 0.0)
    ut, vt = wavefront_uv(torch, dev, torch.Generator(device=dev).manual_seed(13))
    ot, dt = cs.camera.get_rays(ut, vt)
    return dict(primary=(o, d, 1e8), tiled=(ot, dt, 1e8), shadow=(so, sd, s_tmax),
                primary_hits=i_hit)


def soup_rays(torch, dev):
    """The soup's queries of phase 2: (o, d, closest-hit t_max, any-hit
    t_max) for a non-aligned batch of unrelated rays, ~10% dead."""
    import numpy as np

    from mafrixraytracing_torch.core.v3 import V3

    rs = np.random.default_rng(99)
    Bs = UNRELATED
    so_np = rs.uniform(-1.5, 1.5, (Bs, 3)).astype(np.float32)
    sd_np = rs.normal(size=(Bs, 3)).astype(np.float32)
    sd_np /= np.linalg.norm(sd_np, axis=1, keepdims=True)
    dead = rs.random(Bs) < 0.1
    tmax_c = np.where(dead, 0.0, 1e8).astype(np.float32)
    tmax_a = np.where(dead, 0.0, rs.uniform(0.0, 2.0, Bs)).astype(np.float32)
    to = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return V3.of(to(so_np)), V3.of(to(sd_np)), to(tmax_c), to(tmax_a)


def mesh_rays(torch, dev, cs, t_min):
    """The mesh's queries of phase 2, made from seeds -> {name: (o, d, t_max)}:
    "primary", one wavefront in the main path's size and order; "shadow",
    NEE-like shadow rays from the primary hits toward points on the light;
    "shadow_cut", the same less the last 287 (a batch that is not a multiple
    of the tile, whose last tile is padded with dead rays); "incoherent" and
    "incoherent_shadow", a non-aligned batch of unrelated rays around the mesh
    with ~10% dead, the second with shorter t_max; and "primary_hits", the
    primary rays' triangle indices."""
    import numpy as np

    from mafrixraytracing_torch.core.v3 import V3
    from mafrixraytracing_torch.ops import intersect as oi

    scene = cs.scene
    gen = torch.Generator(device=dev).manual_seed(11)
    u, v = wavefront_uv(torch, dev, gen)
    B = u.shape[0]
    o, d = cs.camera.get_rays(u, v)
    t_hit, i_hit = oi.find_closest_soa(scene, o, d, t_min, 1e8)
    hit = i_hit >= 0
    p = o + d * torch.where(hit, t_hit, 0.0)
    lv0, le1, le2 = scene.light_v0[0], scene.light_e1[0], scene.light_e2[0]
    a1 = torch.rand(B, generator=gen, device=dev)
    a2 = torch.rand(B, generator=gen, device=dev)   # the light quad's parallelogram
    lp = V3(*(lv0[k] + a1 * le1[k] + a2 * le2[k] for k in range(3)))
    to_l = lp - p
    dist = torch.sqrt(to_l.x**2 + to_l.y**2 + to_l.z**2)
    sd = V3(to_l.x / dist, to_l.y / dist, to_l.z / dist)
    so = p + sd * 1e-3
    s_tmax = torch.where(hit, dist - 2e-3, 0.0)
    n_cut = B - 287
    cut = lambda v: v.map(lambda c: c[:n_cut])  # noqa: E731

    rs = np.random.default_rng(77)
    Bs = UNRELATED
    o_np = rs.normal(0.0, 1.0, (Bs, 3))
    o_np = (2.5 * o_np / np.linalg.norm(o_np, axis=1, keepdims=True)).astype(np.float32)
    d_np = (rs.uniform(-0.9, 0.9, (Bs, 3)) - o_np).astype(np.float32)
    d_np /= np.linalg.norm(d_np, axis=1, keepdims=True)
    dead = rs.random(Bs) < 0.1
    tmax_c = np.where(dead, 0.0, 1e8).astype(np.float32)
    tmax_a = np.where(dead, 0.0, rs.uniform(0.5, 4.0, Bs)).astype(np.float32)
    to = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    qo, qd = V3.of(to(o_np)), V3.of(to(d_np))
    return dict(primary=(o, d, 1e8), shadow=(so, sd, s_tmax),
                shadow_cut=(cut(so), cut(sd), s_tmax[:n_cut]),
                incoherent=(qo, qd, to(tmax_c)), incoherent_shadow=(qo, qd, to(tmax_a)),
                primary_hits=i_hit)


def phase_kernels_mesh(torch, dev, records, cornell_idx, cornell_P):
    """Kernels D and E (and the gather at a real table size) on the mesh."""
    from mafrixraytracing_torch.geometry.intersect import packed_attr_table
    from mafrixraytracing_torch.ops import intersect as oi
    from mafrixraytracing_torch.ops import unpack as ou
    from mafrixraytracing_torch.scene.compiler import compile_scene

    t_min = 1e-3
    t0 = time.perf_counter()
    spec = mesh_spec(WIDTH, HEIGHT)
    t1 = time.perf_counter()
    cs = compile_scene(spec)
    scene = cs.scene
    C, S = scene.cluster_min.shape[0], scene.super_min.shape[0]
    print(f"  mesh: OBJ written and parsed in {t1 - t0:.2f} s, compiled in "
          f"{time.perf_counter() - t1:.2f} s: {int(scene.tri_mask.sum())} triangles, "
          f"{C} clusters, {S} superclusters, {scene.num_mega} mega")
    check(scene.tri_v0.is_cuda, "compile_scene did not default to the card")
    check(int(scene.tri_mask.sum()) == MESH_FACES + 2, "mesh triangle count")
    check((C, S) == (512, 32), "mesh must have 512 clusters, 32 superclusters")
    rays = mesh_rays(torch, dev, cs, t_min)

    # --- primary rays: one wavefront in the main path's size and order ---
    o, d, _ = rays["primary"]
    B = o.x.shape[0]
    walk, *_ = oi._prep(scene, o, d, t_min, 1e8, anyhit=False)
    check(oi._is_super(walk), "the mesh must take the two-level path")
    err_c, t_k, i_k, ms_cp = compare_closest(walk, t_min, "mesh primary")
    ms_c = time_ms(lambda: oi.closest_super_kernel(*walk, t_min))
    bound_c = walk_bound(scene, walk, t_min, t_final=t_k)
    print_closest_fanout(closest_fanout(walk, t_min, t_k, bound_c["ray_cluster_pairs"]),
                         f"mesh primary, B = {B:,}")
    fused_c = fused_vs_list(scene, o, d, 1e8, False, walk, (t_k, i_k), t_min,
                            "mesh primary")

    # NEE-like shadow rays: from the primary hits toward points on the light
    i_hit = rays["primary_hits"]
    so, sd, s_tmax = rays["shadow"]
    swalk, *_ = oi._prep(scene, so, sd, t_min, s_tmax, anyhit=True)
    err_a, occ_k, ms_ap = compare_anyhit(swalk, t_min, "mesh shadow")
    ms_a = time_ms(lambda: oi.anyhit_super_kernel(*swalk, t_min))
    bound_a = walk_bound(scene, swalk, t_min, occ=occ_k)
    print_fanout(anyhit_fanout(swalk, t_min, bound_a["ray_cluster_pairs"]),
                 f"mesh shadow, B = {B:,}")
    fused_a = fused_vs_list(scene, so, sd, s_tmax, True, swalk, occ_k, t_min,
                            "mesh shadow")
    so_c, sd_c, s_tmax_c = rays["shadow_cut"]
    n_cut = s_tmax_c.shape[0]
    swalk_c, *_ = oi._prep(scene, so_c, sd_c, t_min, s_tmax_c, anyhit=True)
    err_ac, occ_c, _ = compare_anyhit(swalk_c, t_min, "mesh shadow, non-aligned")
    ms_ac = time_ms(lambda: oi.anyhit_super_kernel(*swalk_c, t_min))
    bound_ac = walk_bound(scene, swalk_c, t_min, occ=occ_c)
    print_fanout(anyhit_fanout(swalk_c, t_min, bound_ac["ray_cluster_pairs"]),
                 f"mesh shadow, non-aligned B = {n_cut:,}")
    fused_ac = fused_vs_list(scene, so_c, sd_c, s_tmax_c, True, swalk_c, occ_c, t_min,
                             "mesh shadow, non-aligned")
    print(f"  anyhit_super on the non-aligned shadow rays (B = {n_cut:,}): kernel "
          f"{ms_ac:.4f} ms, bound {bound_ac['bound_ms']:.5f} ms by "
          f"{bound_ac['bound_by']}, {bound_ac['ray_cluster_pairs']} ray-cluster pairs needed")
    print_fused("fused_anyhit_super on the non-aligned shadow rays", fused_ac,
                f"B = {n_cut:,}")

    # the gather at the mesh's table size
    table = packed_attr_table(scene).contiguous()
    check(table.shape[0] >= 65536, "the mesh's attribute table must be real-sized")
    gidx = i_hit.clamp(0, table.shape[0] - 1)
    gk = ou.unpack_kernel(table, gidx)
    torch.cuda.synchronize()
    gp = ou.fetch_cols_reference(table, gidx)
    print(f"  unpack mesh: B={B} P={table.shape[0]} "
          f"bit-exact={bool(torch.equal(gk, gp))}")
    check(torch.equal(gk, gp), "unpack kernel is not bit-exact on the mesh")
    ms_g = time_ms(lambda: ou.unpack_kernel(table, gidx))
    ms_gp = time_ms(lambda: ou.fetch_cols_reference(table, gidx))

    # --- non-aligned batch of unrelated rays around the mesh (incoherent
    # tiles), ~10% dead rays ---
    qo, qd, tmax_c = rays["incoherent"]
    tmax_a = rays["incoherent_shadow"][2]
    walk_n, *_ = oi._prep(scene, qo, qd, t_min, tmax_c, anyhit=False)
    err_cn, t_n, i_n, _ = compare_closest(walk_n, t_min, "mesh non-aligned")
    walk_na, *_ = oi._prep(scene, qo, qd, t_min, tmax_a, anyhit=True)
    err_an, occ_n, _ = compare_anyhit(walk_na, t_min, "mesh non-aligned")
    fused_cn = fused_vs_list(scene, qo, qd, tmax_c, False, walk_n, (t_n, i_n),
                             t_min, "mesh non-aligned")
    fused_an = fused_vs_list(scene, qo, qd, tmax_a, True, walk_na, occ_n,
                             t_min, "mesh non-aligned")
    culls = [f.pop("cull") for f in (fused_c, fused_a, fused_cn, fused_an, fused_ac)]
    culls[0]["max_abs_err"] = max([c["max_abs_err"] for c in culls]
                                  + [records["cull"]["max_abs_err"]])
    records["cull"] = culls[0]     # the mesh's 32 supercluster boxes, B = 524,288
    print_cull(culls[0], f"mesh primary, 32 boxes, B = {B:,}")
    print_cull(culls[1], f"mesh shadow, B = {B:,}")
    print_cull(culls[2], f"mesh non-aligned, B = {walk_n[-1].shape[1]:,}")
    print_fused("fused_closest_super on incoherent tiles", fused_cn,
                f"B = {walk_n[-1].shape[1]:,}")
    print_fused("fused_anyhit_super on incoherent tiles", fused_an,
                f"B = {walk_na[-1].shape[1]:,}")
    # tiles of unrelated rays: the walks' worst case, beside their bound
    for name, fn, w, b in (
            ("closest_super", oi.closest_super_kernel, walk_n,
             walk_bound(scene, walk_n, t_min, t_final=t_n)),
            ("anyhit_super", oi.anyhit_super_kernel, walk_na,
             walk_bound(scene, walk_na, t_min, occ=occ_n))):
        ms = time_ms(lambda: fn(*w, t_min))  # noqa: B023
        print(f"  {name} on incoherent tiles (B = {w[-1].shape[1]:,}): kernel "
              f"{ms:.4f} ms, bound {b['bound_ms']:.5f} ms by {b['bound_by']}, "
              f"{b['ray_cluster_pairs']} ray-cluster pairs needed")
        if name == "anyhit_super":
            print_fanout(anyhit_fanout(w, t_min, b["ray_cluster_pairs"]),
                         f"incoherent tiles, B = {w[-1].shape[1]:,}")
        else:
            print_closest_fanout(closest_fanout(w, t_min, t_n, b["ray_cluster_pairs"]),
                                 f"incoherent tiles, B = {w[-1].shape[1]:,}")

    compare_pure_unpack(torch, dev)
    phase_scatter(torch, dev, records, gidx, table.shape[0], cornell_idx, cornell_P)

    records["closest_super"] = dict(max_abs_err=max(err_c, err_cn), ms=ms_c,
                                    plain_ms=ms_cp, library_ms=None, **bound_c)
    records["anyhit_super"] = dict(max_abs_err=max(err_a, err_an, err_ac), ms=ms_a,
                                   plain_ms=ms_ap, library_ms=None, **bound_a)
    fused_an["max_abs_err"] = max(fused_an["max_abs_err"], fused_ac["max_abs_err"])
    for name, r, rn in (("fused_closest_super", fused_c, fused_cn),
                        ("fused_anyhit_super", fused_a, fused_an)):
        r["max_abs_err"] = max(r["max_abs_err"], rn["max_abs_err"])
        records[name] = r
        print_fused(name, r, f"mesh, B = {B:,}")
    records["unpack"] = dict(max_abs_err=float((gk - gp).abs().max()), ms=ms_g,
                             plain_ms=ms_gp,
                             library_ms=time_library_gather(table, gidx),
                             **gather_bound(table, gidx))
    for k in ("closest_super", "anyhit_super", "unpack"):
        r = records[k]
        print(f"  {k}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              + ("" if r["library_ms"] is None else f"library {r['library_ms']:.4f} ms, ")
              + f"bound {r['bound_ms']:.5f} ms by {r['bound_by']} "
              f"({r['bound_ms'] / r['ms']:.3f} of it)"
              + (f", {r['ray_cluster_pairs']} ray-cluster pairs needed"
                 if "ray_cluster_pairs" in r else "")
              + f" (mesh, B = {B:,})")
    return records


def sha(*ts) -> str:
    """A short hash of tensors' bytes, to compare two checkouts' outputs."""
    import hashlib

    return "".join(hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16] for t in ts)


def cull_thunk(scene, walk):
    """A call of kernel K on the rays and boxes of a list walk, in this
    checkout's interface ((n, 3) minima and maxima) or in the one it had
    before it was the cull of `_prep` (the packed box table and a width), so
    that `--walks` times K in a parent checkout too."""
    import inspect

    from mafrixraytracing_torch.ops import intersect as oi

    boxes, rays = cull_boxes(scene, walk), walk[-1]
    if "aabbs" in inspect.signature(oi.cull_kernel).parameters:
        aabbs = oi.pack_aabbs(*boxes)
        return lambda: oi.cull_kernel(aabbs, rays, boxes[0].shape[0])
    return lambda: oi.cull_kernel(*boxes, rays)


def time_cull(torch, scene, walk, t_min, name, rec, outputs):
    """`--walks`: kernel K on the rays and boxes of one list walk: its time by
    CUDA events and on the device, its bound, a hash of its outputs."""
    fn = cull_thunk(scene, walk)
    out = fn()
    outputs[f"K {name}"] = sha(*out)
    rec[f"K {name}"] = time_ms(fn)
    rec[f"K {name}, device"] = kernel_device_ms(torch, fn, "cull_kernel")
    rec[f"K bound, {name}"] = cull_bound(cull_boxes(scene, walk), walk[-1], t_min,
                                         out)["bound_ms"]


def time_walks(torch, dev, label, out_dir):
    """`--walks`: the flat walks (A and F, B and G, F and G with their cull)
    on Cornell's, the soup's and the walk profile's sphere's queries
    (`time_flat_walks`), the gather (C) and the two-level walks (D and H, E
    and I) timed on the mesh's queries of phase 2, with D's fan-out on its
    two inputs, the cull kernel (K, `time_cull`) on every query's rays and
    boxes, and the scatter-add (J) on the mesh's and Cornell's primary-hit
    rows, one row and the light rows, with its parts from the profiler; one
    JSON line. D's and E's outputs and hashes of A's, B's, the
    gather's and J's are saved in `out_dir`, or, when a run of another
    checkout saved them there, compared with those: two checkouts timed in
    turns on one card must agree bit for bit. F must equal A, G equal B, H
    equal D and I equal E bit for bit."""
    import hashlib

    from mafrixraytracing_torch.geometry.intersect import packed_attr_table
    from mafrixraytracing_torch.ops import intersect as oi
    from mafrixraytracing_torch.ops import unpack as ou
    from mafrixraytracing_torch.scene.compiler import compile_scene

    t_min = 1e-3
    cs = compile_scene(mesh_spec(WIDTH, HEIGHT), device=dev)
    rays = mesh_rays(torch, dev, cs, t_min)
    rec, outputs = {}, {}
    time_flat_walks(torch, dev, t_min, rec, outputs)
    for name in ("shadow", "shadow_cut", "incoherent_shadow"):
        lw, *_ = oi._prep(cs.scene, *rays[name][:2], t_min, rays[name][2], anyhit=True)
        fw, *_ = oi._prep(cs.scene, *rays[name][:2], t_min, rays[name][2], anyhit=True,
                          fused=True)
        occ = oi.anyhit_super_kernel(*lw, t_min)
        outputs[name] = occ.cpu()
        time_cull(torch, cs.scene, lw, t_min, f"mesh {name}", rec, outputs)
        rec[f"I equals E, {name}"] = torch.equal(oi.fused_anyhit_super_kernel(*fw, t_min), occ)
        rec[f"E {name}"] = time_ms(lambda: oi.anyhit_super_kernel(*lw, t_min))  # noqa: B023
        rec[f"I {name}"] = time_ms(lambda: oi.fused_anyhit_super_kernel(*fw, t_min))  # noqa: B023
    for name in ("primary", "incoherent"):
        lw, *_ = oi._prep(cs.scene, *rays[name][:2], t_min, rays[name][2], anyhit=False)
        fw, *_ = oi._prep(cs.scene, *rays[name][:2], t_min, rays[name][2], anyhit=False,
                          fused=True)
        t, idx = oi.closest_super_kernel(*lw, t_min)
        outputs[f"D {name}"] = (t.cpu(), idx.cpu())
        time_cull(torch, cs.scene, lw, t_min, f"mesh {name}", rec, outputs)
        th, ih = oi.fused_closest_super_kernel(*fw, t_min)
        rec[f"H equals D, {name}"] = torch.equal(th, t) and torch.equal(ih, idx)
        rec[f"D {name}"] = time_ms(lambda: oi.closest_super_kernel(*lw, t_min))  # noqa: B023
        rec[f"H {name}"] = time_ms(lambda: oi.fused_closest_super_kernel(*fw, t_min))  # noqa: B023
        needed = walk_bound(cs.scene, lw, t_min, t_final=t)["ray_cluster_pairs"]
        rec[f"D fan-out, {name}"] = closest_fanout(lw, t_min, t, needed)
    table = packed_attr_table(cs.scene).contiguous()
    gidx = rays["primary_hits"].clamp(0, table.shape[0] - 1)
    gk = ou.unpack_kernel(table, gidx)
    outputs["gather_sha256"] = hashlib.sha256(gk.cpu().numpy().tobytes()).hexdigest()
    rec["C gather"] = time_ms(lambda: ou.unpack_kernel(table, gidx))
    rec["C gather, library"] = time_library_gather(table, gidx)
    rows = torch.randn((512 * 1024, 36), generator=torch.Generator(device=dev).manual_seed(5),
                       device=dev)
    idx = torch.arange(rows.shape[0], device=dev)
    rec["C pure unpack"] = time_ms(lambda: ou.unpack_kernel(rows, idx))
    rec["C pure unpack, library"] = time_ms(lambda: rows.t().contiguous())
    for name, ct, jidx, P in scatter_walk_inputs(torch, dev, table.shape[0], gidx):
        out = ou.scatter_kernel(ct, jidx, P)
        outputs[f"J {name}"] = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
        rec[f"J {name}"] = time_ms(lambda: ou.scatter_kernel(ct, jidx, P))  # noqa: B023
        rec[f"J parts, {name}"] = profiled_parts(
            torch, lambda: ou.scatter_kernel(ct, jidx, P))  # noqa: B023
    path = os.path.join(out_dir, "walks_outputs.pt")
    if os.path.exists(path):
        saved = torch.load(path)
        rec["outputs equal to the saved run's"] = {
            k: k in saved and same_outputs(saved[k], v) for k, v in outputs.items()}
    else:
        os.makedirs(out_dir, exist_ok=True)
        torch.save(outputs, path)
    print(f"[{label}] " + json.dumps(rec))
    check(all(v for k, v in rec.items()
              if k.startswith(("F equals", "G equals", "H equals", "I equals", "M equals"))),
          "a fused or instrumented walk differs from its list walk")
    check(all(rec.get("outputs equal to the saved run's", {}).values()),
          "the walks' outputs differ from the saved run's")


def flat_walk_inputs(torch, dev, t_min):
    """The flat walks' inputs of `--walks`, from seeds: (name, scene, o, d,
    t_max, any hit) for Cornell's primary rays (uniform pixels), its primary
    rays in tile order and its shadow rays (phase 2's), the soup's closest-
    and any-hit rays (phase 2's), and the primary and sorted bounce-1
    wavefronts of `profile_walk`'s sphere (122 clusters), each also as an
    any-hit query to its tmax."""
    from mafrixraytracing_torch import profile_walk
    from mafrixraytracing_torch.core import rng
    from mafrixraytracing_torch.scene.builtin import cornell_box
    from mafrixraytracing_torch.scene.compiler import compile_scene

    cs = compile_scene(cornell_box(256, 256), device=dev)
    cr = cornell_rays(torch, dev, cs, t_min)
    soup = soup_scene(dev)
    qo, qd, tmax_c, tmax_a = soup_rays(torch, dev)
    sphere = compile_scene(profile_walk.flat_spec(WIDTH)[0], device=dev)
    o, d, skeys = profile_walk.primary_wavefront(sphere.camera, WIDTH, rng.root_key(0, dev))
    o1, d1, tmax1 = profile_walk.bounce1_wavefront(sphere.scene, o, d, skeys)
    return [("cornell primary", cs.scene, *cr["primary"], False),
            ("cornell primary, tile order", cs.scene, *cr["tiled"], False),
            ("cornell shadow", cs.scene, *cr["shadow"], True),
            ("soup", soup, qo, qd, tmax_c, False),
            ("soup", soup, qo, qd, tmax_a, True),
            ("sphere primary", sphere.scene, o, d, 1e8, False),
            ("sphere primary", sphere.scene, o, d, 1e8, True),
            ("sphere bounce 1", sphere.scene, o1, d1, tmax1, False),
            ("sphere bounce 1", sphere.scene, o1, d1, tmax1, True)]


def time_flat_walks(torch, dev, t_min, rec, outputs):
    """A and F (closest hit) or B and G (any hit) on each input of
    `flat_walk_inputs`, reached through `_prep` and `_searches` so that a
    parent checkout runs the same code: their times by CUDA events and each
    kernel's own device time (`kernel_device_ms`), F equal to A and G to B,
    hashes of A's and B's outputs, the flat fan-out of each input, kernel K
    on each input's rays and boxes (`time_cull`) and, on the closest-hit
    inputs, the instrumented walks (`time_walk_stats`)."""
    from mafrixraytracing_torch.ops import intersect as oi

    for name, scene, o, d, t_max, anyhit in flat_walk_inputs(torch, dev, t_min):
        lw, *_ = oi._prep(scene, o, d, t_min, t_max, anyhit=anyhit)
        fw, *_ = oi._prep(scene, o, d, t_min, t_max, anyhit=anyhit, fused=True)
        check(not oi._is_super(lw), f"{name} must take the flat path")
        k = 1 if anyhit else 0
        walk_fn, fused_fn = oi._searches(lw)[k], oi._searches(fw)[k]
        a, f = ("B", "G") if anyhit else ("A", "F")
        out = walk_fn(*lw, t_min)
        fout = fused_fn(*fw, t_min)
        out, fout = ((out,), (fout,)) if anyhit else (out, fout)
        outputs[f"{a} {name}"] = sha(*out)
        rec[f"{f} equals {a}, {name}"] = all(torch.equal(x, y) for x, y in zip(out, fout))
        rec[f"{a} {name}"] = time_ms(lambda: walk_fn(*lw, t_min))  # noqa: B023
        rec[f"{f} {name}"] = time_ms(lambda: fused_fn(*fw, t_min))  # noqa: B023
        kind = "anyhit" if anyhit else "closest"
        rec[f"{a} {name}, device"] = kernel_device_ms(
            torch, lambda: walk_fn(*lw, t_min), f"{kind}_kernel")  # noqa: B023
        rec[f"{f} {name}, device"] = kernel_device_ms(
            torch, lambda: fused_fn(*fw, t_min), f"fused_{kind}_kernel")  # noqa: B023
        bound = walk_bound(scene, lw, t_min, **({"occ": out[0]} if anyhit
                                               else {"t_final": out[0]}))
        rec[f"{a} bound, {name}"] = bound["bound_ms"]
        rec[f"{a} fan-out, {name}"] = flat_fanout(
            scene, lw, t_min, bound["ray_cluster_pairs"], None if anyhit else out[0])
        time_cull(torch, scene, lw, t_min, f"{name}{', any hit' if anyhit else ''}", rec,
                  outputs)
        if not anyhit:
            time_walk_stats(torch, lw, t_min, name, out, rec, outputs)


def time_walk_stats(torch, walk, t_min, name, closest_out, rec, outputs):
    """`--walks`: the instrumented walks (M) on one closest-hit list walk:
    `(t, idx)` equal to A's (`closest_out`), the mean walked a tile, hashes of
    `(t, idx, walked)` and of the full walk's `(t, idx)`, and each kernel's
    time by CUDA events and on the device (`closest_stats_kernel<true>` and
    `<false>`, the names of M's kernels before and after it took A's walk)."""
    from mafrixraytracing_torch.ops import intersect as oi

    dbg = oi.closest_dbg_kernel(*walk, t_min)
    full = oi.closest_full_kernel(*walk, t_min)
    outputs[f"M dbg {name}"] = sha(*dbg)
    outputs[f"M full {name}"] = sha(*full)
    rec[f"M equals A, {name}"] = all(torch.equal(x, y) for x, y in
                                     zip(dbg[:2] + full, closest_out + closest_out))
    rec[f"M walked a tile, {name}"] = float(dbg[2].float().mean())
    for kind, fn, exit_on in (("dbg", oi.closest_dbg_kernel, "true"),
                              ("full", oi.closest_full_kernel, "false")):
        rec[f"M {kind} {name}"] = time_ms(lambda: fn(*walk, t_min))  # noqa: B023
        rec[f"M {kind} {name}, device"] = kernel_device_ms(
            torch, lambda: fn(*walk, t_min), f"closest_stats_kernel<{exit_on}>")  # noqa: B023


def scatter_walk_inputs(torch, dev, mesh_P, mesh_idx):
    """J's inputs of `--walks`, from seeds: (name, ct, idx, P) for the
    mesh's primary-hit rows, Cornell's (its phase-2 rays), one row for every
    ray and the light rows of 8 and of 2 lights (16 columns, rows layout)."""
    from mafrixraytracing_torch.geometry.intersect import packed_attr_table
    from mafrixraytracing_torch.ops import intersect as oi
    from mafrixraytracing_torch.scene.builtin import cornell_box
    from mafrixraytracing_torch.scene.compiler import compile_scene

    cs = compile_scene(cornell_box(256, 256), device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    B = WAVEFRONT
    u = torch.rand(B, generator=gen, device=dev)
    v = torch.rand(B, generator=gen, device=dev)
    o, d = cs.camera.get_rays(u, v)
    _, i_hit = oi.find_closest_soa(cs.scene, o, d, 1e-3, 1e8)
    cornell_P = packed_attr_table(cs.scene).shape[0]
    gen = torch.Generator(device=dev).manual_seed(41)
    cols = lambda K: torch.randn((K, B), generator=gen, device=dev)  # noqa: E731
    rows = lambda K: torch.randn((B, K), generator=gen, device=dev).t()  # noqa: E731
    return [("mesh", cols(36), mesh_idx, mesh_P),
            ("cornell", cols(36), i_hit.clamp(0, cornell_P - 1), cornell_P),
            ("one row", cols(36), torch.full((B,), 77, device=dev), cornell_P),
            ("light rows", rows(16), torch.randint(0, 8, (B,), generator=gen, device=dev), 8),
            ("light rows of one quad", rows(16),
             torch.randint(0, 2, (B,), generator=gen, device=dev), 2)]


def profiled_ms(torch, fn, part_of, reps: int = 10, host: bool = True) -> dict:
    """Device ms a call of fn() spends in each part, from torch.profiler's
    kernel records over `reps` calls: `part_of(kernel name)` names the part a
    kernel belongs to, or None to leave it out. Reads kernel names only, so
    it measures any checkout's kernels. `host=False` records the device's
    activity alone, for a call of tens of thousands of operators, whose host
    records would take many times the call's own time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] * host + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts: dict[str, float] = {}
    for e in prof.events():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        part = part_of(e.name)
        if part is not None:
            parts[part] = parts.get(part, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return parts


def j_part(name: str) -> str:
    """The part of kernel J a kernel of its call belongs to."""
    name = name.lower()
    return ("pass 1" if "scatter_chunk" in name else
            "pass 2" if "scatter_combine" in name else
            "searchsorted" if "searchsorted" in name else
            "sort" if "sort" in name else "other")


def profiled_parts(torch, fn, reps: int = 10) -> dict:
    """Device ms a call of fn() spends in each part of kernel J: the sort,
    searchsorted, pass 1 (`scatter_chunk_kernel`), pass 2
    (`scatter_combine_kernel`) and the other launches."""
    return profiled_ms(torch, fn, j_part, reps)


def kernel_device_ms(torch, fn, name, reps: int = 10) -> float:
    """Device ms a call of fn() spends in the CUDA kernel called `name`: the
    kernel's own time, which a short kernel's CUDA events cannot tell from
    its launch from Python."""
    import re

    pattern = re.compile(rf"\b{name}\(")
    return profiled_ms(torch, fn, lambda n: name if pattern.search(n) else None,
                       reps).get(name, 0.0)


def same_outputs(a, b) -> bool:
    """Bit-equality of two saved outputs: hashes, tensors or tuples of them."""
    import torch

    if isinstance(b, str):
        return a == b
    if isinstance(b, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def phase_kernels(torch, dev):
    from mafrixraytracing_torch.geometry.intersect import packed_attr_table
    from mafrixraytracing_torch.ops import intersect as oi
    from mafrixraytracing_torch.ops import unpack as ou
    from mafrixraytracing_torch.scene.builtin import cornell_box
    from mafrixraytracing_torch.scene.compiler import compile_scene

    t_min = 1e-3
    records = {}
    # --- Cornell primary rays at the main path's wavefront size ---
    cs = compile_scene(cornell_box(256, 256), device=dev)
    scene = cs.scene
    rays = cornell_rays(torch, dev, cs, t_min)
    o, d, _ = rays["primary"]
    B = o.x.shape[0]
    walk, _, _, _, _ = oi._prep(scene, o, d, t_min, 1e8, anyhit=False)
    err_c, t_k, idx, ms_cp = compare_closest(walk, t_min, "cornell primary")
    ms_c = time_ms(lambda: oi.closest_kernel(*walk, t_min))
    bound_c = walk_bound(scene, walk, t_min, t_final=t_k)
    print_flat_fanout(flat_fanout(scene, walk, t_min, bound_c["ray_cluster_pairs"], t_k),
                      f"cornell primary, B = {B:,}")
    fused_c = fused_vs_list(scene, o, d, 1e8, False, walk, (t_k, idx), t_min,
                            "cornell primary")
    # the same pixels' rays in the render's tile order (its bounce 0)
    ot, dt, _ = rays["tiled"]
    walk_t, *_ = oi._prep(scene, ot, dt, t_min, 1e8, anyhit=False)
    err_ct, t_t, _, _ = compare_closest(walk_t, t_min, "cornell primary, tile order")
    print_flat_fanout(flat_fanout(scene, walk_t, t_min, walk_bound(
        scene, walk_t, t_min, t_final=t_t)["ray_cluster_pairs"], t_t),
        f"cornell primary in tile order, B = {ot.x.shape[0]:,}")

    # NEE-like shadow rays: from the primary hits toward points on the light
    i_hit = rays["primary_hits"]
    so, sd, s_tmax = rays["shadow"]
    swalk, _, _, _, _ = oi._prep(scene, so, sd, t_min, s_tmax, anyhit=True)
    err_a, occ_k, ms_ap = compare_anyhit(swalk, t_min, "cornell shadow")
    ms_a = time_ms(lambda: oi.anyhit_kernel(*swalk, t_min))
    bound_a = walk_bound(scene, swalk, t_min, occ=occ_k)
    print_flat_fanout(flat_fanout(scene, swalk, t_min, bound_a["ray_cluster_pairs"]),
                      f"cornell shadow, B = {B:,}")
    fused_a = fused_vs_list(scene, so, sd, s_tmax, True, swalk, occ_k, t_min,
                            "cornell shadow")

    # gather-unpack at the main path's shape
    table = packed_attr_table(scene).contiguous()
    gidx = i_hit.clamp(0, table.shape[0] - 1)
    gk = ou.unpack_kernel(table, gidx)
    torch.cuda.synchronize()
    gp = ou.fetch_cols_reference(table, gidx)
    err_g = float((gk - gp).abs().max())
    print(f"  unpack cornell: B={B} P={table.shape[0]} max|d|={err_g} "
          f"bit-exact={bool(torch.equal(gk, gp))}")
    check(torch.equal(gk, gp), "unpack kernel is not bit-exact")
    ms_g = time_ms(lambda: ou.unpack_kernel(table, gidx))
    ms_gp = time_ms(lambda: ou.fetch_cols_reference(table, gidx))
    print(f"  unpack cornell (P = {table.shape[0]}): kernel {ms_g:.4f} ms, plain "
          f"{ms_gp:.4f} ms, library {time_library_gather(table, gidx):.4f} ms, "
          f"bound {gather_bound(table, gidx)['bound_ms']:.5f} ms by bytes")

    # --- synthetic soup: 64 clusters, non-aligned batch, ~10% dead rays ---
    soup = soup_scene(dev)
    check(soup.cluster_min.shape[0] == 64, "soup must have 64 clusters")
    qo, qd, tmax_c, tmax_a = soup_rays(torch, dev)
    walk_s, _, _, _, _ = oi._prep(soup, qo, qd, t_min, tmax_c, anyhit=False)
    err_cs, t_s, idx_s, ms_csp = compare_closest(walk_s, t_min, "soup")
    walk_sa, _, _, _, _ = oi._prep(soup, qo, qd, t_min, tmax_a, anyhit=True)
    err_as, occ_s, ms_asp = compare_anyhit(walk_sa, t_min, "soup")
    bound_cs = walk_bound(soup, walk_s, t_min, t_final=t_s)
    bound_as = walk_bound(soup, walk_sa, t_min, occ=occ_s)
    Bs = walk_s[-1].shape[1]
    print_flat_fanout(flat_fanout(soup, walk_s, t_min, bound_cs["ray_cluster_pairs"], t_s),
                      f"soup, closest hit, B = {Bs:,}")
    print_flat_fanout(flat_fanout(soup, walk_sa, t_min, bound_as["ray_cluster_pairs"]),
                      f"soup, any hit, B = {Bs:,}")
    fused_cs = fused_vs_list(soup, qo, qd, tmax_c, False, walk_s, (t_s, idx_s),
                             t_min, "soup")
    fused_as = fused_vs_list(soup, qo, qd, tmax_a, True, walk_sa, occ_s, t_min,
                             "soup")
    # the instrumented walks on Cornell (timed, as closest is) and on the soup,
    # also at t_min = -3, where hits behind the origin count and the walks
    # have no exit
    stats = compare_walk_stats(scene, walk, t_min, "cornell primary", (t_k, idx), True)
    stats_s = compare_walk_stats(soup, walk_s, t_min, "soup", (t_s, idx_s), True)
    walk_n, *_ = oi._prep(soup, qo, qd, -3.0, tmax_c, anyhit=False)
    _, t_n, idx_n, _ = compare_closest(walk_n, -3.0, "soup, t_min = -3")
    stats_n = compare_walk_stats(soup, walk_n, -3.0, "soup, t_min = -3", (t_n, idx_n), False)
    check(torch.equal(oi.closest_dbg_kernel(*walk_n, -3.0)[2], walk_n[-3]),
          "the counting walk exited at t_min = -3")
    for name in ("closest_dbg", "closest_full"):
        r, rs_ = stats[name], stats_s[name]
        r["max_abs_err"] = max(r["max_abs_err"], rs_["max_abs_err"],
                               stats_n[name]["max_abs_err"])
        print(f"  {name} on the soup (B = {walk_s[-1].shape[1]:,}): kernel "
              f"{rs_['ms']:.4f} ms ({rs_['device_ms']:.4f} on the device) against closest "
              f"{time_ms(lambda: oi.closest_kernel(*walk_s, t_min)):.4f} ms")
    culls = [f.pop("cull") for f in (fused_c, fused_a, fused_cs, fused_as)]
    culls[0]["max_abs_err"] = max(c["max_abs_err"] for c in culls)
    print_cull(culls[0], f"Cornell primary, 1 box, B = {B:,}")
    print_cull(culls[1], f"Cornell shadow, B = {B:,}")
    print_cull(culls[2], f"soup, 64 boxes, B = {walk_s[-1].shape[1]:,}")
    print_fused("fused_closest on the soup", fused_cs, f"B = {walk_s[-1].shape[1]:,}")
    print_fused("fused_anyhit on the soup", fused_as, f"B = {walk_sa[-1].shape[1]:,}")
    tab_s = packed_attr_table(soup).contiguous()
    gidx_s = idx_s.long().clamp(0, tab_s.shape[0] - 1)
    check(torch.equal(ou.unpack_kernel(tab_s, gidx_s),
                      ou.fetch_cols_reference(tab_s, gidx_s)),
          "unpack kernel is not bit-exact on the soup")
    ms_cs = time_ms(lambda: oi.closest_kernel(*walk_s, t_min))
    ms_as = time_ms(lambda: oi.anyhit_kernel(*walk_sa, t_min))
    print(f"  soup times (ms, kernel / plain): closest {ms_cs:.4f} / "
          f"{ms_csp:.3f}, anyhit {ms_as:.4f} / {ms_asp:.3f}")
    for name, ms, b in (("closest", ms_cs, bound_cs), ("anyhit", ms_as, bound_as)):
        print(f"  {name} on the soup (B = {Bs:,}): kernel {ms:.4f} ms, bound "
              f"{b['bound_ms']:.5f} ms by {b['bound_by']} ({b['bound_ms'] / ms:.4f} of it), "
              f"{b['ray_cluster_pairs']} ray-cluster pairs needed")

    records["closest"] = dict(max_abs_err=max(err_c, err_ct, err_cs), ms=ms_c,
                              plain_ms=ms_cp, library_ms=None, **bound_c)
    records["anyhit"] = dict(max_abs_err=max(err_a, err_as), ms=ms_a,
                             plain_ms=ms_ap, library_ms=None, **bound_a)
    check(err_g == 0.0, "unpack kernel differs on Cornell")
    records.update(stats)
    for k, r in records.items():
        print(f"  {k}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.5f} ms by {r['bound_by']}, "
              f"{r['ray_cluster_pairs']} ray-cluster pairs needed (Cornell, "
              f"B = {B:,})")
    records["cull"] = culls[0]
    for name, r, rs_ in (("fused_closest", fused_c, fused_cs),
                         ("fused_anyhit", fused_a, fused_as)):
        r["max_abs_err"] = max(r["max_abs_err"], rs_["max_abs_err"])
        records[name] = r
        print_fused(name, r, f"Cornell, B = {B:,}")
    return phase_kernels_mesh(torch, dev, records, gidx, table.shape[0])


def calibrated_config(scene, camera, width, height, depth):
    """(config, survival): each bounce's live share in `trace_stats` of one
    1-spp pass from the pixel centres (keys of seed 123), and from depth 2
    compaction buckets sized from it with headroom (x1.12 + 0.01), so the
    population-control kill stays a rare safety valve."""
    from mafrixraytracing_torch.core import rng
    from mafrixraytracing_torch.integrator import path as P

    dev = scene.tri_v0.device
    base = P.PathTracerConfig(max_depth=depth, wavefront=WAVEFRONT)
    px, py = P.make_pixel_uv(width, height, dev)
    keys = rng.pixel_keys(rng.root_key(123, dev), px.shape[0])
    o, d = camera.get_rays((px + 0.5) / width, (py + 0.5) / height)
    _, prof = P.trace_stats(scene, o, d, keys, base, return_profile=True)
    survival = [float(p) for p in prof]
    if depth < 2:
        return base, survival
    sched = [1.0] + [min(1.0, p * 1.12 + 0.01) for p in survival[1:]]
    return dataclasses.replace(base, compact=tuple(sched)), survival


GRAD_LEAVES = ("mat_albedo", "light_radiance", "tri_v0")


def fwd_bwd(scene, camera, width, height, spp, seed, config, names=GRAD_LEAVES):
    """Render and back-propagate the mean image to the scene fields `names`.
    Returns the image and the gradients."""
    from mafrixraytracing_torch.core import rng
    from mafrixraytracing_torch.integrator import path as P

    leaves = [getattr(scene, n).detach().clone().requires_grad_() for n in names]
    s = scene.replace(**dict(zip(names, leaves)))
    img = P.render_image(s, camera, width, height, spp,
                         rng.root_key(seed, scene.tri_v0.device), config)
    img.mean().backward()
    return img.detach(), [x.grad for x in leaves]


def phase_forward(torch, dev, make_spec, label, launched, idle):
    """The forward main path on `make_spec(width, height)`: `launched` names
    the kernels it must go through, `idle` those it must not touch. Its cull
    is kernel K: launched once a query (80 a frame, as many as the walks of
    `launched[:2]`), the PyTorch cull never."""
    import numpy as np

    from mafrixraytracing_torch.core import rng
    from mafrixraytracing_torch.film.image import write_png
    from mafrixraytracing_torch.film.tonemap import to_bytes, tonemap
    from mafrixraytracing_torch.integrator import path as P
    from mafrixraytracing_torch.ops import cuda
    from mafrixraytracing_torch.scene.compiler import compile_scene

    W, H, spp = WIDTH, HEIGHT, SPP
    cs = compile_scene(make_spec(W, H))
    check(cs.scene.tri_v0.is_cuda and cs.camera.position.is_cuda,
          "compile_scene did not default to the card")
    cuda.reset_launches()
    config, survival = calibrated_config(cs.scene, cs.camera, W, H, DEPTH)
    calibration = dict(cuda.LAUNCHES)
    # the recorded counts are the frame's own: zeroed just before the render,
    # read just after
    culls = []
    cuda.reset_launches()
    with torch.no_grad(), counting_pytorch_cull(culls):
        img = P.render_image(cs.scene, cs.camera, W, H, spp, rng.root_key(0),
                             config)
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    mean = float(img.mean())
    print(f"  calibration launches {calibration}, survival {survival}, "
          f"compact {[round(c, 4) for c in config.compact]}")
    print(f"  forward {label} {W}x{H} x {spp} spp: mean {mean:.5f}, launches {launches}")
    check(bool(torch.isfinite(img).all()), "image has non-finite values")
    check(0.02 < mean < 0.5, f"image mean {mean} outside (0.02, 0.5)")
    for k in launched:
        check(launches[k] > 0, f"kernel {k} was not launched on the {label} path")
    for k in idle:
        check(launches[k] == 0, f"kernel {k} was launched on the {label} path")
    print(f"  the cull: kernel K launched {launches['cull']} times, the PyTorch cull "
          f"called {len(culls)} times")
    check(launches["cull"] == 80 == launches[launched[0]] + launches[launched[1]],
          f"the {label} frame's 80 queries did not each launch the cull kernel")
    check(not culls, f"the {label} frame called the PyTorch cull")
    png = os.path.join(tempfile.gettempdir(), f"mafrix_torch_{label}.png")
    write_png(png, to_bytes(tonemap(img)).cpu().numpy())
    print(f"  wrote {png}")

    # kernels vs plain versions through the whole integrator, 64x64 x 4 spp
    small = compile_scene(make_spec(SMALL, SMALL))
    cfg = P.PathTracerConfig(max_depth=5, compact=(1.0, 0.7, 0.3, 0.15, 0.05))
    with torch.no_grad():
        a = P.render_image(small.scene, small.camera, SMALL, SMALL, 4,
                           rng.root_key(5), cfg)
        with plain_versions():
            b = P.render_image(small.scene, small.camera, SMALL, SMALL, 4,
                               rng.root_key(5), cfg)
    a, b = a.cpu().numpy(), b.cpu().numpy()
    close = np.isclose(a, b, rtol=1e-3, atol=1e-4).all(axis=-1).mean()
    rel = abs(a.mean() - b.mean()) / max(abs(b.mean()), 1e-12)
    print(f"  {SMALL}x{SMALL} x 4 spp kernels vs plain: {close:.5f} of pixels close, "
          f"mean rel diff {rel:.3g}, identical={bool(np.array_equal(a, b))}")
    check(close >= 0.995 and rel <= 1e-4, "kernel render disagrees with plain render")
    return launches, a, img


def phase_textured(torch, untextured):
    """A checker texture on the mesh: the textured branch of the attribute
    recompute runs on the card and changes the picture."""
    import numpy as np

    from mafrixraytracing_torch.core import rng
    from mafrixraytracing_torch.integrator import path as P
    from mafrixraytracing_torch.scene.compiler import compile_scene

    cs = compile_scene(mesh_spec(SMALL, SMALL, textured=True))
    check(cs.scene.has_textures, "the textured mesh scene has no texture")
    cfg = P.PathTracerConfig(max_depth=5, compact=(1.0, 0.7, 0.3, 0.15, 0.05))
    with torch.no_grad():
        img = P.render_image(cs.scene, cs.camera, SMALL, SMALL, 4,
                             rng.root_key(5), cfg).cpu().numpy()
    diff = float(np.abs(img - untextured).mean())
    print(f"  textured {SMALL}x{SMALL} x 4 spp: mean {img.mean():.5f}, mean |textured - "
          f"untextured| {diff:.5f}")
    check(np.isfinite(img).all(), "textured image has non-finite values")
    check(diff > 1e-3, "the texture did not change the picture")


def phase_fwd_bwd(torch, make_spec, launched=()):
    """Forward + backward of the mean image to GRAD_LEAVES on
    `make_spec(WIDTH, HEIGHT)` at SPP with the calibrated compaction;
    `launched` names the kernels it must go through (their launches are read
    over the calibration and the run)."""
    from mafrixraytracing_torch.ops import cuda
    from mafrixraytracing_torch.scene.compiler import compile_scene

    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launches()
    cs = compile_scene(make_spec(WIDTH, HEIGHT))
    config, _ = calibrated_config(cs.scene, cs.camera, WIDTH, HEIGHT, DEPTH)
    _, grads = fwd_bwd(cs.scene, cs.camera, WIDTH, HEIGHT, SPP, 1, config)
    launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"launches over the calibration and the fwd+bwd {launches}")
    for k in launched:
        check(launches.get(k, 0) > 0, f"kernel {k} was not launched by the fwd+bwd")
    for n, g in zip(GRAD_LEAVES, grads):
        check(g is not None and bool(torch.isfinite(g).all()),
              f"gradient of {n} is not finite")
        print(f"  grad {n}: |g|max {float(g.abs().max()):.4g}")
    check(float(grads[0].abs().max()) > 0, "albedo gradient is zero")
    check(float(grads[1].abs().max()) > 0, "radiance gradient is zero")


def bounds_contain_triangles(torch, scene) -> bool:
    """Every live triangle that the clusters own lies inside its cluster's
    box, and every cluster inside its supercluster's."""
    from mafrixraytracing_torch.accel.clusters import SUPER

    v0, p1, p2 = scene.tri_v0, scene.tri_v0 + scene.tri_e1, scene.tri_v0 + scene.tri_e2
    T, C = v0.shape[0], scene.cluster_min.shape[0]
    ids = scene.mega_ids.long()
    own = scene.tri_mask.clone()
    own[ids[ids >= 0]] = False
    own = own.reshape(C, T // C, 1)
    lo = torch.minimum(torch.minimum(v0, p1), p2).reshape(C, T // C, 3)
    hi = torch.maximum(torch.maximum(v0, p1), p2).reshape(C, T // C, 3)
    inside = ((lo >= scene.cluster_min[:, None]) & (hi <= scene.cluster_max[:, None])) | ~own
    child = torch.arange(C, device=v0.device) // SUPER
    live = (scene.cluster_min <= scene.cluster_max).all(dim=1, keepdim=True)
    nested = ((scene.cluster_min >= scene.super_min[child])
              & (scene.cluster_max <= scene.super_max[child])) | ~live
    return bool(inside.all()) and bool(nested.all())


def nondeterministic_ops(torch, fn):
    """The operations PyTorch's determinism check names while fn() runs."""
    import warnings

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    names = sorted({str(w.message).split(" does not have")[0] for w in caught
                    if "deterministic" in str(w.message)})
    return names


def phase_fit(torch, dev):
    """This slice's path at full width: `opt.inverse.fit` on the mesh scene
    (kernels C, D, E forward, J backward), with a restart from a checkpoint."""
    import math
    import shutil

    from mafrixraytracing_torch.core import rng
    from mafrixraytracing_torch.integrator import path as P
    from mafrixraytracing_torch.ops import cuda
    from mafrixraytracing_torch.opt import inverse
    from mafrixraytracing_torch.scene.compiler import compile_scene

    W, H, spp, steps = WIDTH, HEIGHT, FIT_SPP, 6
    names = ("mat_albedo", "light_radiance", "mesh_vertices")
    cs = compile_scene(mesh_spec(W, H, scale=FIT_SCALE))
    scene, camera = cs.scene, cs.camera
    check(scene.cluster_min.shape[0] == 512, "the fit's mesh must have 512 clusters")
    config, _ = calibrated_config(scene, camera, W, H, DEPTH)
    sc = FIT_SCALE
    with torch.no_grad():
        target = P.render_image(scene, camera, W, H, SPP, rng.root_key(0), config)
        # the start: the ground's albedo and the light off, the vertices
        # displaced along y by a smooth field with seeded phases
        gen = torch.Generator(device=dev).manual_seed(17)
        ph = torch.rand(2, generator=gen, device=dev) * (2.0 * math.pi)
        mv = scene.mesh_vertices.clone()
        mv[:, 1] += 0.03 * sc * (torch.sin(3.0 * mv[:, 0] / sc + ph[0])
                                 * torch.cos(2.0 * mv[:, 2] / sc + ph[1]))
        albedo = scene.mat_albedo.clone()
        albedo[1] = torch.tensor([0.1, 0.1, 0.1], device=dev)
        start = inverse.apply_params(scene, {
            "mat_albedo": albedo, "light_radiance": scene.light_radiance * 0.9,
            "mesh_vertices": mv})
    check(bounds_contain_triangles(torch, start), "the start's bounds lose triangles")
    common = dict(param_names=names, lr=FIT_LR, spp=spp, key=rng.root_key(3),
                  config=config, smooth_geometry=4)

    norms = []
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launches()
    ref, ref_losses = inverse.fit(start, camera, target, steps=steps,
                                  log_every=1, **common)
    launches = dict(cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  fit mesh36996 {W}x{H} x {spp} spp, {steps} steps: losses "
          f"{[round(l, 5) for l in ref_losses]}, launches {launches}, peak device "
          f"memory {peak:.2f} GiB")
    check(all(math.isfinite(l) for l in ref_losses), "a loss is not finite")
    check(sum(ref_losses[-2:]) / 2 < ref_losses[0], "the fit did not reduce the loss")
    for k in ("closest_super", "anyhit_super", "unpack", "scatter"):
        check(launches[k] > 0, f"kernel {k} was not launched by the fit")
    for k in ("closest", "anyhit"):
        check(launches[k] == 0, f"kernel {k} was launched by the mesh fit")
    check(bounds_contain_triangles(torch, ref), "the fitted scene's bounds lose triangles")
    moved = float((ref.mesh_vertices - start.mesh_vertices).abs().max())
    check(moved > 0, "the fit did not move the vertices")

    # 3 steps with a checkpoint, everything dropped, a restart for the other 3
    ckdir = tempfile.mkdtemp(prefix="mafrix_torch_fit_")
    try:
        ck = os.path.join(ckdir, "fit_ck")
        inverse.fit(start, camera, target, steps=steps // 2, checkpoint_path=ck,
                    **common)
        res, res_losses = inverse.fit(
            start, camera, target, steps=steps, checkpoint_path=ck,
            callback=lambda i, loss, params: norms.append(float(torch.sqrt(
                sum((p.detach() ** 2).sum() for p in params.values())))),
            **common)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    check(len(res_losses) == steps - steps // 2, "the restart did not resume")
    same_l = res_losses == ref_losses[steps // 2:]
    same_p = all(torch.equal(getattr(res, n), getattr(ref, n)) for n in names)
    print(f"  restart after {steps // 2} steps: losses bit-equal={same_l}, final "
          f"parameters bit-equal={same_p}")
    check(same_l, f"resumed losses differ: {res_losses} vs {ref_losses[steps // 2:]}")
    check(same_p, "resumed parameters differ from the uninterrupted run's")
    check(all(math.isfinite(n) for n in norms), "a parameter norm is not finite")

    # one gradient evaluation, repeated from the same state
    params = {n: getattr(start, n).detach().clone().requires_grad_() for n in names}
    evaluate = lambda: inverse.loss_and_grads(  # noqa: E731
        params, start, camera, target, rng.root_key(9), spp, config)
    (l1, g1), (l2, g2) = evaluate(), evaluate()
    same_g = torch.equal(l1, l2) and all(torch.equal(g1[n], g2[n]) for n in names)
    gnorm = float(torch.sqrt(sum((g * g).sum() for g in g1.values())))
    print(f"  gradients repeated from the same state: bit-equal={same_g}, "
          f"|grad| {gnorm:.4g}")
    check(same_g, "two gradient evaluations from the same state differ")
    check(math.isfinite(gnorm) and gnorm > 0, "the gradient norm is not finite")
    print(f"  operations named by PyTorch's determinism check in one gradient "
          f"evaluation: {nondeterministic_ops(torch, evaluate) or 'none'}")

    # the flat path trains too: Cornell, albedo only
    from mafrixraytracing_torch.scene.builtin import cornell_box

    small = compile_scene(cornell_box(SMALL, SMALL))
    cfg = P.PathTracerConfig(max_depth=5, compact=(1.0, 0.7, 0.3, 0.15, 0.05))
    with torch.no_grad():
        tgt = P.render_image(small.scene, small.camera, SMALL, SMALL, 16,
                             rng.root_key(0), cfg)
    alb = small.scene.mat_albedo.clone()
    alb[:3] = torch.tensor([0.5, 0.5, 0.5], device=dev)
    cuda.reset_launches()
    _, losses = inverse.fit(small.scene.replace(mat_albedo=alb), small.camera, tgt,
                            ("mat_albedo",), steps=4, lr=5e-2, spp=4,
                            key=rng.root_key(2), config=cfg)
    flat = dict(cuda.LAUNCHES)
    print(f"  fit cornell {SMALL}x{SMALL} x 4 spp, 4 steps: losses "
          f"{[round(l, 5) for l in losses]}, launches {flat}")
    check(all(math.isfinite(l) for l in losses) and losses[-1] < losses[0],
          "the Cornell fit did not reduce the loss")
    for k in ("closest", "anyhit", "unpack", "scatter"):
        check(flat[k] > 0, f"kernel {k} was not launched by the Cornell fit")
    return launches

FLAT, TWO_LEVEL = ("closest", "anyhit"), ("closest_super", "anyhit_super")
RNG = ("rng_fold", "rng_uniform")
FUSED_FLAT = ("fused_closest", "fused_anyhit")
FUSED_TWO_LEVEL = ("fused_closest_super", "fused_anyhit_super")


def phase_fused(torch, list_images):
    """The render path on the fused-cull route (`FUSED_CULL`, the cull inside
    the walks): the frames of phases 3 and 5 again (`list_images`: their
    images by label), then forward + backward on the mesh, each held bit for
    bit against the default path (kernel K and the list walks). The route
    must launch its two fused kernels and no other search kernel, K
    included, and never call the PyTorch cull. -> the route's launch counts
    of one frame."""
    from mafrixraytracing_torch.core import rng
    from mafrixraytracing_torch.integrator import path as P
    from mafrixraytracing_torch.ops import cuda
    from mafrixraytracing_torch.scene.builtin import cornell_box
    from mafrixraytracing_torch.scene.compiler import compile_scene

    W, H = WIDTH, HEIGHT
    searches = set(FLAT + TWO_LEVEL + FUSED_FLAT + FUSED_TWO_LEVEL + ("cull",))

    def counted(on, fn):
        """(fn(), seconds, this call's launch counts) on one of the paths."""
        with fused_cull(on):
            cuda.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0, dict(cuda.LAUNCHES)

    def report(label, runs):
        # runs: default, fused, fused, default
        for name, picked in (("default", (runs[0], runs[3])), ("fused", (runs[1], runs[2]))):
            used = {k: v for k, v in picked[0][2].items() if v}
            print(f"  {label}, {name} path: {picked[0][1]:.3f} and {picked[1][1]:.3f} "
                  f"s/frame, kernel launches per frame {used}")

    launches = {}
    for make_spec, label, list_names, names in (
            (cornell_box, "cornell", FLAT, FUSED_FLAT),
            (mesh_spec, "mesh36996", TWO_LEVEL, FUSED_TWO_LEVEL)):
        cs = compile_scene(make_spec(W, H))
        scene, camera = cs.scene, cs.camera
        with fused_cull():
            config, _ = calibrated_config(scene, camera, W, H, DEPTH)

        def frame(seed):
            with torch.no_grad():
                return P.render_image(scene, camera, W, H, SPP, rng.root_key(seed),
                                      config)

        culls = []
        with counting_pytorch_cull(culls):
            img, _, counts = counted(True, lambda: frame(0))
        same = torch.equal(img, list_images[label])
        print(f"  forward {label} {W}x{H} x {SPP} spp, fused: bit-equal to the default "
              f"path's image={same}, calls of the PyTorch cull {len(culls)}, "
              f"launches {counts}")
        check(bool(torch.isfinite(img).all()), "fused image has non-finite values")
        check(same, f"the fused {label} frame differs from the default path's")
        check(not culls, f"the fused {label} frame called the PyTorch cull")
        for k in names + ("unpack",):
            check(counts[k] > 0, f"kernel {k} was not launched on the fused {label} path")
        for k in searches - set(names):
            check(counts[k] == 0, f"kernel {k} was launched on the fused {label} path")
        launches.update({k: counts[k] for k in names})
        runs = [counted(f, lambda: frame(1)) for f in (False, True, True, False)]
        check(all(torch.equal(r[0], runs[0][0]) for r in runs),
              f"the {label} frames of the two paths differ at seed 1")
        check(all(runs[0][2][k] > 0 for k in list_names) and runs[0][2]["cull"] == 80,
              f"the default path did not run its kernels on {label}")
        report(f"forward {label}", runs)

    # forward + backward on the mesh (still `scene`), as phase 6 takes it
    runs = [counted(f, lambda: fwd_bwd(scene, camera, W, H, SPP, 7, config))
            for f in (False, True, True, False)]
    (img_l, grads_l), (img_f, grads_f) = runs[0][0], runs[1][0]
    same = torch.equal(img_l, img_f) and all(
        torch.equal(a, b) for a, b in zip(grads_l, grads_f))
    print(f"  forward + backward mesh36996: gradients and image of the fused path "
          f"bit-equal to the default path's={same}, |grad albedo|max "
          f"{float(grads_f[0].abs().max()):.4g}")
    check(same, "the fused path's gradients differ from the default path's")
    check(all(bool(torch.isfinite(g).all()) for g in grads_f)
          and float(grads_f[0].abs().max()) > 0, "the fused path's gradients are off")
    check(all(runs[1][2][k] > 0 for k in names + ("unpack", "scatter")),
          "the fused forward + backward did not run its kernels")
    report("forward + backward mesh36996", runs)
    return launches


def moving_sphere_spec(width, height):
    """A red sphere moving along x over a floor under an area light."""
    from mafrixraytracing_torch.scene import spec as S

    floor = S.make_rect_mesh((-4, 0, 4), (4, 0, 4), (4, 0, -4), (-4, 0, -4))
    light = S.make_rect_mesh((-1, 3, -1), (1, 3, -1), (1, 3, 1), (-1, 3, 1))
    return S.SceneSpec(
        camera=S.CameraSpec(position=(0.0, 1.0, 4.0), direction=(0.0, -0.1, -1.0),
                            fov=50.0, fov_convention="standard",
                            aspect=width / height),
        materials=[S.MaterialSpec(albedo=(0.75, 0.75, 0.75)),
                   S.MaterialSpec(albedo=(0.9, 0.2, 0.2))],
        shapes=[S.ShapeSpec(floor, 0)],
        spheres=[S.SphereSpec(center=(-0.8, 0.5, 0.0), radius=0.5, material=1,
                              velocity=(1.6, 0.0, 0.0))],
        area_lights=[S.AreaLightSpec(light, radiance=(14.0,) * 3, visible=False)])


def phase_entry_points(torch):
    """Whitted with the fused search, motion blur, the native OBJ loader."""
    import numpy as np

    from mafrixraytracing_torch.core import rng
    from mafrixraytracing_torch.film.image import write_png
    from mafrixraytracing_torch.film.tonemap import to_bytes, tonemap
    from mafrixraytracing_torch.integrator import path as P
    from mafrixraytracing_torch.integrator.whitted import render_whitted
    from mafrixraytracing_torch.io import native
    from mafrixraytracing_torch.io.obj import load_obj
    from mafrixraytracing_torch.ops import cuda
    from mafrixraytracing_torch.scene.builtin import cornell_box
    from mafrixraytracing_torch.scene.compiler import compile_scene

    n = 128
    cs = compile_scene(cornell_box(n, n))
    with fused_cull(), torch.no_grad():
        cuda.reset_launches()
        a = render_whitted(cs.scene, cs.camera, n, n)
        counts = dict(cuda.LAUNCHES)
        b = render_whitted(cs.scene, cs.camera, n, n)
        torch.cuda.synchronize()
    with torch.no_grad():
        c = render_whitted(cs.scene, cs.camera, n, n)
    print(f"  whitted cornell {n}x{n}, fused: mean {float(a.mean()):.5f}, two renders "
          f"bit-equal={torch.equal(a, b)}, equal to the list path's={torch.equal(a, c)}, "
          f"launches { {k: v for k, v in counts.items() if v} }")
    check(bool(torch.isfinite(a).all()) and 0.02 < float(a.mean()) < 1.0,
          "the Whitted image is off")
    check(torch.equal(a, b), "two Whitted renders differ")
    check(torch.equal(a, c), "the fused Whitted render differs from the list path's")
    check(counts["fused_closest"] > 0 and counts["fused_anyhit"] > 0
          and counts["closest"] == 0 and counts["anyhit"] == 0,
          "the Whitted render did not go through the fused kernels")
    png = os.path.join(tempfile.gettempdir(), "mafrix_torch_whitted.png")
    write_png(png, to_bytes(tonemap(a)).cpu().numpy())
    print(f"  wrote {png}")

    m = SMALL
    ms = compile_scene(moving_sphere_spec(m, m))
    check(abs(float(ms.scene.sph_velocity.abs().max()) - 1.6) < 1e-6,
          "the velocity is lost")
    imgs = {}
    with torch.no_grad():
        for blur in (False, True):
            cfg = P.PathTracerConfig(max_depth=2, rr_enable=False, motion_blur=blur)
            imgs[blur] = P.render_image(ms.scene, ms.camera, m, m, 16,
                                        rng.root_key(3), cfg).cpu().numpy()

    def red_columns(img):
        return int(((img[..., 0] > img[..., 1] * 1.5) & (img[..., 0] > 0.02))
                   .any(axis=0).sum())

    cols = red_columns(imgs[False]), red_columns(imgs[True])
    print(f"  motion blur {m}x{m} x 16 spp: columns the red sphere covers "
          f"{cols[0]} still, {cols[1]} blurred; mean |on - off| "
          f"{float(np.abs(imgs[True] - imgs[False]).mean()):.5f}")
    check(all(np.isfinite(i).all() for i in imgs.values()),
          "a motion-blur image has non-finite values")
    check(cols[1] > cols[0] + 2, "motion blur did not spread the sphere")

    path = mesh_obj()
    t0 = time.perf_counter()
    check(native.available(), f"the native OBJ parser did not build: "
                              f"{native.build_error()}")
    t1 = time.perf_counter()
    fast = load_obj(path, use_native=True)
    t2 = time.perf_counter()
    slow = load_obj(path, use_native=False)
    t3 = time.perf_counter()
    for k in ("vertices", "uvs", "normals", "face_v", "face_t", "face_n",
              "face_group", "face_material"):
        check(np.array_equal(getattr(fast, k), getattr(slow, k)),
              f"the native parser's {k} differ from the Python parser's")
    check(fast.group_names == slow.group_names
          and fast.usemtl_names == slow.usemtl_names
          and fast.face_v.shape == (MESH_FACES, 3), "the native parser's names differ")
    print(f"  native OBJ parser: ready in {t1 - t0:.2f} s (g++ ran when the mesh was "
          f"first loaded); {MESH_FACES} "
          f"faces parsed in {t2 - t1:.4f} s against {t3 - t2:.4f} s in Python, "
          f"arrays equal")


def phase_walk_profile(torch):
    """`profile_walk.main()` at the main path's wavefront size; -> the launch
    counts of the cull kernel and the two instrumented walks on this path."""
    from mafrixraytracing_torch import profile_walk
    from mafrixraytracing_torch.ops import cuda

    cuda.reset_launches()
    record = profile_walk.main([], size=WIDTH)
    launches = dict(cuda.LAUNCHES)
    check(record["clusters"] <= 128 and record["primary"]["rays"] == WAVEFRONT,
          "the walk profile did not run a flat scene at the main path's wavefront")
    for w in ("primary", "bounce1"):
        r = record[w]
        check(r["dbg_equals_closest"] and r["full_equals_closest"]
              and r["cull_kernel_equals_cull"] and r["walked_within_listed"],
              f"the walk profile's equalities failed on the {w} wavefront")
        check(set(r["ms"]) == {"cull", "cull_kernel", "closest", "closest_dbg",
                               "closest_full"} and all(v > 0 for v in r["ms"].values()),
              f"the walk profile's times are missing on the {w} wavefront")
        check(0 < r["walked_per_tile"]["mean"] <= r["listed_per_tile"]["mean"],
              f"walked clusters exceed listed clusters on the {w} wavefront")
    for k in ("cull", "closest", "closest_dbg", "closest_full"):
        check(launches[k] > 0, f"kernel {k} was not launched by the walk profile")
    return {k: launches[k] for k in ("closest_dbg", "closest_full")}


def phase_parallel(torch, dev):
    """The multi-process modules on the one card: an NCCL group of one rank,
    the sharded renders against the unsharded image, a sharded fit against
    the same fit without a mesh."""
    import shutil

    from mafrixraytracing_torch.core import rng
    from mafrixraytracing_torch.integrator import path as P
    from mafrixraytracing_torch.ops import cuda
    from mafrixraytracing_torch.opt import inverse
    from mafrixraytracing_torch.parallel import launch, mesh as pmesh, render as prender
    from mafrixraytracing_torch.scene.compiler import compile_scene

    W, H = WIDTH, HEIGHT
    tmp = tempfile.mkdtemp(prefix="mafrix_torch_parallel_")
    try:
        check(launch.init() is False or os.environ.get("MASTER_ADDR"),
              "launch.init() joined a group that nothing configured")
        t0 = time.perf_counter()
        check(launch.init(f"file://{os.path.join(tmp, 'store')}", 1, 0) is True,
              "launch.init did not bring up the group")
        info = launch.process_info()
        meshes = {"one rank, no group": pmesh.make_mesh(1),
                  "NCCL group of one": launch.global_mesh()}
        print(f"  process group up in {time.perf_counter() - t0:.2f} s: {info}")
        check(info["backend"] == "nccl" and info["process_count"] == 1
              and meshes["NCCL group of one"].group is not None,
              "the process group is not an NCCL group of one")

        cs = compile_scene(mesh_spec(W, H))
        scene, camera = cs.scene, cs.camera
        config = P.PathTracerConfig(max_depth=DEPTH, wavefront=WAVEFRONT)
        key = rng.root_key(0)
        with torch.no_grad():
            ref = P.render_flat_pixels(scene, camera, torch.arange(W * H, device=dev),
                                       W, H, SPP, key, config).reshape(H, W, 3)
        check(bool(torch.isfinite(ref).all()) and 0.02 < float(ref.mean()) < 0.5,
              "the unsharded image is off")
        for name, m in meshes.items():
            cuda.reset_launches()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            img = prender.render_image_sharded(scene, camera, m, W, H, SPP, key, config)
            torch.cuda.synchronize()
            counts = {k: v for k, v in cuda.LAUNCHES.items() if v}
            same = torch.equal(img, ref)
            print(f"  render_image_sharded mesh36996 {W}x{H} x {SPP} spp, {name}: "
                  f"{time.perf_counter() - t1:.3f} s, equal to the unsharded image="
                  f"{same}, launches {counts}")
            check(same, f"the sharded image ({name}) differs from the unsharded one")
            for k in TWO_LEVEL + ("unpack",):
                check(counts.get(k, 0) > 0, f"kernel {k} was not launched by the sharded render")
        avg = prender.render_spp_sharded(scene, camera, meshes["NCCL group of one"],
                                         W, H, 8, key, config)
        check(avg.shape == (H, W, 3) and bool(torch.isfinite(avg).all())
              and abs(float(avg.mean()) - float(ref.mean())) < 0.1 * float(ref.mean()),
              "render_spp_sharded is off")
        print(f"  render_spp_sharded 8 spp: mean {float(avg.mean()):.5f} against "
              f"{float(ref.mean()):.5f} at {SPP} spp")

        # a sharded fit of 2 steps, 2 microbatches, against the same without a mesh
        fs = compile_scene(mesh_spec(W, H, scale=FIT_SCALE))
        with torch.no_grad():
            target = P.render_image(fs.scene, fs.camera, W, H, FIT_SPP, rng.root_key(0),
                                    config)
            albedo = fs.scene.mat_albedo.clone()
            albedo[1] = torch.tensor([0.1, 0.1, 0.1], device=dev)
            start = fs.scene.replace(mat_albedo=albedo)
        names = ("mat_albedo", "light_radiance", "mesh_vertices")
        common = dict(param_names=names, steps=2, lr=FIT_LR, spp=FIT_SPP,
                      key=rng.root_key(3), config=config, smooth_geometry=4,
                      overlap_microbatches=2)
        plain, plain_losses = inverse.fit(start, fs.camera, target, **common)
        cuda.reset_launches()
        t2 = time.perf_counter()
        sharded, losses = inverse.fit(start, fs.camera, target,
                                      mesh=meshes["NCCL group of one"], **common)
        torch.cuda.synchronize()
        counts = {k: v for k, v in cuda.LAUNCHES.items() if v}
        same = losses == plain_losses and all(
            torch.equal(getattr(sharded, n), getattr(plain, n)) for n in names)
        print(f"  fit with mesh=, 2 steps x 2 microbatches of {FIT_SPP // 2} spp: "
              f"{time.perf_counter() - t2:.3f} s, losses {[round(l, 5) for l in losses]}, "
              f"bit-equal to the fit without a mesh={same}, launches {counts}")
        check(same, "the fit with a mesh of one rank differs from the fit without")
        for k in TWO_LEVEL + ("unpack", "scatter"):
            check(counts.get(k, 0) > 0, f"kernel {k} was not launched by the sharded fit")
    finally:
        launch.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)


RASTER = 512                # the rasterizer demo's default frame side
RASTER_SMALL = 64           # side of the card-against-CPU raster comparison
RASTER_RADIUS = 0.6         # the mesh's bounding radius under the demo's camera:
                            # at radius 1 it would fill the frame
PREVIEW = 256               # side and passes of the progressive Cornell
PREVIEW_SPP = 4             # render behind the live preview


def raster_inputs(torch, dev, arrays):
    """The rasterizer's operands on `dev`: the mesh's `arrays` (vertices,
    faces, normals, uvs), a model matrix built there that scales it to a
    bounding radius of RASTER_RADIUS, turns it by 150 degrees about y and
    moves it a little, the demo's camera and a checker texture."""
    import numpy as np

    from mafrixraytracing_torch.core import transform as T
    from mafrixraytracing_torch.materials.texture import checker_texture
    from mafrixraytracing_torch.raster import pipeline as R

    v, faces, normals, uvs = (torch.as_tensor(a, device=dev) for a in arrays)
    s = RASTER_RADIUS / float(np.linalg.norm(arrays[0], axis=1).max())
    model = T.compose(T.scale(s, device=dev), T.rotation_y(150.0, device=dev),
                      T.translation((0.0, -0.05, 0.0), device=dev))
    view = R.look_at((0.0, 0.3, 2.2), (0.0, 0.0, 0.0), device=dev)
    proj = R.perspective(40.0, 1.0, near=0.2, far=20.0, device=dev)
    tex = torch.as_tensor(checker_texture(tiles=16), device=dev)
    return v, faces, normals, uvs, model, view, proj, tex


def raster(args, n):
    """The demo's frame of `args` at n x n (perspective-correct, chunks of 64,
    its two lights and background) through `rasterize`'s own code, with the
    indices its two gathers read: -> (image, best, texel), best each pixel's
    face (-1 where none) and texel the texture row it samples."""
    from mafrixraytracing_torch.examples.rasterize import BACKGROUND, LIGHTS
    from mafrixraytracing_torch.raster import pipeline as R

    return R._frame(*args, n, n, LIGHTS, 64, True, True, BACKGROUND)


def raster_grads(args, n):
    """(image, best, texel, d/dvertices, d/dtexture) of the mean image of
    `raster(args, n)`."""
    v = args[0].clone().requires_grad_(True)
    tex = args[7].clone().requires_grad_(True)
    img, best, texel = raster((v,) + args[1:7] + (tex,), n)
    img.mean().backward()
    return img.detach(), best, texel, v.grad, tex.grad


def png_size(png: bytes):
    """(width, height) from a PNG's signature and IHDR; None if malformed."""
    import struct

    if png[:8] != b"\x89PNG\r\n\x1a\n" or png[12:16] != b"IHDR":
        return None
    return struct.unpack(">II", png[16:24])


def phase_raster_preview(torch, dev, card):
    """The rasterizer at the demo's 512x512 on the mesh of phase 2, its
    gradient, the card against the CPU, the live preview of a progressive
    Cornell render, and the two example entry points."""
    import shutil
    import urllib.request

    import numpy as np

    from mafrixraytracing_torch.core import rng
    from mafrixraytracing_torch.core import transform as T
    from mafrixraytracing_torch.examples import rasterize as raster_demo
    from mafrixraytracing_torch.examples import render_cornell
    from mafrixraytracing_torch.film.film import FilmState
    from mafrixraytracing_torch.film.image import encode_png
    from mafrixraytracing_torch.film.preview import LivePreview
    from mafrixraytracing_torch.integrator import path as P
    from mafrixraytracing_torch.ops import cuda
    from mafrixraytracing_torch.scene.builtin import cornell_box
    from mafrixraytracing_torch.scene.compiler import compile_scene

    n = RASTER
    t_phase = t0 = time.perf_counter()
    arrays = raster_demo.mesh_arrays(mesh_obj())
    args = raster_inputs(torch, dev, arrays)
    check(all(a.is_cuda for a in args), "the raster operands are not on the card")
    print(f"  mesh36996 arrays and operands ready in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()

    # forward at full width
    names = []

    def every_kernel(name):
        names.append(name)
        return "frame"

    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        cuda.reset_launches()
        img, best, texel = raster(args, n)
        torch.cuda.synchronize()
        peak_fwd = torch.cuda.max_memory_allocated() / 2**30
        ours = {k: v for k, v in cuda.LAUNCHES.items() if v}
        ms = time_ms(lambda: raster(args, n), reps=3)
        same = torch.equal(img, raster(args, n)[0])
        t1 = time.perf_counter()
        busy_ms = profiled_ms(torch, lambda: raster(args, n), every_kernel, reps=1,
                              host=False)["frame"]
        s_prof = time.perf_counter() - t1
    covered = float((best >= 0).float().mean())
    print(f"  raster mesh36996 {n}x{n} (perspective-correct, chunk 64, checker texture, "
          f"the demo's two lights): {ms / 1e3:.4f} s/frame by CUDA events (mean of 3 after "
          f"a warm-up), {len(names)} kernel launches a frame, {busy_ms / 1e3:.4f} s of them "
          f"on the device, peak device memory {peak_fwd:.3f} GiB, covered pixels "
          f"{int((best >= 0).sum())} ({covered:.4f}), two frames torch.equal={same}, "
          f"the port's kernels launched {ours} ({card}); profiling took "
          f"{s_prof:.2f} s, the forward block {time.perf_counter() - t0:.2f} s")
    check(bool(torch.isfinite(img).all()), "the raster image has non-finite values")
    check(0.05 <= covered <= 0.95, f"the raster covers {covered:.4f} of the pixels")
    check(same, "two raster frames differ")
    check(not ours, "the raster forward launched a kernel of the port")
    hit = (best >= 0).reshape(n, n, 1)
    bg = torch.tensor(raster_demo.BACKGROUND, device=dev)
    check(bool(torch.where(hit, img, bg).eq(img).all()), "the background is off")

    # gradient of the mean image to the texture and the vertices
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launches()
    t1 = time.perf_counter()
    gv, gt = raster_grads(args, n)[3:]
    torch.cuda.synchronize()
    s_bwd = time.perf_counter() - t1
    peak_bwd = torch.cuda.max_memory_allocated() / 2**30
    ours = {k: v for k, v in cuda.LAUNCHES.items() if v}
    gv2, gt2 = raster_grads(args, n)[3:]
    same_g = torch.equal(gv, gv2) and torch.equal(gt, gt2)
    print(f"  raster forward + backward of the mean image to the texture and the vertices: "
          f"{s_bwd:.4f} s (host clock, first call), peak device memory {peak_bwd:.3f} GiB, "
          f"|d/dvertices|max {float(gv.abs().max()):.4g}, |d/dtexture|max "
          f"{float(gt.abs().max()):.4g}, vertices with a gradient "
          f"{int((gv.abs().sum(1) > 0).sum())}, repeated gradient bit-equal={same_g}, "
          f"the port's kernels launched {ours} ({card})")
    for name, g in (("vertices", gv), ("texture", gt)):
        check(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0,
              f"the raster gradient to the {name} is not finite and non-zero")
    check(same_g, "a repeated raster gradient differs")
    check(ours.get("scatter", 0) == 2, "the raster backward did not sum through kernel J")
    check(peak_bwd < 8.0, f"the raster backward took {peak_bwd:.2f} GiB: not O(pixels)")

    # kernel J on the index sets of the backward's two gathers, against its
    # plain version: the winners' corners (16 columns; every background pixel
    # gathers face 0) and the sampled texels (3 columns)
    gen = torch.Generator(device=dev).manual_seed(12)
    corners = args[1].long()[best.clamp(min=0)].reshape(-1)
    tex_rows = args[7].shape[0] * args[7].shape[1]
    for idx, rows, cols, what in ((corners, args[0].shape[0], 16, "corners"),
                                  (texel, tex_rows, 3, "texels")):
        heavy = float(torch.bincount(idx, minlength=rows).topk(3).values.sum()) / idx.numel()
        print(f"  J on the raster's {what} ({n}x{n}): the 3 most gathered rows take "
              f"{heavy:.4f} of the index set")
        compare_scatter(torch, idx, rows, cols, f"raster {what} {n}x{n}", gen,
                        rows_layout=True)

    # the card against the CPU, through the same code: the image, the
    # winners, the texels and the gradients at RASTER_SMALL
    m = RASTER_SMALL
    cpu_args = raster_inputs(torch, "cpu", arrays)
    t2 = time.perf_counter()
    img_c, best_c, texel_c, gv_c, gt_c = raster_grads(cpu_args, m)
    s_cpu = time.perf_counter() - t2
    img_d, best_d, texel_d, gv_d, gt_d = (t.cpu() for t in raster_grads(args, m))
    s_cmp = time.perf_counter() - t2
    agree = best_c == best_d
    same_texel = agree & ((best_c < 0) | (texel_c == texel_d))
    err = float((img_c - img_d).abs().reshape(-1, 3)[agree].max())
    print(f"  raster {m}x{m}, card against CPU: {int((~agree).sum())} of {agree.numel()} "
          f"pixels show another face, {int((agree & ~same_texel).sum())} another texel, "
          f"max |colour difference| {err:.3g} where they show the same face "
          f"(the CPU took {s_cpu:.2f} s, both {s_cmp:.2f} s)")
    check(float(agree.float().mean()) >= 0.999, "the card and the CPU draw other faces")
    check(float(same_texel.float().mean()) >= 0.999,
          "the card and the CPU sample other texels")
    check(err <= 1e-4, "the card's and the CPU's colours differ")
    # A pixel's gradient reaches its face's three vertices and its texel
    # alone, so rows that a pixel of another face or texel reaches are left
    # out. Tolerance 1e-2 |g_cpu| + 2e-2 median|g_cpu|, well below a typical
    # gradient: the vertex gradient goes through 1 / area of faces below a
    # pixel, so an ulp's change in the vertex stage moves it by a part of the
    # median gradient (the texture's by far less).
    faces_c = cpu_args[1].long()
    off_v = torch.zeros(gv_c.shape[0], dtype=torch.bool)
    for b in (best_c[~same_texel], best_d[~same_texel]):
        off_v[faces_c[b[b >= 0]].reshape(-1)] = True
    off_t = torch.zeros(gt_c.shape[0] * gt_c.shape[1], dtype=torch.bool)
    for t in (texel_c[~same_texel], texel_d[~same_texel]):
        off_t[t] = True
    for name, c, d, off in (("vertices", gv_c, gv_d, off_v),
                            ("texture", gt_c.reshape(-1, 3), gt_d.reshape(-1, 3), off_t)):
        typical = float(c.abs()[c.abs() > 0].median())
        diff = (c - d).abs()[~off]
        tol = 1e-2 * c.abs()[~off] + 2e-2 * typical
        print(f"  raster {m}x{m} gradient to the {name}, card against CPU: max |difference| "
              f"{float(diff.max()):.3g} against a median |gradient| of {typical:.3g} "
              f"(max of |difference| / tolerance {float((diff / tol).max()):.3g}), "
              f"{int(off.sum())} rows left out")
        check(bool((diff <= tol).all()),
              f"the card's and the CPU's raster gradients to the {name} differ")
    v_c, v_d = cpu_args[0], args[0]
    model_c, model_d = cpu_args[4], args[4]
    for name, c, d in (
            ("the model matrix", model_c, model_d),
            ("inverse", T.inverse(model_c), T.inverse(model_d)),
            ("apply_point", T.apply_point(model_c, v_c), T.apply_point(model_d, v_d)),
            ("apply_normal", T.apply_normal(model_c, cpu_args[2]),
             T.apply_normal(model_d, args[2]))):
        diff = float((c - d.cpu()).abs().max())
        print(f"  {name} on the card against the CPU: max |difference| {diff:.3g}")
        check(torch.allclose(c, d.cpu(), rtol=1e-6, atol=1e-6),
              f"{name} differs between the card and the CPU")

    # the live preview of a progressive render, and the two entry points
    tmp = tempfile.mkdtemp(prefix="mafrix_torch_preview_")
    try:
        out = os.path.join(tmp, "cornell.png")
        t3 = time.perf_counter()
        rc = render_cornell.main([out, "--size", f"{PREVIEW}x{PREVIEW}", "--spp",
                                  str(PREVIEW_SPP), "--preview-port", "0"])
        s_main = time.perf_counter() - t3
        with open(out, "rb") as f:
            written = f.read()
        check(rc == 0 and png_size(written) == (PREVIEW, PREVIEW),
              "render_cornell with a live preview did not write its PNG")

        t5 = time.perf_counter()
        cs = compile_scene(cornell_box(PREVIEW, PREVIEW))
        key, config = rng.root_key(0), P.PathTracerConfig()
        film = FilmState.create(PREVIEW, PREVIEW)
        with torch.no_grad():
            for i in range(PREVIEW_SPP):
                film = film.add_frame(P.render_sample_batch(
                    cs.scene, cs.camera, PREVIEW, PREVIEW, i, key, config)
                    .reshape(PREVIEW, PREVIEW, 3))
        frame = film.to_bytes()
        check(frame.is_cuda, "the film is not on the card")
        live = os.path.join(tmp, "live.png")
        preview = LivePreview(live, http_port=0)
        try:
            preview.update(frame)
            url = f"http://127.0.0.1:{preview.port}"
            served = urllib.request.urlopen(url + "/frame.png", timeout=10).read()
            page = urllib.request.urlopen(url + "/", timeout=10).read()
        finally:
            preview.close()
        with open(live, "rb") as f:
            on_disk = f.read()
        same_png = served == on_disk == encode_png(frame)
        print(f"  render_cornell.main {PREVIEW}x{PREVIEW} x {PREVIEW_SPP} spp with "
              f"--preview-port 0: {s_main:.2f} s, wrote {len(written)} bytes; a LivePreview "
              f"fed with the FilmState of {PREVIEW_SPP} passes: served /frame.png "
              f"({len(served)} bytes) equal to the file and to encode_png(film.to_bytes())="
              f"{same_png}, PNG size {png_size(served)}, the page names frame.png="
              f"{b'frame.png' in page}, the same bits as the example's file="
              f"{served == written} (the LivePreview's part {time.perf_counter() - t5:.2f} s)")
        check(same_png, "the served frame differs from the file or from encode_png")
        check(png_size(served) == (PREVIEW, PREVIEW), "the served PNG's header is off")
        check(b"frame.png" in page, "the preview page does not name frame.png")

        out = os.path.join(tmp, "raster.png")
        t4 = time.perf_counter()
        rc = raster_demo.main([out, "--obj", mesh_obj()])
        with open(out, "rb") as f:
            written = f.read()
        print(f"  rasterize.main {RASTER}x{RASTER} on mesh36996: {time.perf_counter() - t4:.2f} s "
              f"with the OBJ's parse ({card})")
        check(rc == 0 and png_size(written) == (RASTER, RASTER),
              "the rasterizer demo did not write its PNG")
        png = os.path.join(tempfile.gettempdir(), "mafrix_torch_raster.png")
        shutil.copyfile(out, png)
        print(f"  wrote {png}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  phase 12 took {time.perf_counter() - t_phase:.1f} s")


SPHERES_SPP = 16            # render_spheres at its 400x200 and depth 8: 16 of its 64 passes
MATRIX = 1024               # the mesh row of the baseline matrix at Renault's size,
MATRIX_PASSES = 16          # in Renault's 16 passes, of 1 spp each here
FIRST_STEPS = 3             # the vertex fit's first steps on the card and the CPU
VERTEX_FIT = (48, 80)       # fit_inverse's vertex fit: its side and its steps
# the wrappers that launch the searches' kernels, as `hold_recorded` names them
WALKS = ("closest_kernel", "anyhit_kernel", "cull_kernel")
SUPER_WALKS = ("closest_super_kernel", "anyhit_super_kernel", "cull_kernel")
FITS = ("albedo error", "mean vertex error", "ground height error")


def captured(fn, *args):
    """(fn(*args), what it printed); the output is echoed, indented."""
    import io
    from contextlib import redirect_stdout

    buf = io.StringIO()
    with redirect_stdout(buf):
        out = fn(*args)
    text = buf.getvalue()
    for line in text.splitlines():
        print("    " + line)
    return out, text


@contextmanager
def recorded(rec):
    """Record the operands of every kernel call the block makes, for
    `hold_recorded`: rec["walks"] (scene, `_prep`'s walk, t_min, any-hit or
    not) of every search, rec["gathers"] (table, idx) of every attribute
    gather and rec["scatters"] (ct, idx, rows) of every scatter-add. The
    calls themselves run as they would."""
    import torch

    from mafrixraytracing_torch.ops import intersect as oi
    from mafrixraytracing_torch.ops import unpack as ou

    prep, gather, scatter = oi._prep, ou.gather_unpack, ou.scatter_rows
    rec.update(walks=[], gathers=[], scatters=[])

    def on_prep(scene, o, d, t_min, t_max, anyhit, fused=False):
        out = prep(scene, o, d, t_min, t_max, anyhit, fused)
        rec["walks"].append((scene, out[0], t_min, anyhit))
        return out

    def on_gather(table, idx):
        rec["gathers"].append((table.contiguous(), idx.to(torch.int64).contiguous()))
        return gather(table, idx)

    def on_scatter(ct, idx, num_rows):
        rec["scatters"].append((ct, idx.to(torch.int64).contiguous(), num_rows))
        return scatter(ct, idx, num_rows)

    with mock.patch.object(oi, "_prep", on_prep), \
            mock.patch.object(ou, "gather_unpack", on_gather), \
            mock.patch.object(ou, "scatter_rows", on_scatter):
        yield rec


def hold_recorded(torch, rec, label, first_of_each=False, require_hits=False):
    """Every kernel call `recorded` saw on a path, against its plain version
    on the same operands: each search's walk (A, B, D or E) bit for bit
    (`compare_closest`, `compare_anyhit`), its cull (K) `torch.equal` to
    `cull_reference`, to the PyTorch cull's operands and to `_prep`'s
    (`compare_cull`), each gather (C) `torch.equal` to `fetch_cols_reference`
    and each scatter-add (J) on its own cotangents `torch.equal` to
    `scatter_rows_ordered_reference` and within tolerance of a float64 sum
    (`compare_scatter`). `first_of_each`: only the first closest-hit and the
    first any-hit search and the first gather (the plain two-level walks take
    seconds a call). `require_hits`: every closest-hit search held must hit a
    ray and every any-hit search occlude one. Returns the number of calls
    held, by kernel."""
    from mafrixraytracing_torch.ops import intersect as oi
    from mafrixraytracing_torch.ops import unpack as ou

    walks, gathers = rec["walks"], rec["gathers"]
    if first_of_each:
        walks = [next(w for w in walks if not w[3]), next(w for w in walks if w[3])]
        gathers = gathers[:1]
    held = {}
    for i, (scene, walk, t_min, anyhit) in enumerate(walks):
        what = f"{label}, search {i}"
        kernel = pick(walk)[2 if anyhit else 0].__name__
        if anyhit:
            found = int(compare_anyhit(walk, t_min, what)[1].sum())
        else:
            found = int((compare_closest(walk, t_min, what)[2] >= 0).sum())
        check(found > 0 or not require_hits, f"{what}: no ray hit or occluded")
        held[kernel] = held.get(kernel, 0) + 1
        if not oi._is_fused(walk) and cull_boxes(scene, walk)[0].shape[0] <= oi.CP:
            compare_cull(scene, walk, t_min, what, timed=False)
            held["cull_kernel"] = held.get("cull_kernel", 0) + 1
    for i, (table, idx) in enumerate(gathers):
        same = torch.equal(ou.unpack_kernel(table, idx), ou.fetch_cols_reference(table, idx))
        print(f"  unpack {label}, gather {i}: B={idx.shape[0]} P={table.shape[0]} "
              f"equal to plain={same}")
        check(same, f"unpack kernel differs from its plain version on {label}")
        held["unpack_kernel"] = held.get("unpack_kernel", 0) + 1
    for i, (ct, idx, rows) in enumerate(rec["scatters"]):
        compare_scatter(torch, idx, rows, ct.shape[0], f"{label}, scatter {i}", None, ct=ct)
        held["scatter_kernel"] = held.get("scatter_kernel", 0) + 1
    print(f"  {label}: held against the plain versions on the path's own operands: {held}")
    return held


def vertex_fit_card_against_cpu(torch, dev, obj, card):
    """fit_inverse's vertex fit (its scene, start, target seed, key, lr and
    spp) on the card against the same fit on the CPU, from one target (the
    card's render, copied): the first step's loss and `mesh_vertices`
    gradient, beside the card's gradient at the same state under the next
    step's key (the Monte-Carlo spread); the first FIRST_STEPS losses of both;
    then on the card the whole fit from the start and from the start with the
    ground rows' y one ulp higher (how far rounding alone moves its end)."""
    from mafrixraytracing_torch.core import rng
    from mafrixraytracing_torch.examples import fit_inverse as F
    from mafrixraytracing_torch.opt import inverse
    from mafrixraytracing_torch.parallel.mesh import make_mesh
    from mafrixraytracing_torch.parallel.render import render_image_sharded
    from mafrixraytracing_torch.scene import assets
    from mafrixraytracing_torch.scene.compiler import compile_scene

    W = H = VERTEX_FIT[0]
    t0 = time.perf_counter()
    start = {}
    for kind, d in (("card", dev), ("cpu", torch.device("cpu"))):
        cs = compile_scene(assets.mesh_scene(obj, W, H), device=d)
        sel = torch.zeros(cs.scene.mesh_vertices.shape[0], dtype=torch.bool, device=d)
        sel[torch.as_tensor(F.ground_rows(cs.scene), device=d)] = True
        up = torch.tensor([0.0, 0.25, 0.0], device=d)
        pert = cs.scene.mesh_vertices + torch.where(sel[:, None], up, torch.zeros_like(up))
        start[kind] = (cs.scene, cs.camera, sel, pert)
    scene, camera, sel, pert = start["card"]
    target = render_image_sharded(scene, camera, make_mesh(1), W, H, 32,
                                  rng.root_key(7, dev), F.CONFIG)

    def first_step(kind, which=1):
        """(loss, gradient) of the fit's step `which - 1` keys at the start."""
        s, cam, _, p = start[kind]
        key = rng.root_key(13, p.device)
        for _ in range(which):
            key, sub = rng.split(key)
        loss, g = inverse.loss_and_grads(
            {"mesh_vertices": p.clone().requires_grad_()},
            inverse.apply_params(s, {"mesh_vertices": p}), cam, target.to(p.device), sub,
            8, F.CONFIG)
        return float(loss), g["mesh_vertices"].cpu()

    def fit(kind, steps, p=None):
        s, cam, _, p0 = start[kind]
        p = p0 if p is None else p
        fitted, losses = inverse.fit(
            inverse.apply_params(s, {"mesh_vertices": p}), cam, target.to(p.device),
            ("mesh_vertices",), steps=steps, lr=8e-3, spp=8,
            key=rng.root_key(13, p.device), config=F.CONFIG)
        true = s.mesh_vertices[:, 1]
        err = float((fitted.mesh_vertices[:, 1] - true).abs()[start[kind][2]].mean())
        return losses, err

    l_d, g_d = first_step("card")
    t1 = time.perf_counter()
    l_c, g_c = first_step("cpu")
    s_cpu = time.perf_counter() - t1
    _, g_next = first_step("card", 2)
    ground = sel.cpu()

    def rel(a, b, rows):
        return float(torch.linalg.norm(a[rows] - b[rows]) / torch.linalg.norm(b[rows]))

    every = torch.ones_like(ground)
    print(f"  vertex fit, card against CPU at the start (first step's key): loss "
          f"{l_d:.7f} / {l_c:.7f} (relative difference {abs(l_d - l_c) / l_c:.3g}); "
          f"|g_card - g_cpu| / |g_cpu| on the 4 ground rows {rel(g_d, g_c, ground):.3g}, "
          f"on all {ground.numel()} rows {rel(g_d, g_c, every):.3g}; the card's gradient "
          f"under the next step's key, against its own: {rel(g_next, g_d, ground):.3g} "
          f"and {rel(g_next, g_d, every):.3g} (the CPU's step took {s_cpu:.1f} s)")
    # Rounding alone at the first step: both see the same target, samples and
    # search answers; they differ only in the order of sums and the last bit
    # of elementwise functions, far below the spread of the gradient between
    # two keys.
    check(abs(l_d - l_c) <= 1e-4 * l_c, "the vertex fit's first loss differs between "
          "the card and the CPU beyond rounding")
    check(rel(g_d, g_c, ground) <= 1e-2 * rel(g_next, g_d, ground),
          "the vertex fit's first gradient differs between the card and the CPU beyond "
          "rounding")
    t1 = time.perf_counter()
    lc, _ = fit("cpu", FIRST_STEPS)
    s_cpu = time.perf_counter() - t1
    ld, _ = fit("card", FIRST_STEPS)
    print(f"  vertex fit, first {FIRST_STEPS} losses: card {[f'{x:.6f}' for x in ld]}, "
          f"CPU {[f'{x:.6f}' for x in lc]} (the CPU took {s_cpu:.1f} s)")
    nudged = pert.clone()
    nudged[sel, 1] = torch.nextafter(pert[sel, 1], torch.full_like(pert[sel, 1], float("inf")))
    steps = VERTEX_FIT[1]
    for name, p in (("the start", None), ("the start, ground y one ulp higher", nudged)):
        losses, err = fit("card", steps, p)
        print(f"  vertex fit on the card from {name}, {steps} steps: loss every 20 steps "
              f"{[round(x, 4) for x in losses[::20] + losses[-1:]]}, ground height error "
              f"{err:.4f} ({card})")
    print(f"  the vertex fit, card against CPU: {time.perf_counter() - t0:.1f} s")


def phase_examples(torch, dev, card):
    """The last four entry points on the card, as a user calls them, each
    path's kernel launches read around it."""
    import re
    import shutil
    import subprocess

    from mafrixraytracing_torch import bench_scaling
    from mafrixraytracing_torch.core import rng
    from mafrixraytracing_torch.examples import baseline_matrix, fit_inverse, render_spheres
    from mafrixraytracing_torch.integrator import path as P
    from mafrixraytracing_torch.ops import cuda
    from mafrixraytracing_torch.opt import inverse
    from mafrixraytracing_torch.parallel.mesh import make_mesh
    from mafrixraytracing_torch.parallel.render import render_image_sharded
    from mafrixraytracing_torch.scene.builtin import cornell_box
    from mafrixraytracing_torch.scene.compiler import compile_scene

    t_phase = time.perf_counter()

    def run(label, fn, *args):
        cuda.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, text = captured(fn, *args)
        torch.cuda.synchronize()
        counts = {k: v for k, v in cuda.LAUNCHES.items() if v}
        print(f"  {label}: {time.perf_counter() - t0:.2f} s, launches {counts} ({card})")
        return out, text, counts

    def launched(counts, kernels, label):
        for k in kernels:
            check(counts.get(k, 0) > 0, f"kernel {k} was not launched by {label}")

    def held(label, fn, kernels, first_of_each=False):
        """Record the kernel calls of fn() and hold each against its plain
        version; `kernels` (wrapper names) must be among them."""
        rec = {}
        with recorded(rec):
            captured(fn)
        got = hold_recorded(torch, rec, label, first_of_each)
        for k in kernels:
            check(got.get(k, 0) > 0, f"no call of {k} was held on {label}")

    tmp = tempfile.mkdtemp(prefix="mafrix_torch_examples_")
    try:
        out = os.path.join(tmp, "spheres.png")
        rc, text, counts = run(f"render_spheres.main 400x200, depth 8, {SPHERES_SPP} spp",
                               render_spheres.main, [out, "--spp", str(SPHERES_SPP)])
        with open(out, "rb") as f:
            check(rc == 0 and png_size(f.read()) == (400, 200),
                  "render_spheres did not write its 400x200 PNG")
        check(f"spp {SPHERES_SPP}/{SPHERES_SPP}" in text, "render_spheres did not finish")
        launched(counts, FLAT + ("unpack", "cull"), "render_spheres")
        shutil.copyfile(out, os.path.join(tempfile.gettempdir(), "mafrix_torch_spheres.png"))
        scene, camera = render_spheres.build(400, 200, dev)
        spheres_cfg = P.PathTracerConfig(max_depth=render_spheres.DEPTH)
        with torch.no_grad():
            held("render_spheres pass 0", lambda: P.render_sample_batch(
                scene, camera, 400, 200, 0, rng.root_key(render_spheres.SEED, dev),
                spheres_cfg), WALKS + ("unpack_kernel",))
        del scene, camera

        rc, text, counts = run("baseline_matrix.main --quick (Cornell 256x256, 16 spp)",
                               baseline_matrix.main, ["--quick", "--out-dir", tmp])
        with open(os.path.join(tmp, "RESULTS.json")) as f:
            results = json.load(f)
        check(rc == 0 and [r["scene"] for r in results] == ["cornell"],
              "baseline_matrix --quick did not write its one record")
        rec = results[0]
        check(rec["finite"] and 0.02 < rec["mean_radiance"] < 0.5
              and f"{rec['device']}, {rec['power_limit']}" == card,
              f"the Cornell record is off: {rec}")
        launched(counts, FLAT + ("unpack", "cull"), "the Cornell row")
        w, h, spp, passes = baseline_matrix.CORNELL
        cs = compile_scene(cornell_box(w, h))
        held("the Cornell row", lambda: baseline_matrix.frame(cs, w, h, spp, 5, passes),
             WALKS + ("unpack_kernel",))
        cs = compile_scene(mesh_spec(MATRIX, MATRIX))
        rec, text, counts = run(
            f"baseline_matrix.run mesh36996 {MATRIX}x{MATRIX}, {MATRIX_PASSES} passes "
            "of 1 spp", baseline_matrix.run, "mesh", cs, MATRIX, MATRIX, MATRIX_PASSES,
            5, MATRIX_PASSES, tmp)
        check(rec["finite"] and 0.02 < rec["mean_radiance"] < 0.5,
              f"the mesh record is off: {rec}")
        launched(counts, TWO_LEVEL + ("unpack", "cull"), "the mesh row")
        check(not any(counts.get(k) for k in FLAT), "the mesh row ran the flat walks")
        held("the mesh row's first pass", lambda: baseline_matrix.frame(
            cs, MATRIX, MATRIX, 1, 5, 1), SUPER_WALKS + ("unpack_kernel",),
            first_of_each=True)
        del cs

        rc, text, counts = run("fit_inverse.main (a seeded OBJ of 5,856 faces)",
                               fit_inverse.main, [os.path.join(tmp, "fit")])
        check(rc == 0 and "sphere5856" in text, "fit_inverse did not run on its stand-in")
        losses = re.findall(r"  loss: ([\d.]+) -> ([\d.]+)", text)
        errors = {m[0]: (float(m[1]), float(m[2])) for m in re.findall(
            r"  (albedo error|mean vertex error|ground height error): ([\d.]+) -> "
            r"([\d.]+)", text)}
        setup = re.search(r"set-up of the three fits .*: ([\d.]+) \+ ([\d.]+) \+ "
                          r"([\d.]+) = ([\d.]+) s", text)
        check(len(losses) == 3 and all(float(b) < float(a) for a, b in losses),
              f"a fit's last loss is not below its first: {losses}")
        check(sorted(errors) == sorted(FITS)
              and all(after < before for before, after in errors.values()),
              f"a fit's parameter error did not shrink: {errors}")
        check(setup is not None, "fit_inverse did not print the set-up of its three fits")
        launched(counts, FLAT + ("unpack", "cull", "scatter"), "fit_inverse")
        pngs = sorted(n for n in os.listdir(tmp) if n.startswith("fit_"))
        check(len(pngs) == 9, f"fit_inverse wrote {pngs}")
        # each fit's renders and first step on the stand-in, its kernels held
        # on their own operands: the backward's scatter-adds into the albedo
        # rows (material indices), the floor's attribute rows and the shared
        # vertex rows (the faces' corners)
        obj = fit_inverse.stand_in_obj(tmp)
        fits = fit_inverse.Fits(None, make_mesh(1), obj, dev)
        for name, fit in (("albedo", fit_inverse.fit_albedo),
                          ("floor", fit_inverse.fit_geometry),
                          ("vertex", fit_inverse.fit_vertices)):
            held(f"the {name} fit's renders and first step", lambda: fit(fits, steps=1),
                 WALKS + ("unpack_kernel", "scatter_kernel"))
        vertex_fit_card_against_cpu(torch, dev, obj, card)

        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "mafrixraytracing_torch.bench_scaling"],
                              capture_output=True, text=True, timeout=600,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        for line in proc.stdout.splitlines():
            print("    " + line)
        print(f"  bench_scaling (its defaults, a world of {torch.cuda.device_count()} "
              f"at most): {time.perf_counter() - t0:.2f} s with the processes' start "
              f"({card})")
        check(proc.returncode == 0, f"bench_scaling failed: {proc.stderr[-2000:]}")
        recs = [json.loads(l) for l in proc.stdout.splitlines() if l.startswith("{")]
        kinds = [r.get("metric") or ("note" if "note" in r else r.get("check")) for r in recs]
        renders = [r for r in recs if r.get("metric") == "scaling_render_rays_per_s"]
        (train,) = [r for r in recs if r.get("metric") == "train_step_seconds"]
        check(renders and renders[0]["devices"] == 1, "no render line of the world of one")
        for r in renders + [train]:
            d = r["detail"]
            check(f"{d['device']}, {d['power_limit']}" == card and d["backend"] == "nccl"
                  and r["virtual_mesh"] is False, f"a scaling record is off: {r}")
        launched(renders[0]["detail"]["launches"], FLAT + ("unpack", "cull"),
                 "bench_scaling's renders")
        launched(train["detail"]["launches"], ("scatter",), "bench_scaling's train step")
        # a render and a train step of the harness's world of one, in this
        # process, their kernels held on their own operands
        W, H, S, D = (int(os.environ.get(k, v)) for k, v in bench_scaling.ENV.items())
        cfg = P.PathTracerConfig(max_depth=D, rr_enable=False)
        cs = compile_scene(cornell_box(W, H))
        held("bench_scaling's render", lambda: render_image_sharded(
            cs.scene, cs.camera, make_mesh(1), W, H, S, rng.root_key(1, dev), cfg),
             WALKS + ("unpack_kernel",))
        target = render_image_sharded(cs.scene, cs.camera, make_mesh(1), W, H, S,
                                      rng.root_key(9, dev), cfg)
        albedo = {"mat_albedo": cs.scene.mat_albedo.detach().clone().requires_grad_()}
        held("bench_scaling's train step", lambda: inverse.loss_and_grads(
            albedo, cs.scene, cs.camera, target, rng.root_key(2, dev), S, cfg),
             WALKS + ("unpack_kernel", "scatter_kernel"))
        if torch.cuda.device_count() == 1:
            check(kinds[0] == "note" and "no scaling_efficiency" in recs[0]["note"]
                  and "scaling_efficiency" not in kinds,
                  "bench_scaling did not say why there is no efficiency line")
        else:
            check(kinds.count("scaling_efficiency") == len(renders) - 1,
                  "bench_scaling printed no efficiency line")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  phase 13 took {time.perf_counter() - t_phase:.1f} s")


REMAT_SPP = (128, 512)       # the remat runs beyond the 64-spp cell


SPHERE_LEAVES = ("mat_albedo", "light_radiance", "tri_v0", "sph_center", "sph_radius")


def run_fwd_bwd(torch, cs, spp, config, names=None):
    """`fwd_bwd` on `cs` at WIDTH x HEIGHT (with gradients to `names`
    where given): (image, gradients, s, peak GiB, peak GiB above what was
    allocated before, launches by kernel)."""
    from mafrixraytracing_torch.ops import cuda

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launches()
    t0 = time.perf_counter()
    img, grads = fwd_bwd(cs.scene, cs.camera, WIDTH, HEIGHT, spp, 0, config,
                         names or GRAD_LEAVES)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    return img, grads, seconds, peak / 2**30, (peak - base) / 2**30, launches


def used(launches):
    """The kernels a run launched, with their counts."""
    return {k: v for k, v in launches.items() if v}


def phase_remat(torch):
    """Memory-bounded gradients (`PathTracerConfig.remat`) on the mesh of
    phase 2: bit-equal to the plain graph, the searches never run again, and
    the memory saved at 512 spp, where `remat` unset chooses checkpoints."""
    from mafrixraytracing_torch.ops import remat
    from mafrixraytracing_torch.scene.compiler import compile_scene

    t_phase = time.perf_counter()
    W, H = WIDTH, HEIGHT
    cs = compile_scene(mesh_spec(W, H))
    config, _ = calibrated_config(cs.scene, cs.camera, W, H, DEPTH)
    modes = {"off": dataclasses.replace(config, remat=False),
             "on": dataclasses.replace(config, remat=True),
             "unset": config}
    check(config.remat is None, "the benchmark's config sets remat")
    dev = cs.scene.tri_v0.device
    with torch.enable_grad():
        choice = {spp: remat.needed(config, spp, W * H, dev) for spp in (SPP, *REMAT_SPP)}
    free = torch.cuda.mem_get_info(dev)[0] / 2**30
    print(f"  remat unset: checkpoints chosen {choice} ({free:.2f} GiB free)")
    check(not choice[SPP] and choice[REMAT_SPP[-1]],
          f"remat unset should checkpoint at {REMAT_SPP[-1]} spp and not at {SPP}")
    small = compile_scene(mesh_spec(SMALL, SMALL))
    for name in ("off", "on", "on"):
        t0 = time.perf_counter()
        fwd_bwd(small.scene, small.camera, SMALL, SMALL, 1, 0,
                dataclasses.replace(modes[name], compact=()))
        torch.cuda.synchronize()
        print(f"  remat {name}, {SMALL}x{SMALL} x 1 spp fwd+bwd (the process's first "
              f"checkpointed call is the second): {time.perf_counter() - t0:.3f} s")
    runs = {}
    print(f"  remat, mesh {W}x{H} x {SPP} spp fwd+bwd, compact "
          f"{[round(c, 4) for c in config.compact]}, in turns")
    for name in ("off", "on", "on", "off"):
        img, grads, sec, peak, above, launches = run_fwd_bwd(torch, cs, SPP, modes[name])
        print(f"  remat {name}: {sec:.3f} s/iter, peak {peak:.3f} GiB ({above:.3f} above "
              f"the scene), launches {used(launches)}")
        runs.setdefault(name, []).append((img, grads, peak, launches))
    img0, grads0, _, l0 = runs["off"][0]
    for name, rs in runs.items():
        for img, grads, _, launches in rs:
            check(torch.equal(img, img0), f"remat {name}: the image differs from remat off")
            for n, g, g0 in zip(("mat_albedo", "light_radiance", "tri_v0"), grads, grads0):
                check(torch.equal(g, g0), f"remat {name}: the gradient of {n} differs")
            for k in ("closest_super", "anyhit_super", "cull", "scatter"):
                check(launches[k] == l0[k] > 0,
                      f"remat {name}: {k} launched {launches[k]} times, {l0[k]} without")
    on_unpack = runs["on"][0][3]["unpack"]
    print(f"  image and gradients torch.equal in all four runs; the walks, K and J launched "
          f"as often with remat as without; unpack {l0['unpack']} without remat, "
          f"{on_unpack} with it (the recompute fetches again)")
    check(on_unpack > l0["unpack"], "the recompute did not fetch again")

    # J on the checkpointed backward's own cotangents, and the first searches
    rec = {}
    with recorded(rec):
        fwd_bwd(cs.scene, cs.camera, W, H, SPP, 0, modes["on"])
    held = hold_recorded(torch, rec, "remat mesh fwd+bwd", first_of_each=True,
                         require_hits=True)
    check(held.get("scatter_kernel", 0) == l0["scatter"],
          "not every scatter-add of the checkpointed backward was held")
    del rec

    peaks = {(SPP, name): runs[name][0][2] for name in ("off", "on")}
    for spp in REMAT_SPP:
        for name in (("off", "on") if spp < REMAT_SPP[-1] else ("unset",)):
            img, grads, sec, peak, above, launches = run_fwd_bwd(torch, cs, spp, modes[name])
            mean = float(img.mean())
            print(f"  remat {name} at {spp} spp: {sec:.3f} s/iter, peak {peak:.3f} GiB "
                  f"({above:.3f} above the scene), mean {mean:.5f}, launches {used(launches)}")
            check(bool(torch.isfinite(img).all()) and 0.02 < mean < 0.5,
                  f"the {spp}-spp image is not sane")
            check(all(bool(torch.isfinite(g).all()) for g in grads),
                  f"a {spp}-spp gradient is not finite")
            peaks[spp, name] = peak
    last = peaks[REMAT_SPP[-1], "unset"]
    check(last < peaks[SPP, "off"],
          f"{REMAT_SPP[-1]} spp with remat unset peaks at {last:.3f} GiB, not below "
          f"{SPP} spp without remat ({peaks[SPP, 'off']:.3f})")
    for name in ("off", "on"):
        lo, hi = peaks[SPP, name], peaks[REMAT_SPP[0], name]
        print(f"  peak memory's growth with spp, remat {name}: "
              f"{(hi - lo) / (REMAT_SPP[0] - SPP):.5f} GiB a spp ({lo:.3f} GiB at {SPP}, "
              f"{hi:.3f} at {REMAT_SPP[0]})")
    del runs, img, grads
    graphs = {"mesh36996": (peaks[SPP, "off"], peaks[REMAT_SPP[0], "off"], config)}
    graphs.update(graph_peaks(torch))
    limit = remat.GRAPH_BYTES / remat.FREE_SHARE
    print(f"  remat.needed's estimate, {remat.GRAPH_BYTES} B a lane-bounce (checkpoints "
          f"past {remat.FREE_SHARE} of the free memory; so no scene may pass "
          f"{limit:.0f} B), against each scene's peak growth without remat, "
          f"{W}x{H}, {SPP} -> {REMAT_SPP[0]} spp:")
    for name, (lo, hi, cfg) in graphs.items():
        lanes = sum(cfg.compact) if cfg.compact else cfg.max_depth
        growth = (hi - lo) / (REMAT_SPP[0] - SPP)
        per_lane = growth * 2**30 / (W * H * lanes)
        print(f"  {name}: {growth:.5f} GiB a spp ({lo:.3f} GiB at {SPP}, {hi:.3f} at "
              f"{REMAT_SPP[0]}), {lanes:.4f} lane-bounces a pixel, {per_lane:.1f} B a "
              f"lane-bounce ({per_lane / remat.GRAPH_BYTES:.3f} of GRAPH_BYTES)")
        check(0 < per_lane <= limit,
              f"{name}'s graph takes {per_lane:.1f} B a lane-bounce: remat unset could "
              f"let it outgrow the card's free memory (the estimate's margin is {limit:.0f})")
    print(f"  phase 14 took {time.perf_counter() - t_phase:.1f} s")


def graph_peaks(torch):
    """Cornell and `sphere_triad` (its gradients also to the spheres) at
    WIDTH x HEIGHT with their own calibrated compaction, remat off: {name:
    (peak GiB at SPP, at REMAT_SPP[0], config)}."""
    from mafrixraytracing_torch.scene.builtin import cornell_box, sphere_triad
    from mafrixraytracing_torch.scene.compiler import compile_scene

    out = {}
    for name, spec, names in (("cornell", cornell_box, None),
                              ("sphere_triad", sphere_triad, SPHERE_LEAVES)):
        cs = compile_scene(spec(WIDTH, HEIGHT))
        config, _ = calibrated_config(cs.scene, cs.camera, WIDTH, HEIGHT, DEPTH)
        off = dataclasses.replace(config, remat=False)
        peaks = []
        for spp in (SPP, REMAT_SPP[0]):
            img, grads, sec, peak, above, launches = run_fwd_bwd(torch, cs, spp, off, names)
            mean = float(img.mean())
            print(f"  {name}, remat off at {spp} spp, compact "
                  f"{[round(c, 4) for c in config.compact]}: {sec:.3f} s/iter, peak "
                  f"{peak:.3f} GiB ({above:.3f} above the scene), mean {mean:.5f}, "
                  f"launches {used(launches)}")
            check(bool(torch.isfinite(img).all()) and mean > 0,
                  f"the {name} {spp}-spp image is not sane")
            check(all(bool(torch.isfinite(g).all()) for g in grads),
                  f"a {name} {spp}-spp gradient is not finite")
            check(all(float(g.abs().max()) > 0 for g in grads[:2]),
                  f"a {name} {spp}-spp albedo or radiance gradient is 0")
            peaks.append(peak)
            del img, grads
        out[name] = (*peaks, config)
    return out


def queued_ms(torch, fn, reps: int = 20) -> float:
    """Device ms a call of fn() takes on the card: CUDA events around `reps`
    calls queued behind a spin of the card (`torch.cuda._sleep`), so the
    host's cost of launching them does not show; the time is the kernels'
    own and the card's gaps between back-to-back launches. Fails if the host
    did not queue every call before the spin ended."""
    fn()
    torch.cuda.synchronize()
    spun, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    spun.record()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    check(host_ms < spun.elapsed_time(start),
          f"the host took {host_ms:.1f} ms to queue {reps} calls, longer than the spin")
    return start.elapsed_time(end) / reps


SPIN_CYCLES = 400_000_000   # ~0.2 s of the card at 1.98 GHz
DISPATCH_SLOTS = 132 * 4 * 32 * 1.98e9   # thread instructions a second: a warp instruction a
                                      # clock from each of 4 schedulers of 132 SMs at boost
INSTR_PER_HASH = 68   # SASS of a threefry2x32 hash (`cuobjdump -sass` of csrc/rng.cu under
                      # NVCC_FLAGS): 20 rounds of an add, an SHF and a LOP3, 8 for the keys
L2_BYTES = 50 * 2**20
RNG_SIZES = (1, 2, 255, 256, 257, 1000, 65_537, 360_000, 1 << 19, (1 << 19) + 77, 1 << 21)
RNG_SCALARS = (0, 3, 97, 2**31, 2**31 + 5, 2**32 - 1, 2**32, -1, -2**31, 2**40 + 5)
RNG_SITES = (0, 1, 2, 10, 11, *range(40, 48), 97, 99, 1000, 1001, 1002)


def phase_rng(torch, dev):
    """The threefry kernels against the RNG's plain version (docstring,
    phase 15). Returns the records of the kernels line: `bounce_key` for
    rng_fold, `uniforms` of two for rng_uniform, both at 2^19 keys."""
    import itertools

    from mafrixraytracing_torch.core import rng
    from mafrixraytracing_torch.ops import cuda
    from mafrixraytracing_torch.utils import trace

    gen = torch.Generator().manual_seed(20)

    def keys_of(n):
        k = torch.randint(0, 2**32, (max(n, 4), 2), generator=gen, dtype=torch.int64)
        k[:4] = torch.tensor([[2**32 - 1, 2**32 - 1], [2**31, 0], [0, 2**31 + 1], [0, 0]])
        return k[:n].to(dev)

    cuda.reset_launches()
    trace.reset_counters()
    draws = cases = 0
    t0 = time.perf_counter()

    def held(label, got, want):
        nonlocal draws, cases
        draws += 1
        cases += 1
        check(got.shape == want.shape and got.dtype == want.dtype and torch.equal(got, want),
              f"rng kernel differs from the plain version: {label}")
        check(cuda.LAUNCHES["rng_fold"] + cuda.LAUNCHES["rng_uniform"] == draws,
              f"rng: {label} did not take exactly one launch")

    for n in RNG_SIZES:
        keys = keys_of(n)
        root = keys[0]
        data = torch.randint(-2**40, 2**40, (n,), generator=gen, dtype=torch.int64).to(dev)
        data[: min(n, 4)] = torch.tensor([2**31, 2**32 - 1, -1, -2**31])[: min(n, 4)].to(dev)
        for x in RNG_SCALARS:
            held(f"bounce_key n={n} x={x}", rng.bounce_key(keys, x), rng._fold_in(keys, x))
        held(f"split_dim n={n}", rng.split_dim(keys, 45), rng._fold_in(keys, 45))
        held(f"fold_in paired n={n}", rng.fold_in(keys, data), rng._fold_in(keys, data))
        held(f"fold_in one key n={n}", rng.fold_in(root, data), rng._fold_in(root, data))
        ar = torch.arange(n, device=dev)
        held(f"pixel_keys n={n}", rng.pixel_keys(root, n), rng._fold_in(root, ar))
        held(f"split n={n}", rng.split(root, n), rng._fold_in(root, ar))
        for G in (1, 4, 16):
            if n * G > (1 << 21) * 4:
                continue
            for off in (0, 2**31 - 2):
                sidx = off + torch.arange(G, device=dev)
                held(f"sample_key outer n={n} G={G} off={off}",
                     rng.sample_key(keys[:, None, :], sidx[None, :]),
                     rng._fold_in(keys[:, None, :], sidx[None, :]))
        for dim in RNG_SITES:
            for shape in ((), (2,), (3,)):
                held(f"uniforms n={n} dim={dim} shape={shape}", rng.uniforms(keys, dim, shape),
                     rng._uniforms(keys, dim, shape))
        for i in range(8):   # the lights' draws: a key a light, then two uniforms
            lk = rng.split_dim(keys, 40 + i)
            draws += 1
            held(f"light {i} n={n}", rng.uniforms(lk, 0, (2,)),
                 rng._uniforms(rng._fold_in(keys, 40 + i), 0, (2,)))
    # forms that take a copy first, and a slice of keys at an odd row
    keys = keys_of(1001)
    odd = [("strided keys", lambda r: r.bounce_key(keys[::3], 4),
            lambda: rng._fold_in(keys[::3], 4)),
           ("int32 data", lambda r: r.fold_in(keys, torch.arange(1001, device=dev,
                                                                  dtype=torch.int32)),
            lambda: rng._fold_in(keys, torch.arange(1001, device=dev))),
           ("keys over data, tiled", lambda r: r.fold_in(keys[:999].reshape(333, 3, 2),
                                                         torch.tensor([4, 5, 6], device=dev)),
            lambda: rng._fold_in(keys[:999].reshape(333, 3, 2),
                                 torch.tensor([4, 5, 6], device=dev))),
           ("slice at row 7", lambda r: r.uniforms(keys[7:1000], 1001, (2,)),
            lambda: rng._uniforms(keys[7:1000], 1001, (2,)))]
    for label, got, want in odd:
        held(label, got(rng), want())
    check(trace.COUNTERS["rng_calls"] == draws,
          "rng: the counter rng_calls disagrees with the draws made")
    print(f"  {cases} cases at {len(RNG_SIZES)} sizes (1 to {max(RNG_SIZES):,} keys): "
          f"every draw torch.equal to the plain version, one launch each "
          f"({cuda.LAUNCHES['rng_fold']} fold, {cuda.LAUNCHES['rng_uniform']} uniform), "
          f"{time.perf_counter() - t0:.1f} s")

    # each draw of the main path at its wavefront sizes, kernel against plain,
    # timed on the card by `queued_ms`: the profiler loses device records in
    # a long process (PERF.md §7). The keys rotate through buffers of twice
    # the L2's 50 MB, so each call reads them from HBM; the bound by bytes
    # counts those reads alone (the writes land in the L2), the bound by
    # dispatch slots INSTR_PER_HASH a hash.
    records, main = [], {}
    for B in (360_000, 1 << 19):
        nxt = itertools.cycle([keys_of(B) for _ in range(1 + 2 * L2_BYTES // (16 * B))]).__next__
        root = keys_of(1)[0]
        G = 16
        sidx = 32 + torch.arange(G, device=dev)
        # (label, kernel, bytes read, hashes, kernel, plain)
        draws_b = [
            ("bounce_key", "rng_fold", 16 * B, B,
             lambda: rng.bounce_key(nxt(), 3), lambda: rng._fold_in(nxt(), 3)),
            ("pixel_keys", "rng_fold", 16, B,
             lambda: rng.pixel_keys(root, B),
             lambda: rng._fold_in(root, torch.arange(B, device=dev))),
            ("sample_key outer", "rng_fold", 16 * (B // G) + 8 * G, B,
             lambda: rng.sample_key(nxt()[: B // G, None, :], sidx[None, :]),
             lambda: rng._fold_in(nxt()[: B // G, None, :], sidx[None, :])),
            *[(f"uniforms n={n}", "rng_uniform", 16 * B, B * (1 + n),
               (lambda sh=sh: rng.uniforms(nxt(), 1000, sh)),
               (lambda sh=sh: rng._uniforms(nxt(), 1000, sh)))
              for n, sh in ((1, ()), (2, (2,)), (3, (3,)))]]
        for label, name, nbytes_, hashes, kern, plain in draws_b:
            cuda.reset_launches()
            kern()
            launches = cuda.LAUNCHES["rng_fold"] + cuda.LAUNCHES["rng_uniform"]
            check(launches == 1 and cuda.LAUNCHES[name] == 1,
                  f"rng {label} B={B}: {launches} launches a call")
            ms = time_ms(kern, reps=50)
            dev_ms = queued_ms(torch, kern, reps=20)
            p_ms = time_ms(plain, reps=5)
            # two calls: the host stalls once some thousand launches wait behind
            # the spin, and a plain draw is up to 349
            p_dev_ms = queued_ms(torch, plain, reps=2)
            by_bytes = nbytes_ / HBM_BYTES_PER_S * 1e3
            by_dispatch = hashes * INSTR_PER_HASH / DISPATCH_SLOTS * 1e3
            bound = max(by_bytes, by_dispatch)
            rec = dict(draw=label, kernel=name, keys=B, kernel_ms=round(ms, 5),
                       kernel_device_ms=round(dev_ms, 5), launches=launches,
                       plain_ms=round(p_ms, 4), plain_device_ms=round(p_dev_ms, 4),
                       bytes_read=nbytes_, hashes=hashes, bound_bytes_ms=round(by_bytes, 5),
                       bound_dispatch_ms=round(by_dispatch, 5), share_of_bound=round(bound / dev_ms, 3))
            records.append(rec)
            print(f"  {label} B={B:,}: kernel {ms:.4f} ms by events, {dev_ms:.4f} ms on the "
                  f"device (queued), {launches} launch; bound {by_bytes:.4f} ms by bytes read, "
                  f"{by_dispatch:.4f} by dispatch slots ({rec['share_of_bound']} of the larger); "
                  f"plain {p_ms:.3f} ms by events, {p_dev_ms:.3f} ms on the device (queued)")
            check(bound <= dev_ms, f"rng {label} B={B}: ran faster than its bound")
            if B == 1 << 19 and label in ("bounce_key", "uniforms n=2"):
                main[name] = dict(max_abs_err=0.0, ms=dev_ms, plain_ms=p_dev_ms,
                                  library_ms=None, bound_ms=bound,
                                  bound_by="bytes" if by_bytes >= by_dispatch else "dispatch slots",
                                  draw=label, keys=B, events_ms=ms, plain_events_ms=p_ms)
    print(json.dumps({"rng_kernels": records}))
    return main


def phase_graph(torch, dev):
    """The live preview's pass replayed as one CUDA graph against the eager
    pass (docstring, phase 16)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from mafrixraytracing_torch.core import rng
    from mafrixraytracing_torch.film.film import FilmState
    from mafrixraytracing_torch.integrator import path as P
    from mafrixraytracing_torch.ops import cuda
    from mafrixraytracing_torch.scene.builtin import cornell_box
    from mafrixraytracing_torch.scene.compiler import compile_scene
    from mafrixraytracing_torch.utils import trace

    side, n = GRAPH_SIDE, GRAPH_PASSES
    cs = compile_scene(cornell_box(side, side))
    config = P.PathTracerConfig()
    key = rng.root_key(22, dev)
    ids = torch.arange(side * side, device=dev)

    def eager(s):
        return P.render_flat_pixels(cs.scene, cs.camera, ids, side, side, 1, key, config,
                                    sample_offset=s)

    def replayed(s):
        return P.render_sample_batch(cs.scene, cs.camera, side, side, s, key, config)

    def changes(l0, c0):
        return ({k: v - l0[k] for k, v in cuda.LAUNCHES.items()},
                {k: v - c0[k] for k, v in trace.COUNTERS.items()})

    def block(fn, samples):
        """Frames, host ms a pass and the counters' change over `samples`,
        each pass as the benchmark's preview takes it."""
        film = FilmState.create(side, side, device=dev)
        l0, c0 = dict(cuda.LAUNCHES), dict(trace.COUNTERS)
        frames, ms, call_ms = [], [], []
        for s in samples:
            t = time.perf_counter()
            frame = fn(s)
            call_ms.append((time.perf_counter() - t) * 1e3)
            film = film.add_frame(frame.reshape(side, side, 3))
            film.to_bytes().cpu()
            ms.append((time.perf_counter() - t) * 1e3)
            frames.append(frame)
        return frames, (ms, call_ms), *changes(l0, c0)

    def profiled(fn, samples):
        """Kernels and device busy ms a pass under torch.profiler."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for s in samples:
                fn(s)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith(("Memcpy", "Memset"))]
        busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        return len(kernels) / len(samples), busy / len(samples)

    P._PASSES.entries.clear()
    rec = {"side": side, "passes_a_block": n}
    with torch.no_grad():
        c0 = dict(trace.COUNTERS)
        check(torch.equal(replayed(0), eager(0)), "the first preview pass is not the eager one")
        check(torch.equal(replayed(1), eager(1)), "the captured preview pass is not the eager one")
        first = changes(dict(cuda.LAUNCHES), c0)[1]
        check(first["graph_captures"] == 1 and first["graph_replays"] == 0,
              f"two preview calls did not capture once: {first}")
        a, b = range(2, 2 + n), range(2 + n, 2 + 2 * n)
        turns = [("eager_1", eager, a), ("replay_1", replayed, a),
                 ("replay_2", replayed, b), ("eager_2", eager, b)]
        out = [block(fn, samples) for _, fn, samples in turns]
        for (label, _, _), (frames, (ms, call_ms), dl, dc) in zip(turns, out):
            rec[label] = {
                "ms_median": round(float(np.median(ms)), 3),
                "call_ms_median": round(float(np.median(call_ms)), 3),
                "ms_p95": round(float(np.percentile(ms, 95)), 3),
                "passes_per_s": round(1e3 * len(ms) / sum(ms), 3)}
        for e, r in ((0, 1), (3, 2)):
            check(all(torch.equal(x, y) for x, y in zip(out[e][0], out[r][0])),
                  f"a replayed preview pass differs from the eager one (block {r})")
            check(out[e][2] == out[r][2], "LAUNCHES a block differ between eager and replay: "
                  f"{out[e][2]} against {out[r][2]}")
            ec = {k: v for k, v in out[e][3].items() if not k.startswith("graph_")}
            rc = {k: v for k, v in out[r][3].items() if not k.startswith("graph_")}
            check(ec == rc, f"COUNTERS a block differ between eager and replay: {ec} against {rc}")
            check(out[r][3]["graph_replays"] == n and out[r][3]["graph_captures"] == 0,
                  f"not every replayed pass replayed: {out[r][3]}")
            check(out[e][3]["graph_replays"] == 0, "an eager pass replayed")
        rec["graph_replays_a_pass"] = (out[1][3]["graph_replays"]
                                       + out[2][3]["graph_replays"]) / (2 * n)
        rec["graph_captures_in_turns"] = out[1][3]["graph_captures"] + out[2][3]["graph_captures"]
        rec["launches_a_pass"] = sum(out[1][2].values()) / n
        del out
        samples = range(2 + 2 * n, 2 + 2 * n + GRAPH_PROFILED)
        rec["profiled_eager"] = [round(v, 3) for v in profiled(eager, samples)]
        rec["profiled_replay"] = [round(v, 3) for v in profiled(replayed, samples)]
    P._PASSES.entries.clear()
    print(f"  eager {rec['eager_1']['ms_median']} / {rec['eager_2']['ms_median']} ms a pass, "
          f"replayed {rec['replay_1']['ms_median']} / {rec['replay_2']['ms_median']} ms "
          f"(medians, in turns); profiler kernels / busy ms a pass: eager "
          f"{rec['profiled_eager']}, replayed {rec['profiled_replay']}")
    print(json.dumps({"graph_preview": rec}))
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from mafrixraytracing_torch.core.device import device_info
    from mafrixraytracing_torch.ops import cuda

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["--walks"]:
        cuda.lib()
        time_walks(torch, dev, *sys.argv[2:4])
        return 0
    print("[1] device and build")
    info = device_info()
    check(info["nvidia_smi"], "nvidia-smi did not report the card")
    print(f"  {info['nvidia_smi']}  torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    lib_path = cuda.build(verbose=True)
    cuda.lib()
    print(f"  built {lib_path.name} in {time.perf_counter() - t0:.2f} s")

    print("[2] kernel parity (kernel vs plain PyTorch version)")
    records = phase_kernels(torch, dev)

    from mafrixraytracing_torch.scene.builtin import cornell_box

    print("[3] forward, Cornell")
    flat, two_level = FLAT, TWO_LEVEL
    fused = FUSED_FLAT + FUSED_TWO_LEVEL      # the fused route's kernels
    launches, _, cornell_img = phase_forward(torch, dev, cornell_box, "cornell",
                                             launched=flat + ("unpack", "cull") + RNG,
                                             idle=two_level + fused)

    print("[4] forward + backward, Cornell")
    phase_fwd_bwd(torch, cornell_box, launched=flat + RNG)

    print("[5] forward, mesh of 36,996 faces")
    mesh_launches, small, mesh_img = phase_forward(
        torch, dev, mesh_spec, "mesh36996", launched=two_level + ("unpack", "cull") + RNG,
        idle=flat + fused)
    phase_textured(torch, small)
    # each kernel's count is that of the path that runs it (the gather and
    # the cull run on both; the mesh path's count is the one recorded)
    launches.update({k: mesh_launches[k] for k in two_level + ("unpack", "cull")})

    print("[6] forward + backward, mesh of 36,996 faces")
    phase_fwd_bwd(torch, mesh_spec, launched=two_level + RNG)

    print("[7] fit, mesh of 36,996 faces (and a short Cornell fit)")
    launches["scatter"] = phase_fit(torch, dev)["scatter"]

    print("[8] the fused-cull search at full width")
    images = {"cornell": cornell_img, "mesh36996": mesh_img}
    launches.update(phase_fused(torch, images))

    print("[9] Whitted, motion blur, the native OBJ loader")
    phase_entry_points(torch)

    print("[10] the walk profile (cull kernel and instrumented walks)")
    launches.update(phase_walk_profile(torch))

    print("[11] the multi-process path on one card")
    phase_parallel(torch, dev)

    print("[12] the rasterizer, the transforms and the live preview")
    phase_raster_preview(torch, dev, info["nvidia_smi"])

    print("[13] render_spheres, baseline_matrix, fit_inverse and the scaling harness")
    phase_examples(torch, dev, info["nvidia_smi"])

    print("[14] memory-bounded gradients (remat) on the mesh; its estimate on three scenes")
    phase_remat(torch)

    print("[15] the threefry kernels")
    records.update(phase_rng(torch, dev))

    print("[16] the live preview's pass as a CUDA graph")
    phase_graph(torch, dev)

    pallas = "mafrixraytracing_tpu/ops/intersect_pallas.py"
    fused_cu = "mafrixraytracing_torch/csrc/intersect_fused.cu"
    sources = {"closest": ("mafrixraytracing_torch/csrc/intersect.cu", pallas + ":356"),
               "anyhit": ("mafrixraytracing_torch/csrc/intersect.cu", pallas + ":450"),
               "unpack": ("mafrixraytracing_torch/csrc/unpack.cu",
                          "mafrixraytracing_tpu/ops/unpack_pallas.py:43"),
               "closest_super": ("mafrixraytracing_torch/csrc/intersect_super.cu",
                                 pallas + ":964"),
               "anyhit_super": ("mafrixraytracing_torch/csrc/intersect_super.cu",
                                pallas + ":1028"),
               "fused_closest": (fused_cu, pallas + ":608"),
               "fused_anyhit": (fused_cu, pallas + ":667"),
               "fused_closest_super": (fused_cu, pallas + ":709"),
               "fused_anyhit_super": (fused_cu, pallas + ":769"),
               "scatter": ("mafrixraytracing_torch/csrc/scatter.cu",
                           "experiments/exp_scatter.py:52"),
               "cull": ("mafrixraytracing_torch/csrc/cull.cu",
                        "experiments/exp_cullkernel.py:78"),
               "closest_dbg": ("mafrixraytracing_torch/csrc/intersect_stats.cu",
                               "experiments/exp6.py:48"),
               "closest_full": ("mafrixraytracing_torch/csrc/intersect_stats.cu",
                                "experiments/exp6.py:104"),
               "rng_fold": ("mafrixraytracing_torch/csrc/rng.cu",
                            "mafrixraytracing_torch/core/rng.py:_fold_in"),
               "rng_uniform": ("mafrixraytracing_torch/csrc/rng.cu",
                               "mafrixraytracing_torch/core/rng.py:_uniforms")}
    kernels = [dict(name=k, route="cuda", source=sources[k][0],
                    replaces=sources[k][1], launches=launches[k], **records[k])
               for k in sources]
    print(json.dumps({"kernels": kernels}))
    print(info["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
