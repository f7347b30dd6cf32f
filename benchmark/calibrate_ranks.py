"""The compaction schedule of the data-parallel fit's cell
(`kinds/fit_ranks.py`), read once on a card when the cell is defined; the
benchmark's own runs do not run this.

    python3 benchmark/calibrate_ranks.py schedule <workload>
        The survival profile of each rank's shard of the pixels at 1 spp
        (the program's `trace_stats` at the pixel centres, seed 123, as
        `calibrate.py schedule` takes the whole frame's) and the schedule
        frozen from them: 1, then at each bounce the largest of the shards'
        live shares x 1.12 + 0.01. One card.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def schedule(name):
    from benchmark import loops, manifest, scenes
    from benchmark.reference import fit_ranks as ref_ranks, rng as ref_rng
    from mafrixraytracing_torch.integrator import path as P

    c = manifest.cell(name)
    W, H = scenes.film(c["config"])
    world = c["config"]["deployment"]["ranks"]
    cs = scenes.program_scene(c["config"], "cuda", c["traffic"].get("scene_scale", 1.0))
    cfg = loops.program_config(c, compact=())
    profiles = []
    for r in range(world):
        ids = ref_ranks.shard_ids(W * H, world, r, "cuda")
        px, py = (ids % W).float(), (ids // W).float()
        keys = ref_rng.fold_in(ref_rng.root_key(123, "cuda"), ids)
        o, d = cs.camera.get_rays((px + 0.5) / W, (py + 0.5) / H)
        _, prof = P.trace_stats(cs.scene, o, d, keys, cfg, return_profile=True)
        profiles.append([round(float(p), 4) for p in prof])
    top = [max(p[b] for p in profiles) for b in range(len(profiles[0]))]
    sched = [1.0] + [round(min(1.0, p * 1.12 + 0.01), 4) for p in top[1:]]
    print(json.dumps({"workload": name, "survival": profiles, "largest": top,
                      "compact": sched}), flush=True)


def main(argv) -> int:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if len(argv) != 2 or argv[0] != "schedule":
        raise SystemExit(f"usage: {__doc__.splitlines()[4].strip()}")
    schedule(argv[1])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
