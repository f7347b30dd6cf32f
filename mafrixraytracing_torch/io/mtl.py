"""Wavefront MTL loader.

A copy of `mafrixraytracing_tpu/io/mtl.py` (NumPy only): importing any module
of that package imports JAX, and the port runs where JAX is absent.

Grammar parity with the reference's FParsec MTL parser
(`Models/Obj_Mtl.fs:199-217`): newmtl / Ka / Kd / Ks / Ke / Tr / d / illum /
Ns / Ni / map_* / bump per material. Mapping to our material table:

- Kd -> lambert albedo. (The reference wires **Ka** — ambient — into
  `Lambertian(ka)` at `Obj_Mtl.fs:195`, a flagged bug (SURVEY §7); we use Kd
  and fall back to Ka only when Kd is absent.)
- Ke nonzero -> emissive material.
- high Ks with low Kd and illum >= 3 -> metal (specular reflection).
- Ni != 1 with transparency (d < 1 or Tr > 0) -> dielectric.
- map_Kd is recorded as a texture path for the caller to load.
"""
from __future__ import annotations

import numpy as np

from mafrixraytracing_torch.scene.spec import MaterialSpec


def _floats(parts):
    return tuple(float(x) for x in parts)


def load_mtl(path: str) -> dict:
    """Parse an MTL file -> {name: MaterialSpec}. Texture paths are stored on
    the spec as `texture_path` attribute (consumed by `scene.assets`)."""
    raw: dict = {}
    cur = None

    with open(path, "r", errors="replace") as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            tag = parts[0]
            if tag == "newmtl":
                cur = {
                    "Ka": None, "Kd": None, "Ks": None, "Ke": None,
                    "Ns": 0.0, "Ni": 1.0, "d": 1.0, "Tr": 0.0, "illum": 2,
                    "map_Kd": None,
                }
                raw[parts[1]] = cur
            elif cur is None:
                continue
            elif tag in ("Ka", "Kd", "Ks", "Ke"):
                cur[tag] = _floats(parts[1:4])
            elif tag in ("Ns", "Ni", "d", "Tr"):
                cur[tag] = float(parts[1])
            elif tag == "illum":
                cur[tag] = int(float(parts[1]))
            elif tag == "map_Kd":
                cur["map_Kd"] = " ".join(parts[1:])
            # map_Ka/map_Ks/map_Ns/bump accepted+ignored (reference parity)

    out = {}
    for name, m in raw.items():
        spec = _classify(m)
        spec.texture_path = m["map_Kd"]  # dynamic attr consumed by scene build
        out[name] = spec
    return out


def _classify(m: dict) -> MaterialSpec:
    kd = m["Kd"] if m["Kd"] is not None else (m["Ka"] or (0.8, 0.8, 0.8))
    ke = m["Ke"] or (0.0, 0.0, 0.0)
    ks = m["Ks"] or (0.0, 0.0, 0.0)
    transparent = (m["d"] < 1.0) or (m["Tr"] > 0.0)

    if max(ke) > 0.0:
        return MaterialSpec(type="emissive", albedo=kd, emission=ke)
    if transparent and abs(m["Ni"] - 1.0) > 1e-6:
        return MaterialSpec(type="dielectric", albedo=(1.0, 1.0, 1.0), ior=m["Ni"])
    if m["illum"] >= 3 and max(ks) > 0.5 and max(kd) < 0.3:
        # shiny metal-like: map Ns (0..1000) to fuzz (1 -> 0)
        fuzz = float(np.clip(1.0 - m["Ns"] / 1000.0, 0.0, 1.0))
        return MaterialSpec(type="metal", albedo=ks, fuzz=fuzz)
    return MaterialSpec(type="lambert", albedo=kd)
