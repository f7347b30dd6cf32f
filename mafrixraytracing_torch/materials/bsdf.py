"""Table-driven BSDFs on SoA columns: lambert / metal / dielectric / glossy /
emissive.

Port of the SoA functions of `mafrixraytracing_tpu/materials/bsdf.py`
(`sample_bsdf_soa` `:260`, `eval_bsdf_soa` `:351`, `emitted_soa` `:370`),
which replace the reference's `IMaterial` class zoo
(`Core/Materials/Material.fs:29-125`) with a material table indexed per hit.
Every lobe the scene can contain is evaluated arithmetically and selected
with `torch.where` on the type id; the capability flags skip lobes the scene
cannot contain.

Conventions: `wo` points away from the surface; the hit normal is the
shading normal oriented against the incident ray; a sample's `weight` is
f * cos / pdf.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mafrixraytracing_torch.core import rng, v3
from mafrixraytracing_torch.core.math import fresnel_dielectric
from mafrixraytracing_torch.core.sampling import (
    cosine_hemisphere,
    fuzz_sphere,
    local_to_world,
    uniform_hemisphere,
)
from mafrixraytracing_torch.core.v3 import V3

LAMBERT, METAL, DIELECTRIC, EMISSIVE, GLOSSY = 0, 1, 2, 3, 4
INV_PI = 1.0 / math.pi
TWO_PI = 2.0 * math.pi


class BsdfSample(NamedTuple):
    wi: V3                  # sampled direction (unit)
    weight: V3              # f * cos / pdf
    pdf: torch.Tensor       # solid-angle pdf (1 for delta lobes)
    specular: torch.Tensor  # delta lobe
    valid: torch.Tensor


def sample_bsdf_soa(sh, hit, wo: V3, key, glossy: bool = True,
                    metal: bool = True, dielectric: bool = True,
                    uniform_lambert: bool = False) -> BsdfSample:
    """Sample a scattering direction per ray. The `glossy`/`metal`/
    `dielectric` flags (the scene's `has_*`) skip lobes statically; with all
    False this is the pure-lambert shader. `uniform_lambert` samples the
    lambert lobe uniformly over the hemisphere with the reference's folded
    weight albedo / pi * cos * 2 pi (`Material.fs:33-36`), for the
    reference-parity estimator."""
    n = hit.normal
    d = -wo
    u_l = rng.uniforms(key, 0, (2,))

    # --- lambert (every scene's base lobe) ---
    if uniform_lambert:
        wi = uniform_hemisphere(u_l, n)
        cos_lam = torch.clamp(v3.dot(wi, n), min=0.0)
        pdf = torch.full_like(cos_lam, 1.0 / TWO_PI)
        weight = sh.albedo * (2.0 * cos_lam)
    else:
        wi, pdf = cosine_hemisphere(u_l, n)  # cosine-weighted
        cos_lam = torch.clamp(v3.dot(wi, n), min=0.0)
        weight = sh.albedo
    valid = cos_lam > 0.0
    specular = torch.zeros_like(valid)
    if metal or glossy:
        refl = v3.reflect(d, n)

    # --- metal: mirror + fuzz (reference `Material.fs:58-72`) ---
    if metal:
        u_f = rng.uniforms(key, 1, (3,))
        is_met = sh.mtype == METAL
        wi_met = v3.normalize(refl + fuzz_sphere(u_f) * sh.fuzz)
        met_ok = v3.dot(wi_met, n) > 0.0
        wi = v3.where(is_met, wi_met, wi)
        weight = v3.where(is_met, sh.albedo, weight)
        pdf = torch.where(is_met, 1.0, pdf)
        valid = torch.where(is_met, met_ok, valid)
        specular = specular | is_met

    # --- dielectric: Fresnel-chosen reflect or refract ---
    if dielectric:
        u_c = rng.uniforms(key, 2)
        is_die = sh.mtype == DIELECTRIC
        cos_i = torch.clamp(-v3.dot(d, n), 0.0, 1.0)
        eta_i = torch.where(hit.front_face, 1.0, sh.ior)
        eta_t = torch.where(hit.front_face, sh.ior, 1.0)
        fr = fresnel_dielectric(cos_i, eta_i, eta_t)
        ref_ok, refr = v3.refract(d, n, eta_i / eta_t)
        refr = v3.normalize(refr)
        choose_reflect = (u_c < fr) | ~ref_ok
        wi_die = v3.where(choose_reflect, v3.reflect(d, n), refr)
        # the refracted branch carries (eta_t / eta_i)^2, the reference's
        # transmission weight (`Material.fs:103-118`) with (1 - F) and the
        # delta cos cancelled
        eta_scale = torch.where(choose_reflect, 1.0, (eta_t / eta_i) ** 2)
        wi = v3.where(is_die, wi_die, wi)
        weight = v3.where(is_die, sh.albedo * eta_scale, weight)
        pdf = torch.where(is_die, 1.0, pdf)
        valid = torch.where(is_die, True, valid)
        specular = specular | is_die

    # --- glossy: normalized Phong lobe around the mirror direction ---
    if glossy:
        is_glo = sh.mtype == GLOSSY
        exp_g = torch.clamp(sh.fuzz, min=1.0)
        cos_a = torch.clamp(u_l[..., 0], 1e-6, 1.0) ** (1.0 / (exp_g + 1.0))
        sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
        phi_g = 2.0 * math.pi * u_l[..., 1]
        wi_glo = local_to_world(sin_a * torch.cos(phi_g),
                                sin_a * torch.sin(phi_g), cos_a, refl)
        cos_glo = v3.dot(wi_glo, n)
        pdf_glo = (exp_g + 1.0) / (2.0 * math.pi) * cos_a**exp_g
        w_glo = sh.albedo * ((exp_g + 2.0) / (exp_g + 1.0)
                             * torch.clamp(cos_glo, min=0.0))
        wi = v3.where(is_glo, wi_glo, wi)
        weight = v3.where(is_glo, w_glo, weight)
        pdf = torch.where(is_glo, pdf_glo, pdf)
        valid = torch.where(is_glo, cos_glo > 0.0, valid)

    return BsdfSample(wi=wi, weight=weight, pdf=pdf, specular=specular,
                      valid=valid)


def eval_bsdf_soa(sh, hit, wi: V3, wo: V3 | None = None):
    """(f, pdf) for a given direction, for NEE and MIS; delta lobes give 0.
    The glossy lobe needs `wo` (without it glossy evaluates to 0)."""
    cos_wi = v3.dot(wi, hit.normal)
    lam = (sh.mtype == LAMBERT) & (cos_wi > 0.0)
    zero = torch.zeros_like(cos_wi)
    f = v3.where(lam, sh.albedo * INV_PI, V3(zero, zero, zero))
    pdf = torch.where(lam, torch.clamp(cos_wi, min=0.0) * INV_PI, 0.0)
    if wo is not None:
        exp_g = torch.clamp(sh.fuzz, min=1.0)
        r = v3.reflect(-wo, hit.normal)
        cos_a = torch.clamp(v3.dot(r, wi), min=0.0)
        glo = (sh.mtype == GLOSSY) & (cos_wi > 0.0) & (cos_a > 0.0)
        f = v3.where(glo, sh.albedo * ((exp_g + 2.0) / TWO_PI * cos_a**exp_g), f)
        pdf = torch.where(glo, (exp_g + 1.0) / TWO_PI * cos_a**exp_g, pdf)
    return f, pdf


def emitted_soa(sh, hit) -> V3:
    """Emitted radiance at a hit; one-sided unless the emitter is two-sided
    (reference `NewAreaLight.L`, `Core/Lights/Light.fs:48-56`)."""
    emits = hit.valid & (hit.front_face | sh.two_sided)
    zero = torch.zeros_like(hit.t)
    return v3.where(emits, sh.emission, V3(zero, zero, zero))
