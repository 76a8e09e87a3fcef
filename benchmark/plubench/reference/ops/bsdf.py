"""Branchless BSDF table: eval / sample / pdf per material type.

The reference allocates polymorphic bxdf objects per hit from an arena
(inc/material.h); here each material type's math is evaluated for the whole
ray batch and combined with masked selects on mat_type.

Shading frame (inc/material.h:166-187): N = hit normal, S = normalize(dpdu),
T = cross(N, S). For box x-faces dpdu is parallel to N (see ops/intersect),
making the frame degenerate — reference-faithful.

Faithfully replicated reference details (see the JAX package's
ops/bsdf.py for the citations):
- fresnel_conductor's Rperp2 == 1 (identical numerator and denominator);
- fresnel_dielectric swaps (eta_i, eta_t) when entering;
- specular_transmission wires (et, ei) into fresnel_dielectric(i=et, t=ei);
- bsdf::F sums only non-specular components (only lambert survives);
- bsdf::sampleF picks uniformly among matching components and divides the
  pdf by the match count (glass's two components each get pdf 1/2).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from plubench.reference.ops.safemath import cross, dot, normalize, safe_div, safe_sqrt
from plubench.reference.ops.sampling import cosine_hemisphere_sample
from plubench.reference.scene.types import (
    MAT_DIFFUSE,
    MAT_GLASS,
    MAT_MIRROR,
    MAT_REFRACT,
)

INV_PI = 1.0 / math.pi


class Frame(NamedTuple):
    s: torch.Tensor
    t: torch.Tensor
    n: torch.Tensor


def make_frame(norm, dpdu) -> Frame:
    s = normalize(dpdu)
    return Frame(s=s, t=cross(norm, s), n=norm)


def w2l(f: Frame, v):
    return torch.stack([dot(v, f.s), dot(v, f.t), dot(v, f.n)], -1)


def l2w(f: Frame, v):
    return f.s * v[..., 0:1] + f.t * v[..., 1:2] + f.n * v[..., 2:3]


# ---------------------------------------------------------------------------
# Fresnel
# ---------------------------------------------------------------------------


def fresnel_dielectric_formula(cos_i, cos_t, etai, etat):
    rparl = (etat * cos_i - etai * cos_t) / (etat * cos_i + etai * cos_t)
    rperp = (etai * cos_i - etat * cos_t) / (etai * cos_i + etat * cos_t)
    return (rparl * rparl + rperp * rperp) * 0.5


def fresnel_conductor(cos_i, eta, k):
    """Reference formula incl. the Rperp2 == 1 quirk (inc/material.h:36-45)."""
    ci = cos_i.abs()[..., None]
    tmp0 = eta * eta + k * k
    tmp1 = tmp0 * ci * ci
    rparl2 = (tmp1 - 2.0 * eta * ci + 1.0) / (tmp1 + 2.0 * eta * ci + 1.0)
    return (rparl2 + 1.0) * 0.5


def fresnel_dielectric_eval(cos_i, fr_eta_i, fr_eta_t):
    """fresnel_dielectric::operator() (inc/material.h:95-105): swap the
    index pair when entering (cos_i > 0)."""
    ci = torch.clamp(cos_i, -1.0, 1.0)
    entering = ci > 0.0
    # zero indices belong to rows of other material types (masked later)
    fr_eta_i = torch.where(fr_eta_i == 0.0, 1.0, fr_eta_i)
    fr_eta_t = torch.where(fr_eta_t == 0.0, 1.0, fr_eta_t)
    ei = torch.where(entering, fr_eta_t, fr_eta_i)
    et = torch.where(entering, fr_eta_i, fr_eta_t)
    sin_t = ei / et * safe_sqrt(1.0 - ci * ci)
    tir = sin_t >= 1.0
    cos_t = safe_sqrt(1.0 - sin_t * sin_t)
    f = fresnel_dielectric_formula(
        ci.abs()[..., None], cos_t[..., None], ei[..., None], et[..., None]
    )
    return torch.where(tir[..., None], 1.0, f)


# ---------------------------------------------------------------------------
# NEE-facing eval/pdf (types = all & ~specular: only lambert participates)
# ---------------------------------------------------------------------------


def bsdf_F_nee(mtype, albedo, n_world, wwo, wwi):
    """bsdf::F with non-specular types: lambert R/pi gated by the
    world-space hemisphere test."""
    same_side = dot(wwi, n_world) * dot(wwo, n_world) > 0.0
    diffuse = (mtype == MAT_DIFFUSE) & same_side
    return torch.where(diffuse[..., None], albedo * INV_PI, 0.0)


def bsdf_pdf_nee(frame: Frame, mtype, wwo, wwi):
    """bsdf::pdf averaged over matching non-specular components: lambert's
    default cosine pdf (inc/material.h:67-70) in the local frame."""
    wo = w2l(frame, wwo)
    wi = w2l(frame, wwi)
    same_hemi = wo[..., 2] * wi[..., 2] > 0.0
    cos_pdf = torch.where(same_hemi, wi[..., 2].abs() * INV_PI, 0.0)
    return torch.where(mtype == MAT_DIFFUSE, cos_pdf, 0.0)


# ---------------------------------------------------------------------------
# sampling (bsdf::sampleF)
# ---------------------------------------------------------------------------


class BsdfSample(NamedTuple):
    f: torch.Tensor  # (B,3) bsdf value
    wwi: torch.Tensor  # (B,3) world-space sampled direction
    pdf: torch.Tensor  # (B,)
    is_specular: torch.Tensor  # (B,) bool: sampled component is specular


def bsdf_sample(
    frame: Frame, mtype, albedo, eta3, k3, wwo, u_select, u2,
    non_specular_only: bool = False,
) -> BsdfSample:
    """Sample the BSDF. eta3/k3 are the material's packed eta/k rows:
    MIRROR uses (eta, k) as conductor params; REFRACT packs (eta_t, eta_i);
    GLASS packs (ior,...). u_select picks among matching components,
    u2 feeds the cosine-hemisphere sample for lambert."""
    wo = w2l(frame, wwo)
    cos_wo = wo[..., 2]

    # --- lambert: cosine hemisphere, flipped into wo's hemisphere ---
    wi_d = cosine_hemisphere_sample(u2)
    flip = torch.where(cos_wo < 0.0, -1.0, 1.0)
    wi_d = torch.stack([wi_d[..., 0], wi_d[..., 1], wi_d[..., 2] * flip], -1)
    pdf_d = wi_d[..., 2].abs() * INV_PI
    wwi_d = l2w(frame, wi_d)
    same_side_d = dot(wwi_d, frame.n) * dot(wwo, frame.n) > 0.0
    f_d = torch.where(same_side_d[..., None], albedo * INV_PI, 0.0)

    is_diffuse = mtype == MAT_DIFFUSE
    if non_specular_only:
        # types = all & ~specular: only lambert matches; everything else has
        # zero matching components -> pdf 0, f 0 (material.cpp:19-23)
        return BsdfSample(
            f=torch.where(is_diffuse[..., None], f_d, 0.0),
            wwi=torch.where(is_diffuse[..., None], wwi_d, wwo),
            pdf=torch.where(is_diffuse, pdf_d, 0.0),
            is_specular=torch.zeros_like(is_diffuse),
        )

    # --- specular reflection (mirror half of MIRROR and GLASS) ---
    wi_r = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], -1)
    wwi_r = l2w(frame, wi_r)
    abs_cos_r = torch.clamp(wi_r[..., 2].abs(), min=1e-20)[..., None]
    f_mirror = safe_div(fresnel_conductor(cos_wo, eta3, k3) * albedo, abs_cos_r)
    ior = eta3[..., 0]
    fr_glass = fresnel_dielectric_eval(cos_wo, torch.ones_like(ior), ior)
    f_glass_r = safe_div(fr_glass * albedo, abs_cos_r)

    # --- specular transmission (specular_transmission::sampleF,
    # inc/material.h:137-150; Fr has eta_i = et_ctor, eta_t = ei_ctor) ---
    def transmission(et_ctor, ei_ctor):
        et_ctor = torch.where(et_ctor == 0.0, 1.0, et_ctor)
        ei_ctor = torch.where(ei_ctor == 0.0, 1.0, ei_ctor)
        entering = cos_wo > 0.0
        ei = torch.where(entering, et_ctor, ei_ctor)
        et = torch.where(entering, ei_ctor, et_ctor)
        sin2_i = torch.clamp(1.0 - cos_wo * cos_wo, min=0.0)
        eta = ei / et
        sin2_t = eta * eta * sin2_i
        tir = sin2_t >= 1.0
        cos_t = safe_sqrt(1.0 - sin2_t)
        cos_t = torch.where(entering, -cos_t, cos_t)
        wi = torch.stack([eta * -wo[..., 0], eta * -wo[..., 1], cos_t], -1)
        fr = fresnel_dielectric_eval(cos_wo, et_ctor, ei_ctor)
        scale = (et * et) / (ei * ei)
        f = safe_div(
            scale[..., None] * (1.0 - fr) * albedo,
            torch.clamp(cos_t.abs(), min=1e-20)[..., None],
        )
        f = torch.where(tir[..., None], 0.0, f)
        return f, wi, ~tir

    # REFRACT: ctor (color, eta_t, eta_i) from scene mat_eta (eta_t, eta_i)
    f_t_refract, wi_t_refract, ok_refract = transmission(eta3[..., 0], eta3[..., 1])
    # GLASS transmission: ctor (color, 1, ior)
    f_t_glass, wi_t_glass, ok_glass = transmission(torch.ones_like(ior), ior)
    wwi_t_refract = l2w(frame, wi_t_refract)
    wwi_t_glass = l2w(frame, wi_t_glass)

    is_mirror = mtype == MAT_MIRROR
    is_refract = mtype == MAT_REFRACT
    is_glass = mtype == MAT_GLASS

    # glass: uniform choice among its 2 components, pdf /= 2
    pick_refl = u_select < 0.5
    f_glass = torch.where(pick_refl[..., None], f_glass_r, f_t_glass)
    wwi_glass = torch.where(pick_refl[..., None], wwi_r, wwi_t_glass)
    pdf_glass = torch.where(pick_refl | ok_glass, 0.5, 0.0)

    def by_type(v_d, v_m, v_r, v_g, other, vec):
        w = (lambda m: m[..., None]) if vec else (lambda m: m)
        return torch.where(w(is_diffuse), v_d, torch.where(
            w(is_mirror), v_m, torch.where(
                w(is_refract), v_r, torch.where(w(is_glass), v_g, other))))

    f = by_type(f_d, f_mirror, f_t_refract, f_glass, 0.0, True)
    wwi = by_type(wwi_d, wwi_r, wwi_t_refract, wwi_glass, wwo, True)
    pdf = by_type(pdf_d, 1.0, torch.where(ok_refract, 1.0, 0.0), pdf_glass, 0.0, False)
    return BsdfSample(f=f, wwi=wwi, pdf=pdf, is_specular=is_mirror | is_refract | is_glass)
