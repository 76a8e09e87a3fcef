"""Light sampling: point lights and diffuse area lights.

Reference: inc/light.h:15-35 (point), inc/lights/area_light.h:12-43 (area),
carrier-surface sampling inc/surfaces/{sphere,box,triangle}, and the
solid-angle pdf surface::pdf(p, wi) (inc/surface.h:27-33) whose distance
term is the squared distance of the hit point from the WORLD ORIGIN — a
reference bug that changes images, replicated behind
RenderOptions.origin_distance_pdf.

The primary implementations operate on pre-gathered packed rows
(ops.tables); the scene-based wrappers at the bottom keep the simple API
for tests, tools and user code.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from plubench.reference.ops import intersect
from plubench.reference.ops.safemath import dot, normalize, safe_div, sqrt
from plubench.reference.ops.sampling import uniform_sphere_sample
from plubench.reference.ops.tables import (
    LightRows,
    PrimRows,
    gather_light,
    gather_prim,
    pack_tables,
)
from plubench.reference.scene.types import (
    LIGHT_AREA,
    LIGHT_POINT,
    PRIM_BOX,
    PRIM_SPHERE,
)


def sample_surface_rows(rows: PrimRows, u2, u_face, u_axis):
    """Sample a point + normal on pre-gathered primitive rows.

    - sphere (inc/surfaces/sphere.h:18-22): uniform sphere point.
    - box (inc/surfaces/box.h:23-47): U = (u2.x, u_face, u2.y); snap a
      random axis (u_axis picks 0..2) to its 0/1 face by >0.5; normal is
      that axis's sign.
    - triangle (src/surfaces/triangle.cpp:35-39): barycentric with
      w = 1-(u.x+u.y) (can leave the triangle when u.x+u.y > 1 —
      reference-faithful).
    """
    ptype = rows.ptype
    a, b, c = rows.a, rows.b, rows.c

    ns_s = uniform_sphere_sample(u2)
    ps_s = a + ns_s * b[..., 0:1]

    U = torch.stack([u2[..., 0], u_face, u2[..., 1]], -1)
    mi = torch.clamp((u_axis * 3.0).to(torch.int64), max=2)
    picked = torch.gather(U, -1, mi[..., None])[..., 0]
    snapped = torch.where(picked > 0.5, 1.0, 0.0)
    onehot = F.one_hot(mi, 3).to(U.dtype)
    U = U * (1.0 - onehot) + snapped[..., None] * onehot
    ps_b = a + U * (b - a)
    ns_b = onehot * torch.where(picked > 0.5, 1.0, -1.0)[..., None]

    ux = u2[..., 0:1]
    uy = u2[..., 1:2]
    wz = 1.0 - (ux + uy)
    ps_t = a * ux + b * uy + c * wz
    ns_t = rows.n0 * ux + rows.n1 * uy + rows.n2 * wz

    is_s = (ptype == PRIM_SPHERE)[..., None]
    is_b = (ptype == PRIM_BOX)[..., None]
    ps = torch.where(is_s, ps_s, torch.where(is_b, ps_b, ps_t))
    ns = torch.where(is_s, ns_s, torch.where(is_b, ns_b, ns_t))
    return ps, ns


def surface_pdf_rows(rows: PrimRows, p, wi, options):
    """surface::pdf(p, wi) against pre-gathered carrier rows: trace this
    primitive only; 0 on miss, else dist^2 / (|cos| * area) — dist^2 is the
    hit point's squared distance from the WORLD ORIGIN under
    options.origin_distance_pdf (the reference bug), else textbook t^2."""
    t = intersect.prim_t_rows(p, wi, rows)
    found = t < intersect.T_MAX
    ts = torch.where(found, t, 0.0)
    hitp = p + wi * ts[..., None]
    det = intersect.hit_detail_rows(p, wi, ts, rows.ptype * 0, found, rows)
    dist2 = dot(hitp, hitp) if options.origin_distance_pdf else ts * ts
    denom = dot(det.norm, -wi).abs() * rows.area
    pdf = safe_div(dist2, torch.clamp(denom, min=1e-20))
    return torch.where(found, pdf, 0.0)


class LightSample(NamedTuple):
    Li: torch.Tensor  # (B,3) incident radiance
    wi: torch.Tensor  # (B,3) direction to light
    pdf: torch.Tensor  # (B,)
    is_delta: torch.Tensor  # (B,) bool


def sample_light_rows(
    lrows: LightRows, carrier: PrimRows, p, u2, u_face, u_axis, options,
) -> LightSample:
    """light::sampleL(p, smp, &wi, &pdf, &vis) from pre-gathered rows."""
    is_delta = lrows.ltype == LIGHT_POINT

    # point light (inc/light.h:20-27); squared distance clamped at 1e-20
    l2p = lrows.pos - p
    len2 = torch.clamp(dot(l2p, l2p), min=1e-20)
    wi_p = l2p / sqrt(len2)[..., None]
    li_p = safe_div(lrows.intensity, len2[..., None])

    # diffuse area light (inc/lights/area_light.h:25-31)
    ps, ns = sample_surface_rows(carrier, u2, u_face, u_axis)
    wi_a = normalize(ps - p)
    pdf_a = surface_pdf_rows(carrier, p, wi_a, options)
    # L(ps, ns, -wi): one-sided emission using the light's own normal here
    front = dot(ns, -wi_a) > 0.0
    li_a = torch.where(front[..., None], lrows.intensity, 0.0)

    d = is_delta[..., None]
    return LightSample(
        Li=torch.where(d, li_p, li_a),
        wi=torch.where(d, wi_p, wi_a),
        pdf=torch.where(is_delta, 1.0, pdf_a),
        is_delta=is_delta,
    )


def light_pdf_rows(lrows: LightRows, carrier: PrimRows, p, wi, options):
    """light::pdf(p, wi): 0 for delta lights, surface pdf for area lights."""
    pdf_a = surface_pdf_rows(carrier, p, wi, options)
    return torch.where(lrows.ltype == LIGHT_AREA, pdf_a, 0.0)


def emitted_rows(prim_rows: PrimRows, lrows_of_prim: LightRows, norm, w):
    """material::Le at a hit: the linked area light's one-sided Lemit
    (area_light.h:21-23 via material.cpp:67-70); 0 for non-emissive.
    lrows_of_prim: light rows gathered at max(prim_rows.light, 0)."""
    has = prim_rows.light >= 0
    gate = dot(norm, w) > 0.0
    return torch.where((has & gate)[..., None], lrows_of_prim.intensity, 0.0)


# ---------------------------------------------------------------------------
# scene-based wrappers (tests/tools API)
# ---------------------------------------------------------------------------


def _light_and_carrier(scene, light_idx):
    tables = pack_tables(scene)
    lrows = gather_light(tables, light_idx)
    return lrows, gather_prim(tables, torch.clamp(lrows.prim, min=0))


def light_pdf(scene, light_idx, p, wi, options):
    lrows, carrier = _light_and_carrier(scene, light_idx)
    return light_pdf_rows(lrows, carrier, p, wi, options)


def emitted(scene, prim_idx, norm, w):
    tables = pack_tables(scene)
    prows = gather_prim(tables, prim_idx)
    lrows = gather_light(tables, torch.clamp(prows.light, min=0))
    return emitted_rows(prows, lrows, norm, w)
