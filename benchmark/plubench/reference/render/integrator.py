"""Path-tracing integrator: next-event estimation + MIS, fixed depth.

Faithful to renderer::ray_color / estimate_direct_light /
uniform_sample_one_light (src/renderer.cpp:5-96): shading vertices at
bounces 0..max_bounces-1, no Russian roulette, emission only at the first
vertex or after a specular bounce, one uniformly chosen light per vertex,
the reference's MIS and pdf quirks behind RenderOptions switches, escaped
rays contribute nothing.

``ray_color_plain`` is the plain PyTorch integrator: a Python loop of
``plain_bounce`` (one shading vertex for every ray) on batched tensors,
taking the uniforms ``u`` (max_bounces, B, 12) as an input. It is
differentiable as written (the guarded ops of ops/safemath.py keep its
backward finite).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from plubench.reference.semantics import DEFAULT_OPTIONS, RenderOptions
from plubench.reference.ops import bsdf as bsdf_ops
from plubench.reference.ops import intersect, lights
from plubench.reference.ops.safemath import dot, safe_div
from plubench.reference.ops.tables import (
    gather_light,
    gather_mat,
    gather_prim,
    gather_prim_light,
    gather_tex,
    pack_tables,
)
from plubench.reference.ops.texture import eval_color_rows

class PathState(NamedTuple):
    """The per-ray state carried from one shading vertex to the next (the
    JAX stream kernel's carry): ray, throughput, radiance so far, whether
    the last bounce was specular, whether the path is alive, and the hit
    of the ray (prim, t; found is t < T_MAX)."""

    o: torch.Tensor  # (B,3)
    d: torch.Tensor  # (B,3)
    T: torch.Tensor  # (B,3)
    L: torch.Tensor  # (B,3)
    prev_spec: torch.Tensor  # (B,) bool
    alive: torch.Tensor  # (B,) bool
    prim: torch.Tensor  # (B,) i32
    t: torch.Tensor  # (B,) f32


def _clip_pdf(x):
    return torch.clamp(x, 1e-12, 1e9)


def _nee_contributions(
    hit, frame, mtype, albedo, wwo, options, ls, bs, lrows, carrier,
    shadow_found, shadow_hits_light, nee_found, nee_hits_light, nee_norm,
):
    """Assemble estimate_direct_light (renderer.cpp:5-51) once visibility
    results for the shadow ray and the BSDF-strategy ray are known.
    Returns the two strategies' contributions and the BSDF direction's
    light pdf.

    Every pdf entering arithmetic is clipped to [1e-12, 1e9] (gates keep
    the raw values), so no inf ever materializes in the weights."""
    n = hit.norm

    # ---- light-sampling strategy ----
    f = bsdf_ops.bsdf_F_nee(mtype, albedo, n, wwo, ls.wi)
    unoccl = ~shadow_found | (~ls.is_delta & shadow_hits_light)
    b_pdf = bsdf_ops.bsdf_pdf_nee(frame, mtype, wwo, ls.wi)
    bp = _clip_pdf(b_pdf)
    lp = _clip_pdf(ls.pdf)
    if options.swapped_light_mis_weight:
        w = safe_div(bp * bp, bp * bp + lp * lp)
    else:
        w = safe_div(lp * lp, bp * bp + lp * lp)
    # the historical zero-weight outcome when BOTH raw pdfs are zero
    w = torch.where((b_pdf == 0.0) & (ls.pdf == 0.0), 0.0, w)
    w = torch.where(ls.is_delta, 1.0, w)
    gate_l = (ls.pdf > 0.0) & (dot(ls.Li, ls.Li) > 0.0) & (dot(f, f) > 0.0) & unoccl
    scale_l = torch.where(gate_l, safe_div(dot(ls.wi, n).abs() * w, lp), 0.0)
    contrib_l = torch.where(gate_l[..., None], f * ls.Li * scale_l[..., None], 0.0)

    # ---- BSDF-sampling strategy (non-delta lights only) ----
    l_pdf2 = lights.light_pdf_rows(lrows, carrier, hit.p, bs.wwi, options)
    bp2 = _clip_pdf(bs.pdf)
    lp2 = _clip_pdf(l_pdf2)
    w2 = safe_div(bp2 * bp2, bp2 * bp2 + lp2 * lp2)
    w2 = torch.where((bs.pdf == 0.0) & (l_pdf2 == 0.0), 0.0, w2)
    w2 = torch.where(bs.is_specular, 1.0, w2)
    if options.shading_normal_le_gate:
        # reference passes the SHADING point's (p, n) into material::Le
        # (renderer.cpp:42): emission gated on dot(n_shading, -wi) > 0
        le_gate = dot(n, -bs.wwi) > 0.0
    else:
        le_gate = dot(nee_norm, -bs.wwi) > 0.0
    same_light = nee_found & nee_hits_light
    Li2 = torch.where((same_light & le_gate)[..., None], lrows.intensity, 0.0)
    gate_b = (
        ~ls.is_delta
        & (dot(bs.f, bs.f) > 0.0)
        & (bs.pdf > 0.0)
        & (bs.is_specular | (l_pdf2 != 0.0))  # early return when light_pdf==0
        & nee_found
        & (dot(Li2, Li2) > 0.0)
    )
    scale_b = torch.where(gate_b, safe_div(dot(bs.wwi, n).abs() * w2, bp2), 0.0)
    contrib_b = torch.where(gate_b[..., None], bs.f * Li2 * scale_b[..., None], 0.0)
    return contrib_l, contrib_b, l_pdf2


def ray_color_plain(scene, o, d, u, options: RenderOptions = DEFAULT_OPTIONS, work=None):
    """Plain integrator. o, d: (B,3); u: (max_bounces, B, 12) uniforms.
    Returns (B,3) radiance. Every closest-hit query goes through
    intersect.query_lite (the brute force). A `work` dict collects what the
    paths need (plain_bounce's): the primary rays are its first
    closest-hit rays."""
    B = o.shape[0]
    tables = pack_tables(scene)
    # primary hit (reference traces it before the bounce loop, renderer.cpp:61)
    found, prim, t = intersect.query_lite(scene, o, d, options)
    t = intersect.differentiable_t(scene, tables, o, d, found, prim, t, options)
    if work is not None:
        work.setdefault("closest", []).append((o.detach(), d.detach()))
    state = PathState(
        o=o, d=d, T=torch.ones_like(o), L=torch.zeros_like(o),
        prev_spec=torch.zeros(B, dtype=torch.bool, device=o.device),
        alive=torch.ones(B, dtype=torch.bool, device=o.device),
        prim=prim, t=t,
    )
    for i in range(options.max_bounces):
        state = plain_bounce(scene, tables, state, u[i], i, options, work)
    return state.L


def plain_bounce(scene, tables, state: PathState, ui, i: int,
                 options: RenderOptions = DEFAULT_OPTIONS, work=None):
    """One shading vertex of every ray: state at vertex i and its uniforms
    ui (B, 12) in, the state at vertex i + 1 out. A `work` dict collects
    what the vertex needs, whatever computes it: "vertices", the running
    vertices (a path alive at a hit); "closest" and
    "any_hit", the (o, d) of the queries they must issue: a shadow ray where
    the light's sample can contribute (any-hit toward a point light), a
    NEE-BSDF ray where that strategy can, an extension ray where the path
    goes on."""
    o, d, T, L, prev_spec, alive, prim, t = state
    B = o.shape[0]
    num_lights = scene.light_type.shape[0]
    has_images = scene.atlas.shape[0] > 1
    found = t < intersect.T_MAX

    rows = gather_prim(tables, prim)
    hit = intersect.hit_detail_rows(o, d, t, prim, found, rows)
    cur = alive & hit.found
    wwo = -d
    mrows = gather_mat(tables, rows.material)
    mtype = mrows.mtype
    trows = gather_tex(tables, torch.clamp(mrows.tex, min=0))
    albedo = eval_color_rows(scene.atlas, mrows, trows, hit.uv, has_images)
    frame = bsdf_ops.make_frame(hit.norm, hit.dpdu)

    # emitted light at the vertex (first or post-specular only)
    emit_gate = prev_spec if i > 0 else torch.ones_like(prev_spec)
    own_light = gather_light(tables, torch.clamp(rows.light, min=0))
    Le = lights.emitted_rows(rows, own_light, hit.norm, wwo)
    t_emit = torch.where((cur & emit_gate)[..., None], T * Le, 0.0)
    L = L + t_emit

    # next-event estimation: pick one light uniformly
    li = torch.clamp(
        torch.floor(ui[:, 0] * num_lights).to(torch.int32), max=num_lights - 1
    )
    lrows = gather_light(tables, li)
    carrier = gather_prim(tables, torch.clamp(lrows.prim, min=0))
    ls = lights.sample_light_rows(
        lrows, carrier, hit.p, ui[:, 1:3], ui[:, 3], ui[:, 4], options
    )
    bs_nee = bsdf_ops.bsdf_sample(
        frame, mtype, albedo, mrows.eta, mrows.k, wwo, ui[:, 5], ui[:, 6:8],
        non_specular_only=True,
    )
    # main BSDF sample for the path extension
    bs = bsdf_ops.bsdf_sample(
        frame, mtype, albedo, mrows.eta, mrows.k, wwo, ui[:, 9], ui[:, 10:12]
    )

    # ONE batched closest-hit query: [shadow | nee-bsdf | extension]
    O3 = torch.cat([hit.p, hit.p, hit.p], 0)
    D3 = torch.cat([ls.wi, bs_nee.wwi, bs.wwi], 0)
    f3, p3, t3 = intersect.query_lite(scene, O3, D3, options)
    plight3 = gather_prim_light(tables, p3[: 2 * B])
    sf, nf, xf = f3[:B], f3[B : 2 * B], f3[2 * B :]
    xp, xt = p3[2 * B :], t3[2 * B :]
    s_hits = plight3[:B] == li
    n_hits = plight3[B:] == li

    if options.shading_normal_le_gate:
        nee_norm = hit.norm  # unused in this mode
    else:
        nrows = gather_prim(tables, p3[B : 2 * B])
        nee_norm = intersect.hit_detail_rows(
            hit.p, bs_nee.wwi, t3[B : 2 * B], p3[B : 2 * B], nf, nrows
        ).norm
    cl, cb, l_pdf2 = _nee_contributions(
        hit, frame, mtype, albedo, wwo, options, ls, bs_nee, lrows, carrier,
        sf, s_hits, nf, n_hits, nee_norm,
    )
    t_nee_l = torch.where(cur[..., None], T * cl * num_lights, 0.0)
    t_nee_b = torch.where(cur[..., None], T * cb * num_lights, 0.0)
    L = L + t_nee_l
    L = L + t_nee_b

    # throughput update + path termination; the per-bounce weight and
    # the running product are clamped (1e12 / 1e16) so degenerate
    # x-face frames cannot overflow a live lane to inf
    ok = (dot(bs.f, bs.f) > 0.0) & (bs.pdf > 0.0)
    alive_next = cur & ok & (i <= options.max_bounces - 2)
    w_b = torch.clamp(
        bs.f * safe_div(dot(bs.wwi, hit.norm).abs(), _clip_pdf(bs.pdf))[..., None],
        max=1.0e12,
    )
    T = torch.where(alive_next[..., None], torch.clamp(T * w_b, max=1.0e16), T)

    if work is not None:
        _count_work(work, cur, hit, mtype, albedo, wwo, ls, bs_nee, bs, lrows, l_pdf2,
                    alive_next)
    xt = intersect.differentiable_t(scene, tables, hit.p, bs.wwi, xf, xp, xt, options)
    return PathState(hit.p, bs.wwi, T, L, bs.is_specular, alive_next, xp, xt)


def _count_work(work, cur, hit, mtype, albedo, wwo, ls, bs_nee, bs, lrows, l_pdf2, alive_next):
    """plain_bounce's `work`: the running vertices and the queries they need
    (the gates of the light and BSDF strategies' query-free factors)."""
    nonzero = lambda v: dot(v, v) > 0.0
    f = bsdf_ops.bsdf_F_nee(mtype, albedo, hit.norm, wwo, ls.wi)
    gate_l = cur & (ls.pdf > 0.0) & nonzero(ls.Li) & nonzero(f)
    gate_b = (cur & ~ls.is_delta & nonzero(bs_nee.f) & (bs_nee.pdf > 0.0)
              & (bs_nee.is_specular | (l_pdf2 != 0.0)) & nonzero(lrows.intensity))
    p = hit.p.detach()
    work["vertices"] = work.get("vertices", 0) + int(cur.sum())
    closest = work.setdefault("closest", [])
    closest.append((p[gate_l & ~ls.is_delta], ls.wi.detach()[gate_l & ~ls.is_delta]))
    closest.append((p[gate_b], bs_nee.wwi.detach()[gate_b]))
    closest.append((p[alive_next], bs.wwi.detach()[alive_next]))
    work.setdefault("any_hit", []).append((p[gate_l & ls.is_delta],
                                           ls.wi.detach()[gate_l & ls.is_delta]))
