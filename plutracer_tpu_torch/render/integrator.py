"""Path-tracing integrator: next-event estimation + MIS, fixed depth.

Faithful to renderer::ray_color / estimate_direct_light /
uniform_sample_one_light (src/renderer.cpp:5-96), as the JAX package's
render/integrator.py (whose docstring lists the replicated quirks):
shading vertices at bounces 0..max_bounces-1, no Russian roulette,
emission only at the first vertex or after a specular bounce, one
uniformly chosen light per vertex, the reference's MIS and pdf quirks
behind RenderOptions switches, escaped rays contribute nothing.

``ray_color`` is the plain PyTorch integrator: a Python loop over bounces
on batched tensors, taking the uniforms ``u`` (max_bounces, B, 12) as an
input. ``radiance`` draws those uniforms from a threefry key, exactly as
the JAX package does (uniform(fold_in(key, bounce), (B, 12))), and sends
the batch either to the CUDA megakernel K2 (ops/cuda/integrator_kernel.py)
or to ``ray_color``. Both take the same uniforms, so they make the same
sampling decisions.
"""

from __future__ import annotations

import torch

from plutracer_tpu.semantics import DEFAULT_OPTIONS, RenderOptions
from plutracer_tpu_torch import rng
from plutracer_tpu_torch.ops import bsdf as bsdf_ops
from plutracer_tpu_torch.ops import intersect, lights
from plutracer_tpu_torch.ops.safemath import dot, safe_div
from plutracer_tpu_torch.ops.tables import (
    gather_light,
    gather_mat,
    gather_prim,
    gather_prim_light,
    gather_tex,
    pack_tables,
)
from plutracer_tpu_torch.ops.texture import eval_color_rows

# static caps of the megakernel K2, the JAX package's megakernel_eligible
# (plutracer_tpu/ops/pallas/integrator_kernel.py:62-108), kept so the port
# routes every scene as the reference does
MAX_P = 64
MAX_M = 16
MAX_T = 8
MAX_L = 8
MAX_ATLAS = 4096


def _clip_pdf(x):
    return torch.clamp(x, 1e-12, 1e9)


def _nee_contributions(
    hit, frame, mtype, albedo, wwo, options, ls, bs, lrows, carrier,
    shadow_found, shadow_hits_light, nee_found, nee_hits_light, nee_norm,
):
    """Assemble estimate_direct_light (renderer.cpp:5-51) once visibility
    results for the shadow ray and the BSDF-strategy ray are known.

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
    return contrib_l, contrib_b


def megakernel_eligible(scene, options) -> bool:
    """Static qualification for the megakernel K2 (shapes only)."""
    A = scene.atlas.shape[0]
    return (
        scene.prims_packed is not None
        and scene.prim_type.shape[0] <= MAX_P
        and scene.mat_type.shape[0] <= MAX_M
        and scene.tex_type.shape[0] <= MAX_T
        and 1 <= scene.light_type.shape[0] <= MAX_L
        and A <= MAX_ATLAS
        and getattr(options, "dtype", "float32") == "float32"
    )


def resolve_integrator_backend(scene, options, device) -> str:
    """'kernel' (K2) or 'plain'. auto = K2 on a CUDA device for scenes
    within megakernel_eligible's caps, the plain integrator otherwise."""
    backend = getattr(options, "integrator_backend", "auto")
    eligible = megakernel_eligible(scene, options)
    if backend == "auto":
        return "kernel" if torch.device(device).type == "cuda" and eligible else "plain"
    if backend == "kernel" and not eligible:
        raise ValueError(
            "integrator_backend='kernel' forced but the scene exceeds the "
            "megakernel's static limits (see megakernel_eligible)"
        )
    if backend not in ("kernel", "plain"):
        raise ValueError(
            f"integrator_backend must be 'auto', 'kernel' or 'plain', got {backend!r}"
        )
    return backend


def draw_uniforms(key, B: int, max_bounces: int, device) -> torch.Tensor:
    """(max_bounces, B, 12): uniform(fold_in(key, i), (B, 12)) per bounce
    (the JAX integrator's draw, integrator.py:283-284)."""
    return torch.stack(
        [rng.uniform(rng.fold_in(key, i), (B, 12), device) for i in range(max_bounces)]
    )


def radiance(scene, o, d, key, options: RenderOptions = DEFAULT_OPTIONS):
    """Radiance for a batch of primary rays o, d (B,3) with the per-bounce
    uniforms drawn from `key`. Dispatches to K2 or the plain integrator
    (resolve_integrator_backend)."""
    u = draw_uniforms(key, o.shape[0], options.max_bounces, o.device)
    if resolve_integrator_backend(scene, options, o.device) == "kernel":
        from plutracer_tpu_torch.ops.cuda.integrator_kernel import ray_color_kernel

        return ray_color_kernel(scene, o, d, u, options)
    return ray_color(scene, o, d, u, options)


def ray_color(scene, o, d, u, options: RenderOptions = DEFAULT_OPTIONS):
    """Plain integrator. o, d: (B,3); u: (max_bounces, B, 12) uniforms.
    Returns (B,3) radiance. Every closest-hit query goes through
    intersect.query_lite (K1 on a CUDA device)."""
    B = o.shape[0]
    num_lights = scene.light_type.shape[0]
    tables = pack_tables(scene)
    has_images = scene.atlas.shape[0] > 1
    # the kernel's t is not differentiable: recompute it at the winner
    # with the plain per-primitive test, accepted only where it agrees the
    # ray hits (a _BIG sentinel on a found lane would put p at ~4e37)
    diff_t = o.is_cuda

    # primary hit (reference traces it before the bounce loop, renderer.cpp:61)
    found, prim, t = intersect.query_lite(scene, o, d)
    if diff_t:
        t0d = intersect.prim_t_rows(o, d, gather_prim(tables, prim))
        t = torch.where(found & (t0d < intersect.T_MAX), t0d, t)

    T = torch.ones_like(o)
    L = torch.zeros_like(o)
    prev_spec = torch.zeros(B, dtype=torch.bool, device=o.device)
    alive = torch.ones(B, dtype=torch.bool, device=o.device)
    for i in range(options.max_bounces):
        ui = u[i]
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
        L = L + torch.where((cur & emit_gate)[..., None], T * Le, 0.0)

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
        f3, p3, t3 = intersect.query_lite(scene, O3, D3)
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
        cl, cb = _nee_contributions(
            hit, frame, mtype, albedo, wwo, options, ls, bs_nee, lrows, carrier,
            sf, s_hits, nf, n_hits, nee_norm,
        )
        L = L + torch.where(cur[..., None], T * cl * num_lights, 0.0)
        L = L + torch.where(cur[..., None], T * cb * num_lights, 0.0)

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

        if diff_t:
            xtd = intersect.prim_t_rows(hit.p, bs.wwi, gather_prim(tables, xp))
            xt = torch.where(xf & (xtd < intersect.T_MAX), xtd, xt)
        o, d, prev_spec, alive = hit.p, bs.wwi, bs.is_specular, alive_next
        found, prim, t = xf, xp, xt
    return L
