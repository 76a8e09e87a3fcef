"""Path-tracing integrator: next-event estimation + MIS, fixed depth.

Faithful to renderer::ray_color / estimate_direct_light /
uniform_sample_one_light (src/renderer.cpp:5-96), as the JAX package's
render/integrator.py (whose docstring lists the replicated quirks):
shading vertices at bounces 0..max_bounces-1, no Russian roulette,
emission only at the first vertex or after a specular bounce, one
uniformly chosen light per vertex, the reference's MIS and pdf quirks
behind RenderOptions switches, escaped rays contribute nothing.

``ray_color`` is the plain PyTorch integrator: a Python loop of
``plain_bounce`` (one shading vertex for every ray) on batched tensors,
taking the uniforms ``u`` (max_bounces, B, 12) as an input. ``radiance``
draws those uniforms from a threefry key, exactly as the JAX package does
(uniform(fold_in(key, bounce), (B, 12))), and ``radiance_of_uniforms``
sends the batch either to
the CUDA kernels (ops/cuda/integrator_kernel.ray_color_kernel: the
megakernel K2, the stream kernel K3 or the one-bounce kernel K4, as
``kernel_tier`` says) or to ``ray_color``. All take the same uniforms, so
they make the same sampling decisions.

Gradients. ``ray_color`` is differentiable as written (the guarded ops of
ops/safemath.py keep its backward finite). The kernels are not: on the
kernel path ``radiance`` goes through ``KernelRadiance``, an autograd
Function whose forward runs the kernel on detached inputs and whose
backward re-runs ``ray_color`` with the same uniforms and differentiates
it (the JAX package's _ray_color_pallas_ad, integrator.py:191-237).

Telemetry. ``ray_color(..., debug=True)`` also returns the JAX
megakernel's per-bounce debug output (integrator_kernel.py:1229-1240):
(max_bounces, DBG_C, B) float32, channels in the order of
ops/cuda.DBG_CHANNELS (part of the kernels' C ABI); K2 and K3
write the same channels (K5, ``ray_color_kernel(..., debug=True)``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS, RenderOptions
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

# static caps of the kernel tiers, the JAX package's megakernel_eligible
# (plutracer_tpu/ops/pallas/integrator_kernel.py:57-108), kept so the port
# routes every scene as the reference does: P <= MAX_P takes the
# megakernel K2, MAX_P < P <= MAX_P_HBM the stream kernel K3 (K4 under
# options.stream_wavefront), where the packed type segments below
# HBM_MIN_ROWS rows must sum to at most MAX_P_STREAM (_vmem_rows_ok)
MAX_P = 64
MAX_P_STREAM = 40960
HBM_MIN_ROWS = 24576
MAX_P_HBM = 1 << 20
MAX_M = 16
MAX_T = 8
MAX_L = 8
MAX_ATLAS = 4096

# the scene leaves gradients flow to (parallel/sharded.DIFFERENTIABLE_FIELDS)
DIFF_LEAVES = ("mat_color", "light_intensity", "tex_c0", "tex_c1")


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


def _vmem_rows_ok(type_rows) -> bool:
    """The JAX stream tier's budget (integrator_kernel.py:82-86): packed
    type segments below HBM_MIN_ROWS rows sum to at most MAX_P_STREAM."""
    return sum(r for r in type_rows if r < HBM_MIN_ROWS) <= MAX_P_STREAM


def megakernel_eligible(scene, options) -> bool:
    """Static qualification for the kernel path (shapes only): K2 up to
    MAX_P primitives, the stream kernels (which walk scene.bvh) beyond."""
    A = scene.atlas.shape[0]
    P = scene.prim_type.shape[0]
    return (
        scene.prims_packed is not None
        and (P <= MAX_P_STREAM or _vmem_rows_ok(scene.packed_type_rows))
        and P <= MAX_P_HBM
        and scene.mat_type.shape[0] <= MAX_M
        and scene.tex_type.shape[0] <= MAX_T
        and 1 <= scene.light_type.shape[0] <= MAX_L
        and A <= MAX_ATLAS
        and getattr(options, "dtype", "float32") == "float32"
    )


def kernel_tier(scene, options) -> str:
    """Which kernel the kernel path runs: "k2" (the megakernel, P <=
    MAX_P), "k3" (the stream kernel) or "k4" (the one-bounce kernel under
    a host loop, options.stream_wavefront), as ray_color_pallas
    dispatches (integrator_kernel.py:2257-2268)."""
    if scene.prim_type.shape[0] <= MAX_P:
        return "k2"
    return "k4" if getattr(options, "stream_wavefront", False) else "k3"


def resolve_integrator_backend(scene, options, device) -> str:
    """'kernel' (K2, K3 or K4: kernel_tier) or 'plain'. auto = the kernel
    path on a CUDA device for scenes within megakernel_eligible's caps,
    the plain integrator otherwise."""
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
    uniforms drawn from `key`: radiance_of_uniforms."""
    u = draw_uniforms(key, o.shape[0], options.max_bounces, o.device)
    return radiance_of_uniforms(scene, o, d, u, options)


def radiance_of_uniforms(scene, o, d, u, options: RenderOptions = DEFAULT_OPTIONS):
    """Radiance for primary rays o, d (B,3) and their uniforms u
    (max_bounces, B, 12). Dispatches to the kernels or the plain
    integrator (resolve_integrator_backend); on the kernel path with
    gradients wanted (grad enabled and o, d or a DIFF_LEAVES field
    requiring grad), through KernelRadiance."""
    if resolve_integrator_backend(scene, options, o.device) == "kernel":
        leaves = [getattr(scene, f) for f in DIFF_LEAVES]
        if torch.is_grad_enabled() and any(x.requires_grad for x in (o, d, *leaves)):
            return KernelRadiance.apply(scene, options, o, d, u, *leaves)
        from plutracer_tpu_torch.ops.cuda.integrator_kernel import ray_color_kernel

        return ray_color_kernel(scene, o, d, u, options)
    return ray_color(scene, o, d, u, options)


class KernelRadiance(torch.autograd.Function):
    """The kernel forward with a plain backward (the JAX package's
    _ray_color_pallas_ad). apply(scene, options, o, d, u, mat_color,
    light_intensity, tex_c0, tex_c1): the DIFF_LEAVES fields are explicit
    inputs that replace the scene's own. Forward: ray_color_kernel (K2, K3
    or K4 by kernel_tier) on detached inputs. Backward: ray_color with the
    same uniforms, differentiated by torch.autograd.grad, so the gradients
    are exactly the plain path's. u gets no gradient."""

    @staticmethod
    def forward(ctx, scene, options, o, d, u, *leaves):
        from plutracer_tpu_torch.ops.cuda.integrator_kernel import ray_color_kernel

        ctx.scene, ctx.options = scene, options
        ctx.save_for_backward(o, d, u, *leaves)
        sc = dataclasses.replace(scene, **dict(zip(DIFF_LEAVES, (x.detach() for x in leaves))))
        return ray_color_kernel(sc, o.detach(), d.detach(), u.detach(), options)

    @staticmethod
    def backward(ctx, g):
        o, d, u, *leaves = ctx.saved_tensors
        need = ctx.needs_input_grad
        with torch.enable_grad():
            xs = [x.detach().requires_grad_(n)
                  for x, n in zip((o, d, *leaves), (need[2], need[3], *need[5:]))]
            sc = dataclasses.replace(ctx.scene, **dict(zip(DIFF_LEAVES, xs[2:])))
            L = ray_color(sc, xs[0], xs[1], u.detach(), ctx.options)
            wrt = [x for x in xs if x.requires_grad]
            got = iter(torch.autograd.grad(L, wrt, g, allow_unused=True, materialize_grads=True)
                       if wrt else ())
        grads = [next(got) if x.requires_grad else None for x in xs]
        return (None, None, grads[0], grads[1], None, *grads[2:])


def ray_color(scene, o, d, u, options: RenderOptions = DEFAULT_OPTIONS, debug: bool = False):
    """Plain integrator. o, d: (B,3); u: (max_bounces, B, 12) uniforms.
    Returns (B,3) radiance, and with debug=True also the per-bounce
    telemetry (max_bounces, DBG_C, B). Every closest-hit query goes
    through intersect.query_lite (K1 on a CUDA device). Under
    options.remat_bounces each bounce is rematerialised in the backward
    (torch.utils.checkpoint)."""
    B = o.shape[0]
    tables = pack_tables(scene)
    # primary hit (reference traces it before the bounce loop, renderer.cpp:61)
    found, prim, t = intersect.query_lite(scene, o, d)
    if o.is_cuda:
        t = _recompute_t(tables, o, d, found, prim, t)
    state = PathState(
        o=o, d=d, T=torch.ones_like(o), L=torch.zeros_like(o),
        prev_spec=torch.zeros(B, dtype=torch.bool, device=o.device),
        alive=torch.ones(B, dtype=torch.bool, device=o.device),
        prim=prim, t=t,
    )
    remat = getattr(options, "remat_bounces", False) and torch.is_grad_enabled()
    dbg = []
    for i in range(options.max_bounces):
        if remat:
            out = checkpoint(plain_bounce, scene, tables, state, u[i], i, options, debug,
                             use_reentrant=False)
        else:
            out = plain_bounce(scene, tables, state, u[i], i, options, debug)
        if debug:
            state, ch = out
            dbg.append(ch)
        else:
            state = out
    if debug:
        return state.L, torch.stack(dbg)
    return state.L


def _recompute_t(tables, o, d, found, prim, t):
    """The kernel's t is not differentiable: recompute it at the winner
    with the plain per-primitive test, accepted only where it agrees the
    ray hits (a _BIG sentinel on a found lane would put p at ~4e37)."""
    td = intersect.prim_t_rows(o, d, gather_prim(tables, prim))
    return torch.where(found & (td < intersect.T_MAX), td, t)


def plain_bounce(scene, tables, state: PathState, ui, i: int,
                 options: RenderOptions = DEFAULT_OPTIONS, debug: bool = False):
    """One shading vertex of every ray (the plain twin of the one-bounce
    kernel K4): state at vertex i and its uniforms ui (B, 12) in, the
    state at vertex i + 1 out; with debug=True also the vertex's
    telemetry (DBG_C, B)."""
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
    cl, cb, l_pdf2 = _nee_contributions(
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

    if debug:
        f32 = lambda x: x.to(torch.float32)
        Ld = cl + cb
        ch = torch.stack([
            torch.where(found, t, intersect._BIG), f32(prim),
            torch.maximum(torch.maximum(T[:, 0], T[:, 1]), T[:, 2]),
            bs.pdf, dot(bs.f, bs.f), ls.pdf, l_pdf2,
            Ld[:, 0] + Ld[:, 1] + Ld[:, 2], f32(cur), xt, f32(xp), f32(bs.is_specular),
        ])
    if o.is_cuda:
        xt = _recompute_t(tables, hit.p, bs.wwi, xf, xp, xt)
    nxt = PathState(hit.p, bs.wwi, T, L, bs.is_specular, alive_next, xp, xt)
    return (nxt, ch.detach()) if debug else nxt
