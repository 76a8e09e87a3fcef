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
``ray_color(..., terms=True)`` (the plain path only; the kernel path
refuses it) also returns the radiance split by bounce and contribution
site, (max_bounces, 3, B, 3): emitted at the vertex, the NEE light
strategy, the NEE BSDF strategy (the JAX integrator's terms=True,
integrator.py:246-258; tools/term_dump.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS, RenderOptions
from plutracer_tpu_torch import rng
from plutracer_tpu_torch.ops import bsdf as bsdf_ops
from plutracer_tpu_torch.ops import intersect, lights
from plutracer_tpu_torch.ops.safemath import dot, safe_div
from plutracer_tpu_torch.ops.tables import (
    TABLE_W,
    gather_light,
    gather_mat,
    gather_prim,
    gather_prim_light,
    gather_tex,
    pack_tables,
)
from plutracer_tpu_torch.ops.texture import eval_color_rows
from plutracer_tpu_torch.scene.compile import MAX_TABLE_ROWS

# the kernel tiers. P <= MAX_P takes the megakernel K2 (the JAX package's
# tier boundary, integrator_kernel.py:57) while K2's shared-memory copy of
# the tables (k2_smem_bytes) fits K2_SMEM_MAX, the 48 KB of dynamic shared
# memory any kernel may take without opting in (csrc/megakernel.cu's
# launch); every other eligible scene takes the stream kernel K3 (K4 under
# options.stream_wavefront), which reads its tables from device memory
MAX_P = 64
K2_SMEM_MAX = 48 * 1024

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


def megakernel_eligible(scene, options) -> bool:
    """Whether the kernels (K2, K3, K4, K5) take the scene: shapes and
    options only. Each gate is something a kernel of the port needs:

    - options.dtype float32: every kernel reads float32 tables and rays
      (csrc/path_common.cuh:616 Tables; the wrappers refuse other dtypes);
    - the packed table (scene.prims_packed): K2's queries and the walk's
      winners read it (csrc/megakernel.cu:105, bvh_closest.cuh:150);
    - at least one light: path_vertex picks light min(floor(u nl), nl - 1)
      and reads its row (csrc/path_common.cuh:685-686), which is row -1 of
      an empty table;
    - at most MAX_TABLE_ROWS primitives and atlas texels: the kernels read
      row ids and atlas offsets stored as float32 (path_common.cuh:73
      row_id, :401 the texel, :144 the winner's packed col 10), exact to
      2^24, and index in int32. compile_scene raises beyond it, and on a
      walk deeper than the walk's stack (bvh_closest.cuh:109, WALK_STACK;
      scene/compile.walk_tables).

    The JAX package's TPU caps (M <= 16, T <= 8, L <= 8, a 4,096-texel
    atlas, the VMEM row budget, P <= 2^20) hold nothing back on the card:
    K3 and K4 read every table and the atlas from device memory, and K2's
    shared-memory copy is sized by the shapes (kernel_tier)."""
    return (
        getattr(options, "dtype", "float32") == "float32"
        and scene.prims_packed is not None
        and scene.light_type.shape[0] >= 1
        and scene.prim_type.shape[0] <= MAX_TABLE_ROWS
        and scene.atlas.shape[0] <= MAX_TABLE_ROWS
    )


def k2_smem_bytes(scene) -> int:
    """Bytes of K2's shared-memory copy of the tables: the packed table and
    pack_tables' prim, mat, tex and light rows (TABLE_W columns), float32
    (csrc/megakernel.cu, plu_megakernel's smem). Shapes only."""
    rows = (scene.prim_type.shape[0], scene.mat_type.shape[0], scene.tex_type.shape[0],
            scene.light_type.shape[0])
    return 4 * (math.prod(scene.prims_packed.shape) + sum(n * w for n, w in zip(rows, TABLE_W)))


def kernel_tier(scene, options) -> str:
    """Which kernel the kernel path runs: "k2" (the megakernel: P <= MAX_P
    and its tables within K2_SMEM_MAX bytes of shared memory), else "k3"
    (the stream kernel) or "k4" (the one-bounce kernel under a host loop,
    options.stream_wavefront), as ray_color_pallas dispatches
    (integrator_kernel.py:2257-2268)."""
    if scene.prim_type.shape[0] <= MAX_P and k2_smem_bytes(scene) <= K2_SMEM_MAX:
        return "k2"
    return "k4" if getattr(options, "stream_wavefront", False) else "k3"


def resolve_integrator_backend(scene, options, device) -> str:
    """'kernel' (K2, K3 or K4: kernel_tier) or 'plain'. auto = the kernel
    path on a CUDA device for scenes megakernel_eligible takes, the plain
    integrator otherwise."""
    backend = getattr(options, "integrator_backend", "auto")
    eligible = megakernel_eligible(scene, options)
    if backend == "auto":
        return "kernel" if torch.device(device).type == "cuda" and eligible else "plain"
    if backend == "kernel" and not eligible:
        raise ValueError(
            "integrator_backend='kernel' forced but the kernels do not take the "
            "scene (see megakernel_eligible)"
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


def radiance(scene, o, d, key, options: RenderOptions = DEFAULT_OPTIONS, terms: bool = False):
    """Radiance for a batch of primary rays o, d (B,3) with the per-bounce
    uniforms drawn from `key`: radiance_of_uniforms."""
    u = draw_uniforms(key, o.shape[0], options.max_bounces, o.device)
    return radiance_of_uniforms(scene, o, d, u, options, terms)


def radiance_of_uniforms(scene, o, d, u, options: RenderOptions = DEFAULT_OPTIONS,
                         terms: bool = False):
    """Radiance for primary rays o, d (B,3) and their uniforms u
    (max_bounces, B, 12). Dispatches to the kernels or the plain
    integrator (resolve_integrator_backend); on the kernel path with
    gradients wanted (grad enabled and o, d or a DIFF_LEAVES field
    requiring grad), through KernelRadiance. terms=True (the plain path
    only) also returns ray_color's per-bounce split."""
    if resolve_integrator_backend(scene, options, o.device) == "kernel":
        if terms:
            raise ValueError("the terms split is the plain path's only; pass "
                             "integrator_backend='plain'")
        leaves = [getattr(scene, f) for f in DIFF_LEAVES]
        if torch.is_grad_enabled() and any(x.requires_grad for x in (o, d, *leaves)):
            return KernelRadiance.apply(scene, options, o, d, u, *leaves)
        from plutracer_tpu_torch.ops.cuda.integrator_kernel import ray_color_kernel

        return ray_color_kernel(scene, o, d, u, options)
    return ray_color(scene, o, d, u, options, terms=terms)


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


def ray_color(scene, o, d, u, options: RenderOptions = DEFAULT_OPTIONS, debug: bool = False,
              terms: bool = False):
    """Plain integrator. o, d: (B,3); u: (max_bounces, B, 12) uniforms.
    Returns (B,3) radiance, then with debug=True the per-bounce telemetry
    (max_bounces, DBG_C, B), then with terms=True the per-bounce split
    (max_bounces, 3, B, 3) by contribution site: emitted at the vertex,
    NEE light strategy, NEE BSDF strategy (their sum is the radiance up to
    the order of the float32 additions). Every closest-hit query goes
    through intersect.query_lite, by options.intersect_backend (auto: K1
    on a CUDA device, intersect_lite on the CPU); on every backend but
    "xla" the winner's t is recomputed differentiably
    (intersect.differentiable_t). Under
    options.remat_bounces each bounce is rematerialised in the backward
    (torch.utils.checkpoint)."""
    B = o.shape[0]
    tables = pack_tables(scene)
    # primary hit (reference traces it before the bounce loop, renderer.cpp:61)
    found, prim, t = intersect.query_lite(scene, o, d, options)
    t = intersect.differentiable_t(tables, o, d, found, prim, t, options)
    state = PathState(
        o=o, d=d, T=torch.ones_like(o), L=torch.zeros_like(o),
        prev_spec=torch.zeros(B, dtype=torch.bool, device=o.device),
        alive=torch.ones(B, dtype=torch.bool, device=o.device),
        prim=prim, t=t,
    )
    remat = getattr(options, "remat_bounces", False) and torch.is_grad_enabled()
    extras = []
    for i in range(options.max_bounces):
        if remat:
            out = checkpoint(plain_bounce, scene, tables, state, u[i], i, options, debug, terms,
                             use_reentrant=False)
        else:
            out = plain_bounce(scene, tables, state, u[i], i, options, debug, terms)
        if debug or terms:
            state, *more = out
            extras.append(more)
        else:
            state = out
    if debug or terms:
        return (state.L, *(torch.stack(x) for x in zip(*extras)))
    return state.L


def plain_bounce(scene, tables, state: PathState, ui, i: int,
                 options: RenderOptions = DEFAULT_OPTIONS, debug: bool = False,
                 terms: bool = False):
    """One shading vertex of every ray (the plain twin of the one-bounce
    kernel K4): state at vertex i and its uniforms ui (B, 12) in, the
    state at vertex i + 1 out; with debug=True also the vertex's
    telemetry (DBG_C, B), with terms=True its radiance by site (3, B, 3)."""
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

    if debug:
        f32 = lambda x: x.to(torch.float32)
        Ld = cl + cb
        ch = torch.stack([
            torch.where(found, t, intersect._BIG), f32(prim),
            torch.maximum(torch.maximum(T[:, 0], T[:, 1]), T[:, 2]),
            bs.pdf, dot(bs.f, bs.f), ls.pdf, l_pdf2,
            Ld[:, 0] + Ld[:, 1] + Ld[:, 2], f32(cur), xt, f32(xp), f32(bs.is_specular),
        ])
    xt = intersect.differentiable_t(tables, hit.p, bs.wwi, xf, xp, xt, options)
    nxt = PathState(hit.p, bs.wwi, T, L, bs.is_specular, alive_next, xp, xt)
    if not (debug or terms):
        return nxt
    return (nxt, *([ch.detach()] if debug else []),
            *([torch.stack([t_emit, t_nee_l, t_nee_b])] if terms else []))
