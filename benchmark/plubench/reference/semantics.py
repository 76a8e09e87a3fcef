"""Reference-semantics registry (the port's copy of the JAX package's
``plutracer_tpu/semantics.py``: the same fields with the same defaults, so
an options object means the same thing in both packages; the TPU-only
field ``pallas_interpret`` is kept for that and ignored here).

The plutracer reference implementation contains several idiosyncrasies that
*change rendered images*. To act as a drop-in replacement whose output matches
the reference within Monte-Carlo tolerance, we replicate these by default, and
each one is individually toggleable here. Every quirk cites the reference
source (paths relative to the reference checkout).

Quirks replicated by default
----------------------------
1. ``swapped_light_mis_weight`` — in the light-sampling half of NEE the power
   heuristic weight is computed as bsdf_pdf^2/(bsdf_pdf^2+light_pdf^2), i.e.
   the *BSDF* strategy's weight (src/renderer.cpp:22); textbook MIS would use
   light_pdf^2/(...). The BSDF-sampling half uses the same (there correct)
   formula (src/renderer.cpp:36).
2. ``origin_distance_pdf`` — ``surface::pdf(p, wi)`` computes the solid-angle
   pdf as |hit_point|^2 / (|cos| * area): the squared distance of the hit
   point from the *world origin*, not from ``p`` (inc/surface.h:27-33, the
   ``D = p + wi*t; dot(D,D)`` expression). Textbook is t^2 (distance from p).
3. ``shading_normal_le_gate`` — in the BSDF-sampling half of NEE, the light's
   emitted radiance toward the shading point is gated by
   ``dot(n_shading, -wi) > 0`` where ``n_shading`` is the normal at the
   *shading* point, not the light surface (src/renderer.cpp:42 passes the
   shading p/n into material::Le). For typical geometry (light above a
   surface) this zeroes the BSDF-strategy contribution.
4. ``sphere_area_is_volume`` — ``sphere::area()`` returns (4/3)*pi*r^3
   (inc/surfaces/sphere.h:17), used in the area-light pdf denominator.
5. ``camera_scaled_basis`` — the camera basis is right = 1.5*norm(cross(look,
   (0,-1,0))), up = 1.5*norm(cross(look, right)), film plane at w = 2.5
   (inc/camera.h:17-23), and NDC is [-1,1]^2 on both axes with *no aspect
   compensation* (inc/camera.h:27-30).
6. ``geometric_triangle_normals`` — triangle normals are the geometric
   cross(U,V) of normalized edges; vertex-normal interpolation is written but
   commented out (src/surfaces/triangle.cpp:27).
7. ``spp_is_square`` — ``antialiasing-samples: N`` means an N x N stratified
   grid, i.e. N^2 samples per pixel (src/main.cpp:170 passes uvec2(N)).

Investigated and ruled OUT (round 4): the bounce loop's un-reset hit_record
(src/renderer.cpp:60-61,86) looks like it should clamp every path-extension
segment to the previous segment's t (the leaf hit predicates reject
candidates farther than hr->t) — but bvh_tree::bvh_node::hit allocates
FRESH records at every internal node and copies the winner out
(src/surfaces/bvh_tree.cpp:49-75), so for any scene with >= 2 surfaces the
stale t never reaches a leaf test. Verified empirically: a reference build
patched to reset hr before the extension hit renders identically
(tools/refbuild/build_dump.sh methodology, round-4 session).

Bugs *not* replicated (they only corrupt memory / produce NaN, never change a
correctly-rendered pixel):
- the tile sampler's out-of-bounds write of one extra column on clipped edge
  tiles (inc/sampler.h:75,85 + src/renderer.cpp:132);
- NaN from the Reinhard tonemap when luma == 0 (src/main.cpp:78-86): we
  guard the division; pure black maps to pure black;
- the shared, unlocked global mt19937 (inc/cmmn.h:240): we use counter-based
  jax.random keys, which are race-free and make renders deterministic.

Silent numeric guards (deviations on measure-zero / NaN-only inputs; each
replaces a reference NaN/Inf with a finite value; full audit):
- sphere degenerate dpdu (ops/intersect.py:_sphere_detail): when the hit
  point lies on the world z-axis, the reference's dpdu = 2*pi*(-p.y, p.x, 0)
  (src/surfaces/sphere.cpp:40) is the zero vector and normalize(dpdu) in the
  shading frame (inc/material.h:170) is NaN; we substitute cross((0,1,0),
  normal). Also the polar-UV chain guards sin(phi)==0 (sphere.cpp:33-38
  divides by it) by pinning theta=0 at the poles.
- point-light squared-distance clamp (ops/lights.py:sample_light_rows):
  1/|l-p|^2 (inc/light.h:23-26) is clamped at 1e-20 so a shading point
  exactly at the light position yields a huge-but-finite intensity instead
  of Inf (and a NaN wi).
- box normal at the exact center plane (ops/intersect.py:_box_detail):
  sign(0) -> +1 where the reference's `np.x < 0 ? -1 : 1` chain
  (src/surfaces/box.cpp:44-60) also yields +1 — matching, but made explicit
  because jnp.sign (unlike the C ternary) returns 0 there.
- throughput clamp (render/integrator.py + both megakernels): the
  per-bounce weight f*|cos|/pdf is clamped at 1e12 and the running path
  throughput at 1e16. The reference's degenerate x-face box frames
  (box.cpp:29-33) make the weight unbounded; at 8 bounces the f32 product
  can overflow to +inf on a live lane — the reference then propagates
  inf/NaN into that sample (tonemap saturates it), while our reverse-mode
  gradients would die of 0 * inf for the whole batch. A >=1e12-weight
  sample is saturated garbage either way; images differ only on that
  measure-zero set, gradients become well-defined.
- division guards via jnp.where(x == 0, 1, x) throughout (box_t's
  ray-direction epsilon matching the slab test's IEEE-Inf behavior,
  triangle_t's det==0 reject) — all on paths where the reference relies
  on IEEE Inf propagating into comparisons that then reject the lane;
  ours rejects the lane explicitly with a mask instead.
- derivative-side clamps (ops/safemath.py, r5): safe_div / safe_recip /
  safe_rsqrt keep primals BIT-IDENTICAL to the plain ops but clamp the
  denominators inside their custom_jvp rules — guard floors of the
  1e-20/1e-30 class have transposes that square the denominator (FTZ
  flushes the square to 0 -> 0/0 NaN on zero-cotangent lanes) or
  overflow f32 (rsqrt's u**-1.5). Forward images are unaffected.
- differentiable-t sentinel guard (r5): under non-XLA intersect
  backends, t is recomputed at the kernel's winning primitive; the
  recompute is accepted only where it agrees the ray hits (t < T_MAX),
  else the kernel's t is kept. On knife-edge lanes where the backends
  disagree, the old code put the 3e37 miss sentinel on a found=True
  lane — hit points at ~4e37 whose dot products overflow and NaN the
  whole backward. Primal changes only on those disagreeing lanes
  (which previously carried saturated garbage positions).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    """Static (hashable) render configuration, usable as a jit static arg."""

    # --- integrator shape (reference: src/renderer.cpp:59-96) ---
    max_bounces: int = 8  # shading vertices; reference shades bounces 0..7
    t_max: float = 100000.0  # hit_record init t (inc/cmmn.h:228)

    # --- reference-faithful quirks (see module docstring) ---
    swapped_light_mis_weight: bool = True
    origin_distance_pdf: bool = True
    shading_normal_le_gate: bool = True
    sphere_area_is_volume: bool = True

    # --- numerics ---
    shadow_eps: float = 0.0  # reference traces shadow rays from p exactly
    dtype: str = "float32"

    def replace(self, **kw) -> "RenderOptions":
        return dataclasses.replace(self, **kw)


DEFAULT_OPTIONS = RenderOptions()

# Correct-by-the-book variant, for users who prefer textbook MIS/pdfs over
# reference parity. Documented deviation; not the default.
TEXTBOOK_OPTIONS = RenderOptions(
    swapped_light_mis_weight=False,
    origin_distance_pdf=False,
    shading_normal_le_gate=False,
    sphere_area_is_volume=False,
    shadow_eps=1e-4,
)
