"""Ray-primitive intersection.

Faithful ports of the reference hit predicates — these are load-bearing for
shadow rays, which the reference traces with *zero* origin offset and which
only avoid self-intersection because of the exact accept rules:

- sphere (src/surfaces/sphere.cpp:16-27): hit iff BOTH quadratic roots are
  strictly positive; t = near root. Rays starting inside a sphere (e.g.
  refracted rays in glass) do NOT hit it from inside.
- box (src/surfaces/box.cpp:6-35): slab test; miss if tmax < tmin or
  tmin < 0; t = tmin. Rays starting inside a box miss it.
- triangle (src/surfaces/triangle.cpp:5-33): Moller-Trumbore, accept
  0 < t < t_best.

``intersect_lite`` is the plain brute-force closest hit over the whole
primitive table ((B, P) t matrix, first minimum wins). ``query_lite`` is
the integrator's entry point: it answers by the engine that
options.intersect_backend names (``_resolve_backend``, the JAX package's
names and meanings, plutracer_tpu/ops/intersect.py:195-256):

- "pallas": K1, the brute force over the packed table
  (ops/cuda/intersect_kernel.closest_hit; closest_hit_plain on CPU
  tensors);
- "bvh": the K3 query, a walk of the scene's BVH (closest_hit_bvh;
  walk_closest_plain on CPU tensors);
- "xla": ``intersect_lite`` over the scene rows, in ray chunks of at most
  XLA_BUDGET (ray, primitive) pairs;
- "auto": "pallas" on CUDA tensors, "xla" on CPU tensors (as the JAX
  package picks the Pallas kernel on an accelerator and XLA on the CPU).

All four return the same winner (found, prim). The kernels' t carries no
gradient; ``differentiable_t`` recomputes it at the winner on every backend
but "xla" (the JAX package's query_closest), for the integrator.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from plutracer_tpu_torch.ops.safemath import (
    cross,
    dot,
    safe_div,
    safe_recip,
    safe_rsqrt,
    safe_sqrt,
)
from plutracer_tpu_torch.ops.tables import gather_prim
from plutracer_tpu_torch.scene.types import PRIM_BOX, PRIM_SPHERE
from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS

T_MAX = 100000.0  # hit_record initial t (inc/cmmn.h:228)
_BIG = 3.0e37  # sentinel for "no hit" inside reductions
BACKENDS = ("auto", "xla", "pallas", "bvh")  # options.intersect_backend
# "xla": (ray, primitive) pairs of one intersect_lite call, which builds
# (rays, P, 3) temporaries: mesh1's 65,536 rays at once would be 5.4 GB
XLA_BUDGET = 1 << 23


# ---------------------------------------------------------------------------
# per-primitive t computation (vectorized over rays x prims)
# ---------------------------------------------------------------------------


def sphere_t(o, d, center, radius):
    """Both-roots-positive accept rule. o,d: (...,3); center broadcasts."""
    v = o - center
    b = -dot(v, d)
    det = b * b - dot(v, v) + radius * radius
    ok = det >= 0
    sq = safe_sqrt(det)
    i1 = b - sq
    i2 = b + sq
    hit = ok & (i1 > 0.0) & (i2 > 0.0)
    return torch.where(hit, i1, _BIG)


def box_t(o, d, bmin, bmax):
    """Slab test; miss when tmin < 0 (so origins inside the box miss).
    |d| < 1e-12 is replaced by 1e-12 (the JAX package's parallel-ray
    guard: the slab interval on that axis is effectively unbounded)."""
    rrd = 1.0 / torch.where(d.abs() < 1e-12, 1e-12, d)
    t1 = (bmin - o) * rrd
    t2 = (bmax - o) * rrd
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    # reference rejects tmax < tmin or tmin < 0 (box.cpp:29); tmin == 0 hits
    hit = (tmax >= tmin) & (tmin >= 0.0)
    return torch.where(hit, tmin, _BIG)


def triangle_t(o, d, v0, v1, v2):
    """Moller-Trumbore; accept t > 0 (det == 0 rejected)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pv = cross(d, e2)
    det = dot(e1, pv)
    idet = safe_recip(torch.where(det == 0.0, 1.0, det))
    tv = o - v0
    u = dot(tv, pv) * idet
    qv = cross(tv, e1)
    v = dot(d, qv) * idet
    t = dot(e2, qv) * idet
    hit = (det != 0.0) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    return torch.where(hit, t, _BIG)


def _prim_t_batched(o, d, ptype, a, b, c):
    ts = sphere_t(o, d, a, b[..., 0])
    tb = box_t(o, d, a, b)
    tt = triangle_t(o, d, a, b, c)
    return torch.where(ptype == PRIM_SPHERE, ts, torch.where(ptype == PRIM_BOX, tb, tt))


def line_hit_aabb(o, d, mn, mx):
    """Reference aabb::hit (inc/cmmn.h:150-172): slab LINE test, hit iff
    tmax >= tmin — no positivity, boxes fully behind the ray still 'hit'.
    Broadcasts over leading dims of (o, d) x (mn, mx)."""
    rrd = 1.0 / torch.where(d == 0.0, 1e-20, d)
    t1 = (mn - o) * rrd
    t2 = (mx - o) * rrd
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    return tmax >= tmin


# ---------------------------------------------------------------------------
# scene-level closest hit
# ---------------------------------------------------------------------------


class Hit(NamedTuple):
    """Batched hit records (the SoA analog of plu::hit_record)."""

    found: torch.Tensor  # (B,) bool
    t: torch.Tensor  # (B,)
    prim: torch.Tensor  # (B,) int32 winning primitive row (0 if none)
    p: torch.Tensor  # (B,3) hit point o + d*t
    norm: torch.Tensor  # (B,3) (triangle: unnormalized cross(U,V))
    uv: torch.Tensor  # (B,2) texture coords
    dpdu: torch.Tensor  # (B,3) raw dpdu (shading frame S = normalize(dpdu))


def intersect_ts(scene, o, d):
    """(B, P) t values with _BIG where missed.

    Sphere rows in scene.cull_rows additionally require the reference
    bvh_tree's internal-node culling, collapsed to one slab LINE test
    against the leaf's parent AABB (scene/bvh.parent_bounds_tables): this
    discards exactly the phantom hits of non-unit rays that the
    reference's traversal never reaches."""
    tmat = _prim_t_batched(
        o[:, None, :], d[:, None, :],
        scene.prim_type[None, :], scene.prim_a[None, :],
        scene.prim_b[None, :], scene.prim_c[None, :],
    )
    rows = scene.cull_rows
    if rows and scene.parent_min is not None:
        ridx = torch.tensor(rows, dtype=torch.long, device=o.device)
        elig = line_hit_aabb(
            o[:, None, :], d[:, None, :],
            scene.parent_min[ridx][None, :, :], scene.parent_max[ridx][None, :, :],
        )  # (B, S)
        tmat = tmat.clone()
        tmat[:, ridx] = torch.where(elig, tmat[:, ridx], _BIG)
    return tmat


def intersect_lite(scene, o, d, t_max: float = T_MAX):
    """Closest-hit query without shading detail: (found, prim, t).
    The first minimum over scene rows wins (argmin)."""
    tmat = intersect_ts(scene, o, d)  # (B, P)
    prim = torch.argmin(tmat, dim=1)
    t = torch.gather(tmat, 1, prim[:, None])[:, 0]
    return t < t_max, prim.to(torch.int32), t


def _resolve_backend(options, device) -> str:
    """options.intersect_backend with "auto" resolved for tensors on
    `device`: "pallas" (K1) on a CUDA device, "xla" elsewhere. Raises
    ValueError on a name that is not in BACKENDS."""
    backend = getattr(options, "intersect_backend", "auto")
    if backend not in BACKENDS:
        raise ValueError(f"intersect_backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "auto":
        return "pallas" if torch.device(device).type == "cuda" else "xla"
    return backend


def query_lite(scene, o, d, options=DEFAULT_OPTIONS):
    """Closest-hit (found, prim, t) by the engine options.intersect_backend
    names (module docstring). The kernels' inputs are detached (their t is
    not differentiable, as the JAX package stops their gradients); "xla"
    keeps intersect_lite's differentiable t."""
    backend = _resolve_backend(options, o.device)
    if backend == "pallas":
        from plutracer_tpu_torch.ops.cuda.intersect_kernel import closest_hit

        return closest_hit(scene.prims_packed, o.detach(), d.detach(), scene.packed_type_rows)
    if backend == "bvh":
        from plutracer_tpu_torch.ops.cuda.intersect_kernel import closest_hit_bvh

        return closest_hit_bvh(scene, o.detach(), d.detach())
    chunk = max(1, XLA_BUDGET // scene.prim_type.shape[0])
    if o.shape[0] <= chunk:
        return intersect_lite(scene, o, d)
    parts = [intersect_lite(scene, o[i:i + chunk], d[i:i + chunk])
             for i in range(0, o.shape[0], chunk)]
    return tuple(torch.cat(x) for x in zip(*parts))


def differentiable_t(tables, o, d, found, prim, t, options):
    """query_lite's t for the same rays and options, with a gradient: on
    every backend but "xla" (whose t is intersect_lite's, differentiable
    as it stands) it is recomputed at the winner with the plain
    per-primitive test (tables: ops.tables.pack_tables), accepted only
    where that test agrees the ray hits (a _BIG sentinel on a found lane
    would put p at ~4e37). A missed lane keeps the query's t (_BIG from
    the walk, possibly a padding row near 1e30 from K1), which nothing
    reads: found is t < T_MAX."""
    if _resolve_backend(options, o.device) == "xla":
        return t
    td = prim_t_rows(o, d, gather_prim(tables, prim))
    return torch.where(found & (td < T_MAX), td, t)


# ---------------------------------------------------------------------------
# shading detail for the winning primitive
# ---------------------------------------------------------------------------


def _sphere_detail(p, norm):
    """UV/normal/dpdu per the reference's polar-coordinate code
    (src/surfaces/sphere.cpp:28-44). Note dpdu uses the *world* hit point.
    norm = normalize(p - center), computed by the caller."""
    cos_phi = -norm[..., 1]
    phi = torch.arccos(torch.clamp(cos_phi, -1.0, 1.0))
    sin_phi = torch.sin(phi)
    v = phi * (1.0 / math.pi)
    safe_sin = torch.where(sin_phi == 0.0, 1.0, sin_phi)
    ct = torch.clamp(-norm[..., 2] / safe_sin, -1.0, 1.0)
    theta = torch.arccos(ct) * (2.0 / math.pi)
    theta = torch.where(sin_phi == 0.0, 0.0, theta)
    theta = torch.where(norm[..., 0] >= 0.0, 1.0 - theta, theta)
    uv = torch.stack([theta, v], -1)
    two_pi = 2.0 * math.pi
    dpdu = torch.stack(
        [-two_pi * p[..., 1], two_pi * p[..., 0], torch.zeros_like(p[..., 0])], -1
    )
    # degenerate dpdu (hit point on the world z-axis): cross((0,1,0), norm)
    deg = dot(dpdu, dpdu) < 1e-20
    fallback = torch.stack(
        [norm[..., 2], torch.zeros_like(norm[..., 0]), -norm[..., 0]], -1
    )
    dpdu = torch.where(deg[..., None], fallback, dpdu)
    return norm, uv, dpdu


def _box_detail(p, bmin, bmax):
    """Nearest-face normal (src/surfaces/box.cpp:37-62) and the reference's
    uv/dpdu index maps (box.cpp:29-33 with unsigned (mci-1)%3 arithmetic:
    mci=0 -> uv=(p.x,p.y), dpdu=x; mci=1 -> uv=(p.x,p.z), dpdu=x;
    mci=2 -> uv=(p.y,p.x), dpdu=y). For x-faces dpdu is parallel to the
    normal (degenerate shading frame) — reference-faithful."""
    center = (bmin + bmax) * 0.5
    extents = bmax - center
    np_ = p - center
    dist = (extents - np_.abs()).abs()
    # reference loop keeps the FIRST minimum (strict <)
    mci = torch.argmin(dist, dim=-1)
    sign = torch.where(np_ < 0.0, -1.0, 1.0)  # sign(0) -> +1
    norm = F.one_hot(mci, 3).to(p.dtype) * torch.gather(sign, -1, mci[..., None])
    idx_u = torch.where(mci == 2, 1, 0)
    idx_v = torch.where(mci == 0, 1, torch.where(mci == 1, 2, 0))
    uv = torch.cat(
        [torch.gather(p, -1, idx_u[..., None]), torch.gather(p, -1, idx_v[..., None])], -1
    )
    dpdu = F.one_hot(idx_u, 3).to(p.dtype)
    return norm, uv, dpdu


def _triangle_detail(o, d, v0, v1, v2, uv0, uv1, uv2):
    """Geometric normal cross(U,V) of *normalized* edges, left unnormalized
    (|n| = sin(angle) < 1 darkens cosine terms — reference-faithful,
    src/surfaces/triangle.cpp:27), and the reference's swapped barycentric
    texture interp (weight u on corner 0)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pv = cross(d, e2)
    det = dot(e1, pv)
    idet = safe_recip(torch.where(det == 0.0, 1.0, det))
    tv = o - v0
    u = dot(tv, pv) * idet
    qv = cross(tv, e1)
    v = dot(d, qv) * idet
    w = 1.0 - (u + v)
    n1 = safe_sqrt(dot(e1, e1))[..., None]
    n2 = safe_sqrt(dot(e2, e2))[..., None]
    U = safe_div(e1, torch.clamp(n1, min=1e-20))
    V = safe_div(e2, torch.clamp(n2, min=1e-20))
    norm = cross(U, V)
    uv = uv0 * u[..., None] + uv1 * v[..., None] + uv2 * w[..., None]
    return norm, uv, U


def hit_detail_rows(o, d, t, prim, found, rows) -> Hit:
    """Shading detail from pre-gathered primitive rows (ops.tables.PrimRows).

    Missed lanes use t = 1 and found lanes are capped at T_MAX, so a
    sentinel t never turns into a 1e37 hit point."""
    a, b, c = rows.a, rows.b, rows.c
    ptype = rows.ptype
    t_safe = torch.where(found, torch.clamp(t, max=T_MAX), 1.0)
    p = o + d * t_safe[..., None]

    sp_norm = p - a
    sp_norm = sp_norm * safe_rsqrt(dot(sp_norm, sp_norm) + 1e-30)[..., None]
    sn, suv, sdpdu = _sphere_detail(p, sp_norm)
    bn, buv, bdpdu = _box_detail(p, a, b)
    tn, tuv, tdpdu = _triangle_detail(o, d, a, b, c, rows.uv0, rows.uv1, rows.uv2)

    is_s = (ptype == PRIM_SPHERE)[..., None]
    is_b = (ptype == PRIM_BOX)[..., None]
    norm = torch.where(is_s, sn, torch.where(is_b, bn, tn))
    uv = torch.where(is_s, suv, torch.where(is_b, buv, tuv))
    dpdu = torch.where(is_s, sdpdu, torch.where(is_b, bdpdu, tdpdu))
    return Hit(found=found, t=t, prim=prim, p=p, norm=norm, uv=uv, dpdu=dpdu)


def prim_t_rows(o, d, rows):
    """t for one pre-gathered primitive row per ray."""
    return _prim_t_batched(o, d, rows.ptype, rows.a, rows.b, rows.c)
