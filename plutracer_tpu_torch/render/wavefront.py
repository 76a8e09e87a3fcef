"""Wavefront dispatch of the stream tier: one kernel launch per bounce.

The counterpart of the JAX package's ``_ray_color_stream_wavefront`` and
``_morton_key`` (plutracer_tpu/ops/pallas/integrator_kernel.py:2078-2228),
taken when ``options.stream_wavefront`` is set. The ray state lives in a
carry of 16 columns, (16, B) float32 (unpadded: K4 takes any B):

    0:3 o | 3:6 d | 6:9 T | 9:12 L | 12 prev_spec | 13 alive | 14 prim | 15 t

(prim is a scene row, exact in float32 below 2^24; the stream tier holds
at most 2^20 rows). Between bounces the carry is reordered
(``options.stream_sort``): ``none``; ``compact``, a cumsum partition of
live lanes ahead of dead ones; ``morton``, a stable sort of live lanes by
the Morton code of their origin; ``morton5``, three direction-octant bits
ahead of the origin code. The uniforms are gathered through the order,
so each ray keeps its own draws, and the radiance is scattered back to
ray order at the end.

Each bounce is ``stream_kernel.onebounce``: the one-bounce kernel K4 on
CUDA tensors, ``integrator.plain_bounce`` on CPU tensors. The per-ray
math is that of ``ray_color`` and only the row order differs, so on the
CPU the wavefront result is bit-equal to ``ray_color``.
"""

from __future__ import annotations

import torch

from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS, RenderOptions
from plutracer_tpu_torch.ops import intersect
from plutracer_tpu_torch.ops.tables import pack_tables
from plutracer_tpu_torch.render.integrator import PathState

SORTS = ("none", "compact", "morton", "morton5")


def carry_of(state: PathState) -> torch.Tensor:
    """(16, B) carry columns of a PathState."""
    return torch.cat([
        state.o.T, state.d.T, state.T.T, state.L.T,
        state.prev_spec.to(torch.float32)[None], state.alive.to(torch.float32)[None],
        state.prim.to(torch.float32)[None], state.t[None],
    ])


def state_of(carry: torch.Tensor) -> PathState:
    """The PathState view of a (16, B) carry."""
    return PathState(
        o=carry[0:3].T, d=carry[3:6].T, T=carry[6:9].T, L=carry[9:12].T,
        prev_spec=carry[12] != 0.0, alive=carry[13] != 0.0,
        prim=carry[14].to(torch.int32), t=carry[15],
    )


def _spread(v: torch.Tensor) -> torch.Tensor:
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_key(p, lo, hi) -> torch.Tensor:
    """(B,) int32 Morton code of positions p (B, 3) within [lo, hi], 10
    bits per axis: the JAX package's _morton_key, bit for bit."""
    g = torch.clamp((p - lo) / torch.clamp(hi - lo, min=1e-9), 0.0, 1.0)
    xyz = (g * 1023.0).to(torch.int64)
    code = _spread(xyz[:, 0]) | (_spread(xyz[:, 1]) << 1) | (_spread(xyz[:, 2]) << 2)
    return code.to(torch.int32)


def scene_bounds(scene):
    """The Morton grid's box: min and max over prim_a, prim_b and prim_c
    (the JAX wavefront's bounds, sphere radius columns included)."""
    lo = torch.minimum(scene.prim_a.min(0).values,
                       torch.minimum(scene.prim_b.min(0).values, scene.prim_c.min(0).values))
    hi = torch.maximum(scene.prim_a.max(0).values,
                       torch.maximum(scene.prim_b.max(0).values, scene.prim_c.max(0).values))
    return lo, hi


def reorder(carry, sort: str, lo, hi) -> torch.Tensor:
    """The permutation (B,) int64 of the carry's lanes for the next bounce
    under ``sort``."""
    live = (carry[13] != 0.0) & (carry[15] < intersect.T_MAX)
    if sort in ("morton", "morton5"):
        key = morton_key(carry[0:3].T, lo, hi)
        if sort == "morton5":
            octant = ((carry[3] >= 0.0).to(torch.int32) * 4
                      + (carry[4] >= 0.0).to(torch.int32) * 2
                      + (carry[5] >= 0.0).to(torch.int32))
            key = (octant << 27) | (key >> 3)
        key = torch.where(live, key, 2**30)
        return torch.argsort(key, stable=True)
    if sort == "compact":
        n = live.shape[0]
        live_i = live.to(torch.int64)
        pos = torch.where(live, torch.cumsum(live_i, 0) - 1,
                          live_i.sum() + torch.cumsum(1 - live_i, 0) - 1)
        return torch.empty(n, dtype=torch.int64, device=live.device).scatter_(
            0, pos, torch.arange(n, device=live.device))
    raise ValueError(f"stream_sort must be one of {SORTS}, got {sort!r}")


def ray_color_wavefront(scene, o, d, u, options: RenderOptions = DEFAULT_OPTIONS, step=None):
    """Radiance (B, 3) for rays o, d (B, 3) and uniforms u
    (max_bounces, B, 12), one step per bounce over the reordered carry:
    ``step(scene, tables, carry, u_i, i, options)``, by default
    stream_kernel.onebounce (K4 on a card)."""
    if step is None:
        from plutracer_tpu_torch.ops.cuda.stream_kernel import onebounce as step

    sort = getattr(options, "stream_sort", "morton")
    if sort not in SORTS:
        raise ValueError(f"stream_sort must be one of {SORTS}, got {sort!r}")
    B = o.shape[0]
    dev = o.device
    tables = pack_tables(scene)

    # the primary hit (query_lite: K1 on a card)
    found, prim, t = intersect.query_lite(scene, o, d)
    carry = carry_of(PathState(
        o=o, d=d, T=torch.ones_like(o), L=torch.zeros_like(o),
        prev_spec=torch.zeros(B, dtype=torch.bool, device=dev),
        alive=torch.ones(B, dtype=torch.bool, device=dev), prim=prim, t=t,
    ))
    us = u.permute(0, 2, 1)  # (mb, 12, B): uniforms per (bounce, slot, lane)
    orig = torch.arange(B, device=dev)
    lo, hi = scene_bounds(scene)

    for i in range(options.max_bounces):
        # bounce 0 keeps the camera rays' pixel order
        if i > 0 and sort != "none":
            perm = reorder(carry, sort, lo, hi)
            carry = carry[:, perm]
            orig = orig[perm]
        carry = step(scene, tables, carry, us[i][:, orig], i, options)

    L = torch.empty((B, 3), dtype=torch.float32, device=dev)
    L[orig] = carry[9:12].T
    return L
