"""Wavefront dispatch of the stream tier: one kernel launch per bounce.

The counterpart of the JAX package's ``_ray_color_stream_wavefront`` and
``_morton_key`` (plutracer_tpu/ops/pallas/integrator_kernel.py:2078-2228),
taken when ``options.stream_wavefront`` is set. Each launch runs one
shading vertex of every live lane; between launches the lanes are
reordered (``options.stream_sort``): ``none``; ``compact``, live lanes
ahead of dead ones; ``morton``, live lanes by the Morton code of their
origin; ``morton5``, three direction-octant bits ahead of the origin
code. The host's part of the loop is a stable argsort of the keys the
previous launch wrote; everything else happens in the launch
(``Wave`` holds the buffers):

- launch 0 finds the primary hit and starts every lane's state itself;
- the carry is lane-major, (B, 16) float32 (unpadded: K4 takes any B):

      0:3 o | 3:6 d | 6:9 T | 9:12 L | 12 prev_spec | 13 alive | 14 prim | 15 t

  (prim is a scene row, exact in float32: compile_scene holds a scene to
  scene/compile.MAX_TABLE_ROWS = 2^24 rows). Under a sort launch i reads its lane at
  perm[lane] of the previous carry, with the lane's ray index
  (orig_next[lane] = orig[perm[lane]]), and its uniforms at that ray, so
  each ray keeps its own draws; under ``none`` the carry is updated in
  place;
- a lane writes its radiance to out[ray] at the launch where its path
  ends (``alive and t < T_MAX`` fails, the JAX loop's test) or at the
  last launch: each ray once;
- the launch counts the lanes it leaves alive and those it ends into
  ``counts`` (on the device); under a sort the live lanes form a prefix,
  and the next launch runs only that prefix;
- when a sort follows, every lane writes its next key (``sort_keys``).

Each step is ``stream_kernel.onebounce``: the one-bounce kernel K4 on
CUDA tensors, ``onebounce_plain`` (the same contract in torch around
``integrator.plain_bounce``) on CPU tensors. The per-ray math is that of
``ray_color_plain`` and only the lane order differs, so on the CPU the
wavefront result is bit-equal to ``ray_color_plain``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS, RenderOptions
from plutracer_tpu_torch.ops import intersect
from plutracer_tpu_torch.ops.tables import pack_tables
from plutracer_tpu_torch.render.integrator import PathState

SORTS = ("none", "compact", "morton", "morton5")
CARRY_W = 16
DEAD_KEY = 2**30  # a dead lane's key (compact: 1), behind every live key


def carry_of(state: PathState) -> torch.Tensor:
    """(B, 16) lane-major carry of a PathState."""
    return torch.cat([
        state.o, state.d, state.T, state.L,
        state.prev_spec.to(torch.float32)[:, None], state.alive.to(torch.float32)[:, None],
        state.prim.to(torch.float32)[:, None], state.t[:, None],
    ], 1)


def state_of(carry: torch.Tensor) -> PathState:
    """The PathState view of a (B, 16) carry."""
    return PathState(
        o=carry[:, 0:3], d=carry[:, 3:6], T=carry[:, 6:9], L=carry[:, 9:12],
        prev_spec=carry[:, 12] != 0.0, alive=carry[:, 13] != 0.0,
        prim=carry[:, 14].to(torch.int32), t=carry[:, 15],
    )


def live_lanes(carry: torch.Tensor) -> torch.Tensor:
    """(B,) bool: the lane's path goes on (alive and t < T_MAX)."""
    return (carry[:, 13] != 0.0) & (carry[:, 15] < intersect.T_MAX)


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


def sort_keys(carry, sort: str, lo, hi, live=None) -> torch.Tensor:
    """(B,) int32 keys of the carry's lanes for the next reorder under
    ``sort`` (not "none"), whose stable argsort is the JAX loop's order:
    morton, the Morton code of the origin; morton5, the direction octant
    ahead of that code >> 3; compact, 0. A lane that is not live (``live``,
    by default live_lanes) gets DEAD_KEY, under compact 1."""
    if sort not in SORTS[1:]:
        raise ValueError(f"stream_sort must be one of {SORTS[1:]} for keys, got {sort!r}")
    live = live_lanes(carry) if live is None else live
    if sort == "compact":
        return torch.where(live, 0, 1).to(torch.int32)
    key = morton_key(carry[:, 0:3], lo, hi)
    if sort == "morton5":
        d = carry[:, 3:6] >= 0.0
        octant = d[:, 0].to(torch.int32) * 4 + d[:, 1].to(torch.int32) * 2 + d[:, 2].to(torch.int32)
        key = (octant << 27) | (key >> 3)
    return torch.where(live, key, DEAD_KEY).to(torch.int32)


@dataclasses.dataclass
class Wave:
    """The buffers of one wavefront loop. ``carry`` is what the next
    launch reads, ``carry_next`` what it writes (the same tensor under
    "none"); ``orig``/``orig_next`` the ray of each lane of them (None
    under "none": lane = ray); ``key`` the keys the last launch wrote;
    ``counts`` (2 * max_bounces,) int32: lanes left alive by launch i at
    i, lanes ended by it at max_bounces + i; ``bounds`` the Morton grid's
    lo and hi (6,); ``out`` (B, 3) the radiance at each ray."""

    o: torch.Tensor
    d: torch.Tensor
    u: torch.Tensor
    sort: str
    carry: torch.Tensor
    carry_next: torch.Tensor
    orig: Optional[torch.Tensor]
    orig_next: Optional[torch.Tensor]
    key: Optional[torch.Tensor]
    counts: torch.Tensor
    bounds: torch.Tensor
    out: torch.Tensor

    @property
    def B(self) -> int:
        return self.o.shape[0]

    @classmethod
    def start(cls, scene, o, d, u, sort, max_bounces, out=None):
        B, dev = o.shape[0], o.device
        f32 = dict(dtype=torch.float32, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        carry = torch.empty((B, CARRY_W), **f32)
        sorted_ = sort != "none"
        return cls(
            o=o.contiguous(), d=d.contiguous(), u=u.contiguous(), sort=sort, carry=carry,
            carry_next=torch.empty((B, CARRY_W), **f32) if sorted_ else carry,
            orig=None, orig_next=torch.empty(B, **i32) if sorted_ else None,
            key=torch.empty(B, **i32) if sorted_ else None,
            counts=torch.zeros(2 * max_bounces, **i32),
            bounds=torch.cat(scene_bounds(scene)).to(torch.float32).contiguous(),
            out=torch.empty((B, 3), **f32) if out is None else out,
        )

    def advance(self):
        """After a launch: what it wrote is what the next one reads."""
        self.carry, self.carry_next = self.carry_next, self.carry
        if self.orig_next is not None:
            if self.orig is None:
                self.orig = torch.empty_like(self.orig_next)
            self.orig, self.orig_next = self.orig_next, self.orig


def ray_color_wavefront(scene, o, d, u, options: RenderOptions = DEFAULT_OPTIONS, step=None,
                        out=None, wave_out=None):
    """Radiance (B, 3) for rays o, d (B, 3) and uniforms u
    (max_bounces, B, 12), one step per bounce: ``step(scene, tables, wave,
    i, perm, options)`` runs vertex i of the Wave's lanes (perm: the
    stable argsort of wave.key under a sort, None at launch 0 and under
    "none") and writes the Wave's buffers; by default
    stream_kernel.onebounce (K4 on a card). ``out`` (B, 3), if given,
    receives the radiance; ``wave_out``, a list, receives the Wave."""
    if step is None:
        from plutracer_tpu_torch.ops.cuda.stream_kernel import onebounce as step

    sort = getattr(options, "stream_sort", "morton")
    if sort not in SORTS:
        raise ValueError(f"stream_sort must be one of {SORTS}, got {sort!r}")
    tables = pack_tables(scene)
    wave = Wave.start(scene, o, d, u, sort, options.max_bounces, out)
    for i in range(options.max_bounces):
        # launch 0 keeps the camera rays' pixel order
        perm = torch.argsort(wave.key, stable=True) if i > 0 and sort != "none" else None
        step(scene, tables, wave, i, perm, options)
        wave.advance()
    if wave_out is not None:
        wave_out.append(wave)
    return wave.out
