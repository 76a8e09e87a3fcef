"""Math-core utilities: rays and axis-aligned bounding boxes.

Batched ports of the reference's plu::ray / plu::aabb toolkit
(inc/cmmn.h:40-216), as the JAX package's ops/geometry.py. The renderer's
hot path inlines what it needs (ops/intersect.py); these standalone
versions complete the public API (transforms, containment, union,
ray-interval queries) for tooling, the reference-topology BVH traversal
(ops/bvh.py) and user code.

Every sum over an axis of length 3 is written out in one order, (x + y) +
z, so the rounding is the same on every device. The transforms are such
sums of products; XLA's CPU contracts them into fused multiply-adds, so
they differ from the JAX package's by an ulp or two (within 1e-6
relative).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from plubench.reference.ops.safemath import dot


def _matvec(r, v):
    """r (3, 3) times v (..., 3), each row's sum in the order (x + y) + z."""
    return torch.stack([dot(r[i], v) for i in range(3)], -1)


class Aabb(NamedTuple):
    lo: torch.Tensor  # (...,3)
    hi: torch.Tensor  # (...,3)

    @staticmethod
    def empty(device) -> "Aabb":
        z = torch.zeros(3, dtype=torch.float32, device=device)
        return Aabb(z, z.clone())

    def union(self, other: "Aabb") -> "Aabb":
        """aabb(a, b) union constructor (cmmn.h:77-84)."""
        return Aabb(torch.minimum(self.lo, other.lo), torch.maximum(self.hi, other.hi))

    def contains(self, p):
        """Inclusive containment (cmmn.h:97-104)."""
        return torch.all((p >= self.lo) & (p <= self.hi), dim=-1)

    def transform(self, m) -> "Aabb":
        """Arvo-style AABB transform by a 4x4 matrix (cmmn.h:125-146)."""
        t = m[:3, 3]
        r = m[:3, :3]
        a = r * self.lo[..., None, :]
        b = r * self.hi[..., None, :]
        lo3, hi3 = torch.minimum(a, b), torch.maximum(a, b)
        fold = lambda x: x[..., 0] + x[..., 1] + x[..., 2]
        return Aabb(t + fold(lo3), t + fold(hi3))

    def hit(self, o, d):
        """Slab test: tmax >= tmin (cmmn.h:150-170; no positivity check)."""
        tmin, tmax = self.hit_retint(o, d)
        return tmax >= tmin

    def hit_retint(self, o, d) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (tmin, tmax) interval on the ray inside the box
        (cmmn.h:173-190)."""
        rrd = 1.0 / torch.where(d == 0.0, 1e-20, d)
        t1 = (self.lo - o) * rrd
        t2 = (self.hi - o) * rrd
        tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
        tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
        return tmin, tmax

    def center(self):
        return (self.lo + self.hi) * 0.5

    def extents(self):
        return self.hi - self.lo
