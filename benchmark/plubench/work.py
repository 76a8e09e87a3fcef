"""The least time the card could take for a render's work: the yardstick of
``render_kernels_roofline``.

The work is what the render's paths need, whatever kernels compute it,
counted by the frozen reference (plubench/reference) on the pixels the
correctness check replays (all their strata), and scaled to the images the
window completed:

- operations: each running vertex outside its queries at its cheapest
  branch (SHADE_OPS); each query the vertex must issue (ray_color_plain's
  `work`) walked over the reference's tree, every node's box test at
  NODE_OPS and every row tested at its type's ROW_OPS, an any-hit walk
  ending at its first hit; float32 operations at FP32_OPS_PER_S;
- the threefry words the paths consume (12 a running vertex; 2 a camera
  ray's pixel jitter, 2 more with a lens) at INT32_WORD_OPS integer
  operations a word, at INT32_OPS_PER_S;
- bytes: the scene's tables read once and each image written once (the
  linear and the tonemapped image), at HBM_BYTES_PER_S.

The least time is the largest of the three. The walk is the skip-link
walk of the reference's tree (median split, the upstream renderer's
topology) with the ray's segment [0, best t) pruning boxes, in depth-first
order: a program with a better tree could need fewer operations, and the
count then wants correcting.
"""

from __future__ import annotations

import dataclasses

import torch

# NVIDIA H100 SXM peaks (data sheet, dense, at the 700 W limit): HBM3
# bytes/s and float32 (non-tensor) operations/s; 32-bit integer operations
# at 128 a clock on each of the 132 SMs at 1,980 MHz
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 128 * 132 * 1.98e9
# float32 operations of one row test (sphere, box, triangle: subtractions,
# products, sums, min/max, compares and the fold of the closest hit)
ROW_OPS = (50, 26, 60)
# one box test of a walk (the slab: 6 sub, 6 mul, 10 min/max, 3 compares)
NODE_OPS = 25
# a vertex outside its queries on its cheapest branch: a sphere's hit
# detail 47, the frame 19, a point light's sample 16, a mirror's two BSDF
# samples 96, and 109 for the emission test, the light pick, the MIS
# weights, the NEE gates and the radiance and throughput updates
SHADE_OPS = 47 + 19 + 16 + 96 + 109
# 32-bit integer operations of one threefry word: 20 rounds of add, rotate
# and xor, 5 key injections of two adds, the counter's add, and the xor,
# shift, or and subtract that make the float
INT32_WORD_OPS = 20 * 3 + 5 * 2 + 1 + 4
WALK_CHUNK = 1 << 18  # rays a lockstep walk takes at once


@dataclasses.dataclass
class Work:
    fp32_ops: float = 0.0
    int32_ops: float = 0.0
    bytes: float = 0.0

    def scaled(self, k: float) -> "Work":
        return Work(self.fp32_ops * k, self.int32_ops * k, self.bytes * k)

    def __add__(self, other: "Work") -> "Work":
        return Work(self.fp32_ops + other.fp32_ops, self.int32_ops + other.int32_ops,
                    self.bytes + other.bytes)

    def least_s(self) -> float:
        return max(self.fp32_ops / FP32_OPS_PER_S, self.int32_ops / INT32_OPS_PER_S,
                   self.bytes / HBM_BYTES_PER_S)


def _box_segment_hit(o, d, mn, mx, t_hi):
    """The slab test of the segment [0, t_hi) of each ray against its box."""
    inv = 1.0 / torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
    t1, t2 = (mn - o) * inv, (mx - o) * inv
    lo = torch.minimum(t1, t2).amax(-1).clamp(min=0.0)
    hi = torch.minimum(torch.maximum(t1, t2).amin(-1), t_hi)
    return lo <= hi


def walk_ops(scene, o, d, any_hit: bool) -> float:
    """Float32 operations of the skip-link walks of rays o, d over the
    reference scene's tree (scene.bvh) and rows: every node visited tests
    its box (a leaf its row instead)."""
    from plubench.reference.ops.intersect import T_MAX, _prim_t_batched

    bvh = scene.bvh
    node_min, node_max = bvh.node_min, bvh.node_max
    skip, node_prim = bvh.node_skip.long(), bvh.node_prim.long()
    row_ops = torch.tensor(ROW_OPS, dtype=torch.float64, device=o.device)
    N, total = skip.shape[0], 0.0
    for i in range(0, o.shape[0], WALK_CHUNK):
        oc, dc = o[i:i + WALK_CHUNK], d[i:i + WALK_CHUNK]
        B = oc.shape[0]
        node = torch.zeros(B, dtype=torch.long, device=o.device)
        best = torch.full((B,), T_MAX, dtype=oc.dtype, device=o.device)
        boxes = torch.zeros(B, dtype=torch.float64, device=o.device)
        rows = torch.zeros(B, dtype=torch.float64, device=o.device)
        while True:
            active = node < N
            if not bool(active.any()):
                break
            ni = node.clamp(max=N - 1)
            prim = node_prim[ni]
            leaf = prim >= 0
            pi = prim.clamp(min=0)
            ptype = scene.prim_type[pi].long()
            t = _prim_t_batched(oc, dc, scene.prim_type[pi], scene.prim_a[pi], scene.prim_b[pi],
                                scene.prim_c[pi])
            tested = active & leaf
            rows += torch.where(tested, row_ops[ptype.clamp(0, 2)], 0.0)
            boxes += (active & ~leaf).double()
            best = torch.where(tested & (t < best), t, best)
            enter = _box_segment_hit(oc, dc, node_min[ni], node_max[ni], best) & ~leaf
            nxt = torch.where(enter | leaf, node + 1, skip[ni])
            if any_hit:
                nxt = torch.where(best < T_MAX, N, nxt)
            node = torch.where(active, nxt, node)
        total += float((boxes * NODE_OPS + rows).sum())
    return total


def path_work(scene, work: dict, rays: int, lens: bool) -> Work:
    """The Work of ray_color_plain's `work` dict over `rays` camera rays."""
    cat = lambda pairs: tuple(torch.cat(x) for x in zip(*pairs))
    fp = work.get("vertices", 0) * SHADE_OPS
    fp += walk_ops(scene, *cat(work["closest"]), any_hit=False)
    if work.get("any_hit"):
        fp += walk_ops(scene, *cat(work["any_hit"]), any_hit=True)
    words = 12 * work.get("vertices", 0) + (4 if lens else 2) * rays
    return Work(fp32_ops=float(fp), int32_ops=float(words * INT32_WORD_OPS))


def table_bytes(scene) -> float:
    """The scene tables the paths read once: primitive, material, texture
    and light rows (their packed widths) and the atlas."""
    n = (scene.prim_type.shape[0] * 32 + scene.mat_type.shape[0] * 12
         + scene.tex_type.shape[0] * 12 + scene.light_type.shape[0] * 8 + scene.atlas.numel())
    return 4.0 * n


def image_bytes(width: int, height: int) -> float:
    """One image written once: the linear and the tonemapped (H, W, 3)."""
    return 2 * 4.0 * width * height * 3
