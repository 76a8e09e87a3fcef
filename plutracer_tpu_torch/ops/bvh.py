"""Closest hit by the reference's own BVH topology: the lockstep skip-link
traversal of ``Scene.bvh``.

The tree is the reference's (src/surfaces/bvh_tree.cpp:7-36: median split
on primitive centroids, the axis cycling x->y->z, one primitive a leaf),
flattened in depth-first order with skip links. It is built by
scene/bvh.py (``build_bvh``); ``Scene.bvh`` holds it as tensors
(scene/types.BvhTables). ``bvh_closest`` walks it as the JAX package's
ops/bvh.bvh_closest does (plutracer_tpu/ops/bvh.py:282-345), in plain
torch on the tensors' device:

- every ray holds a node pointer; an internal node whose box the ray's
  LINE crosses (the reference's slab test, geometry.Aabb.hit: no
  positivity or t-range check) is entered (node + 1), any other node is
  skipped (node_skip);
- a leaf tests its primitive WITHOUT its own box (bvh_node::hit returns
  object->hit directly, bvh_tree.cpp:40-42), so a non-unit ray keeps a
  phantom sphere hit whose line crosses the leaf's parent box;
- the running minimum takes a new t only when strictly smaller;
- the rays advance in lockstep while any ray's node is below N.

It is the oracle that reads the reference's tree topology, and a library
function. No intersect_backend routes to it: the port's "bvh" engine is
the K3 query over the walk layout (ops/cuda/intersect_kernel.closest_hit_bvh).
"""

from __future__ import annotations

import torch

from plutracer_tpu_torch.ops.geometry import Aabb
from plutracer_tpu_torch.ops.intersect import _BIG, T_MAX, _prim_t_batched


def bvh_closest(scene, bvh, o, d, count: bool = False):
    """(found, prim, t) of rays o, d (B, 3) by the skip-link traversal of
    `bvh` (scene.bvh, or scene/bvh.build_bvh's numpy arrays) over the
    scene's primitive rows. A miss reports prim 0 and t _BIG. With
    count=True also the number of lockstep steps the batch took."""
    dev = o.device
    node_min, node_max, node_skip, node_prim = (
        torch.as_tensor(x, device=dev) for x in (bvh.node_min, bvh.node_max, bvh.node_skip,
                                                 bvh.node_prim))
    node_skip, node_prim = node_skip.long(), node_prim.long()
    B, N = o.shape[0], node_skip.shape[0]
    node = torch.zeros(B, dtype=torch.long, device=dev)
    best_t = torch.full((B,), _BIG, dtype=o.dtype, device=dev)
    best_p = torch.zeros(B, dtype=torch.int32, device=dev)
    steps = 0
    while bool((node < N).any()):
        active = node < N
        ni = torch.clamp(node, max=N - 1)
        hit_box = Aabb(node_min[ni], node_max[ni]).hit(o, d) & active
        prim = node_prim[ni]
        is_leaf = prim >= 0
        pi = torch.clamp(prim, min=0)
        t = _prim_t_batched(o, d, scene.prim_type[pi], scene.prim_a[pi], scene.prim_b[pi],
                            scene.prim_c[pi])
        take = active & is_leaf & (t < best_t)
        best_t = torch.where(take, t, best_t)
        best_p = torch.where(take, pi.to(torch.int32), best_p)
        descend = hit_box & ~is_leaf
        node = torch.where(active, torch.where(descend, node + 1, node_skip[ni]), node)
        steps += 1
    out = (best_t < T_MAX, best_p, best_t)
    return out + (steps,) if count else out
