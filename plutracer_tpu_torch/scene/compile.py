"""Scene compiler: SceneDesc -> Scene (tensors on one device).

Every table is assembled in host numpy first (the same stage as the JAX
package's compile), then ``scene_from_numpy`` turns the numpy leaves into
tensors and one ``.to(device)`` moves them. ``scene_from_numpy`` also
accepts the JAX package's compiled leaves, so tests can run both packages
on identical tables.

The camera basis is built exactly as the reference does
(inc/camera.h:17-23): look = norm(target-pos), right = 1.5*norm(cross(look,
(0,-1,0))), up = 1.5*norm(cross(look, right)), film distance w = 2.5.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Dict, Tuple

import numpy as np
import torch

from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS, RenderOptions
from plutracer_tpu_torch.scene.bvh import build_bvh, parent_bounds_tables
from plutracer_tpu_torch.scene.loader import box_area, sphere_area, triangle_area
from plutracer_tpu_torch.scene.types import (
    PRIM_BOX,
    PRIM_SPHERE,
    PRIM_TRIANGLE,
    TEX_IMAGE,
    BvhTables,
    CameraParams,
    Scene,
    SceneDesc,
)

PRIM_TILE = 8  # rows per type segment of the packed closest-hit table
# node boxes of the BVH walk are padded by this fraction of the scene's
# size: a hit that K1's arithmetic accepts on a box face or a triangle
# edge must never be culled by a node test that rounds the other way
BVH_MARGIN = 1e-4
# the walk layout of the stream kernels (csrc/bvh_closest.cuh, whose
# constants of the same names must agree): rows a leaf holds at most, the
# per-thread stack's entries, the width of a walk row
WALK_LEAF_ROWS = 4
WALK_STACK = 32
WALK_ROW_W = 20
# the tables store row ids and atlas offsets as float32, exact up to 2^24
# (every path reads them back as integers: ops/tables.py, csrc
# path_common.cuh row_id), so a scene holds at most this many primitives
# and atlas texels
MAX_TABLE_ROWS = 1 << 24


def build_camera(
    pos: np.ndarray,
    target: np.ndarray,
    resolution: Tuple[int, int],
    lens_radius: float = 0.0,
    focal_distance: float = 0.0,
    w: float = 2.5,
) -> Dict[str, np.ndarray]:
    """CameraParams fields as numpy leaves."""
    look = target - pos
    nl = np.linalg.norm(look)
    look = look / nl if nl > 0 else np.array([0.0, 0.0, 1.0], np.float32)
    right = np.cross(look, np.array([0.0, -1.0, 0.0], np.float32))
    nr = np.linalg.norm(right)
    right = 1.5 * right / nr if nr > 0 else np.array([1.5, 0.0, 0.0], np.float32)
    up = np.cross(look, right)
    up = 1.5 * up / np.linalg.norm(up)
    return dict(
        pos=np.asarray(pos, np.float32),
        look=np.asarray(look, np.float32),
        right=np.asarray(right, np.float32),
        up=np.asarray(up, np.float32),
        inv_image_size=np.asarray(
            [1.0 / resolution[0], 1.0 / resolution[1]], np.float32
        ),
        w=np.float32(w),
        lens_radius=np.float32(lens_radius),
        focal_distance=np.float32(focal_distance),
    )


def _prim_area(p, options: RenderOptions) -> float:
    if p.ptype == PRIM_SPHERE:
        return sphere_area(float(p.b[0]), options.sphere_area_is_volume)
    if p.ptype == PRIM_BOX:
        return box_area(p.b - p.a)
    return triangle_area(p.a, p.b, p.c)


def pack_prims_np(leaves: Dict) -> np.ndarray:
    """(P_pad, 24) f32 primitive table for the closest-hit kernel,
    PARTITIONED BY PRIMITIVE TYPE: all spheres, then boxes, then
    triangles, each segment padded to a PRIM_TILE multiple with never-hit
    rows of the same type. Columns: 0 type | 1:4 a | 4:7 b | 7:10 c |
    10 original scene row (the reported winner) | 11:14 parent-AABB min |
    14:17 parent-AABB max (sphere rows in cull_rows; always-hit +-3e38
    otherwise). Identical to the JAX package's pack_prims_np."""
    ptype = np.asarray(leaves["prim_type"], np.int32)
    pa = np.asarray(leaves["prim_a"], np.float32)
    pb = np.asarray(leaves["prim_b"], np.float32)
    pc = np.asarray(leaves["prim_c"], np.float32)
    pmin = leaves.get("parent_min")
    pmax = leaves.get("parent_max")
    cull = set(leaves.get("cull_rows") or ())

    segments = []
    for t in (PRIM_SPHERE, PRIM_BOX, PRIM_TRIANGLE):
        (idx,) = np.nonzero(ptype == t)
        if idx.size == 0:
            continue
        n_pad = -(-idx.size // PRIM_TILE) * PRIM_TILE
        seg = np.zeros((n_pad, 24), np.float32)
        seg[:, 0] = t
        seg[:, 11:14] = -3.0e38  # parent-AABB cull default: always hit
        seg[:, 14:17] = 3.0e38
        seg[: idx.size, 1:4] = pa[idx]
        seg[: idx.size, 4:7] = pb[idx]
        seg[: idx.size, 7:10] = pc[idx]
        seg[: idx.size, 10] = idx.astype(np.float32)
        if t == PRIM_SPHERE and pmin is not None:
            for i, j in enumerate(idx):
                if int(j) in cull:
                    seg[i, 11:14] = np.asarray(pmin)[j]
                    seg[i, 14:17] = np.asarray(pmax)[j]
        # never-winning padding placed ~1e30 away (an inverted box is not
        # a miss: the slab test re-sorts t1/t2); zero triangles have det 0
        if t == PRIM_SPHERE:
            seg[idx.size :, 1] = 1.0e30
        elif t == PRIM_BOX:
            seg[idx.size :, 1:4] = 1.0e30
            seg[idx.size :, 4:7] = 2.0e30
        seg[idx.size :, 10] = 0.0
        segments.append(seg)
    if not segments:
        seg = np.zeros((PRIM_TILE, 24), np.float32)
        seg[:, 0] = PRIM_TRIANGLE
        segments.append(seg)
    return np.concatenate(segments, axis=0)


def _packed_rows(prim_type):
    """(row_of, type_rows): each primitive's row of ``prims_packed`` (the
    inverse of packed col 10 over the real rows) and the padded rows of
    each type segment (sphere, box, triangle; 0 for an absent type)."""
    ptype = np.asarray(prim_type, np.int32)
    row_of = np.zeros(ptype.shape[0], np.int32)
    type_rows = []
    offset = 0
    for t in (PRIM_SPHERE, PRIM_BOX, PRIM_TRIANGLE):
        (idx,) = np.nonzero(ptype == t)
        row_of[idx] = offset + np.arange(idx.size, dtype=np.int32)
        n_pad = -(-idx.size // PRIM_TILE) * PRIM_TILE
        type_rows.append(int(n_pad))
        offset += n_pad
    return row_of, tuple(type_rows)


def packed_type_rows(prim_type) -> Tuple[int, int, int]:
    """The padded rows of each type segment of ``prims_packed`` (sphere,
    box, triangle), 0 for an absent type."""
    return _packed_rows(prim_type)[1]


def bvh_helpers(prim_type, bvh) -> Dict:
    """What the walk layout reads of the skip-link tree beyond its boxes
    (numpy), from the primitive types and the tree:

    - ``leaf_row`` (N,) i32: each leaf's row of ``prims_packed``, -1 at
      internal nodes;
    - ``line_only`` (N,) bool: the node's subtree holds a sphere, so the
      walk tests it with the LINE slab test only (a phantom hit of a
      non-unit ray lies outside the sphere's own box at any t);
    - ``margin``: the padding of every node box, BVH_MARGIN of the root
      box's size (diagonal or largest coordinate)."""
    ptype = np.asarray(prim_type, np.int32)
    row_of, _ = _packed_rows(ptype)
    node_prim = np.asarray(bvh.node_prim, np.int32)
    node_skip = np.asarray(bvh.node_skip, np.int64)
    leaf = node_prim >= 0
    prim = np.maximum(node_prim, 0)
    sphere_leaf = leaf & (ptype[prim] == PRIM_SPHERE)
    csum = np.concatenate([[0], np.cumsum(sphere_leaf)])
    line_only = csum[node_skip] - csum[np.arange(node_prim.shape[0])] > 0
    lo = np.asarray(bvh.node_min, np.float64)[0]
    hi = np.asarray(bvh.node_max, np.float64)[0]
    scale = max(float(np.linalg.norm(hi - lo)), float(np.abs(lo).max()), float(np.abs(hi).max()))
    return dict(
        leaf_row=np.where(leaf, row_of[prim], -1).astype(np.int32),
        line_only=line_only,
        margin=BVH_MARGIN * scale,
    )


def leaf_ref(first, count):
    """A walk child reference to the leaf of rows [first, first + count)
    of walk_rows (count 1 to WALK_LEAF_ROWS): -1 - (4 first + count - 1).
    An internal node is referenced by its index (> 0, the root is never a
    child), an absent child by 0."""
    return -1 - (np.asarray(first, np.int64) * 4 + np.asarray(count, np.int64) - 1)


def walk_tables(prim_type, bvh, prims_packed) -> Dict:
    """The traversal layout of the stream kernels' walk, built from the
    reference tree (which it does not change: its nodes are a subset of
    the tree's, so every node box still holds its spheres' cull boxes) and
    bvh_helpers' leaf rows, LINE flags and margin:

    - ``walk_rows`` (P, WALK_ROW_W) f32: the packed rows in the tree's
      leaf order, so a subtree's rows are contiguous; cols 0:17 as
      prims_packed, col 10 the row's index in prims_packed (the tie key
      of the lexicographic fold; the scene row is read from prims_packed
      for the winner), cols 17:20 zero;
    - ``walk_nodes`` (Nw, 16) i32, one 64-byte record per internal node,
      root first, in depth-first order: both children's boxes padded by
      `margin` (cols 0:12, float32 bits: left lo, left hi, right lo,
      right hi), the children's references (cols 12, 13: see leaf_ref),
      flags (col 14: bit 0 the left, bit 1 the right subtree holds a
      sphere, so it is entered on the LINE test only), col 15 zero.
      A subtree of at most WALK_LEAF_ROWS primitives is one leaf.

    Returns the two tables and ``walk_depth``, the deepest internal
    node's depth (the walk's stack holds at most walk_depth + 1 entries;
    it must fit WALK_STACK)."""
    h = bvh_helpers(prim_type, bvh)
    node_prim = np.asarray(bvh.node_prim, np.int32)
    skip = np.asarray(bvh.node_skip, np.int64)
    line_only = h["line_only"]
    lo = np.asarray(bvh.node_min, np.float32) - np.float32(h["margin"])
    hi = np.asarray(bvh.node_max, np.float32) + np.float32(h["margin"])
    N = node_prim.shape[0]
    leaf = node_prim >= 0
    csum = np.concatenate([[0], np.cumsum(leaf)])
    n_leaves = csum[skip] - csum[np.arange(N)]
    order = h["leaf_row"].astype(np.int64)[leaf]  # packed rows in leaf order
    rows = np.array(prims_packed, np.float32)[order, :WALK_ROW_W]
    rows[:, 10] = order.astype(np.float32)
    rows[:, 17:] = 0.0

    if N == 1:  # a one-primitive scene: the root is a leaf
        left, right = np.zeros(1, np.int64), np.zeros(1, np.int64)
        left[0] = leaf_ref(0, 1)
        boxes = np.concatenate([lo[:1], hi[:1], np.zeros((1, 6), np.float32)], 1)
        flags = line_only[:1].astype(np.int64)
        depth = np.zeros(1, np.int64)
    else:
        internal = ~leaf & ((n_leaves > WALK_LEAF_ROWS) | (np.arange(N) == 0))
        idx = np.flatnonzero(internal)
        walk_index = np.cumsum(internal) - 1
        kids = (idx + 1, skip[idx + 1])  # left child, right child (pre-order)
        left, right = (np.where(internal[c], walk_index[c], leaf_ref(csum[c], n_leaves[c]))
                       for c in kids)
        boxes = np.concatenate([lo[kids[0]], hi[kids[0]], lo[kids[1]], hi[kids[1]]], 1)
        flags = line_only[kids[0]].astype(np.int64) | (line_only[kids[1]].astype(np.int64) << 1)
        depth = np.zeros(idx.shape[0], np.int64)
        for i in range(idx.shape[0]):  # children follow their parent
            for c in (left[i], right[i]):
                if c > 0:
                    depth[c] = depth[i] + 1
    refs = np.stack([left, right, flags, np.zeros_like(flags)], 1).astype(np.int32)
    nodes = np.concatenate([np.ascontiguousarray(boxes, np.float32).view(np.int32), refs], 1)
    walk_depth = int(depth.max())
    if walk_depth + 1 > WALK_STACK:
        raise ValueError(f"walk_tables: the tree is {walk_depth} internal levels deep; the "
                         f"walk's stack holds {WALK_STACK} entries")
    return dict(walk_nodes=np.ascontiguousarray(nodes), walk_rows=rows, walk_depth=walk_depth)


def compile_numpy(desc: SceneDesc, options: RenderOptions = DEFAULT_OPTIONS) -> Dict:
    """The host stage: every Scene field as a numpy leaf (camera as a
    dict of CameraParams fields)."""
    P = max(len(desc.prims), 1)
    M = max(len(desc.materials), 1)
    T = max(len(desc.textures), 1)
    L = max(len(desc.lights), 1)

    f3 = lambda n: np.zeros((n, 3), np.float32)
    f2 = lambda n: np.zeros((n, 2), np.float32)
    i1 = lambda n, fill=0: np.full((n,), fill, np.int32)
    f1 = lambda n: np.zeros((n,), np.float32)

    lv = dict(
        prim_type=i1(P), prim_a=f3(P), prim_b=f3(P), prim_c=f3(P),
        prim_n0=f3(P), prim_n1=f3(P), prim_n2=f3(P),
        prim_uv0=f2(P), prim_uv1=f2(P), prim_uv2=f2(P),
        prim_material=i1(P, -1), prim_area=f1(P), prim_light=i1(P, -1),
    )
    for j, p in enumerate(desc.prims):
        lv["prim_type"][j] = p.ptype
        for k in ("a", "b", "c", "n0", "n1", "n2", "uv0", "uv1", "uv2"):
            lv["prim_" + k][j] = getattr(p, k)
        lv["prim_material"][j] = p.material
        lv["prim_area"][j] = _prim_area(p, options)
        lv["prim_light"][j] = p.light

    lv.update(mat_type=i1(M), mat_color=f3(M), mat_tex=i1(M, -1),
              mat_eta=f3(M), mat_k=f3(M))
    for j, m in enumerate(desc.materials):
        lv["mat_type"][j] = m.mtype
        lv["mat_color"][j] = m.color
        lv["mat_tex"][j] = m.tex
        lv["mat_eta"][j] = m.eta
        lv["mat_k"][j] = m.k

    lv.update(tex_type=i1(T), tex_c0=f3(T), tex_c1=f3(T), tex_scale=f1(T),
              tex_line=f1(T), tex_img_ofs=i1(T), tex_img_w=i1(T), tex_img_h=i1(T))
    atlas_parts = []
    ofs = 0
    for j, t in enumerate(desc.textures):
        lv["tex_type"][j] = t.ttype
        lv["tex_c0"][j], lv["tex_c1"][j] = t.c0, t.c1
        lv["tex_scale"][j], lv["tex_line"][j] = t.scale, t.line
        if t.ttype == TEX_IMAGE and t.image is not None:
            h, w = t.image.shape[:2]
            lv["tex_img_ofs"][j] = ofs
            lv["tex_img_w"][j] = w
            lv["tex_img_h"][j] = h
            atlas_parts.append(t.image.reshape(-1, 3).astype(np.float32))
            ofs += h * w
    lv["atlas"] = (
        np.concatenate(atlas_parts, 0) if atlas_parts else np.zeros((1, 3), np.float32)
    )
    for what, n in (("primitives", P), ("atlas texels", lv["atlas"].shape[0])):
        if n > MAX_TABLE_ROWS:
            raise ValueError(f"compile_scene: {n} {what}; the tables' float32 row ids and "
                             f"offsets are exact up to {MAX_TABLE_ROWS}")

    lv.update(light_type=i1(L), light_pos=f3(L), light_intensity=f3(L),
              light_prim=i1(L, -1))
    for j, l in enumerate(desc.lights):
        lv["light_type"][j] = l.ltype
        lv["light_pos"][j] = l.pos
        lv["light_intensity"][j] = l.intensity
        lv["light_prim"][j] = l.prim

    lv["camera"] = build_camera(
        desc.cam_pos, desc.cam_target, desc.resolution,
        desc.lens_radius, desc.focal_distance,
    )

    # reference bvh_tree internal-node culling (phantom-hit parity for
    # non-unit rays — see scene/bvh.parent_bounds_tables). Only sphere
    # rows can change under the cull, so the row list is filtered to them.
    bvh = build_bvh(types.SimpleNamespace(**lv))
    parent_min, parent_max = parent_bounds_tables(bvh, P)
    cull_rows = tuple(
        int(j)
        for j in np.nonzero(lv["prim_type"] == PRIM_SPHERE)[0]
        if parent_max[j, 0] < 3.0e38
    )
    lv.update(parent_min=parent_min, parent_max=parent_max,
              cull_rows=cull_rows or None, bvh=bvh)
    lv["prims_packed"] = pack_prims_np(lv)
    lv["packed_type_rows"] = packed_type_rows(lv["prim_type"])
    lv.update(walk_tables(lv["prim_type"], bvh, lv["prims_packed"]))
    _assert_finite(lv)
    return lv


def _assert_finite(leaves: Dict) -> None:
    """Reject non-finite scene data at load time (a NaN or Inf in a table
    row would poison every lane that gathers it)."""
    arrays = [v for v in leaves.values() if isinstance(v, np.ndarray)]
    arrays += [np.asarray(v) for v in leaves["camera"].values()]
    for arr in arrays:
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            raise ValueError(
                "scene contains non-finite values (NaN/Inf); refusing to "
                "compile — check material/texture/light parameters"
            )


def scene_from_numpy(leaves: Dict) -> Scene:
    """Scene (CPU tensors) from numpy leaves keyed by Scene field name,
    with ``camera`` a dict keyed by CameraParams field name. Accepts both
    this package's ``compile_numpy`` output and the JAX package's
    compiled leaves (whose ``bvh`` is the JAX package's BvhArrays; the
    walk layout and the packed type rows are derived when absent); keys
    that are not Scene fields are ignored."""
    t = lambda x: torch.as_tensor(np.array(x))
    if "walk_nodes" not in leaves:
        leaves = {**leaves, "packed_type_rows": packed_type_rows(leaves["prim_type"]),
                  **walk_tables(leaves["prim_type"], leaves["bvh"], leaves["prims_packed"])}
    cam = CameraParams(**{
        f.name: t(leaves["camera"][f.name]) for f in dataclasses.fields(CameraParams)
    })
    kw = {}
    for f in dataclasses.fields(Scene):
        if f.name == "camera" or f.name not in leaves:
            continue
        v = leaves[f.name]
        if f.name == "cull_rows":
            kw[f.name] = tuple(int(r) for r in v) if v else None
        elif f.name == "packed_type_rows":
            kw[f.name] = tuple(int(r) for r in v)
        elif f.name == "bvh":
            kw[f.name] = BvhTables(*(t(getattr(v, g.name)) for g in dataclasses.fields(BvhTables)))
        elif v is not None:
            kw[f.name] = t(v)
    return Scene(camera=cam, **kw)


def compile_scene(
    desc: SceneDesc,
    options: RenderOptions = DEFAULT_OPTIONS,
    device=None,
) -> Scene:
    """The compiled Scene on `device`: the CUDA card unless the caller
    names another device. Without a card and without an explicit device
    it raises; it never falls back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "compile_scene: no CUDA device is available; pass device='cpu' to "
                "compile the scene onto the CPU"
            )
        device = "cuda"
    return scene_from_numpy(compile_numpy(desc, options)).to(device)
