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

from plutracer_tpu.semantics import DEFAULT_OPTIONS, RenderOptions
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


def bvh_helpers(prim_type, bvh) -> Dict:
    """The BVH walk's helper leaves (numpy), from the primitive types and
    the skip-link tree:

    - ``bvh_leaf_row`` (N,) i32: each leaf's row of ``prims_packed`` (the
      inverse of packed col 10 over the real rows), -1 at internal nodes;
    - ``bvh_line_only`` (N,) bool: the node's subtree holds a sphere, so
      the walk tests it with the LINE slab test only (a phantom hit of a
      non-unit ray lies outside the sphere's own box at any t);
    - ``bvh_margin``: the padding of every node box, BVH_MARGIN of the
      root box's size (diagonal or largest coordinate);
    - ``packed_type_rows``: the padded rows of each type segment of
      ``prims_packed`` (sphere, box, triangle), 0 for an absent type."""
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
        bvh_leaf_row=np.where(leaf, row_of[prim], -1).astype(np.int32),
        bvh_line_only=line_only,
        bvh_margin=BVH_MARGIN * scale,
        packed_type_rows=tuple(type_rows),
    )


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
    lv.update(bvh_helpers(lv["prim_type"], bvh))
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
    walk's helper leaves are derived from it when absent); keys that are
    not Scene fields are ignored."""
    t = lambda x: torch.as_tensor(np.array(x))
    if "bvh_leaf_row" not in leaves:
        leaves = {**leaves, **bvh_helpers(leaves["prim_type"], leaves["bvh"])}
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
        elif f.name == "bvh_margin":
            kw[f.name] = float(v)
        elif f.name == "bvh":
            kw[f.name] = BvhTables(*(t(getattr(v, g.name)) for g in dataclasses.fields(BvhTables)))
        elif v is not None:
            kw[f.name] = t(v)
    return Scene(camera=cam, **kw)


def compile_scene(
    desc: SceneDesc,
    options: RenderOptions = DEFAULT_OPTIONS,
    device="cpu",
) -> Scene:
    return scene_from_numpy(compile_numpy(desc, options)).to(device)
