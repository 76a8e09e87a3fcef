"""Scene compiler: SceneDesc -> Scene (tensors on one device).

Every table is assembled in host numpy first, then ``scene_from_numpy``
turns the numpy leaves into tensors and one ``.to(device)`` moves them.
The accelerator is the tree alone: its parent boxes cull the phantom hits
of sphere rows; the kernels' packed table and walk layout are not built.

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

from plubench.reference.semantics import DEFAULT_OPTIONS, RenderOptions
from plubench.reference.scene.bvh import build_bvh, parent_bounds_tables
from plubench.reference.scene.loader import box_area, sphere_area, triangle_area
from plubench.reference.scene.types import (
    PRIM_BOX,
    PRIM_SPHERE,
    TEX_IMAGE,
    BvhTables,
    CameraParams,
    Scene,
    SceneDesc,
)

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


def compile_numpy(desc: SceneDesc, options: RenderOptions = DEFAULT_OPTIONS,
                  build_accel: bool = True) -> Dict:
    """The host stage: every Scene field as a numpy leaf (camera as a
    dict of CameraParams fields). build_accel=False leaves out the
    accelerator (ACCEL_FIELDS), as the JAX package's compile_scene does."""
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

    if build_accel:
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
    with ``camera`` a dict keyed by CameraParams field name; keys that are
    not Scene fields are ignored."""
    t = lambda x: torch.as_tensor(np.array(x))
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
        elif f.name == "packed_type_rows" and v is not None:
            kw[f.name] = tuple(int(r) for r in v)
        elif f.name == "bvh" and v is not None:
            kw[f.name] = BvhTables(*(t(getattr(v, g.name)) for g in dataclasses.fields(BvhTables)))
        elif v is not None:
            kw[f.name] = t(v)
    return Scene(camera=cam, **kw)
