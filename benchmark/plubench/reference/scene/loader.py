"""urn scene loader: parsed urn value -> SceneDesc.

Mirrors the reference scene constructor (inc/scene.h:229-298) including CLI
overrides ``/res WxH`` and ``/smp N``, the materials map, and the objects
scan that wires diffuse-area-lights to emission materials and their carrier
surfaces. Area computations bake the reference's formulas, including
sphere::area() returning the volume formula (inc/surfaces/sphere.h:17) —
see semantics.RenderOptions.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from plubench.reference.scene import obj as obj_loader
from plubench.reference.scene.types import (
    LIGHT_AREA,
    LIGHT_POINT,
    MAT_DIFFUSE,
    MAT_EMISSION,
    MAT_GLASS,
    MAT_MIRROR,
    MAT_REFRACT,
    PRIM_BOX,
    PRIM_SPHERE,
    PRIM_TRIANGLE,
    TEX_CHECKERBOARD,
    TEX_GRID,
    TEX_IMAGE,
    TEX_NONE,
    LightDesc,
    MaterialDesc,
    PrimDesc,
    SceneDesc,
    TextureDesc,
)
from plubench.reference.urn import EvalContext, Kind, Value, parse


class SceneError(Exception):
    pass


def _bk2v3(cx: EvalContext, v: Value) -> np.ndarray:
    """Block -> vec3, evaluating expressions (reference bk2v3, scene.h:22-25)."""
    rv = cx.reduce(v)
    return np.array([rv[0].get_num(), rv[1].get_num(), rv[2].get_num()], np.float32)


def sphere_area(radius: float, volume_quirk: bool = True) -> float:
    """Reference sphere::area() is actually (4/3)*pi*r^3 (sphere.h:17)."""
    if volume_quirk:
        return (4.0 / 3.0) * math.pi * radius**3
    return 4.0 * math.pi * radius**2


def box_area(extents: np.ndarray) -> float:
    d = extents
    return float(2.0 * (d[0] * d[1] + d[0] * d[2] + d[1] * d[2]))


def triangle_area(v0, v1, v2) -> float:
    """Heron's formula (inc/surfaces/triangle.h:25-31)."""
    a = float(np.linalg.norm(v1 - v0))
    b = float(np.linalg.norm(v2 - v1))
    c = float(np.linalg.norm(v2 - v0))
    p = (a + b + c) * 0.5
    return math.sqrt(max(p * (p - a) * (p - b) * (p - c), 0.0))


class _Loader:
    def __init__(self, tlv: Value, args: List[str], base_dir: str = "."):
        self.tlv = tlv
        self.args = list(args)
        self.base_dir = base_dir
        self.desc = SceneDesc()
        self.cx = EvalContext().create_std_funcs()
        self.named_mats: Dict[str, int] = {}
        self._mesh_cache: Dict[str, obj_loader.ObjMesh] = {}

    # ---- CLI overrides (scene.h:232-238, 251-256) ----
    def _pop_flag(self, flag: str) -> Optional[str]:
        if flag in self.args:
            i = self.args.index(flag)
            val = self.args[i + 1]
            del self.args[i : i + 2]
            return val
        return None

    def load(self) -> SceneDesc:
        d = self.desc
        tlv = self.tlv

        res_b = tlv.named_block_val("resolution")
        if not res_b.is_null:
            d.resolution = (res_b[0].get_int(), res_b[1].get_int())
        res_override = self._pop_flag("/res")
        if res_override is not None:
            w, _, h = res_override.partition("x")
            d.resolution = (int(w), int(h))

        cam_b = tlv.named_block_val("camera")
        if cam_b.has_block_val_named("lens"):
            lens_b = cam_b.named_block_val("lens")
            d.lens_radius = lens_b.named_block_val("radius").get_num()
            d.focal_distance = lens_b.named_block_val("focal-distance").get_num()
        d.cam_pos = _bk2v3(self.cx, cam_b.named_block_val("position"))
        d.cam_target = _bk2v3(self.cx, cam_b.named_block_val("target"))

        d.samples = tlv.named_block_val("antialiasing-samples").get_int()
        smp_override = self._pop_flag("/smp")
        if smp_override is not None:
            d.samples = int(smp_override)

        # materials map
        mat_block = tlv.named_block_val("materials")
        if not mat_block.is_null:
            for v in mat_block.items:
                if v.kind is not Kind.DEF:
                    raise SceneError("materials block must contain only definitions")
                name, mv = v.get_def()
                self.named_mats[name] = self._make_material(mv)

        # objects scan
        objs = self.cx.eval1(tlv.named_block_val("objects"))
        vs = list(objs.items)
        i = 0
        while i < len(vs):
            prim_ids, i = self._make_basic_surface(vs, i)
            if prim_ids is None:
                head = vs[i].get_var()
                if head == "point-light":
                    d.add_light(
                        LightDesc(
                            LIGHT_POINT,
                            pos=_bk2v3(self.cx, vs[i + 1]),
                            intensity=_bk2v3(self.cx, vs[i + 2]),
                        )
                    )
                    i += 3
                elif head == "diffuse-area-light":
                    carrier = self.cx.eval1(vs[i + 1])
                    sub = list(carrier.items)
                    sub_ids, consumed = self._make_basic_surface(sub, 0)
                    if sub_ids is None or len(sub_ids) != 1:
                        raise SceneError(
                            "diffuse-area-light needs exactly one carrier surface"
                        )
                    pid = sub_ids[0]
                    mid = d.add_material(MaterialDesc(MAT_EMISSION))
                    lid = d.add_light(
                        LightDesc(
                            LIGHT_AREA,
                            intensity=_bk2v3(self.cx, vs[i + 2]),
                            prim=pid,
                        )
                    )
                    d.prims[pid].material = mid
                    d.prims[pid].light = lid
                    i += 3
                else:
                    raise SceneError(f"unknown object '{head}'")
            else:
                mid = self._make_or_ref_material(vs[i])
                i += 1
                for pid in prim_ids:
                    d.prims[pid].material = mid
        return d

    # ---- factories ----
    def _make_color(self, vs: List[Value], i: int) -> Tuple[np.ndarray, int, int]:
        """Returns (constant_color, tex_index, new_i). Reference scene.h:72-99."""
        v = vs[i]
        if v.kind is Kind.VAR:
            if v.get_var() != "texture":
                raise SceneError(f"expected 'texture', got '{v.get_var()}'")
            ts = vs[i + 1].items
            i += 2
            t = ts[0].get_var()
            if t == "checkerboard":
                tid = self.desc.add_texture(
                    TextureDesc(
                        TEX_CHECKERBOARD,
                        c0=_bk2v3(self.cx, ts[1]),
                        c1=_bk2v3(self.cx, ts[2]),
                        scale=self.cx.eval(ts[3]).get_num(),
                    )
                )
            elif t == "grid":
                tid = self.desc.add_texture(
                    TextureDesc(
                        TEX_GRID,
                        c0=_bk2v3(self.cx, ts[1]),  # fg
                        c1=_bk2v3(self.cx, ts[2]),  # bg
                        scale=self.cx.eval(ts[3]).get_num(),
                        line=self.cx.eval(ts[4]).get_num(),
                    )
                )
            elif t == "img":
                from plubench.reference.io.bmp import read_bmp

                img = read_bmp(os.path.join(self.base_dir, ts[1].get_str()))
                tid = self.desc.add_texture(TextureDesc(TEX_IMAGE, image=img))
            else:
                raise SceneError(f"unknown texture type '{t}'")
            return np.zeros(3, np.float32), tid, i
        if v.kind is Kind.BLOCK:
            return _bk2v3(self.cx, v), TEX_NONE, i + 1
        raise SceneError("expected a color block or 'texture'")

    def _make_material(self, v: Value) -> int:
        vs = list(v.items)
        head = vs[0].get_var()
        if head == "diffuse":
            color, tex, _ = self._make_color(vs, 1)
            return self.desc.add_material(
                MaterialDesc(MAT_DIFFUSE, color=color, tex=tex)
            )
        if head == "perfect-reflection":
            color, tex, i = self._make_color(vs, 1)
            eta = _bk2v3(self.cx, vs[i])
            k = _bk2v3(self.cx, vs[i + 1])
            return self.desc.add_material(
                MaterialDesc(MAT_MIRROR, color=color, tex=tex, eta=eta, k=k)
            )
        if head == "perfect-refraction":
            color, tex, i = self._make_color(vs, 1)
            eta_t = vs[i].get_num()
            eta_i = vs[i + 1].get_num()
            return self.desc.add_material(
                MaterialDesc(
                    MAT_REFRACT,
                    color=color,
                    tex=tex,
                    eta=np.array([eta_t, eta_i, 0.0], np.float32),
                )
            )
        if head == "glass":
            color, tex, i = self._make_color(vs, 1)
            ior = vs[i].get_num()
            return self.desc.add_material(
                MaterialDesc(
                    MAT_GLASS,
                    color=color,
                    tex=tex,
                    eta=np.array([ior, 0.0, 0.0], np.float32),
                )
            )
        raise SceneError(f"unknown material '{head}'")

    def _make_or_ref_material(self, v: Value) -> int:
        if v.kind is Kind.BLOCK:
            return self._make_material(v)
        if v.kind is Kind.ID:
            name = v.get_id()
            if name not in self.named_mats:
                raise SceneError(f"unknown material '{name}'")
            return self.named_mats[name]
        raise SceneError("expected a material block or 'name reference")

    def _make_basic_surface(self, vs: List[Value], i: int):
        """Returns (list-of-prim-ids | None, new_i). Reference scene.h:203-226."""
        if vs[i].kind is not Kind.VAR:
            raise SceneError(f"expected surface/light head, got {vs[i]}")
        head = vs[i].get_var()
        d = self.desc
        if head == "sphere":
            center = _bk2v3(self.cx, vs[i + 1])
            radius = self.cx.eval(vs[i + 2]).get_num()
            pid = d.add_prim(
                PrimDesc(
                    PRIM_SPHERE,
                    a=center,
                    b=np.array([radius, 0.0, 0.0], np.float32),
                )
            )
            return [pid], i + 3
        if head == "box":
            center = _bk2v3(self.cx, vs[i + 1])
            extent = _bk2v3(self.cx, vs[i + 2])
            pid = d.add_prim(
                PrimDesc(PRIM_BOX, a=center - extent, b=center + extent)
            )
            return [pid], i + 3
        if head == "triangle-mesh":
            path = vs[i + 1].get_str()
            full = os.path.join(self.base_dir, path)
            if full not in self._mesh_cache:
                self._mesh_cache[full] = obj_loader.load_obj(full)
            mesh = self._mesh_cache[full]
            pids = []
            for f in range(mesh.positions.shape[0]):
                pids.append(
                    d.add_prim(
                        PrimDesc(
                            PRIM_TRIANGLE,
                            a=mesh.positions[f, 0],
                            b=mesh.positions[f, 1],
                            c=mesh.positions[f, 2],
                            n0=mesh.normals[f, 0],
                            n1=mesh.normals[f, 1],
                            n2=mesh.normals[f, 2],
                            uv0=mesh.texcoords[f, 0],
                            uv1=mesh.texcoords[f, 1],
                            uv2=mesh.texcoords[f, 2],
                        )
                    )
                )
            return pids, i + 2
        return None, i


def load_scene(tlv: Value, args: Optional[List[str]] = None, base_dir: str = ".") -> SceneDesc:
    return _Loader(tlv, args or [], base_dir).load()


def load_scene_file(path: str, args: Optional[List[str]] = None) -> SceneDesc:
    with open(path, "r") as f:
        tlv = parse(f.read())
    return load_scene(tlv, args, base_dir=os.path.dirname(os.path.abspath(path)))

