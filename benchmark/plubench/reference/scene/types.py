"""Scene data types.

Two layers, as in the JAX package:

- ``SceneDesc``: host-side Python lists built by the loader (mirrors the
  object graph the reference builds in inc/scene.h).
- ``Scene``: the compiled structure of tensors. Every cross-reference
  (surface->material, material->texture, surface<->area-light) is an int32
  index column. ``Scene.to(device)`` moves every tensor at once.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

# primitive type enum (prim_type column)
PRIM_SPHERE = 0
PRIM_BOX = 1
PRIM_TRIANGLE = 2

# material type enum (mat_type column); mirrors the reference material set
# (inc/material.h:213-254, inc/lights/area_light.h:46-55)
MAT_DIFFUSE = 0
MAT_MIRROR = 1  # perfect-reflection (conductor fresnel)
MAT_REFRACT = 2  # perfect-refraction (specular transmission only)
MAT_GLASS = 3  # dielectric reflection + transmission pair
MAT_EMISSION = 4  # empty bsdf; emission via the linked area light

# texture type enum (tex_type column / mat_tex = TEX_NONE means constant)
TEX_NONE = -1
TEX_CHECKERBOARD = 0
TEX_GRID = 1
TEX_IMAGE = 2

# light type enum
LIGHT_POINT = 0
LIGHT_AREA = 1


def _move(obj, device):
    """Copy of a dataclass with every tensor field moved to `device`."""
    return dataclasses.replace(
        obj,
        **{
            f.name: getattr(obj, f.name).to(device)
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), (torch.Tensor, CameraParams, BvhTables))
        },
    )


@dataclasses.dataclass
class CameraParams:
    """Reference camera model (inc/camera.h:6-38): hand-built basis with
    right/up scaled by 1.5, film plane at distance w=2.5, optional thin lens.
    """

    pos: torch.Tensor  # (3,)
    look: torch.Tensor  # (3,)
    right: torch.Tensor  # (3,) already scaled by 1.5
    up: torch.Tensor  # (3,) already scaled by 1.5
    inv_image_size: torch.Tensor  # (2,)
    w: torch.Tensor  # ()
    lens_radius: torch.Tensor  # ()
    focal_distance: torch.Tensor  # ()

    def to(self, device) -> "CameraParams":
        return _move(self, device)


@dataclasses.dataclass
class BvhTables:
    """The skip-link BVH (scene/bvh.build_bvh) as tensors: N nodes in
    depth-first order, the JAX package's ops.bvh.BvhArrays."""

    node_min: torch.Tensor  # (N,3) f32
    node_max: torch.Tensor  # (N,3) f32
    node_skip: torch.Tensor  # (N,) i32: next node in DFS order skipping this subtree
    node_prim: torch.Tensor  # (N,) i32: primitive row at a leaf, else -1

    def to(self, device) -> "BvhTables":
        return _move(self, device)


@dataclasses.dataclass
class Scene:
    """Compiled scene. Shapes: P primitives, M materials, T textures,
    L lights, A atlas pixels."""

    # primitives
    prim_type: torch.Tensor  # (P,) i32
    prim_a: torch.Tensor  # (P,3) sphere center | box min | tri v0
    prim_b: torch.Tensor  # (P,3) sphere (radius,0,0) | box max | tri v1
    prim_c: torch.Tensor  # (P,3) tri v2
    prim_n0: torch.Tensor  # (P,3) tri vertex normals (surface::sample parity)
    prim_n1: torch.Tensor
    prim_n2: torch.Tensor
    prim_uv0: torch.Tensor  # (P,2) tri texcoords
    prim_uv1: torch.Tensor
    prim_uv2: torch.Tensor
    prim_material: torch.Tensor  # (P,) i32 -> material row
    prim_area: torch.Tensor  # (P,) f32, with reference quirks baked (sphere=volume)
    prim_light: torch.Tensor  # (P,) i32 -> light row, or -1

    # materials
    mat_type: torch.Tensor  # (M,) i32
    mat_color: torch.Tensor  # (M,3) constant color
    mat_tex: torch.Tensor  # (M,) i32 -> texture row, or TEX_NONE
    mat_eta: torch.Tensor  # (M,3) conductor eta | (eta_t, eta_i, 0) | (ior, 0, 0)
    mat_k: torch.Tensor  # (M,3) conductor k

    # textures
    tex_type: torch.Tensor  # (T,) i32
    tex_c0: torch.Tensor  # (T,3) checkerboard colors[0] | grid fg
    tex_c1: torch.Tensor  # (T,3) checkerboard colors[1] | grid bg
    tex_scale: torch.Tensor  # (T,)
    tex_line: torch.Tensor  # (T,) grid line_size
    tex_img_ofs: torch.Tensor  # (T,) i32 offset into atlas (or 0)
    tex_img_w: torch.Tensor  # (T,) i32
    tex_img_h: torch.Tensor  # (T,) i32
    atlas: torch.Tensor  # (A,3) f32 flattened image pixels (A>=1)

    # lights
    light_type: torch.Tensor  # (L,) i32
    light_pos: torch.Tensor  # (L,3) point-light position
    light_intensity: torch.Tensor  # (L,3) point intensity | area Lemit
    light_prim: torch.Tensor  # (L,) i32 -> primitive row for area lights, or -1

    camera: CameraParams

    # The accelerator (ACCEL_FIELDS), None when compile_scene ran with
    # build_accel=False. The reference BVH (scene/bvh.build_bvh), and the
    # padded row count of each type segment of prims_packed (sphere, box,
    # triangle; host-side)
    bvh: Optional[BvhTables] = None
    packed_type_rows: Optional[Tuple[int, int, int]] = None
    # the same tree laid out for the stream kernels K3/K4's walk
    # (scene/compile.walk_tables): 64-byte internal-node records holding
    # both children's padded boxes, and the packed rows in leaf order
    walk_nodes: Optional[torch.Tensor] = None  # (Nw, 16) i32 (cols 0:12 float32 bits)
    walk_rows: Optional[torch.Tensor] = None  # (P, 20) f32

    # closest-hit kernel table (scene/compile.pack_prims_np)
    prims_packed: Optional[torch.Tensor] = None  # (P_pad, 24)

    # phantom-hit culling (scene/bvh.parent_bounds_tables): per-prim parent
    # AABB, and the sphere rows that need the test (host-side tuple)
    parent_min: Optional[torch.Tensor] = None  # (P,3)
    parent_max: Optional[torch.Tensor] = None  # (P,3)
    cull_rows: Optional[Tuple[int, ...]] = None

    @property
    def num_lights(self) -> int:
        return self.light_type.shape[0]

    @property
    def device(self) -> torch.device:
        return self.prim_a.device

    def to(self, device) -> "Scene":
        return _move(self, device)


# the Scene fields compile_scene(build_accel=False) leaves None: the BVH, the
# walk and the packed table derived from it, and the phantom-hit cull's
ACCEL_FIELDS = ("bvh", "packed_type_rows", "walk_nodes", "walk_rows", "prims_packed",
                "parent_min", "parent_max", "cull_rows")


# ---------------- host-side description ----------------


def _z3():
    return np.zeros(3, np.float32)


def _z2():
    return np.zeros(2, np.float32)


@dataclasses.dataclass
class PrimDesc:
    ptype: int
    a: np.ndarray
    b: np.ndarray
    c: np.ndarray = dataclasses.field(default_factory=_z3)
    n0: np.ndarray = dataclasses.field(default_factory=_z3)
    n1: np.ndarray = dataclasses.field(default_factory=_z3)
    n2: np.ndarray = dataclasses.field(default_factory=_z3)
    uv0: np.ndarray = dataclasses.field(default_factory=_z2)
    uv1: np.ndarray = dataclasses.field(default_factory=_z2)
    uv2: np.ndarray = dataclasses.field(default_factory=_z2)
    material: int = -1
    light: int = -1


@dataclasses.dataclass
class MaterialDesc:
    mtype: int
    color: np.ndarray = dataclasses.field(default_factory=_z3)
    tex: int = TEX_NONE
    eta: np.ndarray = dataclasses.field(default_factory=_z3)
    k: np.ndarray = dataclasses.field(default_factory=_z3)


@dataclasses.dataclass
class TextureDesc:
    ttype: int
    c0: np.ndarray = dataclasses.field(default_factory=_z3)
    c1: np.ndarray = dataclasses.field(default_factory=_z3)
    scale: float = 1.0
    line: float = 0.0
    image: Optional[np.ndarray] = None  # (H,W,3) f32


@dataclasses.dataclass
class LightDesc:
    ltype: int
    pos: np.ndarray = dataclasses.field(default_factory=_z3)
    intensity: np.ndarray = dataclasses.field(default_factory=_z3)
    prim: int = -1


@dataclasses.dataclass
class SceneDesc:
    """Host-side scene: what the urn loader produces."""

    resolution: Tuple[int, int] = (1280, 960)
    samples: int = 8  # antialiasing-samples N; spp = N*N (src/main.cpp:170)
    cam_pos: np.ndarray = dataclasses.field(default_factory=_z3)
    cam_target: np.ndarray = dataclasses.field(default_factory=_z3)
    lens_radius: float = 0.0
    focal_distance: float = 0.0
    prims: List[PrimDesc] = dataclasses.field(default_factory=list)
    materials: List[MaterialDesc] = dataclasses.field(default_factory=list)
    textures: List[TextureDesc] = dataclasses.field(default_factory=list)
    lights: List[LightDesc] = dataclasses.field(default_factory=list)

    def add_material(self, m: MaterialDesc) -> int:
        self.materials.append(m)
        return len(self.materials) - 1

    def add_texture(self, t: TextureDesc) -> int:
        self.textures.append(t)
        return len(self.textures) - 1

    def add_prim(self, p: PrimDesc) -> int:
        self.prims.append(p)
        return len(self.prims) - 1

    def add_light(self, l: LightDesc) -> int:
        self.lights.append(l)
        return len(self.lights) - 1

