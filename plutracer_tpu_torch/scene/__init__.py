"""Scene front-end: urn scene files -> scene tables as torch tensors."""

from plutracer_tpu_torch.scene.compile import compile_scene, scene_from_numpy
from plutracer_tpu_torch.scene.loader import load_scene, load_scene_file
from plutracer_tpu_torch.scene.types import (
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
    CameraParams,
    Scene,
    SceneDesc,
)

__all__ = [
    "CameraParams",
    "Scene",
    "SceneDesc",
    "compile_scene",
    "load_scene",
    "load_scene_file",
    "scene_from_numpy",
    "PRIM_SPHERE",
    "PRIM_BOX",
    "PRIM_TRIANGLE",
    "MAT_DIFFUSE",
    "MAT_MIRROR",
    "MAT_REFRACT",
    "MAT_GLASS",
    "MAT_EMISSION",
    "TEX_NONE",
    "TEX_CHECKERBOARD",
    "TEX_GRID",
    "TEX_IMAGE",
    "LIGHT_POINT",
    "LIGHT_AREA",
]
