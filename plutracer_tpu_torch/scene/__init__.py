"""Scene front-end: urn scene files -> scene tables as torch tensors."""

from plutracer_tpu_torch.scene.compile import compile_scene, scene_from_numpy
from plutracer_tpu_torch.scene.loader import load_scene, load_scene_file
from plutracer_tpu_torch.scene.types import Scene, SceneDesc

__all__ = [
    "Scene",
    "SceneDesc",
    "compile_scene",
    "load_scene",
    "load_scene_file",
    "scene_from_numpy",
]
