"""plutracer_tpu_torch scene compile against the JAX package's compile_scene.

Tolerance: none. Both packages run the same numpy stage, so every compiled
leaf (tables, packed closest-hit table, parent-AABB cull bounds, cull rows,
camera) must be equal in dtype, shape and value.
"""

import dataclasses

import numpy as np
import pytest
import torch

from plutracer_tpu.scene import compile_scene as jax_compile
from plutracer_tpu.scene import load_scene_file as jax_load
from plutracer_tpu_torch.scene import compile_scene, load_scene_file, scene_from_numpy
from plutracer_tpu_torch.scene.types import CameraParams, Scene
from torch_cpu import one_torch_thread  # noqa: F401 (autouse: one torch thread)

SCENES = ["demo-box", "dof", "textured0", "sphere-grid", "mesh0"]


def jax_leaves(js):
    """The JAX compiled scene as numpy leaves keyed by field name."""
    out = {}
    for f in dataclasses.fields(js):
        v = getattr(js, f.name)
        if f.name == "camera":
            out["camera"] = {g.name: np.asarray(getattr(v, g.name))
                             for g in dataclasses.fields(v)}
        elif f.name == "cull_rows" or v is None or not hasattr(v, "shape"):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


def assert_scene_equals_leaves(scene, leaves):
    """Every Scene field the leaves hold; the packed type rows and the
    BVH's traversal layout, which only the port has, are derived from the
    leaves and held in tests/test_torch_bvh.py and test_torch_walk.py."""
    for f in dataclasses.fields(Scene):
        if f.name not in leaves:
            assert f.name in ("packed_type_rows", "walk_nodes", "walk_rows")
            continue
        got = getattr(scene, f.name)
        want = leaves[f.name]
        if f.name == "bvh":
            for g in ("node_min", "node_max", "node_skip", "node_prim"):
                a, b = getattr(got, g).numpy(), np.asarray(getattr(want, g))
                assert a.dtype == b.dtype and a.shape == b.shape, g
                np.testing.assert_array_equal(a, b, err_msg=g)
        elif f.name == "camera":
            for g in dataclasses.fields(CameraParams):
                a = getattr(got, g.name).numpy()
                b = want[g.name]
                assert a.dtype == b.dtype and a.shape == b.shape, g.name
                np.testing.assert_array_equal(a, b, err_msg=g.name)
        elif f.name == "cull_rows":
            assert got == want
        else:
            a = got.numpy()
            assert a.dtype == want.dtype and a.shape == want.shape, f.name
            np.testing.assert_array_equal(a, want, err_msg=f.name)


@pytest.mark.parametrize("name", SCENES)
def test_compile_matches_jax(name):
    args = ["/res", "40x30"]
    leaves = jax_leaves(jax_compile(jax_load(f"scenes/{name}.urn", args)))
    scene = compile_scene(load_scene_file(f"scenes/{name}.urn", args), device="cpu")
    assert_scene_equals_leaves(scene, leaves)


@pytest.mark.parametrize("name", ["demo-box", "textured0", "mesh0"])
def test_scene_from_numpy_round_trip(name):
    leaves = jax_leaves(jax_compile(jax_load(f"scenes/{name}.urn", ["/res", "16x16"])))
    scene = scene_from_numpy(leaves)
    assert_scene_equals_leaves(scene, leaves)
    moved = scene.to("cpu")
    assert moved.prims_packed.device == torch.device("cpu")
    assert moved.cull_rows == scene.cull_rows


def test_demo_box_tables():
    """The slice's configuration: demo-box compiles to P=9, M=8, T=2, L=1
    with spheres 6 and 7 under the phantom-hit cull."""
    s = compile_scene(load_scene_file("scenes/demo-box.urn"), device="cpu")
    assert (s.num_prims, s.mat_type.shape[0], s.tex_type.shape[0], s.num_lights) == (9, 8, 2, 1)
    assert s.cull_rows == (6, 7)
    assert tuple(s.prims_packed.shape) == (16, 24)
