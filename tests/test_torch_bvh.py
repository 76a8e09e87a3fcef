"""The port's BVH tables and its plain BVH walk (the K3 query's plain
version, closest_hit_bvh on CPU tensors: walk_closest_plain over the
walk layout; tests/test_torch_walk.py holds the layout itself) against
the JAX package's BVH and the brute-force closest hit.

Tolerances: none where both sides run the same arithmetic. The tree and
its leaves are the same numpy build as the JAX package's, so they are
equal; the walk tests the same packed rows with K1's arithmetic
as closest_hit_plain, so found and prim are equal bit for bit on every
ray and t on every hit (on a miss the walk reports _BIG, where the
brute force may report a padding row about 1e30 away). Against JAX's
ops.bvh.bvh_closest (XLA's arithmetic, FMA-contracted) found and the
winner are equal and t agrees to 1e-4 relative: the sphere near root qb - sqrt(det) cancels on grazing rays
and amplifies XLA's contraction differences (measured 2.7e-5 on 4 of
650 sphere-grid camera-ray hits at 32x32).
"""

import numpy as np
import pytest
import torch

from plutracer_tpu.ops.bvh import bvh_closest as jax_bvh_closest
from plutracer_tpu.scene import compile_scene as jax_compile
from plutracer_tpu.scene import load_scene_file as jax_load
from plutracer_tpu_torch.ops.camera import generate_rays
from plutracer_tpu_torch.ops.intersect import T_MAX
from plutracer_tpu_torch.ops.cuda.intersect_kernel import (
    closest_hit_bvh,
    closest_hit_plain,
    walk_closest_plain,
)
from plutracer_tpu_torch.render.renderer import pixel_centers
from plutracer_tpu_torch.scene import compile_scene, load_scene_file
from plutracer_tpu_torch.scene.compile import bvh_helpers
from plutracer_tpu_torch.scene.loader import sphere_cloud
from plutracer_tpu_torch.scene.types import PRIM_TRIANGLE, PrimDesc, SceneDesc


def load(name, res=32):
    return compile_scene(load_scene_file(f"scenes/{name}.urn", ["/res", f"{res}x{res}"]), device="cpu")


def camera_rays(s, res=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    px = pixel_centers(res, res) + torch.rand((res * res, 2), generator=g)
    return generate_rays(s.camera, px, torch.rand((res * res, 2), generator=g))


def interior_rays(s, n=2048, seed=1, unit=False):
    """Origins inside the root box; directions of random length (0.5 to
    1.5) unless unit: a non-unit ray makes phantom sphere hits."""
    rng = np.random.default_rng(seed)
    lo, hi = s.bvh.node_min[0].numpy(), s.bvh.node_max[0].numpy()
    o = lo + (hi - lo) * rng.uniform(size=(n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if not unit:
        d *= rng.uniform(0.5, 1.5, (n, 1))
    return torch.from_numpy(o.astype(np.float32)), torch.from_numpy(d.astype(np.float32))


def cloud_rays(n, seed=2):
    """proto_bigp.py's rays: origins in [-12, 12]^3, unit directions."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (torch.from_numpy(rng.uniform(-12.0, 12.0, (n, 3)).astype(np.float32)),
            torch.from_numpy(d.astype(np.float32)))


def assert_same_answer(s, o, d):
    want = closest_hit_plain(s.prims_packed, o, d)
    got = closest_hit_bvh(s, o, d)  # CPU tensors: walk_closest_plain
    for name, a, b in zip(("found", "prim"), got, want):
        assert torch.equal(a, b), f"{name}: {(a != b).sum().item()} rays differ"
    f = want[0]
    assert torch.equal(got[2][f], want[2][f]), f"t: {(got[2] != want[2])[f].sum().item()} hits differ"
    assert (got[2][~f] >= T_MAX).all()
    return want


@pytest.mark.parametrize("name", ["sphere-grid", "mesh0", "mesh1"])
def test_bvh_equals_jax(name):
    js = jax_compile(jax_load(f"scenes/{name}.urn", ["/res", "8x8"]))
    s = load(name, 8)
    for f in ("node_min", "node_max", "node_skip", "node_prim"):
        a, b = getattr(s.bvh, f).numpy(), np.asarray(getattr(js.bvh, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("name", ["demo-box", "sphere-grid", "mesh0"])
def test_leaf_row_inverts_packed_col10(name):
    s = load(name, 8)
    h = bvh_helpers(s.prim_type, s.bvh)
    node_prim, leaf_row = s.bvh.node_prim, torch.from_numpy(h["leaf_row"])
    leaf = node_prim >= 0
    assert torch.equal(leaf_row >= 0, leaf)
    # each leaf's packed row reports the leaf's primitive, and the leaves
    # cover every real packed row once
    assert torch.equal(s.prims_packed[leaf_row[leaf].long(), 10].long(), node_prim[leaf].long())
    assert sorted(leaf_row[leaf].tolist()) == sorted(set(leaf_row[leaf].tolist()))
    assert int(leaf.sum()) == s.num_prims
    # sphere leaves sit in the sphere segment, which comes first
    assert s.packed_type_rows[0] >= int((s.prim_type == 0).sum())
    # line-only nodes are exactly those whose subtree holds a sphere
    sphere_leaf = leaf & (s.prim_type[node_prim.clamp(min=0).long()] == 0)
    skip = s.bvh.node_skip.tolist()
    want = [bool(sphere_leaf[n:skip[n]].any()) for n in range(s.bvh.num_nodes)]
    assert h["line_only"].tolist() == want


@pytest.mark.parametrize("name", ["demo-box", "sphere-grid", "mesh0"])
def test_walk_equals_brute_force_on_scenes(name):
    s = load(name)
    f, _, _ = assert_same_answer(s, *camera_rays(s))
    assert f.float().mean() > 0.2
    # non-unit directions from inside the scene: phantom sphere hits on
    # demo-box and sphere-grid, culled by the parent-AABB LINE test
    assert_same_answer(s, *interior_rays(s))


def test_walk_equals_brute_force_on_sphere_cloud():
    s = compile_scene(sphere_cloud(512, seed=0), device="cpu")
    assert s.num_prims == 512 and bool(bvh_helpers(s.prim_type, s.bvh)["line_only"][0])
    f, _, _ = assert_same_answer(s, *cloud_rays(4096))
    assert f.float().mean() > 0.1


@pytest.mark.parametrize("name", ["sphere-grid", "mesh0"])
def test_walk_winners_equal_jax_bvh_closest(name):
    js = jax_compile(jax_load(f"scenes/{name}.urn", ["/res", "32x32"]))
    s = load(name)
    for o, d in (camera_rays(s), interior_rays(s, unit=True)):
        f, p, t = closest_hit_bvh(s, o, d)
        jf, jp, jt = (np.asarray(x) for x in jax_bvh_closest(js, js.bvh, o.numpy(), d.numpy()))
        np.testing.assert_array_equal(f.numpy(), jf)
        np.testing.assert_array_equal(p.numpy()[jf], jp[jf])
        np.testing.assert_allclose(t.numpy()[jf], jt[jf], rtol=1e-4)


def test_tie_goes_to_lower_packed_row():
    """Two triangles sharing an edge, a ray through the edge: both give
    t = 1 exactly. The tree visits scene row 1 first (its centre is left
    of row 0's), so only the (t, row) fold keeps row 0, as K1 does."""
    tri = lambda a, b, c: PrimDesc(PRIM_TRIANGLE, *(np.array(v, np.float32) for v in (a, b, c)))
    desc = SceneDesc()
    desc.add_prim(tri((1, 0, 0), (0, 1, 0), (1, 1, 0)))
    desc.add_prim(tri((1, 0, 0), (0, 1, 0), (-2, -2, 0)))
    desc.add_prim(tri((10, 0, 0), (11, 0, 0), (10, 1, 0)))
    s = compile_scene(desc, device="cpu")
    leaves = [p for p in s.bvh.node_prim.tolist() if p >= 0]
    assert leaves.index(1) < leaves.index(0)
    o = torch.tensor([[0.5, 0.5, 1.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]])
    f, p, t = assert_same_answer(s, o, d)
    assert f.item() and p.item() == 0 and t.item() == 1.0


def test_walk_takes_scene_tables():
    """closest_hit_bvh on CPU tensors is walk_closest_plain over the
    scene's walk layout."""
    s = load("sphere-grid", 8)
    o, d = camera_rays(s, 8)
    want = walk_closest_plain(s.prims_packed, s.walk_nodes, s.walk_rows, o, d)
    for a, b in zip(closest_hit_bvh(s, o, d), want):
        assert torch.equal(a, b)

