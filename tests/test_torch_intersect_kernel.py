"""K1 (closest hit over the packed table) against the JAX package.

The plain version closest_hit_plain is held against the JAX Pallas kernel
in interpret mode (intersect_lite_pallas, interpret=True) and against the
JAX brute force intersect_lite. Tolerance: winners (found, prim) exact.
t against intersect_lite: bit for bit on the sphere and box scenes now
that the port's CPU sqrt is rounded to nearest as XLA's is (torch's own
missed by an ulp on one lane each of dof and textured0); within 1e-6
relative on mesh0, whose triangle test XLA contracts into FMAs (measured
2.7e-7 on 6 of 181 hits). t against the Pallas kernel within 1e-5
relative: the kernel's own float32 arithmetic, contracted, moves the
sphere discriminant by an ulp, and the near root qb - sqrt(det) amplifies
that on grazing rays where det is small (measured up to 4.7e-6). The CUDA kernel itself is held to
its plain version bit for bit on a card, in tests/test_torch_cuda.py (the
machine with the card has no jax).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plutracer_tpu.ops.intersect import intersect_lite as jax_intersect_lite
from plutracer_tpu.ops.pallas.intersect_kernel import intersect_lite_pallas
from plutracer_tpu.render.renderer import pixel_centers as jax_pixel_centers
from plutracer_tpu.ops.camera import generate_rays as jax_generate_rays
from plutracer_tpu.scene import compile_scene as jax_compile
from plutracer_tpu.scene import load_scene_file as jax_load
from plutracer_tpu_torch.ops.cuda.intersect_kernel import (
    closest_hit,
    closest_hit_cuda,
    closest_hit_plain,
    closest_hit_segments_plain,
)
from plutracer_tpu_torch.scene import compile_scene, load_scene_file
from torch_cpu import one_torch_thread  # noqa: F401 (autouse: one torch thread)


def rays(js, res, seed):
    """Camera rays at res x res plus as many random rays from inside the
    scene's bounds (exercising every primitive type from all sides)."""
    px = jax_pixel_centers(res, res) + 0.5
    o, d = jax_generate_rays(js.camera, px, jnp.full(px.shape, 0.3))
    rs = np.random.RandomState(seed)
    lo = np.asarray(js.prim_a).min(0) - 1.0
    hi = np.asarray(js.prim_b).max(0) + 1.0
    o2 = rs.uniform(lo, hi, (res * res, 3)).astype(np.float32)
    d2 = rs.normal(size=(res * res, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    return (np.concatenate([np.asarray(o), o2]).astype(np.float32),
            np.concatenate([np.asarray(d), d2]).astype(np.float32))


@pytest.mark.parametrize("name,res,rtol", [("demo-box", 24, 0.0), ("dof", 24, 0.0),
                                           ("textured0", 24, 0.0), ("mesh0", 16, 1e-6)])
def test_plain_matches_jax(name, res, rtol):
    js = jax_compile(jax_load(f"scenes/{name}.urn", ["/res", f"{res}x{res}"]))
    o, d = rays(js, res, seed=len(name))
    packed = torch.from_numpy(np.asarray(js.prims_packed))
    f, p, t = (x.numpy() for x in closest_hit(packed, torch.from_numpy(o), torch.from_numpy(d)))
    assert f.mean() > 0.2  # the comparison is not vacuous
    for ref, t_rtol in ((intersect_lite_pallas(js, jnp.asarray(o), jnp.asarray(d),
                                               js.prims_packed, interpret=True), 1e-5),
                        (jax_intersect_lite(js, jnp.asarray(o), jnp.asarray(d)), rtol)):
        jf, jp, jt = (np.asarray(x) for x in ref)
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(p[jf], jp[jf])
        np.testing.assert_allclose(t[jf], jt[jf], rtol=t_rtol, atol=0)


def test_plain_tie_goes_to_first_packed_row():
    """Two identical boxes: the strict-< fold keeps the first row in table
    order, whose original scene row (col 10) is reported."""
    packed = torch.zeros((8, 24))
    packed[:, 0] = 1.0  # boxes
    packed[:, 1:4] = 1.0e30
    packed[:, 4:7] = 2.0e30
    for row, scene_row in ((0, 5.0), (1, 2.0)):
        packed[row, 1:4] = torch.tensor([-1.0, -1.0, 4.0])
        packed[row, 4:7] = torch.tensor([1.0, 1.0, 6.0])
        packed[row, 10] = scene_row
    o = torch.zeros((2, 3))
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    f, p, t = closest_hit_plain(packed, o, d)
    assert f.tolist() == [True, False]
    assert p.tolist() == [5, 0]
    assert t.tolist() == [4.0, float(np.float32(3.0e37))]


@pytest.mark.parametrize("name,res", [("demo-box", 16), ("dof", 16), ("sphere-grid", 12),
                                      ("mesh0", 12)])
def test_segment_fold_equals_plain(name, res):
    """K1's fold as the kernel runs it (each type segment with its type's
    test only, the segments in table order) equals closest_hit_plain on
    every ray, bit for bit."""
    s = compile_scene(load_scene_file(f"scenes/{name}.urn", ["/res", f"{res}x{res}"]), device="cpu")
    js = jax_compile(jax_load(f"scenes/{name}.urn", ["/res", f"{res}x{res}"]))
    o, d = (torch.from_numpy(x) for x in rays(js, res, seed=3))
    got = closest_hit_segments_plain(s.prims_packed, o, d, s.packed_type_rows)
    want = closest_hit_plain(s.prims_packed, o, d)
    assert want[0].float().mean() > 0.2
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_segment_fold_tie_goes_to_first_row():
    """Equal t across and within segments: a sphere row and two boxes
    whose hits all lie at t = 4; the first row in table order wins."""
    packed = torch.zeros((24, 24))
    packed[:8, 0], packed[8:16, 0], packed[16:, 0] = 0.0, 1.0, 2.0
    packed[:8, 1] = 1.0e30  # never-hit padding of each type
    packed[8:16, 1:4], packed[8:16, 4:7] = 1.0e30, 2.0e30
    packed[:8, 11:14], packed[:8, 14:17] = -3.0e38, 3.0e38
    packed[0, 1:5] = torch.tensor([0.0, 0.0, 5.0, 1.0])  # sphere: near root at t = 4
    packed[0, 10] = 7.0
    for row, scene_row in ((8, 5.0), (9, 2.0)):  # boxes: entry at t = 4
        packed[row, 1:4] = torch.tensor([-1.0, -1.0, 4.0])
        packed[row, 4:7] = torch.tensor([1.0, 1.0, 6.0])
        packed[row, 10] = scene_row
    o = torch.zeros((3, 3))
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    for rows, first in (((8, 8, 8), 7), ((0, 8, 16), 5)):
        if rows[0] == 0:  # no sphere segment: the boxes tie, the first box wins
            table = packed[8:].clone()
        else:
            table = packed
        f, p, t = closest_hit_segments_plain(table, o, d, rows)
        assert (f.tolist(), p.tolist()) == ([True, False, False], [first, 0, 0])
        assert t[0].item() == 4.0
        assert all(torch.equal(a, b) for a, b in zip((f, p, t), closest_hit_plain(table, o, d)))


def test_cuda_launcher_rejects_cpu_tensors():
    s = compile_scene(load_scene_file("scenes/demo-box.urn", ["/res", "8x8"]), device="cpu")
    o = torch.zeros((4, 3))
    d = torch.ones((4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        closest_hit_cuda(s.prims_packed, o, d)
