"""The JAX package's signatures the port keeps: any int64 seed,
safemath.normalize(v, axis, eps), compile_scene(desc, options,
build_accel) and make_mesh(shape, axis_names, devices), each against the
JAX function.

Tolerances: normalize within 1 ulp-scale (rtol 1e-6) of the JAX function
(both compute v * rsqrt(sum(v * v) + eps); XLA's CPU rsqrt and torch's may
round apart by an ulp). Renders of a scene compiled with
build_accel=False against the JAX package's render of its own
build_accel=False compile: tests/test_golden.py's bounds (p99 of |log1p|
differences below 0.05, mean below 0.01), as tests/test_torch_render.py
holds the full compile.
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plutracer_tpu.ops.safemath import normalize as jax_normalize
from plutracer_tpu.parallel.mesh import make_mesh as jax_make_mesh
from plutracer_tpu.render.renderer import render as jax_render
from plutracer_tpu.scene import compile_scene as jax_compile
from plutracer_tpu.scene import load_scene_file as jax_load
from plutracer_tpu_torch import rng
from plutracer_tpu_torch.ops.intersect import query_lite
from plutracer_tpu_torch.ops.safemath import normalize
from plutracer_tpu_torch.parallel import make_mesh
from plutracer_tpu_torch.render.integrator import megakernel_eligible, resolve_integrator_backend
from plutracer_tpu_torch.render.renderer import render
from plutracer_tpu_torch.scene import compile_scene, load_scene_file
from plutracer_tpu_torch.scene.types import ACCEL_FIELDS
from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS
from torch_cpu import one_torch_thread  # noqa: F401 (autouse: one torch thread)

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
W, H, N, SEED = 32, 24, 2, 42


# ---- seeds: every int64 seed jax.random.PRNGKey takes ----


def test_negative_seed_renders_as_jax(tmp_path):
    """/seed -1 through the CLI, and render_elastic at seed -1: the image
    of render at rng.PRNGKey(-1), and within the golden bounds of the
    JAX package's render at jax.random.PRNGKey(-1)."""
    from plutracer_tpu_torch import cli
    from plutracer_tpu_torch.render.elastic import render_elastic

    path = str(REPO / "scenes" / "dof.urn")
    res = cli.run([path, "/res", f"{W}x{H}", "/smp", str(N), "/seed", "-1", "/device", "cpu",
                   "/o", str(tmp_path / "m1.bmp")])
    assert (tmp_path / "m1.bmp").exists()
    scene = compile_scene(load_scene_file(path, ["/res", f"{W}x{H}"]), device="cpu")
    want = render(scene, W, H, N, rng.PRNGKey(-1))
    assert torch.equal(res.linear, want)
    assert np.array_equal(render_elastic(scene, W, H, N, -1, devices=[CPU]), want.numpy())
    ref = np.asarray(jax_render(jax_compile(jax_load(path, ["/res", f"{W}x{H}"])), W, H, N,
                                jax.random.PRNGKey(-1)))
    diff = np.abs(np.log1p(np.maximum(want.numpy(), 0.0)) - np.log1p(np.maximum(ref, 0.0)))
    assert np.quantile(diff, 0.99) < 0.05 and diff.mean() < 0.01


# ---- normalize(v, axis=-1, eps=1e-30) ----

CALLS = {  # how the axis and eps reach the function
    "axis 0 by position": ((0,), {}),
    "axis 1 by position": ((1,), {}),
    "axis -1 by position": ((-1,), {}),
    "axis 0 by keyword": ((), {"axis": 0}),
    "axis 1 by keyword": ((), {"axis": 1}),
    "axis -1 by keyword": ((), {"axis": -1}),
    "axis 0, eps by keyword": ((0,), {"eps": 0.25}),
    "eps by keyword": ((), {"eps": 0.25}),
}


@pytest.mark.parametrize("shape", [(3, 3), (4, 3), (5, 2)])
@pytest.mark.parametrize("call", list(CALLS))
def test_normalize_matches_jax(shape, call):
    args, kwargs = CALLS[call]
    v = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
    want = np.asarray(jax_normalize(jnp.asarray(v), *args, **kwargs))
    got = normalize(torch.from_numpy(v), *args, **kwargs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_normalize_last_axis_keeps_the_kernels_order():
    """Over a last axis of 3 the sum is safemath.dot's (x + y) + z, the
    order the kernels round in: bit-equal to it whatever the axis's
    spelling."""
    from plutracer_tpu_torch.ops.safemath import dot, safe_rsqrt

    v = torch.from_numpy(np.random.default_rng(3).normal(size=(64, 3)).astype(np.float32))
    want = v * safe_rsqrt(dot(v, v) + 1e-30)[..., None]
    for got in (normalize(v), normalize(v, -1), normalize(v, axis=1)):
        assert torch.equal(got, want)


# ---- compile_scene(desc, options, build_accel, device) ----


def _bare(name, by_position):
    desc = load_scene_file(str(REPO / "scenes" / f"{name}.urn"), ["/res", f"{W}x{H}"])
    if by_position:
        return compile_scene(desc, DEFAULT_OPTIONS, False, "cpu")
    return compile_scene(desc, build_accel=False, device="cpu")


@pytest.mark.parametrize("by_position", [False, True], ids=["keyword", "position"])
def test_compile_without_accel_has_no_accelerator(by_position):
    s = _bare("demo-box", by_position)
    assert all(getattr(s, f) is None for f in ACCEL_FIELDS)
    assert s.device == CPU and s.to(CPU).prims_packed is None
    assert not megakernel_eligible(s, DEFAULT_OPTIONS)
    assert resolve_integrator_backend(s, DEFAULT_OPTIONS, "cuda") == "plain"
    full = compile_scene(load_scene_file(str(REPO / "scenes" / "demo-box.urn"),
                                         ["/res", f"{W}x{H}"]), device="cpu")
    assert all(getattr(full, f) is not None for f in ACCEL_FIELDS)


@pytest.mark.parametrize("name", ["demo-box", "dof"])
def test_render_without_accel_matches_jax(name):
    """The plain path over a scene compiled with build_accel=False against
    the JAX package's render of compile_scene(desc, build_accel=False)."""
    img = render(_bare(name, False), W, H, N, rng.PRNGKey(SEED)).numpy()
    path, args = str(REPO / "scenes" / f"{name}.urn"), ["/res", f"{W}x{H}"]
    ref = np.asarray(jax_render(jax_compile(jax_load(path, args), build_accel=False), W, H, N,
                                jax.random.PRNGKey(SEED)))
    assert img.shape == ref.shape and np.isfinite(img).all()
    diff = np.abs(np.log1p(np.maximum(img, 0.0)) - np.log1p(np.maximum(ref, 0.0)))
    assert np.quantile(diff, 0.99) < 0.05 and diff.mean() < 0.01, (
        np.quantile(diff, 0.99), diff.mean())


def test_render_without_accel_equals_full_compile_on_the_plain_path():
    """dof, whose phantom-hit cull moves no hit at this size: the render
    of the bare scene is bit-equal to the full compile's. (On demo-box the
    full compile's cull drops phantom sphere hits that the bare scene
    keeps, in the JAX package as here.)"""
    desc = load_scene_file(str(REPO / "scenes" / "dof.urn"), ["/res", f"{W}x{H}"])
    full = render(compile_scene(desc, device="cpu"), W, H, N, rng.PRNGKey(SEED))
    bare = render(compile_scene(desc, DEFAULT_OPTIONS, False, device="cpu"), W, H, N,
                  rng.PRNGKey(SEED))
    assert torch.equal(full, bare)


@pytest.mark.parametrize("engine", ["pallas", "bvh"])
def test_engines_that_need_the_accelerator_raise(engine):
    s = _bare("demo-box", True)
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]] * 4)
    opts = dataclasses.replace(DEFAULT_OPTIONS, intersect_backend=engine)
    with pytest.raises(ValueError, match="build_accel=False"):
        query_lite(s, o, d, opts)
    with pytest.raises(ValueError, match="build_accel=False"):
        render(s, 4, 4, 1, rng.PRNGKey(0), opts)


def test_forced_kernel_integrator_raises_without_accel():
    s = _bare("demo-box", False)
    opts = dataclasses.replace(DEFAULT_OPTIONS, integrator_backend="kernel")
    with pytest.raises(ValueError, match="build_accel=False"):
        resolve_integrator_backend(s, opts, "cuda")


# ---- make_mesh(shape, axis_names, devices) ----


def test_make_mesh_takes_jax_signature():
    cpus = [CPU] * 8
    want = jax_make_mesh((4, 2), ("tiles", "spp"), jax.devices()[:8])
    for m in (make_mesh((4, 2), ("tiles", "spp"), cpus),
              make_mesh((4, 2), ["tiles", "spp"], devices=cpus),
              make_mesh(shape=(4, 2), axis_names=("tiles", "spp"), devices=cpus),
              make_mesh((4, 2), devices=cpus)):
        assert m.axis_names == tuple(want.axis_names)
        assert m.shape == dict(want.shape)
    assert make_mesh(None, ("tiles", "spp"), [CPU] * 3).shape == {"tiles": 3, "spp": 1}


@pytest.mark.parametrize("second", [[CPU] * 4, (CPU, CPU), ("spp", "tiles"), ("x", "y"),
                                    "tiles", ("tiles",)], ids=repr)
def test_make_mesh_refuses_other_axes(second):
    """The port's meshes are (tiles, spp) grids: other axis names, and a
    device list in the old second place, raise ValueError."""
    with pytest.raises(ValueError, match="axis_names"):
        make_mesh((2, 2), second)
