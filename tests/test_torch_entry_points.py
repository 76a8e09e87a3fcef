"""The JAX package's calls of two entry points the port once took other
arguments for: render.elastic.pass_stack(scene, key, strata, width,
height, n, options, mesh) and parallel.mesh.initialize_distributed(
coordinator=None, **kw).

Bounds: pass_stack's rows against the JAX package's on a (1, 2) mesh of
CPU positions within tests/test_golden.py's bounds (p99 of |log1p|
differences below 0.05, mean below 0.01; XLA contracts products into
FMAs, so knife-edge lanes differ); the port's rows against its own on
other meshes and against render_passes: bit for bit.
initialize_distributed is held by what it hands torch.distributed.
"""

import datetime

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from plutracer_tpu.parallel.mesh import make_mesh as jax_make_mesh
from plutracer_tpu.render.elastic import pass_stack as jax_pass_stack
from plutracer_tpu.scene import compile_scene as jax_compile
from plutracer_tpu.scene import load_scene_file as jax_load
from plutracer_tpu.semantics import DEFAULT_OPTIONS as JAX_OPTIONS
from plutracer_tpu_torch import rng
from plutracer_tpu_torch.parallel import mesh as mesh_mod
from plutracer_tpu_torch.parallel.mesh import Mesh, Position, initialize_distributed, make_mesh
from plutracer_tpu_torch.render.elastic import pass_stack
from plutracer_tpu_torch.render.renderer import render_passes
from plutracer_tpu_torch.scene import compile_scene, load_scene_file
from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS
from torch_cpu import one_torch_thread  # noqa: F401 (autouse: one torch thread)

CPU = torch.device("cpu")
SCENE = "scenes/demo-box.urn"
W, H, N, SEED = 32, 24, 2, 5
STRATA = [0, 1, 3]  # three of the four: the spp axis of 2 does not divide them


@pytest.fixture(scope="module")
def scenes():
    args = ["/res", f"{W}x{H}"]
    return jax_compile(jax_load(SCENE, args)), compile_scene(load_scene_file(SCENE, args),
                                                             device="cpu")


def test_pass_stack_takes_jax_call(scenes):
    """The same positional arguments on a (1, 2) mesh: JAX pads the three
    strata to four and returns the padding row too; the port returns the
    three rows, within the golden bounds of JAX's first three."""
    js, ts = scenes
    want = np.asarray(jax_pass_stack(js, jax.random.PRNGKey(SEED), np.asarray(STRATA), W, H, N,
                                     JAX_OPTIONS, jax_make_mesh((1, 2))))
    got = pass_stack(ts, rng.PRNGKey(SEED), STRATA, W, H, N, DEFAULT_OPTIONS,
                     make_mesh((1, 2), devices=[CPU, CPU]))
    assert want.shape == (4, H * W, 3) and got.shape == (3, H * W, 3) and got.dtype == np.float32
    assert np.isfinite(got).all()
    diff = np.abs(np.log1p(np.maximum(got, 0.0)) - np.log1p(np.maximum(want[:3], 0.0)))
    assert np.quantile(diff, 0.99) < 0.05 and diff.mean() < 0.01, (
        np.quantile(diff, 0.99), diff.mean())


def test_pass_stack_rows_are_the_passes_whatever_the_mesh(scenes):
    """Row i is pass STRATA[i] of render_passes, bit for bit, on a (1, 1),
    (1, 2) and (1, 3) mesh (a (2, 2) mesh uses its first tile row), and
    on_pass fires once a stratum."""
    _, ts = scenes
    key = rng.PRNGKey(SEED)
    want = np.stack([render_passes(ts, key, s, W, H, N, 1).numpy()
                     for s in STRATA])
    for shape in ((1, 1), (1, 2), (1, 3), (2, 2)):
        seen = []
        got = pass_stack(ts, key, STRATA, W, H, N, DEFAULT_OPTIONS,
                         make_mesh(shape, devices=[CPU] * 4), on_pass=seen.append)
        assert np.array_equal(got, want), shape
        assert sorted(seen) == STRATA, shape


def test_pass_stack_refuses_another_process_positions(scenes):
    _, ts = scenes
    other = Mesh(((Position(0, CPU), Position(1, CPU)),), rank=0, world=2, distributed=True)
    with pytest.raises(ValueError, match="this process"):
        pass_stack(ts, rng.PRNGKey(0), [0, 1], 4, 4, 1, DEFAULT_OPTIONS, other)


# ---- initialize_distributed(coordinator=None, **kw) ----


@pytest.fixture
def calls(monkeypatch):
    """torch.distributed.init_process_group replaced by a recorder, and
    torch.distributed's environment cleared."""
    got = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: got.append((a, kw)))
    for var in mesh_mod.DIST_ENV:
        monkeypatch.delenv(var, raising=False)
    return got


def test_initialize_distributed_without_arguments_is_a_no_op(calls):
    """JAX's single-host call: nothing to join, nothing touched."""
    assert initialize_distributed() is None
    assert calls == [] and not dist.is_initialized()


@pytest.mark.parametrize("coordinator,init_method", [
    ("127.0.0.1:9371", "tcp://127.0.0.1:9371"),
    ("tcp://localhost:29500", "tcp://localhost:29500"),
    ("file:///tmp/rendezvous", "file:///tmp/rendezvous"),
])
def test_initialize_distributed_takes_jax_keywords(calls, coordinator, init_method):
    """JAX's multi-host call: the coordinator's address and
    jax.distributed's num_processes and process_id."""
    initialize_distributed(coordinator=coordinator, num_processes=2, process_id=1)
    initialize_distributed(coordinator, num_processes=4, process_id=3, backend="gloo",
                           timeout=7.5)
    assert calls == [
        (("gloo",), dict(init_method=init_method, world_size=2, rank=1,
                         timeout=datetime.timedelta(seconds=120.0))),
        (("gloo",), dict(init_method=init_method, world_size=4, rank=3,
                         timeout=datetime.timedelta(seconds=7.5))),
    ]


def test_initialize_distributed_reads_the_torch_environment(calls, monkeypatch):
    """Without a coordinator but with torch.distributed's environment (as
    torchrun sets it): an env:// rendezvous of WORLD_SIZE and RANK."""
    for var, value in zip(mesh_mod.DIST_ENV, ("localhost", "29500", "3", "2")):
        monkeypatch.setenv(var, value)
    initialize_distributed()
    assert calls == [(("gloo",), dict(init_method="env://", world_size=3, rank=2,
                                      timeout=datetime.timedelta(seconds=120.0)))]


def test_initialize_distributed_refuses_what_it_cannot_do(calls):
    with pytest.raises(TypeError, match="local_device_ids"):
        initialize_distributed("127.0.0.1:9371", num_processes=2, process_id=0,
                               local_device_ids=[0])
    with pytest.raises(ValueError, match="num_processes"):
        initialize_distributed("127.0.0.1:9371")
    assert calls == []
