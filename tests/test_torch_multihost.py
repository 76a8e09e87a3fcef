"""The port's multi-process path: two real processes (torch.distributed,
gloo, on the CPU), each holding one tiles row (two positions) of a (2, 2)
mesh, run a sharded render and one train step (parallel/dryrun.mesh_jobs
through run_processes). Both processes get the same image, loss,
parameters and optimiser state, bit for bit, and so does one process
holding the whole mesh: every process reduces every position's partial
in mesh order. The counterpart of tests/test_multihost.py on a repo
scene (demo-box 16x16), rendezvousing through a file rather than a fixed
port. The workers run with one CPU thread, as does the one-process run.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from plutracer_tpu_torch.parallel.dryrun import ROOT, mesh_jobs, run_processes
from plutracer_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
from plutracer_tpu_torch.scene import compile_scene, load_scene_file
from torch_cpu import one_torch_thread  # noqa: F401 (autouse: one torch thread)

SCENE = str(ROOT / "scenes" / "demo-box.urn")
SPECS = [
    dict(kind="render", scene=SCENE, res=[16, 16], n=2, seed=7, shape=[2, 2]),
    dict(kind="train", scene=SCENE, res=[16, 16], n=1, seed=7, shape=[2, 2], loss_space="ab"),
]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_two_processes_equal_one(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    ranks = run_processes(SPECS, [["cpu", "cpu"], ["cpu", "cpu"]], env=env, timeout=240)
    single = mesh_jobs(SPECS, [torch.device("cpu")] * 4)
    assert set(ranks[0]) == set(ranks[1]) == set(single)
    assert {"j0_image", "j1_loss", "j1_param_mat_color", "j1_opt_0"} <= set(single)
    for name, want in single.items():
        for r, got in enumerate(ranks):
            assert got[name].dtype == want.dtype and np.array_equal(got[name], want), (r, name)
    assert np.isfinite(single["j0_image"]).all() and single["j0_image"].shape == (16, 16, 3)
    # the step moved the parameters from their start, half the scene's albedo
    scene = compile_scene(load_scene_file(SCENE, ["/res", "16x16"]), device="cpu")
    start = (scene.mat_color * 0.5).numpy()
    assert np.isfinite(single["j1_loss"]) and not np.array_equal(single["j1_param_mat_color"], start)


def test_failed_rendezvous_raises(tmp_path):
    """A world of 2 whose second process never comes: the rendezvous times
    out and raises, and leaves no process group behind."""
    with pytest.raises(RuntimeError, match="(?i)timeout"):
        initialize_distributed(f"file://{tmp_path}/rendezvous", num_processes=2, process_id=0,
                               backend="gloo", timeout=2.0)
    assert not dist.is_initialized()


def test_failed_worker_fails_the_job():
    bad = [dict(SPECS[0], scene=str(ROOT / "scenes" / "absent.urn"))]
    with pytest.raises(RuntimeError, match="rank 0 exited"):
        run_processes(bad, [["cpu"], ["cpu"]], env=dict(os.environ, OMP_NUM_THREADS="1"),
                      timeout=120)


def test_mesh_spans_every_rank(tmp_path):
    """In a world of 1 the mesh is built under the process group and its
    partials go through the collective, with the same image."""
    initialize_distributed(f"file://{tmp_path}/rendezvous", num_processes=1, process_id=0,
                           backend="gloo", timeout=60.0)
    try:
        mesh = make_mesh((2, 1), devices=[torch.device("cpu")] * 2)
        assert mesh.distributed and mesh.world == 1
        got = mesh_jobs(SPECS[:1], [torch.device("cpu")] * 4)
    finally:
        dist.destroy_process_group()
    assert np.array_equal(got["j0_image"],
                          mesh_jobs(SPECS[:1], [torch.device("cpu")] * 4)["j0_image"])
