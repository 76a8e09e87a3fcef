"""The port's crash-safe rendering against itself and the JAX package:
render(accum, start_pass), render/progressive.py, render/elastic.py,
render/supervisor.py and the CLI's /checkpoint, /supervise and /profile,
on scenes/demo-box.urn at 16x12, n = 3 (9 passes).

Bounds: the port against itself bit for bit everywhere (the pass is keyed
by its index, every sum runs in stratum order, and a checkpoint
round-trips exactly), the supervised renders against a supervised
baseline run by the same worker code. The port's elastic render against
the JAX package's render_elastic within the golden bounds of
tests/test_golden.py (|log1p| difference p99 < 0.05, mean < 0.01): the
two run the same estimator in different float32 arithmetic (XLA contracts
products into FMAs), so lanes at knife edges differ.

Workers run with one CPU thread (OMP_NUM_THREADS=1): this image's torch
spends most of a 192-ray pass in its thread pool otherwise. The JAX
render runs in a subprocess beside the tests, so its compile overlaps
them.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from plutracer_tpu_torch import cli, rng
from plutracer_tpu_torch.io.bmp import read_bmp
from plutracer_tpu_torch.render import progressive, supervisor
from plutracer_tpu_torch.render.elastic import render_elastic
from plutracer_tpu_torch.render.progressive import render_with_checkpoint, save_state
from plutracer_tpu_torch.render.renderer import render, render_passes
from plutracer_tpu_torch.render.supervisor import WorkerFailure, _worker, supervise_render
from plutracer_tpu_torch.scene import compile_scene, load_scene_file
from torch_cpu import one_torch_thread  # noqa: F401 (autouse: one torch thread)

REPO = pathlib.Path(__file__).resolve().parent.parent
SCENE = str(REPO / "scenes" / "demo-box.urn")
W, H, N, SEED = 16, 12, 3, 7  # 9 passes; checkpoints every 4 land at 4, 8, 9
SUP = dict(checkpoint_every=4, device="cpu", poll=0.1)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def one_thread_workers(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(scope="module")
def scene():
    return compile_scene(load_scene_file(SCENE, ["/res", f"{W}x{H}"]), device="cpu")


@pytest.fixture(scope="module")
def reference(scene):
    return render(scene, W, H, N, rng.PRNGKey(SEED)).numpy()


@pytest.fixture(scope="module")
def baseline(tmp_path_factory):
    """The no-failure supervised render every recovery run must match: the
    CLI's /supervise (one worker, one CPU, checkpoints every 8 passes)."""
    tmp = tmp_path_factory.mktemp("baseline")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        res = cli.run([SCENE, "/res", f"{W}x{H}", "/smp", str(N), "/seed", str(SEED),
                       "/supervise", "/o", str(tmp / "out.bmp"), "/device", "cpu"])
    finally:
        os.chdir(cwd)
    assert res.integrator == "supervised"
    assert read_bmp(str(tmp / "out.bmp")).shape == (H, W, 3)
    assert (tmp / f".supervise_demo-box_{W}x{H}_s{SEED}" / "result.npz").exists()
    return res.linear.numpy()


def test_render_resumes_from_start_pass(scene, reference):
    key = rng.PRNGKey(SEED)
    partial = render_passes(scene, key, 0, W, H, N, 4)
    img = render(scene, W, H, N, key, accum=partial, start_pass=4)
    assert np.array_equal(img.numpy(), reference)


def test_progressive_resume_bit_exact(scene, reference, tmp_path, monkeypatch):
    """A render stopped after its first checkpointed chunk resumes from
    pass 4 to the same image; a checkpoint of another seed is refused."""
    ck = str(tmp_path / "r.ckpt.npz")
    calls = []

    def stop_second_chunk(*args, **kw):
        calls.append(args[2])
        if len(calls) == 2:
            raise KeyboardInterrupt
        return render_passes(*args, **kw)

    monkeypatch.setattr(progressive, "render_passes", stop_second_chunk)
    with pytest.raises(KeyboardInterrupt):
        render_with_checkpoint(scene, W, H, N, SEED, checkpoint_path=ck, checkpoint_every=4)
    assert progressive.load_state(ck)[1:] == (4, SEED)
    monkeypatch.setattr(progressive, "render_passes", render_passes)
    img = render_with_checkpoint(scene, W, H, N, SEED, checkpoint_path=ck, checkpoint_every=4)
    assert np.array_equal(img.numpy(), reference)
    with pytest.raises(ValueError, match="seed"):
        render_with_checkpoint(scene, W, H, N, SEED + 1, checkpoint_path=ck)


@pytest.mark.parametrize("devices,every", [(1, 8), (2, 4), (4, 8)])
def test_elastic_equals_render(scene, reference, devices, every):
    """Any device list and any chunking: the image of render, bit for bit;
    a heartbeat for every pass."""
    passes = []
    img = render_elastic(scene, W, H, N, SEED, devices=[torch.device("cpu")] * devices,
                         checkpoint_every=every, on_pass=passes.append)
    assert np.array_equal(img, reference)
    assert sorted(passes) == list(range(N * N))  # as each device's launch returns


@pytest.fixture(scope="module", autouse=True)
def jax_elastic(tmp_path_factory):
    """The JAX package's render_elastic of the same job, in a subprocess
    started when this module starts (its compile overlaps the tests
    below); yields a function that waits for it and returns the image."""
    out = tmp_path_factory.mktemp("jax") / "elastic.npy"
    code = ("import jax, numpy as np\n"
            "from plutracer_tpu.render.elastic import render_elastic\n"
            "from plutracer_tpu.scene import compile_scene, load_scene_file\n"
            f"s = compile_scene(load_scene_file({SCENE!r}, ['/res', '{W}x{H}']))\n"
            f"img = render_elastic(s, {W}, {H}, {N}, {SEED}, devices=jax.devices()[:1])\n"
            f"np.save({str(out)!r}, np.asarray(img))\n")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=str(REPO),
                            env=dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=" ".join(
                                [os.environ.get("XLA_FLAGS", ""),
                                 "--xla_cpu_multi_thread_eigen=false"])),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)

    def image():
        log = proc.communicate(timeout=600)[0]
        assert proc.returncode == 0, log[-3000:]
        return np.load(out)

    yield image
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def test_elastic_within_golden_bounds_of_jax(reference, jax_elastic):
    ref = jax_elastic()
    assert ref.shape == reference.shape
    diff = np.abs(np.log1p(np.maximum(reference, 0.0)) - np.log1p(np.maximum(ref, 0.0)))
    assert np.quantile(diff, 0.99) < 0.05 and diff.mean() < 0.01, (np.quantile(diff, 0.99),
                                                                    diff.mean())


def test_elastic_rejects_foreign_checkpoint(scene, tmp_path):
    ck = str(tmp_path / "c.npz")
    save_state(ck, np.zeros((H * W, 3), np.float32), 4, seed=99)
    with pytest.raises(ValueError, match="seed"):
        render_elastic(scene, W, H, N, SEED, checkpoint_path=ck, devices=["cpu"])


def test_worker_rejects_foreign_job_checkpoint(tmp_path):
    ck = tmp_path / "c.npz"
    save_state(str(ck), np.zeros((H * W, 3), np.float32), 4, SEED)
    (tmp_path / "c.npz.job").write_text("elsewhere.urn|8x6|n=1|seed=0")
    with pytest.raises(SystemExit, match="different job"):
        _worker(["--worker", "--scene", SCENE, "--res", f"{W}x{H}", "--n", str(N),
                 "--seed", str(SEED), "--ckpt", str(ck), "--heartbeat", str(tmp_path / "hb"),
                 "--out", str(tmp_path / "o.npz"), "--device", "cpu"])


def test_worker_never_falls_back_to_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _worker(["--worker", "--scene", SCENE, "--res", f"{W}x{H}", "--n", str(N),
                 "--ckpt", str(tmp_path / "c.npz"), "--heartbeat", str(tmp_path / "hb"),
                 "--out", str(tmp_path / "o.npz")])


@pytest.mark.parametrize("fault,counts,timeout,failure", [
    ("crash:4", [1], 120.0, "exit code 13"),  # passes 4..7 rendered, not checkpointed
    ("hang:0", [4, 2], 20.0, "heartbeat stale"),  # wedged; restarted on fewer devices
])
def test_recovery_bit_exact(tmp_path, baseline, fault, counts, timeout, failure):
    """The first launch fails as injected, a restart resumes from the last
    checkpoint (the hang's on 2 devices where it ran on 4), and the image
    is the baseline's bit for bit. The hang's 20 s bound is short: on a
    loaded CPU a healthy worker's torch import can outlast it and be
    restarted too, so the hang asserts the first failure and at least one
    restart."""
    r = supervise_render(SCENE, W, H, N, SEED, str(tmp_path), inject_fault=fault,
                         device_counts=counts, heartbeat_timeout=timeout, **SUP)
    failures = [d for e, d in r.events if e == "failure"]
    assert failure in failures[0], r.events
    assert r.restarts == 1 or (fault.startswith("hang") and r.restarts > 1), r.events
    assert np.array_equal(r.image, baseline)


def test_persistent_failure_exhausts_restarts(tmp_path):
    with pytest.raises(WorkerFailure, match="failed 2 times"):
        supervise_render(str(tmp_path / "does-not-exist.urn"), W, H, N, SEED, str(tmp_path),
                         max_restarts=1, heartbeat_timeout=120.0, **SUP)


def test_exit_zero_without_result_restarts(tmp_path, baseline, monkeypatch):
    """A worker that exits 0 but leaves no readable result is a failure."""
    launch = supervisor._launch
    seen = []

    def first_exits_clean(args, env, log_path):
        seen.append(args)
        if len(seen) == 1:
            args = [args[0], "-c", "pass"]
        return launch(args, env, log_path)

    monkeypatch.setattr(supervisor, "_launch", first_exits_clean)
    r = supervise_render(SCENE, W, H, N, SEED, str(tmp_path), heartbeat_timeout=120.0, **SUP)
    assert r.restarts == 1 and len(seen) == 2
    assert ("failure", "exit code 0 without a readable result") in r.events
    assert np.array_equal(r.image, baseline)


def test_cli_supervised_render(tmp_path, baseline, reference):
    """/supervise (the baseline's run, checked there) gives the in-process
    image; /checkpoint names the work directory under /supervise, and a
    file there is refused."""
    assert np.array_equal(baseline, reference)
    (tmp_path / "taken").write_text("")
    with pytest.raises(SystemExit, match="is a file"):
        cli.run([SCENE, "/res", f"{W}x{H}", "/smp", "1", "/supervise", "/checkpoint",
                 str(tmp_path / "taken"), "/device", "cpu"])


def test_cli_checkpoint_resume_and_profile(tmp_path, monkeypatch, reference):
    """/checkpoint: a CLI render stopped after its first checkpoint resumes
    to the in-process image (linear radiance, not the BMP, whose watermark
    holds timings); /profile writes a torch.profiler trace."""
    ck = str(tmp_path / "cli.ckpt.npz")
    args = [SCENE, "/res", f"{W}x{H}", "/smp", str(N), "/seed", str(SEED), "/o",
            str(tmp_path / "x.bmp"), "/device", "cpu", "/checkpoint", ck]
    calls = []

    def stop_second_chunk(*a, **kw):
        calls.append(a[2])
        if len(calls) == 2:
            raise KeyboardInterrupt
        return render_passes(*a, **kw)

    monkeypatch.setattr(progressive, "render_passes", stop_second_chunk)
    with pytest.raises(KeyboardInterrupt):
        cli.run(args)
    assert progressive.load_state(ck)[1] == 8 and not (tmp_path / "x.bmp").exists()
    monkeypatch.setattr(progressive, "render_passes", render_passes)
    res = cli.run(args + ["/profile", str(tmp_path / "prof")])
    assert np.array_equal(res.linear.numpy(), reference)
    (trace,) = (tmp_path / "prof").glob("*.pt.trace.json")
    assert trace.stat().st_size > 0
