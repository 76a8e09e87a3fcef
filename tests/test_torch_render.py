"""The port's whole render and CLI against the JAX package and the goldens.

Renders at the golden configuration (64x48, N=2, seed 42) are compared
with the JAX render at the same seed and with tests/goldens/repo-*.npz
under the bounds of tests/test_golden.py: p99 of |log1p| differences
below 0.05 and their mean below 0.01 (float16 golden quantisation plus
float32 knife-edge lanes, which flip whole paths).
"""

import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from plutracer_tpu.render.renderer import render as jax_render
from plutracer_tpu.scene import compile_scene as jax_compile
from plutracer_tpu.scene import load_scene_file as jax_load
from plutracer_tpu_torch import cli, rng
from plutracer_tpu_torch.io.bmp import read_bmp
from plutracer_tpu_torch.render.renderer import render
from plutracer_tpu_torch.scene import compile_scene, load_scene_file
from torch_cpu import one_torch_thread  # noqa: F401 (autouse: one torch thread)

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDENS = REPO / "tests" / "goldens"
W, H, N, SEED = 64, 48, 2, 42


def assert_golden_bounds(img, ref, what):
    assert img.shape == ref.shape and np.isfinite(img).all()
    diff = np.abs(np.log1p(np.maximum(img, 0.0)) - np.log1p(np.maximum(ref, 0.0)))
    assert np.quantile(diff, 0.99) < 0.05, f"{what}: p99 {np.quantile(diff, 0.99)}"
    assert diff.mean() < 0.01, f"{what}: mean {diff.mean()}"


@pytest.mark.parametrize("name", ["demo-box", "dof", "textured0"])
def test_render_matches_jax_and_golden(name):
    path = str(REPO / "scenes" / f"{name}.urn")
    args = ["/res", f"{W}x{H}"]
    img = render(compile_scene(load_scene_file(path, args), device="cpu"), W, H, N, rng.PRNGKey(SEED)).numpy()
    ref = np.asarray(jax_render(jax_compile(jax_load(path, args)), W, H, N,
                                jax.random.PRNGKey(SEED)))
    assert_golden_bounds(img, ref, f"{name} vs JAX")
    golden = np.load(GOLDENS / f"repo-{name}.npz")["linear"].astype(np.float32)
    assert_golden_bounds(img, golden, f"{name} vs golden")


def test_cli_cpu_writes_bmp(tmp_path):
    out = tmp_path / "out.bmp"
    rc = cli.main([str(REPO / "scenes" / "dof.urn"), "/res", "32x24", "/smp", "1",
                   "/o", str(out), "/seed", "3", "/device", "cpu"])
    assert rc == 0
    img = read_bmp(str(out))
    assert img.shape == (24, 32, 3)
    assert img.max() > 0


def test_cli_cuda_without_gpu_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([str(REPO / "scenes" / "dof.urn"), "/res", "8x8", "/smp", "1",
                  "/o", str(tmp_path / "x.bmp")])
    assert not (tmp_path / "x.bmp").exists()


@pytest.mark.parametrize("flag", ["/checkpoint", "/supervise", "/profile"])
def test_cli_rejects_unported_flags(flag, tmp_path):
    """Every flag of the JAX package's CLI is ported: none is refused.
    /checkpoint writes its state file and /profile its trace; /supervise
    with /checkpoint naming a file is refused for that file (before any
    worker starts), not for the flag."""
    args = [str(REPO / "scenes" / "dof.urn"), "/res", "8x6", "/smp", "1", "/device", "cpu",
            "/o", str(tmp_path / "x.bmp")]
    target = tmp_path / "x"
    if flag == "/supervise":
        target.write_text("")
        with pytest.raises(SystemExit, match="is a file"):
            cli.main(args + [flag, "/checkpoint", str(target)])
        return
    assert cli.main(args + [flag, str(target)]) == 0
    assert (tmp_path / "x.bmp").exists()
    made = next(target.glob("*.pt.trace.json")) if flag == "/profile" else target
    assert made.exists() and made.stat().st_size > 0


NO_JAX = (
    "import sys\n"
    "bad = sorted(m for m in sys.modules if m.startswith(('jax', 'optax'))\n"
    "             or m == 'plutracer_tpu' or m.startswith('plutracer_tpu.'))\n"
    "assert not bad, bad\n"
    "print('NO_JAX')\n"
)


def test_package_never_imports_jax(tmp_path):
    """A fresh interpreter: import the port, render a tiny image through the
    CLI, take one train step, query the scene-level API (query_closest,
    bvh_closest, stratified_offsets), import R1's wrapper
    (ops/cuda/rng_kernel), run the flagship tool, a sharded
    render and a (2, 2) mesh train step and term_dump on the CPU, and find
    no jax or optax module and no module of the JAX package
    (plutracer_tpu, plutracer_tpu.*) loaded; then the same in a supervisor
    worker subprocess run as the supervisor runs it."""
    code = (
        "import sys\n"
        "import plutracer_tpu_torch.cli as cli\n"
        "import plutracer_tpu_torch.ops.cuda.build, plutracer_tpu_torch.ops.cuda.integrator_kernel\n"
        "import plutracer_tpu_torch.ops.cuda.rng_kernel\n"
        "from plutracer_tpu_torch.ops import bvh, geometry, intersect, lights, sampling, texture\n"
        "from plutracer_tpu_torch.ops.tonemap import reinhard\n"
        "from plutracer_tpu_torch.render.integrator import estimate_direct\n"
        "from plutracer_tpu_torch import rng\n"
        "from plutracer_tpu_torch.diff.optimize import InverseRenderConfig, optimize_scene\n"
        "from plutracer_tpu_torch.scene import compile_scene, load_scene_file\n"
        f"cli.main([{str(REPO / 'scenes' / 'demo-box.urn')!r}, '/res', '8x6', '/smp', '1',"
        f" '/o', {str(tmp_path / 'x.bmp')!r}, '/device', 'cpu'])\n"
        f"s = compile_scene(load_scene_file({str(REPO / 'scenes' / 'demo-box.urn')!r}, ['/res', '8x6']),"
        " device='cpu')\n"
        "p, losses = optimize_scene(s, s.atlas.new_zeros((6, 8, 3)), InverseRenderConfig(\n"
        "    width=8, height=6, n=1, steps=1, trainable=('mat_color',)))\n"
        "assert len(losses) == 1\n"
        "import torch\n"
        "o = s.camera.pos.expand(4, 3).contiguous()\n"
        "d = torch.nn.functional.normalize(torch.randn(4, 3), dim=-1)\n"
        "intersect.query_closest(s, o, d)\n"
        "bvh.bvh_closest(s, s.bvh, o, d)\n"
        "sampling.stratified_offsets(rng.PRNGKey(0), 2)\n"
        "from plutracer_tpu_torch.tools import inverse_flagship\n"
        "r = inverse_flagship.main(['--res', '8', '--steps', '1', '--phase2-steps', '1',"
        " '--target-n', '1', '--n', '1', '--phase2-n', '1', '--phase2-downsample', '2',"
        f" '--device', 'cpu', '--save-images', '--out', {str(tmp_path / 'inv.json')!r}])\n"
        "assert len(r['losses']) == 2\n"
        "import torch\n"
        "from plutracer_tpu_torch.parallel import make_mesh, make_train_step, render_sharded\n"
        "from plutracer_tpu_torch.parallel import dryrun, sharded\n"
        "from plutracer_tpu_torch.utils import profiling\n"
        "mesh = make_mesh((2, 2), devices=[torch.device('cpu')] * 4)\n"
        "img = render_sharded(s, 8, 6, 1, rng.PRNGKey(0), mesh)\n"
        "st = make_train_step(s, 8, 6, 1, mesh, loss_space='linear')\n"
        "params = sharded.get_params(s)\n"
        "st(params, st.init(params), img.reshape(-1, 3), rng.PRNGKey(1), 0)\n"
        "from plutracer_tpu_torch.tools import term_diff, term_dump\n"
        f"term_dump.main([{str(REPO / 'scenes' / 'demo-box.urn')!r}, {str(tmp_path / 'td')!r},"
        " '--res', '8', '--smp', '1', '--device', 'cpu'])\n"
    ) + NO_JAX
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(REPO), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "NO_JAX" in proc.stdout
    assert (tmp_path / "x.bmp").exists() and (tmp_path / "inv.json").exists()
    assert (tmp_path / "td.terms.f32").exists()
    assert (tmp_path / "inverse_target.bmp").exists() and (tmp_path / "inverse_recovered.bmp").exists()
    # a supervisor worker, run as the supervisor launches it (python -m)
    worker = [
        "--worker", "--scene", str(REPO / "scenes" / "demo-box.urn"), "--res", "8x6", "--n", "1",
        "--ckpt", str(tmp_path / "w.ckpt.npz"), "--heartbeat", str(tmp_path / "hb"),
        "--out", str(tmp_path / "w.npz"), "--device", "cpu",
    ]
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['supervisor', *{worker!r}]\n"
        "try:\n"
        "    runpy.run_module('plutracer_tpu_torch.render.supervisor', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
    ) + NO_JAX
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(REPO), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "NO_JAX" in proc.stdout
    assert (tmp_path / "w.npz").exists()
