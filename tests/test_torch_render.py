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
    with pytest.raises(SystemExit, match="ROADMAP"):
        cli.main([str(REPO / "scenes" / "dof.urn"), flag, str(tmp_path / "x"),
                  "/device", "cpu"])


def test_package_never_imports_jax(tmp_path):
    """A fresh interpreter: import the port, render a tiny image through the
    CLI and take one train step on the CPU, and find no jax module and no
    module of the JAX package (plutracer_tpu, plutracer_tpu.*) loaded."""
    code = (
        "import sys\n"
        "import plutracer_tpu_torch.cli as cli\n"
        "import plutracer_tpu_torch.ops.cuda.build, plutracer_tpu_torch.ops.cuda.integrator_kernel\n"
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
        "bad = sorted(m for m in sys.modules if m.startswith('jax')\n"
        "             or m == 'plutracer_tpu' or m.startswith('plutracer_tpu.'))\n"
        "assert not bad, bad\n"
        "print('NO_JAX')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(REPO), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "NO_JAX" in proc.stdout
    assert (tmp_path / "x.bmp").exists()
