"""A run end to end on the CPU at a tiny size (the kernels' plain
versions), its last line, and the run that finds no card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from helpers import ROOT, run_tiny, tiny_cell, tiny_train

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("name", ["cornell-box.final", "spd-tetra.final"])
def test_final_render_end_to_end_on_cpu(name):
    cell = tiny_cell(name, size=8, pixels=8)
    result, compared = run_tiny(cell)
    assert list(result) == KEYS  # checks last
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {m.name for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert set(result["checks"]) == {c.name for c in compared}
    assert all(set(v) == {"value", "limit"} for v in result["checks"].values())
    assert result["device"]["count"] == 1


def test_train_step_end_to_end_on_cpu():
    cell = tiny_train()
    result, _ = run_tiny(cell)
    assert list(result) == KEYS
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"train_step_ms", "setup_s"}
    assert set(result["checks"]) == {"tables_off", "target_rel_l1", "target_pixels_off",
                                     "loss_gap", "grad_gap", "change_gap", "last_loss_gap",
                                     "last_change_gap", "last_moments_gap"}


@pytest.mark.parametrize("mix", [
    {"loss_space": "ab", "n": 2, "loss_downsample": 2},
    {"loss_space": "linear", "loss_clamp": 5.0, "project_nonnegative": True},
])
def test_train_mix_parameters_reach_both_sides(mix):
    """The flagship's phase 2 (the ab loss with pooling) and the other
    losses are a mix's parameters: the program and the reference follow
    them alike."""
    result, _ = run_tiny(tiny_train(**mix))
    assert result["correct"], result["checks"]


def test_render_mix_overrides_the_configuration():
    """A preview mix's own n and the program's options reach the run; the
    options the reference lacks (the engine) do not change the answer."""
    cell = tiny_cell("cornell-box.final", size=8, pixels=8)
    cell.traffic.update(n=1, options={"integrator_backend": "plain", "max_bounces": 3})
    from plubench import traffic
    from plubench.trace import Tracer

    loop = traffic.make_loop(cell, 5, torch.device("cpu"), Tracer(False))
    assert loop.n == 1 and loop.options["max_bounces"] == 3
    result, _ = run_tiny(cell)
    assert result["correct"], result["checks"]


def test_traced_run_reports_per_layer_metrics_only():
    cell = tiny_cell("cornell-box.final")
    result, _ = run_tiny(cell, trace=True)
    # no device records on the CPU: the device readers find nothing to read
    assert set(result["metrics"]) == {"scene_compile_ms"}
    assert result["correct"]


def test_seed_gives_the_same_images():
    cell = tiny_cell("cornell-box.final")
    from plubench import check, traffic
    from plubench.trace import Tracer

    imgs = []
    for _ in range(2):
        loop = traffic.make_loop(cell, 2**33 + 5, torch.device("cpu"), Tracer(False))
        loop.setup()
        imgs.append(loop._image(loop._key(3))[1])
    assert torch.equal(imgs[0], imgs[1])
    assert check.seed_words(2**33 + 5) != check.seed_words(5)


def test_no_card_exits_nonzero_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "cornell-box.final",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_no_jax_loaded_and_reference_stands_alone():
    """A tiny run in a fresh process loads no module whose top-level name
    is jax, jaxlib, flax or plutracer_tpu (compared whole); the reference
    alone loads nothing of plutracer_tpu_torch."""
    code = (
        "import sys, time, torch\n"
        "sys.path[:0] = [{bench!r}, {root!r}]\n"
        "from helpers import run_tiny, tiny_cell\n"
        "r, _ = run_tiny(tiny_cell('cornell-box.final'))\n"
        "assert r['correct']\n"
        "print(sorted({{m.split('.')[0] for m in sys.modules}}))\n"
    ).format(bench=str(ROOT / "benchmark" / "tests"), root=str(ROOT / "benchmark"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "plutracer_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "plutracer_tpu"}
    ref = (
        "import sys\n"
        "sys.path[:0] = [{root!r}]\n"
        "import plubench.reference.render.integrator, plubench.reference.scene.compile\n"
        "import plubench.reference.diff.optim, plubench.check, plubench.work\n"
        "print(sorted({{m.split('.')[0] for m in sys.modules}}))\n"
    ).format(root=str(ROOT / "benchmark"))
    out = subprocess.run([sys.executable, "-c", ref], cwd=ROOT / "benchmark", capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "plutracer_tpu", "plutracer_tpu_torch"}


def test_result_line_is_json():
    result, _ = run_tiny(tiny_cell("cornell-box.final"))
    assert json.loads(json.dumps(result)) == result


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import types

    from plubench.main import forbidden_modules

    monkeypatch.setitem(sys.modules, "plutracer_tpu_torch_like", types.ModuleType("x"))
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "plutracer_tpu.render", types.ModuleType("y"))
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", types.ModuleType("z"))
    assert forbidden_modules() == ["jaxlib.xla_client", "plutracer_tpu.render"]
