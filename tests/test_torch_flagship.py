"""The port's flagship recipe (plutracer_tpu_torch/tools/inverse_flagship.py)
and its optimisers against the JAX package's tool and optax.

Bounds:
- exponential_decay against optax.exponential_decay run op by op: bit
  for bit on every count of the recipe's phase-1 schedule (20.0, 600,
  0.1; counts 0 to 1,200) and on counts 0 to 445 of its phase-2 schedule
  (1e-2, 300, 0.05), whose 300 steps end far before; the first count that
  differs is 446 (XLA's float32 power against the correctly rounded one).
  Inside a jitted program XLA fuses the power and rounds it otherwise on
  about a quarter of the counts (310 of the 1,201 phase-1 counts, by up
  to 6 units in the last place), so the JAX tool's jitted train step and
  the port's differ there by a few ulps of the learning rate: the curve
  bounds below cover it.
- MultiTransform of Adams against optax.multi_transform run op by op (as
  tests/test_torch_train.py holds Adam): bit for bit over 8 steps, with
  the carried state and its leaves equal.
- the tool at 32x32 on scenes/dof.urn (whose lanes do not flip between
  XLA's FMA-contracted arithmetic and the port's: on demo-box the glass
  sphere's do, tests/test_torch_train) against tools/inverse_flagship.main
  with the same flags, init and seeds (both phases, the mask, the pooled
  and clamped phase 2): losses within 1e-5 relative, the curve's errors
  and the recovered albedo within 1e-6, the emission within 1e-6
  relative. Measured at 5 + 3 steps (target n = 4): losses 4.5e-7,
  errors 2.3e-9, albedo 4.5e-8, emission 6e-8. Here at 0 + 1 steps: the
  JAX tool compiles a train step for each chunk shape of each phase,
  about 15 to 25 s (log) and 30 to 40 s (pooled ab) apiece on this CPU,
  and 5 + 3 steps take four such compiles (135 s in all), 1 + 1 two (85
  to 100 s): this module would not stay within its 90 s. So the JAX tool
  runs phase 2 alone (the clamped target, the pooled ab loss, the
  decaying albedo rate, the mask), from the canonical perturbation;
  phase 1's parts are held against JAX elsewhere: its step
  (tests/test_torch_train.py, dof, log loss with the mask, 1e-3) and
  its optimiser (bit for bit, above). The port's own runs below take the
  5 + 3 steps.
- the tool on scenes/demo-box.urn at 16x16 (target n = 4, n = 2, 11
  phase-1 steps, no phase 2; the JAX tool with XLA's CPU ISA capped at
  SSE4.2, so that it cannot contract products into FMAs) against the JAX
  tool with the same flags: step 0 within the dof bounds above, step 10
  (after ten Adam steps on each side's own knife-edge lanes) losses within
  1e-3 relative, the albedo error within 0.01 and the emission error within
  1e-3 relative. Measured: step 0 loss 2.8e-6, step 10 loss 1.4e-4, albedo
  error 0.0023, emission 9.4e-5 relative (`python
  tests/torch_jax_flagship.py curves --res 16 --steps 11 --phase2-steps 0
  --target-n 4 --no-fma`). On demo-box the mirror and glass spheres carry
  caustic paths of up to a few hundred times a pixel's radiance, and the
  lanes that flip between XLA's arithmetic and the port's (33 of 1,024
  pixels at 32x32, n = 2, with FMAs) move the loss and gradients far more
  than on dof.
- the flagship's log loss and its gradients on demo-box 32x32, n = 2, from
  the tool's perturbed start, with the pixels whose radiance differs from
  JAX's by more than 1e-4 relative (the knife-edge lanes) weighted out:
  the loss within 1e-5 relative and each field's gradient within 1e-5 of
  its largest entry (measured 2.8e-7 and at most 1.4e-6; with every pixel
  kept, 4.9e-2 and up to 803 times tex_c0's largest entry:
  `python tests/torch_jax_flagship.py grads --target-n 4`).
- an interrupted-and-rerun tool run (5 + 3 steps) against a straight run:
  bit for bit.
- a JAX checkpoint resumed by the port: the state read back equal to the
  JAX leaves bit for bit; the run continued from it within the bounds
  above of the port's run continued from its own checkpoint.

The JAX tool's runs (dof and demo-box) are subprocesses started when this
module starts, so their compiles overlap the port's runs.
"""

import dataclasses
import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from plutracer_tpu_torch.diff import optimize
from plutracer_tpu_torch.diff.optim import (
    Adam,
    MultiTransform,
    apply_updates,
    exponential_decay,
    multi_transform_state_from_optax,
)
from plutracer_tpu_torch.diff.optimize import InverseRenderConfig, load_train_checkpoint
from plutracer_tpu_torch.parallel.sharded import params_from_numpy
from plutracer_tpu_torch.tools import inverse_flagship as flagship
from torch_cpu import one_torch_thread  # noqa: F401 (autouse: one torch thread)

REPO = pathlib.Path(__file__).resolve().parent.parent
LABELS = flagship.LABELS
SCENE = str(REPO / "scenes" / "dof.urn")
FLAGS = ["--scene", SCENE, "--res", "32", "--n", "2", "--target-n", "2", "--phase2-n", "2",
         "--phase2-downsample", "8", "--phase2-clamp", "5"]
ARGS = FLAGS + ["--steps", "5", "--phase2-steps", "3"]
JAX_ARGS = FLAGS + ["--steps", "0", "--phase2-steps", "1"]
DEMO = str(REPO / "scenes" / "demo-box.urn")
DEMO_ARGS = ["--scene", DEMO, "--res", "16", "--n", "2", "--target-n", "4", "--steps", "11",
             "--phase2-steps", "0"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("flagship")


def start_jax_tool(workdir, name, argv, xla_flags=()):
    """tools/inverse_flagship.main(argv + --out workdir/<name>.json) in a
    subprocess; returns a function that waits for it and returns its JSON,
    and the process."""
    argv = argv + ["--out", str(workdir / f"{name}.json")]
    code = (f"import sys; sys.path.insert(0, {str(REPO / 'tools')!r})\n"
            f"import inverse_flagship; inverse_flagship.main({argv!r})\n")
    # one CPU device, as the tool runs on one card (the test session's
    # 8 virtual devices would shard phase 1 over 8 tiles with other keys),
    # and one thread, beside the suite's other workers
    flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
             if "xla_force_host_platform_device_count" not in f]
    flags += ["--xla_cpu_multi_thread_eigen=false", *xla_flags]
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=" ".join(flags))
    log = workdir / f"{name}.log"
    with open(log, "w") as out:
        proc = subprocess.Popen([sys.executable, "-c", code], cwd=str(REPO), env=env,
                                stdout=out, stderr=subprocess.STDOUT)

    def result():
        assert proc.wait(timeout=900) == 0, log.read_text()[-3000:]
        return json.loads((workdir / f"{name}.json").read_text())

    return result, proc


@pytest.fixture(scope="module", autouse=True)
def jax_tools(workdir):
    """The JAX tool at JAX_ARGS with a checkpoint directory, and at
    DEMO_ARGS without FMA contraction, both started when the module
    starts; yields {"dof": result, "demo-box": result}."""
    runs = {"dof": start_jax_tool(workdir, "jax", JAX_ARGS + ["--checkpoint",
                                                              str(workdir / "jax_ck")]),
            "demo-box": start_jax_tool(workdir, "jax_demo", DEMO_ARGS,
                                       ["--xla_cpu_max_isa=SSE4_2"])}
    yield {k: r for k, (r, _) in runs.items()}
    for _, proc in runs.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def jax_tool(jax_tools):
    return jax_tools["dof"]


@pytest.fixture(scope="module")
def port_run(workdir):
    return flagship.main(ARGS + ["--out", str(workdir / "port.json"), "--device", "cpu"])


@pytest.fixture(scope="module")
def port_small(workdir):
    """The port's tool at JAX_ARGS."""
    (workdir / "small").mkdir()
    return flagship.main(JAX_ARGS + ["--out", str(workdir / "small" / "port.json"), "--device",
                                     "cpu", "--checkpoint", str(workdir / "port_ck")])


@pytest.mark.parametrize("args,counts,differ", [
    ((20.0, 600, 0.1), 1201, []),
    ((1e-2, 300, 0.05), 601, [446]),
])
def test_exponential_decay_bit_equal_to_optax(args, counts, differ):
    jsched = optax.exponential_decay(*args)
    want = np.array([np.float32(jsched(jnp.int32(c))) for c in range(counts)])
    sched = exponential_decay(*args)
    got = np.array([sched(torch.tensor(c, dtype=torch.int32)).item() for c in range(counts)],
                   np.float32)
    assert np.nonzero(got != want)[0].tolist() == differ
    # under jit XLA fuses the power and rounds some counts otherwise (310
    # of the phase-1 schedule's 1,201 with jax 0.9.0), by a few ulps
    fused = np.asarray(jax.jit(jax.vmap(jsched))(jnp.arange(counts, dtype=jnp.int32)))
    assert (fused != want).any()
    np.testing.assert_allclose(fused, want, rtol=1e-6)


def test_multi_transform_bit_equal_to_optax():
    g = np.random.default_rng(0)
    shapes = {"mat_color": (5, 3), "light_intensity": (1, 3), "tex_c0": (2, 3), "tex_c1": (2, 3)}
    params = {k: g.uniform(0.0, 1.0, s).astype(np.float32) for k, s in shapes.items()}
    jopt = optax.multi_transform(
        {"albedo": optax.adam(3e-2), "emission": optax.adam(optax.exponential_decay(20.0, 6, 0.1))},
        param_labels=LABELS)
    topt = MultiTransform({"albedo": Adam(3e-2), "emission": Adam(exponential_decay(20.0, 6, 0.1))},
                          LABELS)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init(jp)
    tp = params_from_numpy(params)
    ts = topt.init(tp)
    update = jopt.update
    for _ in range(8):
        grads = {k: (g.normal(size=s) * 10.0 ** g.integers(-6, 3)).astype(np.float32)
                 for k, s in shapes.items()}
        upd, js = update({k: jnp.asarray(v) for k, v in grads.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        tu, ts = topt.update(params_from_numpy(grads), ts)
        tp = apply_updates(tp, tu)
        for k in shapes:
            assert np.array_equal(tp[k].numpy(), np.asarray(jp[k])), k
    carried = multi_transform_state_from_optax(js, LABELS)
    for label in ("albedo", "emission"):
        a, b = carried.inner_states[label], ts.inner_states[label]
        assert int(a.count) == int(b.count) == 8 and sorted(a.mu) == sorted(b.mu)
        for k in b.mu:
            assert torch.equal(a.mu[k], b.mu[k]) and torch.equal(a.nu[k], b.nu[k]), (label, k)
    # the port's leaves are optax's, in jax.tree_util order
    leaves = topt.state_leaves(ts)
    jleaves = jax.tree_util.tree_leaves(js)
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_first_layout_checkpoint_loads(tmp_path):
    """A single-Adam checkpoint in the port's first layout (mu_*, nu_*,
    count) still loads."""
    g = np.random.default_rng(1)
    keys = ("light_intensity", "mat_color")
    arr = {k: g.normal(size=(2, 3)).astype(np.float32) for k in keys}
    path = str(tmp_path / "old.ckpt.npz")
    np.savez(path, next_i=3, seed=0, count=3, losses=np.zeros(3), nf_fracs=np.zeros(3),
             param_keys=np.asarray(sorted(keys)), **{f"param_{k}": v for k, v in arr.items()},
             **{f"mu_{k}": v + 1 for k, v in arr.items()}, **{f"nu_{k}": v + 2 for k, v in arr.items()})
    opt = Adam(1e-2)
    params, state, i, losses, _ = load_train_checkpoint(path, opt, opt.init(params_from_numpy(arr)),
                                                        0, "cpu")
    assert i == 3 and int(state.count) == 3 and losses == [0.0] * 3
    for k in keys:
        assert np.array_equal(state.mu[k].numpy(), arr[k] + 1)
        assert np.array_equal(state.nu[k].numpy(), arr[k] + 2)
        assert np.array_equal(params[k].numpy(), arr[k])


def test_interrupted_rerun_bit_exact(port_run, workdir, monkeypatch):
    """Stopped by an exception from the callback at phase 2's second chunk
    (after phase 2's first checkpoint, so that chunk is lost), then rerun
    with the same flags: phase 1 replays from its checkpoint, and the
    parameters and loss history equal the straight run's bit for bit."""
    real = flagship.optimize_scene

    def interrupting(scene, target, cfg, init_params=None, callback=None, stats_out=None):
        def cb(i, loss, params):
            callback(i, loss, params)
            if cfg.seed == 1 and i > 0:
                raise KeyboardInterrupt

        return real(scene, target, cfg, init_params=init_params, callback=cb,
                    stats_out=stats_out)

    args = ARGS + ["--device", "cpu", "--checkpoint", str(workdir / "rerun_ck"),
                   "--out", str(workdir / "rerun.json")]
    monkeypatch.setattr(flagship, "optimize_scene", interrupting)
    with pytest.raises(KeyboardInterrupt):
        flagship.main(args)
    assert np.load(workdir / "rerun_ck" / "phase2.ckpt.npz")["next_i"] == 1
    monkeypatch.setattr(flagship, "optimize_scene", real)
    got = flagship.main(args)
    assert got["losses"] == port_run["losses"] and len(got["losses"]) == 8
    for k, v in port_run["params"].items():
        assert torch.equal(got["params"][k], v), k
    assert got["grad_sanitize_stats"] == port_run["grad_sanitize_stats"]
    assert got["grad_sanitize_stats"]["nonfinite_grad_frac_max"] == 0.0


def test_tool_matches_jax(port_small, port_run, jax_tool, workdir):
    want = jax_tool()
    got = port_small
    assert set(want) <= set(got)
    assert want["config"] == json.loads((workdir / "small" / "port.json").read_text())["config"]
    assert [r["step"] for r in got["curve"]] == [r["step"] for r in want["curve"]] == [0]
    for a, b in zip(got["curve"], want["curve"]):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"]), (a, b)
        assert abs(a["albedo_mae"] - b["albedo_mae"]) <= 1e-6, (a, b)
        assert abs(a["emission_rel_err"] - b["emission_rel_err"]) <= 1e-6, (a, b)
    np.testing.assert_allclose(got["recovered_albedo"], want["recovered_albedo"], atol=1e-6)
    np.testing.assert_allclose(got["recovered_emission"], want["recovered_emission"], rtol=1e-6)
    assert got["init"] == want["init"]
    for run in (got, port_run):
        stats = run["grad_sanitize_stats"]
        assert stats["nonfinite_grad_frac_max"] == stats["phase2"]["nonfinite_grad_frac_max"] == 0
    # the 5 + 3 step run: its curve's cadence
    assert [r["step"] for r in port_run["curve"]] == [0, 4, 5, 7]
    assert port_run["final"]["emission_rel_err"] < port_run["init"]["emission_rel_err"]


def test_jax_checkpoint_resumes_in_port(port_small, jax_tool, workdir):
    """The JAX tool's phase-2 checkpoint (a multi_transform state after 1
    step: a scheduled and a constant adam) read into the port's
    MultiTransform, and continued to step 3 by the port's optimize_scene:
    within the bounds above of the port continuing its own checkpoint."""
    jax_tool()
    scene = flagship.compile_scene(flagship.load_scene_file(SCENE, ["/res", "32x32"]),
                                   device="cpu")
    mask = {"mat_color": (scene.mat_type == 0).to(torch.float32)[:, None]}
    target = flagship.clamped_target(scene, 32, 32, 2, 5.0, flagship.rng.PRNGKey(100))

    def opt():
        return MultiTransform({"albedo": Adam(exponential_decay(1e-2, 3, 0.05)),
                               "emission": Adam(1.0)}, LABELS)

    runs = {}
    for side in ("jax", "port"):
        src = workdir / f"{side}_ck" / "phase2.ckpt.npz"
        ck = workdir / f"continue_{side}.ckpt.npz"
        shutil.copy(src, ck)
        o = opt()
        template = o.init(params_from_numpy(flagship._numpy(flagship.get_params(scene))))
        z = np.load(src)
        _, state, i, _, _ = load_train_checkpoint(str(ck), o, template, 1, "cpu")
        assert i == 1 and int(state.inner_states["albedo"].count) == 1
        for j, leaf in enumerate(o.state_leaves(state)):
            assert np.array_equal(leaf.numpy(), z[f"opt_{j}"]), j
        cfg = InverseRenderConfig(width=32, height=32, n=2, steps=3, seed=1, log_every=10,
                                  trainable=("mat_color", "light_intensity"), optimizer=o,
                                  grad_mask=mask, loss_space="ab", loss_downsample=8,
                                  loss_clamp=5.0, checkpoint_path=str(ck))
        runs[side] = optimize.optimize_scene(scene, target, cfg)
    (jp, jl), (pp, pl) = runs["jax"], runs["port"]
    assert len(jl) == len(pl) == 3
    np.testing.assert_allclose(jl, pl, rtol=1e-5)
    np.testing.assert_allclose(jp["mat_color"].numpy(), pp["mat_color"].numpy(), atol=1e-6)
    np.testing.assert_allclose(jp["light_intensity"].numpy(), pp["light_intensity"].numpy(),
                               rtol=1e-6)


def test_tool_matches_jax_on_demo_box(jax_tools, workdir):
    """The flagship tool on demo-box against the JAX tool with the same
    flags (the bounds in the module's docstring). Both move the albedo away
    from the truth at first while the emission error falls, as the full
    recipe does on this scene in both packages (PERF.md)."""
    got = flagship.main(DEMO_ARGS + ["--out", str(workdir / "port_demo.json"), "--device", "cpu"])
    want = jax_tools["demo-box"]()
    assert got["init"] == want["init"]
    assert [r["step"] for r in got["curve"]] == [r["step"] for r in want["curve"]] == [0, 10]
    (a0, a10), (b0, b10) = got["curve"], want["curve"]
    assert abs(a0["loss"] - b0["loss"]) <= 1e-5 * abs(b0["loss"]), (a0, b0)
    assert abs(a0["albedo_mae"] - b0["albedo_mae"]) <= 1e-6, (a0, b0)
    assert abs(a0["emission_rel_err"] - b0["emission_rel_err"]) <= 1e-6, (a0, b0)
    assert abs(a10["loss"] - b10["loss"]) <= 1e-3 * abs(b10["loss"]), (a10, b10)
    assert abs(a10["albedo_mae"] - b10["albedo_mae"]) <= 0.01, (a10, b10)
    assert abs(a10["emission_rel_err"] - b10["emission_rel_err"]) <= 1e-3 * b10[
        "emission_rel_err"], (a10, b10)
    for first, last in ((a0, a10), (b0, b10)):  # the albedo drifts from the truth
        assert last["albedo_mae"] > first["albedo_mae"]
        assert last["emission_rel_err"] < first["emission_rel_err"]


def test_demo_box_gradients_match_jax_off_knife_edges():
    """The flagship's log loss on demo-box 32x32, n = 2, at the tool's
    perturbed start, and its gradient to every differentiable field, in
    both packages with the knife-edge pixels weighted out (the module's
    docstring has the bounds)."""
    from plutracer_tpu.parallel.sharded import apply_params as jax_apply
    from plutracer_tpu.parallel.sharded import get_params as jax_get
    from plutracer_tpu.render.renderer import render as jax_render
    from plutracer_tpu.scene import compile_scene as jax_compile
    from plutracer_tpu.scene import load_scene_file as jax_load
    from plutracer_tpu_torch.parallel.sharded import apply_params
    from plutracer_tpu_torch.render.renderer import render

    W = H = 32
    js = jax_compile(jax_load(DEMO, ["/res", f"{W}x{H}"]))
    ts = flagship.compile_scene(flagship.load_scene_file(DEMO, ["/res", f"{W}x{H}"]),
                                device="cpu")
    start = {k: np.asarray(v).copy() for k, v in jax_get(js).items()}
    start["mat_color"][np.asarray(js.mat_type) == 0] = 0.25
    start["light_intensity"] = start["light_intensity"] * 0.25
    target = render(ts, W, H, 4, flagship.rng.PRNGKey(100)).numpy()
    jp = {k: jnp.asarray(v) for k, v in start.items()}
    a = np.asarray(jax_render(jax_apply(js, jp), W, H, 2, jax.random.PRNGKey(0)))
    b = render(apply_params(ts, params_from_numpy(start)), W, H, 2,
               flagship.rng.PRNGKey(0)).numpy()
    rel = np.abs(a - b).max(-1) / np.maximum(np.abs(a).max(-1), 1e-6)
    weight = (rel <= 1e-4).astype(np.float32)[..., None]
    assert weight.mean() > 0.9, weight.mean()

    def jax_loss(p):
        x = jax_render(jax_apply(js, p), W, H, 2, jax.random.PRNGKey(0))
        return jnp.mean(weight * (jnp.log1p(jnp.maximum(x, 0.0)) - jnp.log1p(target)) ** 2)

    jl, jg = jax.value_and_grad(jax_loss)(jp)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in start.items()}
    x = render(apply_params(ts, tp), W, H, 2, flagship.rng.PRNGKey(0))
    tl = torch.mean(torch.from_numpy(weight) * (torch.log1p(torch.clamp(x, min=0.0))
                                                - torch.log1p(torch.from_numpy(target))) ** 2)
    tl.backward()
    assert abs(tl.item() - float(jl)) <= 1e-5 * float(jl), (tl.item(), float(jl))
    for f, g in jg.items():
        g = np.asarray(g)
        assert np.abs(tp[f].grad.numpy() - g).max() <= 1e-5 * np.abs(g).max(), f
