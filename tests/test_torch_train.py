"""The port's training step, Adam and fitting loop against the JAX
package's (make_train_step on a 1x1 mesh, optax.adam, optimize_scene).

Bounds:
- first-step gradients: each step is given an optimiser that returns zero
  updates and keeps the gradients it was handed as its state, so the state
  after one step is the gradient after the trainable filter, the mask and
  the non-finite count. Masked entries and untrained fields are exactly 0
  in both. On demo-box 16x12, n = 2, every key flips 1 to 5 of the 192
  lanes of a pass between XLA's FMA-contracted and unfused float32
  arithmetic (the knife-edge lanes of tests/test_megakernel.py's pin, here
  the glass sphere and box faces), and a flipped lane moves a pooled
  pixel's residual: each field's gradient within 0.1 of the field's
  largest entry (measured at most 0.058, log mat_color), losses within
  1e-3 relative. On dof 16x12, whose lanes do not flip at this key, the
  same step (every loss space, the clamp, the mask) within 1e-3 of each
  field's largest entry, losses within 1e-4 relative.
- Adam against optax.adam on identical gradients: bit for bit, with a
  float learning rate and with a schedule;
- step.many(k) against k calls of step, checkpoint resume against a
  straight run: bit for bit;
- a step whose gradient is not finite changes nothing, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from plutracer_tpu.parallel.mesh import make_mesh
from plutracer_tpu.parallel.sharded import get_params as jax_get_params
from plutracer_tpu.parallel.sharded import make_train_step as jax_make_train_step
from plutracer_tpu.render.renderer import render as jax_render
from plutracer_tpu.scene import compile_scene as jax_compile
from plutracer_tpu.scene import load_scene_file as jax_load
from plutracer_tpu_torch import rng
from plutracer_tpu_torch.diff.optim import Adam, adam_state_from_optax, apply_updates
from plutracer_tpu_torch.diff.optimize import InverseRenderConfig, optimize_scene
from plutracer_tpu_torch.parallel.sharded import (
    DIFFERENTIABLE_FIELDS,
    get_params,
    make_train_step,
    params_from_numpy,
    params_to_numpy,
)
from plutracer_tpu_torch.render.renderer import render
from plutracer_tpu_torch.scene import compile_scene, load_scene_file

W, H, N = 16, 12, 2
STEP_KW = dict(loss_downsample=2, loss_clamp=5.0, project_nonnegative=True,
               trainable=("mat_color", "light_intensity", "tex_c0"))


def jax_probe():
    """optax transformation: zero updates, the gradients as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


class Probe:
    """The port's counterpart of jax_probe (Adam's interface)."""

    def init(self, params):
        return {k: torch.zeros_like(v) for k, v in params.items()}

    def update(self, grads, state):
        return {k: torch.zeros_like(v) for k, v in grads.items()}, grads


def scenes(name):
    args = ["/res", f"{W}x{H}"]
    return (jax_compile(jax_load(f"scenes/{name}.urn", args)),
            compile_scene(load_scene_file(f"scenes/{name}.urn", args), device="cpu"))


@pytest.fixture(scope="module")
def demo():
    """Both scenes, a JAX target, perturbed numpy params and a mask that
    freezes the odd material rows."""
    js, ts = scenes("demo-box")
    target = np.asarray(jax_render(js, W, H, N, jax.random.PRNGKey(11))).reshape(-1, 3)
    params = {k: np.asarray(v) for k, v in jax_get_params(js).items()}
    params["mat_color"] = params["mat_color"] * 0.5
    rows = params["mat_color"].shape[0]
    mask = {"mat_color": np.repeat((np.arange(rows) % 2 == 0).astype(np.float32)[:, None], 3, 1)}
    return js, ts, target, params, mask


def first_step_grads(js, ts, target, params, mask, loss_space, **kw):
    jstep = jax_make_train_step(js, W, H, N, make_mesh((1, 1)), optimizer=jax_probe(),
                                loss_space=loss_space,
                                grad_mask={k: jnp.asarray(v) for k, v in mask.items()}, **kw)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jp, jg, jl = jstep(jparams, jstep.init(jparams), target, jax.random.PRNGKey(3), jnp.int32(1))
    tstep = make_train_step(ts, W, H, N, optimizer=Probe(), loss_space=loss_space,
                            grad_mask={k: torch.from_numpy(v) for k, v in mask.items()}, **kw)
    tparams = params_from_numpy(params)
    tp, tg, tl = tstep(tparams, tstep.init(tparams), torch.from_numpy(target), rng.PRNGKey(3), 1)
    for k in params:  # zero updates, projection of nonnegative params: unchanged
        assert np.array_equal(np.asarray(jp[k]), params[k]) and torch.equal(tp[k], tparams[k])
    return ({k: np.asarray(v) for k, v in jg.items()}, float(jl), params_to_numpy(tg), float(tl))


@pytest.mark.parametrize("loss_space", ["ab", "linear", "log"])
def test_first_step_grads_match_jax(demo, loss_space):
    js, ts, target, params, mask = demo
    jg, jl, tg, tl = first_step_grads(js, ts, target, params, mask, loss_space, **STEP_KW)
    assert abs(tl - jl) <= 1e-3 * abs(jl)
    for f in DIFFERENTIABLE_FIELDS:
        assert np.isfinite(tg[f]).all()
        if f not in STEP_KW["trainable"]:
            assert not tg[f].any() and not jg[f].any(), f
            continue
        if f in mask:
            frozen = mask[f] == 0
            assert not tg[f][frozen].any() and not jg[f][frozen].any(), f
        scale = float(np.abs(jg[f]).max())
        assert np.abs(tg[f] - jg[f]).max() <= 0.1 * scale, (f, np.abs(tg[f] - jg[f]).max(), scale)
    assert np.abs(tg["mat_color"]).max() > 0


@pytest.fixture(scope="module")
def dof():
    """dof's scenes, a JAX target, params at 0.8 of the scene's and the odd
    material rows frozen."""
    js, ts = scenes("dof")
    target = np.asarray(jax_render(js, W, H, N, jax.random.PRNGKey(11))).reshape(-1, 3)
    params = {k: np.asarray(v) * 0.8 for k, v in jax_get_params(js).items()}
    rows = params["mat_color"].shape[0]
    mask = {"mat_color": np.repeat((np.arange(rows) % 2 == 0).astype(np.float32)[:, None], 3, 1)}
    return js, ts, target, params, mask


@pytest.mark.parametrize("loss_space", ["ab", "linear", "log"])
def test_first_step_grads_match_jax_dof(dof, loss_space):
    js, ts, target, params, mask = dof
    jg, jl, tg, tl = first_step_grads(js, ts, target, params, mask, loss_space, **STEP_KW)
    assert abs(tl - jl) <= 1e-4 * abs(jl)
    for f in DIFFERENTIABLE_FIELDS:
        assert np.isfinite(tg[f]).all()
        if f not in STEP_KW["trainable"]:
            assert not tg[f].any() and not jg[f].any(), f
            continue
        if f in mask:
            frozen = mask[f] == 0
            assert not tg[f][frozen].any() and not jg[f][frozen].any(), f
        scale = float(np.abs(jg[f]).max())
        assert np.abs(tg[f] - jg[f]).max() <= 1e-3 * scale + 1e-12, (f, np.abs(tg[f] - jg[f]).max(), scale)
    assert np.abs(tg["mat_color"]).max() > 0


@pytest.mark.parametrize("schedule", [False, True])
def test_adam_bit_equal_to_optax(schedule):
    g = np.random.default_rng(0)
    shapes = {"mat_color": (5, 3), "light_intensity": (1, 3)}
    params = {k: g.uniform(0.0, 1.0, s).astype(np.float32) for k, s in shapes.items()}
    if schedule:
        sched = optax.exponential_decay(3e-2, transition_steps=2, decay_rate=0.5)
        jopt = optax.adam(sched)
        topt = Adam(lambda count: float(sched(int(count))))
    else:
        jopt, topt = optax.adam(3e-2), Adam(3e-2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init(jp)
    tp = params_from_numpy(params)
    ts = topt.init(tp)
    for _ in range(6):
        grads = {k: (g.normal(size=s) * 10.0 ** g.integers(-6, 3)).astype(np.float32)
                 for k, s in shapes.items()}
        upd, js = jopt.update({k: jnp.asarray(v) for k, v in grads.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        tu, ts = topt.update(params_from_numpy(grads), ts)
        tp = apply_updates(tp, tu)
        for k in shapes:
            assert np.array_equal(tp[k].numpy(), np.asarray(jp[k])), k
    carried = adam_state_from_optax(js)
    assert int(carried.count) == int(ts.count) == 6
    for k in shapes:
        assert torch.equal(carried.mu[k], ts.mu[k]) and torch.equal(carried.nu[k], ts.nu[k])


def port_setup():
    ts = compile_scene(load_scene_file("scenes/demo-box.urn", ["/res", f"{W}x{H}"]), device="cpu")
    target = render(ts, W, H, N, rng.PRNGKey(11)).reshape(-1, 3)
    params = dict(get_params(ts))
    params["mat_color"] = params["mat_color"] * 0.5
    return ts, target, params


def test_many_equals_single_steps():
    ts, target, params = port_setup()
    step = make_train_step(ts, W, H, N, optimizer=Adam(1e-2), **STEP_KW)
    key0 = rng.PRNGKey(5)
    p, s = params, step.init(params)
    losses = []
    for i in range(2, 5):
        p, s, loss = step(p, s, target, rng.fold_in(key0, i), i % (N * N))
        losses.append(loss)
    mp, ms, mlosses, nf = step.many(params, step.init(params), target, key0, 2, 3)
    assert torch.equal(mlosses, torch.stack(losses)) and not nf.any()
    for k in p:
        assert torch.equal(mp[k], p[k]), k
    assert torch.equal(ms.count, s.count) and int(s.count) == 3
    for k in p:
        assert torch.equal(ms.mu[k], s.mu[k]) and torch.equal(ms.nu[k], s.nu[k])


def test_nonfinite_step_is_rejected_whole():
    ts, target, params = port_setup()
    step = make_train_step(ts, W, H, N, optimizer=Adam(1e-2))
    p1, s1, _ = step(params, step.init(params), target, rng.PRNGKey(1), 0)  # one good step
    bad_target = target.clone()
    bad_target[7] = float("nan")
    p2, s2, losses, nf = step.many(p1, s1, bad_target, rng.PRNGKey(2), 0, 2)
    assert (nf > 0).all() and torch.isnan(losses).all()
    for k in p1:
        assert torch.equal(p2[k], p1[k]), k
        assert torch.equal(s2.mu[k], s1.mu[k]) and torch.equal(s2.nu[k], s1.nu[k]), k
    assert torch.equal(s2.count, s1.count) and int(s2.count) == 1


def test_optimize_resume_bit_exact(tmp_path):
    """Mirror of tests/test_optimize.py:93: a run stopped after 7 of 10
    steps (chunks 1 + 3 + 3) and resumed from its checkpoint equals a
    straight run, parameters and loss history bit for bit."""
    ts, target, params = port_setup()
    base = dict(width=W, height=H, n=N, learning_rate=3e-2, log_every=3,
                trainable=("mat_color",), loss_downsample=2)
    ref_params, ref_losses = optimize_scene(ts, target.reshape(H, W, 3),
                                            InverseRenderConfig(steps=10, **base),
                                            init_params=params)
    ck = str(tmp_path / "train.ckpt.npz")
    calls = []
    optimize_scene(ts, target.reshape(H, W, 3),
                   InverseRenderConfig(steps=7, checkpoint_path=ck, **base), init_params=params,
                   callback=lambda i, loss, p: calls.append(i))
    assert calls == [0, 3, 6]
    stats = {}
    got_params, got_losses = optimize_scene(
        ts, target.reshape(H, W, 3), InverseRenderConfig(steps=10, checkpoint_path=ck, **base),
        init_params=params, stats_out=stats)
    assert got_losses == ref_losses and len(got_losses) == 10
    for k in ref_params:
        assert torch.equal(got_params[k], ref_params[k]), k
    assert stats == {"nonfinite_grad_frac_mean": 0.0, "nonfinite_grad_frac_max": 0.0}


def test_optimize_checkpoint_rejects_foreign_seed(tmp_path):
    """Mirror of tests/test_optimize.py:137."""
    ts, target, params = port_setup()
    ck = str(tmp_path / "t.ckpt.npz")
    cfg = InverseRenderConfig(width=W, height=H, n=N, steps=2, log_every=2,
                              trainable=("tex_c1",), checkpoint_path=ck)
    optimize_scene(ts, target.reshape(H, W, 3), cfg, init_params=params)
    with pytest.raises(ValueError, match="seed"):
        optimize_scene(ts, target.reshape(H, W, 3), dataclasses.replace(cfg, seed=5, steps=4),
                       init_params=params)
