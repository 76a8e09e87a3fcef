"""Gradients of the port: the guarded ops, pixel-loss gradients against
jax.grad of the same render_pass loss and against central finite
differences, finite gradients on the repo's scenes, remat_bounces, and the
kernel path's autograd Function.

The loss is tests/test_grad.py's make_loss: one render_pass at 24x18,
n = 2, stratum 1, pixels clipped at 20, mean of squares. The port draws
the JAX package's random numbers (rng.py), so both differentiate the same
estimator. Bounds:
- port vs jax.grad: rtol 1e-3 per entry on dof and textured0 (atol 1e-6
  of the field's largest entry, for entries that are exactly 0 in one
  package); demo-box, whose glass sphere and box faces flip knife-edge
  lanes between XLA's FMA-contracted and unfused float32 arithmetic, at
  1e-3 of the field's largest entry (measured 1.6e-5 at this size and key);
- central finite differences: rtol 2e-2, atol 1e-6 (tests/test_grad.py);
- remat_bounces and the autograd Function against plain autograd: bit for
  bit (the same operations in the same order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plutracer_tpu.parallel.sharded import apply_params as jax_apply_params
from plutracer_tpu.parallel.sharded import get_params as jax_get_params
from plutracer_tpu.render.renderer import render_pass as jax_render_pass
from plutracer_tpu.scene import compile_scene as jax_compile
from plutracer_tpu.scene import load_scene_file as jax_load
from plutracer_tpu_torch import rng
from plutracer_tpu_torch.ops import safemath
from plutracer_tpu_torch.parallel.sharded import (
    DIFFERENTIABLE_FIELDS,
    apply_params,
    get_params,
    params_from_numpy,
)
from plutracer_tpu_torch.render.renderer import render_pass
from plutracer_tpu_torch.scene import compile_scene, load_scene_file
from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS
from torch_cpu import one_torch_thread  # noqa: F401 (autouse: one torch thread)

W, H, N, SEED = 24, 18, 2, 0


def port_loss(scene, w=W, h=H, n=N, seed=SEED, options=DEFAULT_OPTIONS, dtype=torch.float32):
    """make_loss's loss; dtype is the type the squares are summed in."""
    def loss(params):
        img = render_pass(apply_params(scene, params), rng.PRNGKey(seed), 1, w, h, n, options)
        img = torch.clamp(img, max=20.0).to(dtype)
        return torch.sum(img * img) / img.numel()

    return loss


def port_grads(loss, params):
    leaves = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    g = torch.autograd.grad(loss(leaves), list(leaves.values()))
    return dict(zip(leaves, g))


@pytest.fixture(scope="module")
def jax_grads():
    """name -> (port scene, numpy params, jax.grad of the loss)."""
    out = {}
    for name in ("demo-box", "dof", "textured0"):
        args = ["/res", f"{W}x{H}"]
        js = jax_compile(jax_load(f"scenes/{name}.urn", args))
        key = jax.random.PRNGKey(SEED)

        def loss(params, js=js, key=key):
            img = jnp.minimum(jax_render_pass(jax_apply_params(js, params), key, jnp.int32(1),
                                              W, H, N), 20.0)
            return jnp.sum(img * img) / img.size

        params = jax_get_params(js)
        g = jax.grad(loss)(params)
        out[name] = (compile_scene(load_scene_file(f"scenes/{name}.urn", args), device="cpu"),
                     {k: np.asarray(v) for k, v in params.items()},
                     {k: np.asarray(v) for k, v in g.items()})
    return out


def test_safemath_derivative_guards():
    """Mirror of tests/test_grad.py:102-147: primals bit-identical to the
    plain ops; derivatives finite (exact zeros) on zero-cotangent lanes
    where the plain ops' are not; exact away from the floors."""
    x = torch.tensor(3.0)

    def grad_of(f, v):
        y = torch.tensor(v, dtype=torch.float32, requires_grad=True)
        (g,) = torch.autograd.grad(torch.where(torch.tensor(False), f(y), 0.0).sum(), y)
        return g

    # (the plain rules' 0 * x / y**2 is NaN where y**2 flushes to zero, as
    # it does on a flush-to-zero device; the guarded rules never square y)
    assert grad_of(lambda y: safemath.safe_div(x, y), 1e-20).item() == 0.0
    assert grad_of(safemath.safe_recip, 1e-20).item() == 0.0
    assert grad_of(safemath.safe_rsqrt, 1e-30).item() == 0.0

    ys = torch.tensor([1e-20, 1e-3, 0.5, -2.0, 3e7])
    assert torch.equal(safemath.safe_div(x, ys), x / ys)
    assert torch.equal(safemath.safe_recip(ys), 1.0 / ys)
    us = torch.tensor([1e-30, 1e-6, 1.0, 9.0])
    assert torch.equal(safemath.safe_rsqrt(us), torch.rsqrt(us))
    # with gradients on, the primals are still the plain ops'
    yg = ys.clone().requires_grad_()
    assert torch.equal(safemath.safe_div(x, yg).detach(), x / ys)

    for y0 in (0.37, -1.4):
        y = torch.tensor(y0, requires_grad=True)
        (g,) = torch.autograd.grad(safemath.safe_div(x, y), y)
        assert abs(g.item() - (-3.0 / y0 ** 2)) < 1e-3 * abs(g.item())
    u = torch.tensor(4.0, requires_grad=True)
    (g,) = torch.autograd.grad(safemath.safe_rsqrt(u), u)
    assert abs(g.item() - (-0.5 * 4.0 ** -1.5)) < 1e-6
    # broadcast operands get gradients of their own shape
    a = torch.ones(4, 3, requires_grad=True)
    b = torch.full((4, 1), 2.0, requires_grad=True)
    ga, gb = torch.autograd.grad(safemath.safe_div(a, b).sum(), (a, b))
    assert ga.shape == a.shape and gb.shape == b.shape
    assert torch.allclose(gb, torch.full((4, 1), -0.75))


@pytest.mark.parametrize("name", ["demo-box", "dof", "textured0"])
def test_grad_matches_jax(jax_grads, name):
    scene, params_np, want = jax_grads[name]
    got = port_grads(port_loss(scene), params_from_numpy(params_np))
    for f in DIFFERENTIABLE_FIELDS:
        g, w = got[f].numpy(), want[f]
        assert np.isfinite(g).all(), f
        scale = float(np.abs(w).max())
        if name == "demo-box":
            assert np.abs(g - w).max() <= 1e-3 * scale + 1e-12, (f, np.abs(g - w).max(), scale)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-6 * scale + 1e-12, err_msg=f)


def fd_grad(loss, params, field, idx, eps=1e-2):
    # relative step: parameters span 0.05 (albedo) to 1e4 (emission)
    eps = eps * max(0.1, abs(float(params[field][idx])))
    plus, minus = dict(params), dict(params)
    delta = torch.zeros_like(params[field])
    delta[idx] = eps
    plus[field] = params[field] + delta
    minus[field] = params[field] - delta
    with torch.no_grad():
        return (float(loss(plus)) - float(loss(minus))) / (2 * eps)


@pytest.mark.parametrize("name", ["demo-box", "dof", "textured0"])
def test_grad_matches_finite_differences(name):
    """One central difference per field, at the field's largest gradient
    entry (fields whose gradient is 0 everywhere are skipped: unreachable
    from these pixels). The squares are summed in float64 here: a float32
    sum of 1,296 pixels moves by about 2e-6 of the loss between the two
    evaluations, as much as the smallest fields' whole difference."""
    scene = compile_scene(load_scene_file(f"scenes/{name}.urn", ["/res", f"{W}x{H}"]), device="cpu")
    loss = port_loss(scene, dtype=torch.float64)
    params = get_params(scene)
    g = port_grads(loss, params)
    checked = 0
    for f in DIFFERENTIABLE_FIELDS:
        if not g[f].abs().max() > 0:
            continue
        idx = np.unravel_index(int(g[f].abs().argmax()), g[f].shape)
        g_fd = fd_grad(loss, params, f, idx)
        np.testing.assert_allclose(g[f][idx].item(), g_fd, rtol=2e-2, atol=1e-6, err_msg=f)
        checked += 1
    assert checked >= 3


@pytest.mark.parametrize("name", ["demo-box", "dof", "textured0", "sphere-grid"])
def test_grads_finite_on_repo_scenes(name):
    scene = compile_scene(load_scene_file(f"scenes/{name}.urn", ["/res", "16x12"]), device="cpu")
    g = port_grads(port_loss(scene, 16, 12, 1), get_params(scene))
    for k, v in g.items():
        assert torch.isfinite(v).all(), f"{name}: non-finite gradient in {k}"
    assert any(v.abs().max() > 0 for v in g.values())


def test_remat_bounces_bit_equal():
    scene = compile_scene(load_scene_file("scenes/demo-box.urn", ["/res", "16x12"]), device="cpu")
    params = get_params(scene)
    plain = port_grads(port_loss(scene, 16, 12), params)
    remat = port_grads(port_loss(scene, 16, 12, options=DEFAULT_OPTIONS.replace(
        remat_bounces=True)), params)
    for k in plain:
        assert torch.equal(plain[k], remat[k]), k


def test_kernel_function_matches_plain_autograd():
    """integrator.KernelRadiance (the kernel path with a plain backward; on
    CPU tensors its forward is the plain version) against autograd through
    the plain path, for the scene leaves and the rays."""
    from plutracer_tpu_torch.render.integrator import DIFF_LEAVES, KernelRadiance, ray_color

    scene = compile_scene(load_scene_file("scenes/demo-box.urn", ["/res", "12x8"]), device="cpu")
    g = np.random.default_rng(0)
    B = 96
    o0 = torch.from_numpy(g.uniform(-1.0, 1.0, (B, 3)).astype(np.float32)) + scene.camera.pos
    d0 = torch.nn.functional.normalize(torch.from_numpy(g.normal(size=(B, 3)).astype(np.float32)),
                                       dim=-1)
    key = rng.PRNGKey(3)
    weights = torch.from_numpy(g.uniform(0.5, 1.5, (B, 3)).astype(np.float32))

    def grads(backend):
        leaves = {k: getattr(scene, k).clone().requires_grad_() for k in DIFF_LEAVES}
        o, d = o0.clone().requires_grad_(), d0.clone().requires_grad_()
        sc = dataclasses.replace(scene, **leaves)
        L = ray_color(sc, o, d, key, DEFAULT_OPTIONS.replace(integrator_backend=backend))
        got = torch.autograd.grad((L * weights).sum(), [o, d, *leaves.values()])
        return L.detach(), got, L.grad_fn

    L_k, g_k, fn = grads("kernel")
    L_p, g_p, _ = grads("plain")
    assert type(fn).__name__ == KernelRadiance.__name__ + "Backward"
    assert torch.equal(L_k, L_p)
    for a, b in zip(g_k, g_p):
        assert torch.equal(a, b)
    assert any(x.abs().max() > 0 for x in g_k[2:])
