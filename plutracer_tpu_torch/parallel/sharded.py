"""Inverse rendering on one device: the differentiable scene parameters and
the training step.

The port of the training half of plutracer_tpu/parallel/sharded.py
(DIFFERENTIABLE_FIELDS, get_params, apply_params, make_train_step) on one
device. Keys are derived as the JAX step derives them on a 1x1 mesh
(fold_in(fold_in(key, tile 0), spp 0)), so the two steps draw the same
random numbers. Multi-device rendering and training (render_sharded, the
mesh) are not here.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from plutracer_tpu_torch import rng
from plutracer_tpu_torch.diff.optim import Adam, apply_updates
from plutracer_tpu_torch.render.integrator import DIFF_LEAVES
from plutracer_tpu_torch.render.renderer import _trace_stratum, over, pixel_centers
from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS, RenderOptions

DIFFERENTIABLE_FIELDS = DIFF_LEAVES  # ("mat_color", "light_intensity", "tex_c0", "tex_c1")


def get_params(scene) -> Dict[str, torch.Tensor]:
    """The differentiable parameters of a scene, by field name."""
    return {f: getattr(scene, f) for f in DIFFERENTIABLE_FIELDS}


def apply_params(scene, params: Dict[str, torch.Tensor]):
    """A scene with the parameter tensors swapped in."""
    return dataclasses.replace(scene, **params)


def params_from_numpy(params: Dict[str, np.ndarray], device="cpu") -> Dict[str, torch.Tensor]:
    """float32 tensors on `device` from a dict of arrays (e.g. the JAX
    package's get_params, read with numpy)."""
    return {k: torch.from_numpy(np.array(v, np.float32)).to(device) for k, v in params.items()}


def params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


@contextlib.contextmanager
def _deterministic():
    """torch's deterministic algorithms for the duration: the backward of a
    table row gather accumulates with atomics on a CUDA device, which sum
    in a different order from run to run; the sorted accumulation makes a
    step, and so a resumed run, reproducible bit for bit."""
    prev = torch.are_deterministic_algorithms_enabled()
    prev_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=prev_warn)


def _keep(bad: torch.Tensor, old, new):
    """`old` where `bad`, else `new`, leaf by leaf over matching dicts,
    tuples (NamedTuples included) and tensors."""
    if isinstance(old, dict):
        return {k: _keep(bad, old[k], new[k]) for k in old}
    if isinstance(old, tuple):
        vals = [_keep(bad, a, b) for a, b in zip(old, new)]
        return type(old)(*vals) if hasattr(old, "_fields") else tuple(vals)
    return torch.where(bad, old, new)


def make_train_step(
    scene,
    width: int,
    height: int,
    n: int,
    optimizer=None,
    options: RenderOptions = DEFAULT_OPTIONS,
    loss_space: str = "ab",
    trainable=DIFFERENTIABLE_FIELDS,
    grad_mask: Optional[Dict[str, torch.Tensor]] = None,
    project_nonnegative: bool = False,
    loss_downsample: int = 1,
    loss_clamp: float = 0.0,
):
    """An inverse-rendering step on the scene's device.

    step(params, opt_state, target_flat, key, stratum) -> (params,
    opt_state, loss): render one stratified pass (two independent ones for
    "ab") with `params`, compare with the (H*W, 3) linear target,
    differentiate, and apply the optimiser (default Adam(1e-2)).

    loss_space: "ab", the dual-buffer product loss (X_a - t).(X_b - t),
    whose expectation is (E[X] - t)^2 per pixel; "linear", the MSE of one
    pass; "log", the MSE of log1p radiances. loss_downsample = k > 1
    average-pools rendered and target images over k x k blocks first;
    loss_clamp > 0 clamps both at that radiance (firefly clamp). trainable:
    fields that are updated (the others get zero gradients); grad_mask:
    per-entry masks applied with where(mask > 0, g, 0), so a masked entry
    is 0 even where its gradient is not finite. The fraction of gradient
    entries that are not finite after the filter and the mask is counted,
    they are zeroed, and a step with any is rejected whole: parameters and
    optimiser state (Adam's count included) stay as they were.
    project_nonnegative clamps updated parameters at 0.

    The integrator is pinned to the plain path (on a CUDA device every
    closest-hit query still runs K1): the kernel path's backward re-runs
    the plain path anyway (render/integrator.KernelRadiance).

    step.init(params) -> optimiser state. step.many(params, opt_state,
    target_flat, key0, start, k) -> (params, opt_state, losses (k,),
    nonfinite fractions (k,)): steps start..start+k-1, step i keyed
    fold_in(key0, i) at stratum i % (n * n), bit-equal to k calls of step.
    step.ab_loss(xa, xb, target_flat) is the ab loss of two passes.
    step.loss_and_grads(params, target_flat, key, stratum) -> (loss, grads,
    nonfinite fraction) and step.apply(params, opt_state, grads, nf_frac)
    -> (params, opt_state) are the step's two halves.
    """
    optimizer = optimizer if optimizer is not None else Adam(1e-2)
    options = options.replace(integrator_backend="plain")
    kk = loss_downsample
    if kk > 1 and (height % kk or width % kk):
        raise ValueError(f"loss_downsample {kk} must divide the image ({width}x{height})")
    if loss_space not in ("ab", "linear", "log"):
        raise ValueError(f"loss_space must be 'ab', 'linear' or 'log', got {loss_space!r}")
    px0 = pixel_centers(width, height, scene.device)
    fields = tuple(DIFFERENTIABLE_FIELDS)
    n_entries = sum(getattr(scene, f).numel() for f in fields)

    def pool(x):
        # the block mean as a sum divided by the count (JAX's mean): torch's
        # CUDA mean multiplies by the count's reciprocal
        return over(x.reshape(height // kk, kk, width // kk, kk, 3).sum(dim=(1, 3)),
                    kk * kk).reshape(-1, 3)

    def clampf(x):
        return torch.clamp(x, max=loss_clamp) if loss_clamp > 0 else x

    def ab_loss(xa, xb, target):
        """The dual-buffer loss of two (H*W, 3) passes: clamp, pool, then
        the mean of (xa - t)(xb - t) over the pooled entries."""
        xa, xb, tl = clampf(xa), clampf(xb), clampf(target)
        if kk > 1:
            xa, xb, tl = pool(xa), pool(xb), pool(tl)
        da, db = xa - tl, xb - tl
        return over(torch.sum(da * db), da.shape[0] * 3)

    def loss_and_grads(params, target, key, stratum):
        k = rng.fold_in(rng.fold_in(key, 0), 0)  # tile 0, spp 0 of a 1x1 mesh
        leaves = {f: params[f].detach().requires_grad_(f in trainable) for f in fields}
        sc = apply_params(scene, leaves)
        with torch.enable_grad(), _deterministic():
            if loss_space == "ab":
                ka, kb = rng.split(k)
                loss = ab_loss(_trace_stratum(sc, px0, ka, stratum, n, options),
                               _trace_stratum(sc, px0, kb, stratum, n, options), target)
            else:
                c, tl = clampf(_trace_stratum(sc, px0, k, stratum, n, options)), clampf(target)
                if loss_space == "log":
                    c, tl = torch.log1p(torch.clamp(c, min=0.0)), torch.log1p(torch.clamp(tl, min=0.0))
                dc = c - tl
                loss = over(torch.sum(dc * dc), px0.shape[0] * 3)
            wrt = [leaves[f] for f in fields if f in trainable]
            got = iter(torch.autograd.grad(loss, wrt, allow_unused=True, materialize_grads=True)
                       if wrt else ())
        grads = {f: next(got) if f in trainable else torch.zeros_like(leaves[f]) for f in fields}
        if grad_mask is not None:
            grads = {f: torch.where(grad_mask[f] > 0, g, 0.0) if f in grad_mask else g
                     for f, g in grads.items()}
        nf_count = sum((~torch.isfinite(g)).sum().to(torch.float32) for g in grads.values())
        grads = {f: torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0) for f, g in grads.items()}
        return loss.detach(), grads, over(nf_count, n_entries)

    def apply(params, opt_state, grads, nf_frac):
        updates, new_state = optimizer.update(grads, opt_state)
        new_params = apply_updates(params, updates)
        if project_nonnegative:
            new_params = {f: torch.clamp(x, min=0.0) for f, x in new_params.items()}
        # reject the whole step (parameters and optimiser state, the
        # count included) when the backward left non-finite entries
        bad = nf_frac > 0.0
        return _keep(bad, params, new_params), _keep(bad, opt_state, new_state)

    def one(params, opt_state, target, key, stratum):
        loss, grads, nf_frac = loss_and_grads(params, target, key, stratum)
        params, opt_state = apply(params, opt_state, grads, nf_frac)
        return params, opt_state, loss, nf_frac

    def step(params, opt_state, target_flat, key, stratum: int):
        params, opt_state, loss, _ = one(params, opt_state, target_flat, key, int(stratum))
        return params, opt_state, loss

    def many(params, opt_state, target_flat, key0, start: int, k_steps: int):
        losses, nf_fracs = [], []
        for i in range(start, start + k_steps):
            params, opt_state, loss, nf = one(params, opt_state, target_flat,
                                              rng.fold_in(key0, i), i % (n * n))
            losses.append(loss)
            nf_fracs.append(nf)
        return params, opt_state, torch.stack(losses), torch.stack(nf_fracs)

    step.init = optimizer.init
    step.many = many
    step.ab_loss = ab_loss
    # the two halves of a step, for timing them apart
    step.loss_and_grads = loss_and_grads
    step.apply = apply
    return step
