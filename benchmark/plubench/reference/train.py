"""The inverse-rendering step of one card (a 1x1 mesh), in plain PyTorch:
the reference of make_train_step's step.

Step i of a run keyed key0 renders, with the parameters, one stratified
pass of every pixel at stratum i % n^2 keyed k = fold_in(fold_in(fold_in(
key0, i), 0), 0) (the mesh position (0, 0)), or two ("ab": keyed by
split(k)), and takes the loss against the target:

- "log": the mean of (log1p(max(c, 0)) - log1p(max(t, 0)))^2 over the
  pixels' channels; "linear": the mean of (c - t)^2;
- "ab": the mean of (a - t)(b - t) over the channels of the pixels,
  average-pooled over k x k blocks first (loss_downsample = k);

c and t clamped at loss_clamp first where it is > 0. It differentiates
the loss with respect to the trainable fields under torch's deterministic
algorithms, masks the gradients (where(mask > 0, g, 0)), counts and
zeroes the ones that are not finite, and hands them to the optimiser
(project_nonnegative clamps the new parameters at 0); a step with any
non-finite entry is rejected whole. Divisions by counts divide by float32
tensors (over).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from plubench.reference import rng
from plubench.reference.diff.optim import apply_updates
from plubench.reference.render.integrator import ray_color_plain
from plubench.reference.render.renderer import (
    camera_rays_plain,
    launch_draws,
    over,
    pixel_centers,
)
from plubench.reference.semantics import DEFAULT_OPTIONS

FIELDS = ("mat_color", "light_intensity", "tex_c0", "tex_c1")


def trace_stratum(scene, px0, words, stratum: int, n: int, bf16: bool = False):
    """The (B, 3) radiance of one stratified sample per pixel of px0 from
    the stratum cell, keyed `words` itself. bf16 rounds it to bfloat16."""
    keys, u = launch_draws([words], px0.shape[0], DEFAULT_OPTIONS.max_bounces, px0.device)
    o, d = camera_rays_plain(scene.camera, px0, keys, [stratum], n)
    c = ray_color_plain(scene, o, d, u)
    return c.to(torch.bfloat16).to(torch.float32) if bf16 else c


@dataclasses.dataclass(frozen=True)
class Loss:
    space: str = "log"  # "log", "linear" or "ab"
    downsample: int = 1  # "ab" only: k x k average pooling
    clamp: float = 0.0
    project_nonnegative: bool = False


def loss_of(sc, px0, words, stratum: int, n: int, target, loss: Loss, width: int, height: int,
            bf16: bool = False):
    clampf = (lambda x: torch.clamp(x, max=loss.clamp)) if loss.clamp > 0 else (lambda x: x)
    if loss.space == "ab":
        wa, wb = rng.split_words(words, 2)
        xa, xb, tl = (clampf(trace_stratum(sc, px0, wa, stratum, n, bf16)),
                      clampf(trace_stratum(sc, px0, wb, stratum, n, bf16)), clampf(target))
        k = loss.downsample
        if k > 1:
            pool = lambda x: over(x.reshape(height // k, k, width // k, k, 3).sum(dim=(1, 3)),
                                  k * k).reshape(-1, 3)
            xa, xb, tl = pool(xa), pool(xb), pool(tl)
        da, db = xa - tl, xb - tl
        return over(torch.sum(da * db), da.shape[0] * 3)
    c, tl = clampf(trace_stratum(sc, px0, words, stratum, n, bf16)), clampf(target)
    if loss.space == "log":
        c, tl = torch.log1p(torch.clamp(c, min=0.0)), torch.log1p(torch.clamp(tl, min=0.0))
    dc = c - tl
    return over(torch.sum(dc * dc), c.shape[0] * 3)


def step(scene, params: Dict[str, torch.Tensor], opt_state, optimizer, target_flat, key0_words,
         i: int, width: int, height: int, n: int, trainable, grad_mask: Optional[dict] = None,
         loss: Loss = Loss(), bf16: bool = False):
    """(params, opt_state, loss, gradients as the optimiser got them) after
    step i."""
    words = rng.fold_in_words(rng.fold_in_words(rng.fold_in_words(key0_words, i), 0), 0)
    leaves = {f: params[f].detach().requires_grad_(f in trainable) for f in FIELDS}
    sc = dataclasses.replace(scene, **leaves)
    px0 = pixel_centers(width, height, scene.prim_a.device)
    prev = torch.are_deterministic_algorithms_enabled()
    prev_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with torch.enable_grad():
            value = loss_of(sc, px0, words, i % (n * n), n, target_flat, loss, width, height, bf16)
            wrt = [leaves[f] for f in FIELDS if f in trainable]
            got = iter(torch.autograd.grad(value, wrt, allow_unused=True, materialize_grads=True))
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=prev_warn)
    grads = {f: next(got) if f in trainable else torch.zeros_like(leaves[f]) for f in FIELDS}
    grads = {f: torch.where(grad_mask[f] > 0, g, 0.0) if grad_mask and f in grad_mask else g
             for f, g in grads.items()}
    nf = sum((~torch.isfinite(g)).sum().to(torch.float32) for g in grads.values())
    grads = {f: over(torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0), 1)
             for f, g in grads.items()}
    value = over(value.detach(), 1)
    nf_frac = over(nf, sum(g.numel() for g in grads.values()))
    updates, new_state = optimizer.update(grads, opt_state)
    new_params = apply_updates(params, updates)
    if loss.project_nonnegative:
        new_params = {f: torch.clamp(x, min=0.0) for f, x in new_params.items()}
    if bool(nf_frac > 0):
        return params, opt_state, value, grads
    return new_params, new_state, value, grads
