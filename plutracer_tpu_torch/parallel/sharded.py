"""Sharded rendering and inverse rendering over a (tiles, spp) mesh.

The port of plutracer_tpu/parallel/sharded.py over parallel/mesh.Mesh in
place of shard_map. Position (ti, si) of the mesh owns tile ti's
contiguous rows of the (zero-padded) pixel list and, in a render, spp
block si's contiguous strata; its key is fold_in(fold_in(key, ti), si),
so the port draws the random numbers the JAX package draws at every
position. Forward: each position sums its strata; the spp partials are
summed in si order. Backward: each position differentiates its local
loss; losses and gradients are summed over tiles in ti order, then
averaged over spp. Every process computes its own positions, all-gathers
every position's partial (parallel/mesh.gather) and reduces them in mesh
order, so a result does not depend on how the positions are split over
processes; the optimiser then runs identically on every process.

One difference from the JAX package: render_sharded traces exactly the
n^2 strata. The JAX code pads the strata to a multiple of the spp axis
with stratum 0 and, though its comment says padding contributes nothing,
adds those samples in (its valid mask is stratum < spp, which a padding
0 passes).

A train step's layers are spans of utils/profiling (recorded while a
profiler runs): ``plu.train.step`` (one step, a request), and inside it
``plu.train.forward`` (the plain forward under autograd, K1's queries),
``plu.train.backward`` (torch.autograd.grad), ``plu.train.filter`` (the
mask, the non-finite count, nan_to_num), ``plu.train.reduce`` (the gather
and the reduction over positions) and ``plu.train.optimizer``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Dict, Optional

import numpy as np
import torch

from plutracer_tpu_torch import rng
from plutracer_tpu_torch.diff.optim import Adam, apply_updates
from plutracer_tpu_torch.parallel.mesh import Mesh, gather, make_mesh, scene_replicas, single
from plutracer_tpu_torch.render.integrator import DIFF_LEAVES
from plutracer_tpu_torch.render.renderer import (
    _trace_stratum,
    over,
    pixel_centers,
    stratum_launches,
)
from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS, RenderOptions
from plutracer_tpu_torch.utils import profiling

DIFFERENTIABLE_FIELDS = DIFF_LEAVES  # ("mat_color", "light_intensity", "tex_c0", "tex_c1")


def _pad_rows(x: torch.Tensor, mult: int) -> torch.Tensor:
    """x with zero rows appended to a multiple of `mult` rows."""
    pad = (-x.shape[0]) % mult
    return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))]) if pad else x


def _sum(xs):
    """The sum of a list of tensors, added in list order."""
    return functools.reduce(torch.add, xs)


def _layout(scene, mesh: Mesh, width: int, height: int):
    """(rows, scenes, px_pad) of this process's positions: the rows of a
    tile, the scene on each of their devices, and each device's pixel
    centres padded with zeros to a multiple of the tiles axis."""
    d_tiles = mesh.shape["tiles"]
    devs = list(dict.fromkeys(dev for _, _, dev in mesh.local()))
    scenes = dict(zip(devs, scene_replicas(scene, devs)))
    px_pad = {d: _pad_rows(pixel_centers(width, height, d), d_tiles) for d in devs}
    return -(-width * height // d_tiles), scenes, px_pad


def render_sharded(scene, width: int, height: int, n: int, key, mesh: Optional[Mesh] = None,
                   options: RenderOptions = DEFAULT_OPTIONS) -> torch.Tensor:
    """The linear (H, W, 3) image of n^2 strata, split over `mesh`
    (default make_mesh(): every visible card on `tiles`), on the scene's
    device.

    The pixels are padded with zeros to a multiple of the tiles axis;
    position (ti, si) traces tile ti's rows for spp block si's strata
    (ceil(n^2 / spp) strata a block, the last one short: no padding
    stratum is traced), its j-th stratum keyed fold_in(shard key, j), on
    the kernel path strata_per_launch strata a launch. Each position sums
    its strata in order; the partials are summed over spp in si order, the
    tiles joined, the padding dropped and the sum divided by n^2. No
    position waits for another before the gather."""
    mesh = make_mesh() if mesh is None else mesh
    d_tiles, d_spp = mesh.shape["tiles"], mesh.shape["spp"]
    spp = n * n
    block = -(-spp // d_spp)
    rows, scenes, px_pad = _layout(scene, mesh, width, height)
    partials = {}
    for ti, si, dev in mesh.local():
        shard_key = rng.fold_in(rng.fold_in(key, ti), si)
        strata = range(si * block, min((si + 1) * block, spp))
        acc = torch.zeros((rows, 3), device=dev)
        for launch in stratum_launches(scenes[dev], shard_key, list(enumerate(strata)),
                                       px_pad[dev][ti * rows:(ti + 1) * rows], n, options):
            for L in launch:
                acc = acc + L
        partials[(ti, si)] = acc
    parts = gather(mesh, partials, (rows, 3), scene.device)
    tiles = [_sum(parts[ti * d_spp:(ti + 1) * d_spp]) for ti in range(d_tiles)]
    return over(torch.cat(tiles)[:width * height], spp).reshape(height, width, 3)


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
    """torch's deterministic algorithms for the duration: torch operators
    that would accumulate with atomics on a CUDA device, which sum in a
    different order from run to run, take their deterministic versions, so
    a step, and so a resumed run, is reproducible bit for bit. The table
    row gathers' backward is G1 on a card (ops/cuda/row_grad_kernel),
    deterministic by construction."""
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
    mesh: Optional[Mesh] = None,
    optimizer=None,
    options: RenderOptions = DEFAULT_OPTIONS,
    loss_space: str = "ab",
    trainable=DIFFERENTIABLE_FIELDS,
    grad_mask: Optional[Dict[str, torch.Tensor]] = None,
    project_nonnegative: bool = False,
    loss_downsample: int = 1,
    loss_clamp: float = 0.0,
):
    """An inverse-rendering step over `mesh` (default: the 1x1 mesh of the
    scene's device).

    step(params, opt_state, target_flat, key, stratum) -> (params,
    opt_state, loss): every position renders one stratified pass (two
    independent ones for "ab") of its tile's rows with `params`, compares
    it with those rows of the (H*W, 3) linear target (zero-padded like the
    pixels), differentiates, and the reduced gradients go to the optimiser
    (default Adam(1e-2)), once, on the scene's device of every process.

    loss_space: "ab", the dual-buffer product loss (X_a - t).(X_b - t),
    whose expectation is (E[X] - t)^2 per pixel; "linear", the MSE of one
    pass; "log", the MSE of log1p radiances. A position's ab loss is
    normalised by its (pooled) rows * 3 * tiles, the others by the padded
    rows * 3, so the sum over tiles is the image's mean; the sums are then
    averaged over spp. loss_downsample = k > 1 average-pools rendered and
    target images over k x k blocks first (a 1-tile mesh only);
    loss_clamp > 0 clamps both at that radiance (firefly clamp).
    trainable: fields that are updated (the others get zero gradients);
    grad_mask: per-entry masks applied with where(mask > 0, g, 0), so a
    masked entry is 0 even where its gradient is not finite. The fraction
    of gradient entries that are not finite after the filter and the mask
    (over all positions) is counted, they are zeroed, and a step with any
    is rejected whole: parameters and optimiser state (Adam's count
    included) stay as they were. project_nonnegative clamps updated
    parameters at 0.

    The integrator is pinned to the plain path (on a CUDA device every
    closest-hit query still runs K1): the kernel path's backward re-runs
    the plain path anyway (render/integrator.KernelRadiance).

    step.init(params) -> optimiser state. step.many(params, opt_state,
    target_flat, key0, start, k) -> (params, opt_state, losses (k,),
    nonfinite fractions (k,)): steps start..start+k-1, step i keyed
    fold_in(key0, i) at stratum i % (n * n), bit-equal to k calls of step.
    step.ab_loss(xa, xb, target_rows) is a position's ab loss of two passes.
    step.loss_and_grads(params, target_flat, key, stratum) -> (loss, grads,
    nonfinite fraction) and step.apply(params, opt_state, grads, nf_frac)
    -> (params, opt_state) are the step's two halves.
    """
    optimizer = optimizer if optimizer is not None else Adam(1e-2)
    options = options.replace(integrator_backend="plain")
    mesh = single(scene.device) if mesh is None else mesh
    d_tiles, d_spp = mesh.shape["tiles"], mesh.shape["spp"]
    kk = loss_downsample
    if kk > 1 and d_tiles > 1:
        raise ValueError(f"loss_downsample {kk} pools the whole image and needs a 1-tile mesh, "
                         f"not {d_tiles} tiles")
    if kk > 1 and (height % kk or width % kk):
        raise ValueError(f"loss_downsample {kk} must divide the image ({width}x{height})")
    if loss_space not in ("ab", "linear", "log"):
        raise ValueError(f"loss_space must be 'ab', 'linear' or 'log', got {loss_space!r}")
    home = scene.device
    fields = tuple(DIFFERENTIABLE_FIELDS)
    sizes = [getattr(scene, f).numel() for f in fields]
    n_entries = sum(sizes)
    rows, scenes, px_pad = _layout(scene, mesh, width, height)
    masks = {d: {f: m.to(d) for f, m in (grad_mask or {}).items()} for d in scenes}

    def pool(x):
        # the block mean as a sum divided by the count (JAX's mean): torch's
        # CUDA mean multiplies by the count's reciprocal
        return over(x.reshape(height // kk, kk, width // kk, kk, 3).sum(dim=(1, 3)),
                    kk * kk).reshape(-1, 3)

    def clampf(x):
        return torch.clamp(x, max=loss_clamp) if loss_clamp > 0 else x

    def ab_loss(xa, xb, target):
        """The dual-buffer loss of a position's two passes: clamp, pool,
        then the sum of (xa - t)(xb - t) over (pooled) rows * 3 * tiles."""
        xa, xb, tl = clampf(xa), clampf(xb), clampf(target)
        if kk > 1:
            xa, xb, tl = pool(xa), pool(xb), pool(tl)
        da, db = xa - tl, xb - tl
        return over(torch.sum(da * db), da.shape[0] * 3 * d_tiles)

    def position_loss(sc, px, tl, k, stratum):
        if loss_space == "ab":
            ka, kb = rng.split(k)
            return ab_loss(_trace_stratum(sc, px, ka, stratum, n, options),
                           _trace_stratum(sc, px, kb, stratum, n, options), tl)
        c, tl = clampf(_trace_stratum(sc, px, k, stratum, n, options)), clampf(tl)
        if loss_space == "log":
            c, tl = torch.log1p(torch.clamp(c, min=0.0)), torch.log1p(torch.clamp(tl, min=0.0))
        dc = c - tl
        return over(torch.sum(dc * dc), rows * d_tiles * 3)

    def position_grads(params, target_pad, key, stratum, ti, si, dev):
        """A position's loss, its filtered, masked and sanitised gradients,
        and their non-finite count."""
        k = rng.fold_in(rng.fold_in(key, ti), si)
        leaves = {f: params[f].detach().to(dev).requires_grad_(f in trainable) for f in fields}
        sc = apply_params(scenes[dev], leaves)
        tile = slice(ti * rows, (ti + 1) * rows)
        with torch.enable_grad(), _deterministic():
            with profiling.span("plu.train.forward"):
                loss = position_loss(sc, px_pad[dev][tile], target_pad[tile].to(dev), k, stratum)
            wrt = [leaves[f] for f in fields if f in trainable]
            with profiling.span("plu.train.backward"):
                got = iter(torch.autograd.grad(loss, wrt, allow_unused=True,
                                               materialize_grads=True) if wrt else ())
        with profiling.span("plu.train.filter"):
            grads = {f: next(got) if f in trainable else torch.zeros_like(leaves[f])
                     for f in fields}
            grads = {f: torch.where(masks[dev][f] > 0, g, 0.0) if f in masks[dev] else g
                     for f, g in grads.items()}
            nf_count = sum((~torch.isfinite(g)).sum().to(torch.float32) for g in grads.values())
            grads = {f: torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0)
                     for f, g in grads.items()}
        return loss.detach(), grads, nf_count

    def loss_and_grads(params, target, key, stratum):
        target_pad = _pad_rows(target, d_tiles)
        partials = {(ti, si): position_grads(params, target_pad, key, stratum, ti, si, dev)
                    for ti, si, dev in mesh.local()}
        with profiling.span("plu.train.reduce"):
            # one float32 vector a position: loss, non-finite count, gradients
            flat = {p: torch.cat([loss.reshape(1), nf.reshape(1),
                                  *(g[f].reshape(-1) for f in fields)])
                    for p, (loss, g, nf) in partials.items()}
            parts = gather(mesh, flat, (2 + n_entries,), home)

            def reduce(xs):
                # summed over tiles in ti order, then averaged over spp
                return over(_sum([_sum(xs[si::d_spp]) for si in range(d_spp)]), d_spp)

            cols = torch.stack(parts).split([1, 1, *sizes], dim=1)
            loss = reduce(list(cols[0][:, 0]))
            grads = {f: reduce(list(c)).reshape(getattr(scene, f).shape)
                     for f, c in zip(fields, cols[2:])}
            nf_count = _sum(list(cols[1][:, 0]))
            return loss, grads, over(nf_count, n_entries * d_tiles * d_spp)

    def apply(params, opt_state, grads, nf_frac):
        with profiling.span("plu.train.optimizer"):
            updates, new_state = optimizer.update(grads, opt_state)
            new_params = apply_updates(params, updates)
            if project_nonnegative:
                new_params = {f: torch.clamp(x, min=0.0) for f, x in new_params.items()}
            # reject the whole step (parameters and optimiser state, the
            # count included) when the backward left non-finite entries
            bad = nf_frac > 0.0
            return _keep(bad, params, new_params), _keep(bad, opt_state, new_state)

    def one(params, opt_state, target, key, stratum):
        with profiling.span("plu.train.step", request=True):
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
