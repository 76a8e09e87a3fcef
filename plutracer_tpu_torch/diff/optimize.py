"""Inverse rendering: fit scene parameters to a target image.

The port of plutracer_tpu/diff/optimize.py: optimise material albedo,
light emission and texture colours so a render matches a target, through
parallel/sharded.make_train_step over a (tiles, spp) mesh. Gradients flow
through the whole path-tracing estimator; per-pass noise acts as minibatch
noise.

Checkpoints hold the parameters, the progress and the optimiser state
flattened as the JAX package flattens it (``opt_{i}``, the leaves of the
optax state in jax.tree_util order: diff/optim's ``state_leaves``), and
the state is rebuilt on load from the leaves and ``step.init``'s template.
So a checkpoint written by the JAX package's optimize_scene resumes here
with the port's counterpart of its optimiser (Adam for optax.adam,
MultiTransform of Adams for optax.multi_transform), and the single-Adam
checkpoints of the port's first layout (``mu_*``, ``nu_*``, ``count``)
still load.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from plutracer_tpu_torch import rng
from plutracer_tpu_torch.diff.optim import Adam, AdamState
from plutracer_tpu_torch.parallel.mesh import make_mesh, visible_devices
from plutracer_tpu_torch.parallel.sharded import get_params, make_train_step
from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS, RenderOptions


@dataclasses.dataclass
class InverseRenderConfig:
    width: int = 128
    height: int = 128
    n: int = 2  # stratified grid per step (spp = n^2 per estimator pass)
    steps: int = 200
    learning_rate: float = 5e-3
    seed: int = 0
    mesh_shape: Optional[tuple] = None  # default: all devices on `tiles`
    log_every: int = 20
    options: RenderOptions = DEFAULT_OPTIONS
    loss_space: str = "ab"
    trainable: tuple = ("mat_color", "light_intensity", "tex_c0", "tex_c1")
    # project parameters to be nonnegative after each update (albedo,
    # emission, and texture colors are physically >= 0)
    project_nonnegative: bool = True
    # optional optimiser with Adam's interface (init, update, and for
    # checkpoints state_leaves / state_from_leaves) in place of the default
    # Adam(learning_rate), e.g. MultiTransform for per-field learning rates
    optimizer: Optional[object] = None
    # optional per-entry 0/1 gradient mask (see make_train_step)
    grad_mask: Optional[Dict] = None
    # k x k average-pool rendered/target images before the ab loss
    # (unbiased variance reduction; see make_train_step)
    loss_downsample: int = 1
    # firefly clamp: bound both rendered and target linear radiance
    # before the loss (see make_train_step)
    loss_clamp: float = 0.0
    # checkpoint/resume: parameters, Adam's state and the step counter are
    # written after every chunk, and an interrupted run resumes bit-exactly
    # (chunk boundaries are absolute, the randomness is keyed by the
    # absolute step index, and the state round-trips exactly)
    checkpoint_path: Optional[str] = None


def state_from_leaves(optimizer, template, leaves: List[torch.Tensor]):
    """The optimiser state rebuilt from the leaves of its optax
    counterpart's state; every leaf must be used."""
    state, rest = optimizer.state_from_leaves(template, leaves)
    if rest:
        raise ValueError(f"{len(rest)} checkpoint leaves left over: another optimiser's state")
    return state


def _save_train_ckpt(path, params, optimizer, opt_state, next_i, seed, losses, nf_fracs):
    """Atomic checkpoint (npz), the JAX package's layout: parameters, the
    optimiser state's leaves, progress."""
    leaves = optimizer.state_leaves(opt_state)
    arrays = {f"param_{k}": v.detach().cpu().numpy() for k, v in params.items()}
    arrays.update({f"opt_{i}": x.detach().cpu().numpy() for i, x in enumerate(leaves)})
    tmp = path + ".tmp"
    np.savez(
        tmp, next_i=next_i, seed=seed,
        losses=np.asarray(losses, np.float64), nf_fracs=np.asarray(nf_fracs, np.float64),
        param_keys=np.asarray(sorted(params)), n_opt_leaves=len(leaves), **arrays,
    )
    os.replace(tmp + ".npz", path)


def load_train_checkpoint(path, optimizer, template, seed, device):
    """(params, optimiser state, next step, losses, non-finite fractions)
    from a checkpoint of optimize_scene, the port's or the JAX package's.
    template: optimizer's init state, which the leaves are rebuilt into; a
    checkpoint of another seed is refused."""
    z = np.load(path, allow_pickle=False)
    if int(z["seed"]) != seed:
        raise ValueError(f"checkpoint seed {int(z['seed'])} != config {seed}")
    t = lambda name: torch.from_numpy(np.asarray(z[name])).to(device)
    keys = [str(k) for k in z["param_keys"]]
    params = {k: t(f"param_{k}") for k in keys}
    if "n_opt_leaves" in z:
        leaves = [t(f"opt_{i}") for i in range(int(z["n_opt_leaves"]))]
        opt_state = state_from_leaves(optimizer, template, leaves)
    else:  # the port's first layout: one Adam's count, mu_*, nu_*
        opt_state = AdamState(
            count=torch.tensor(int(z["count"]), dtype=torch.int32, device=device),
            mu={k: t(f"mu_{k}") for k in keys}, nu={k: t(f"nu_{k}") for k in keys},
        )
    return params, opt_state, int(z["next_i"]), z["losses"].tolist(), z["nf_fracs"].tolist()


def mesh_devices(scene, shape: Optional[tuple]) -> Optional[list]:
    """The devices of optimize_scene's mesh. A scene on the CPU: as many
    CPU positions as the shape has (one by default). A scene on a card in
    a job of one process: every visible card, the scene's first, so a
    (1, 1) mesh stays on the scene's card. Under torch.distributed: None,
    make_mesh's default of each rank's own card."""
    if scene.device.type != "cuda":
        return [scene.device] * (shape[0] * shape[1] if shape else 1)
    if dist.is_available() and dist.is_initialized():
        return None
    return [scene.device] + [c for c in visible_devices("optimize_scene") if c != scene.device]


def optimize_scene(
    scene,
    target_linear,
    config: InverseRenderConfig = InverseRenderConfig(),
    init_params: Optional[Dict] = None,
    callback: Optional[Callable[[int, float, Dict], None]] = None,
    stats_out: Optional[Dict] = None,
):
    """Run the inverse-rendering loop over a mesh of config.mesh_shape
    (default all positions on `tiles`) on mesh_devices(scene, shape). The
    parameters and the optimiser live on the scene's device.

    target_linear: (H, W, 3) linear-radiance target (tensor or array).
    Returns (params, losses). The first chunk is one step, then chunks of
    log_every steps through step.many; the callback fires after each chunk
    with (last step index, its loss, params). If stats_out is a dict it
    records 'nonfinite_grad_frac_mean'/'_max', the fraction of gradient
    entries that were not finite per step (0 unless the backward emitted
    NaN/Inf; such steps are rejected, see make_train_step).
    """
    opt = config.optimizer or Adam(config.learning_rate)
    mesh = make_mesh(config.mesh_shape, devices=mesh_devices(scene, config.mesh_shape))
    step = make_train_step(
        scene, config.width, config.height, config.n, mesh, optimizer=opt,
        options=config.options, loss_space=config.loss_space,
        trainable=config.trainable, grad_mask=config.grad_mask,
        project_nonnegative=config.project_nonnegative,
        loss_downsample=config.loss_downsample, loss_clamp=config.loss_clamp,
    )
    dev = scene.device
    params = dict(init_params if init_params is not None else get_params(scene))
    opt_state = step.init(params)
    target_flat = torch.as_tensor(target_linear, dtype=torch.float32).reshape(-1, 3).to(dev)
    key = rng.PRNGKey(config.seed)
    losses: List[float] = []
    nf_fracs: List[float] = []
    chunk = max(1, config.log_every)
    i = 0
    ckpt = config.checkpoint_path
    if ckpt and os.path.exists(ckpt):
        params, opt_state, i, losses, nf_fracs = load_train_checkpoint(ckpt, opt, opt_state,
                                                                       config.seed, dev)
    while i < config.steps:
        # the first chunk is a single step, so the callback fires at steps
        # 0, log_every, 2 * log_every, ..., and the last
        k = 1 if i == 0 else min(chunk, config.steps - i)
        params, opt_state, loss_k, nf_k = step.many(params, opt_state, target_flat, key, i, k)
        losses.extend(loss_k.double().cpu().tolist())
        nf_fracs.extend(nf_k.double().cpu().tolist())
        if callback:
            callback(i + k - 1, losses[-1], params)
        i += k
        if ckpt:
            # checkpoints land on chunk boundaries, so a resumed run
            # issues the same chunks (bit-exact)
            _save_train_ckpt(ckpt, params, opt, opt_state, i, config.seed, losses, nf_fracs)
    if stats_out is not None:
        stats_out["nonfinite_grad_frac_mean"] = float(np.mean(nf_fracs)) if nf_fracs else 0.0
        stats_out["nonfinite_grad_frac_max"] = float(np.max(nf_fracs)) if nf_fracs else 0.0
    return params, losses
