"""Adam, written out operation for operation as optax's ``adam``.

The train step (parallel/sharded.make_train_step) needs an optimiser
whose state it can hold, reject and checkpoint, and whose arithmetic is
the JAX package's: optax.adam(lr) = chain(scale_by_adam(b1, b2, eps,
eps_root=0), scale_by_learning_rate(lr)). ``Adam.update`` follows it step
by step in float32:

    mu    = (1 - b1) * g + b1 * mu
    nu    = (1 - b2) * (g * g) + b2 * nu
    count = count + 1
    u     = (mu / (1 - b1**count)) / (sqrt(nu / (1 - b2**count) + eps_root) + eps)
    u     = (-lr) * u            (-lr(count before the increment) for a schedule)

and ``apply_updates`` adds u to the parameters. ``b**count`` is the
correctly rounded float32 power (computed in float64): XLA's float32 power
on the CPU, which optax's bias correction uses, agrees with it at every
count below 2,958 for the default betas (b2's first disagreement; b1's none
below 20,000), so the two optimisers are bit-equal over any run shorter
than that on identical gradients. Divisions divide (torch would multiply
by the reciprocal of a scalar divisor) and the square root is rounded to
nearest (ops/safemath._sqrt_rn). torch.optim.Adam rounds in another order
and is not used.

State: ``AdamState(count, mu, nu)``, count an int32 scalar tensor and
mu/nu dicts of tensors shaped like the parameters. ``adam_state_from_optax``
carries an optax adam state (anything shaped like it: arrays that numpy
can read) into the port.

``exponential_decay`` and ``MultiTransform`` are optax.exponential_decay
and optax.multi_transform: a learning-rate schedule bit-equal to optax's
on the counts the flagship recipe uses (the power is the correctly
rounded float32 one, as in the bias correction), and one inner optimiser
per label, each with its own count and state over only its own fields.
``multi_transform_state_from_optax`` carries an optax multi-transform
state into the port.

Every optimiser here flattens its state into the leaves of its optax
counterpart's, in jax.tree_util order (``state_leaves``), and rebuilds it
from such leaves (``state_from_leaves``): diff/optimize.py checkpoints
that list, so the port resumes a checkpoint of the JAX package's
optimize_scene and the JAX package can read the port's.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Tuple, Union

import numpy as np
import torch

from plutracer_tpu_torch.ops.safemath import _sqrt_rn


class AdamState(NamedTuple):
    count: torch.Tensor  # () int32: updates taken
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def _bias_correction(decay: torch.Tensor, one: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """1 - decay**count in float32, the power correctly rounded: decay is
    the float64 value of the float32 decay rate, one a float32 1, both
    scalar tensors on count's device."""
    power = torch.pow(decay, count.to(torch.float64))
    return one - power.to(torch.float32)


class _Constants:
    """Scalar tensors built once a device and kept: an update then copies
    nothing from the host, so a CUDA graph can capture it, and it computes
    with the values it computed with before (the same ops, the same
    bits)."""

    def __init__(self, build: Callable):
        self.build, self.held = build, {}

    def on(self, device: torch.device):
        got = self.held.get(device)
        if got is None:
            got = self.held[device] = self.build(device)
        return got


class Adam:
    """optax.adam(learning_rate, b1, b2, eps) with eps_root = 0.
    learning_rate: a float, or a callable of the update count (an int32
    scalar tensor) returning the step size."""

    def __init__(self, learning_rate: Union[float, Callable] = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.learning_rate, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self._constants = _Constants(self._build_constants)

    def _build_constants(self, dev) -> dict:
        """The update's constants on `dev`: float32 tensors first, as in the
        JAX program (a Python float operand would make torch compute in
        double), the bias corrections' bases in float64."""
        f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
        f64 = lambda x: torch.tensor(np.float32(x).item(), dtype=torch.float64, device=dev)
        b1, b2 = self.b1, self.b2
        got = dict(c1=f32(1 - b1), d1=f32(b1), c2=f32(1 - b2), d2=f32(b2), eps=f32(self.eps),
                   eps_root=f32(0.0), one=f32(1.0), b1_64=f64(b1), b2_64=f64(b2))
        if not callable(self.learning_rate):
            got["step"] = f32(-1 * self.learning_rate)
        return got

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        dev = next(iter(params.values())).device
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            mu={k: torch.zeros_like(v) for k, v in params.items()},
            nu={k: torch.zeros_like(v) for k, v in params.items()},
        )

    def update(self, grads: Dict[str, torch.Tensor], state: AdamState):
        """(updates, new state) for gradients shaped like the parameters.
        Every constant is a float32 tensor on the count's device, built at
        the first update there (``_build_constants``); the count is the
        one value that changes from update to update."""
        k = self._constants.on(state.count.device)
        c1, d1, c2, d2 = k["c1"], k["d1"], k["c2"], k["d2"]
        mu = {f: c1 * g + d1 * state.mu[f] for f, g in grads.items()}
        nu = {f: c2 * (g * g) + d2 * state.nu[f] for f, g in grads.items()}
        count = state.count + 1
        bc1 = _bias_correction(k["b1_64"], k["one"], count)
        bc2 = _bias_correction(k["b2_64"], k["one"], count)
        if callable(self.learning_rate):
            step = torch.as_tensor(-1 * self.learning_rate(state.count), dtype=torch.float32,
                                   device=state.count.device)
        else:
            step = k["step"]
        eps, eps_root = k["eps"], k["eps_root"]
        # divisors expanded to full shape: torch divides by a scalar as a
        # multiplication by its reciprocal, which rounds differently
        full = lambda c, x: c.expand_as(x)
        updates = {f: step * ((mu[f] / full(bc1, mu[f]))
                              / (_sqrt_rn(nu[f] / full(bc2, nu[f]) + eps_root) + eps))
                   for f in grads}
        return updates, AdamState(count, mu, nu)

    def state_leaves(self, state: AdamState) -> List[torch.Tensor]:
        """The leaves of optax.adam's state: (ScaleByAdamState(count, mu,
        nu), the learning rate's state), dict entries by sorted key; a
        schedule's state is a second count, equal to Adam's."""
        keys = sorted(state.mu)
        leaves = [state.count, *(state.mu[k] for k in keys), *(state.nu[k] for k in keys)]
        return leaves + [state.count] if callable(self.learning_rate) else leaves

    def state_from_leaves(self, template: AdamState, leaves: List[torch.Tensor]
                          ) -> Tuple[AdamState, List[torch.Tensor]]:
        """(state, the leaves left over) from leaves in state_leaves'
        order, shaped as `template` (this optimiser's init)."""
        keys = sorted(template.mu)
        m = len(keys)
        take = 1 + 2 * m + (1 if callable(self.learning_rate) else 0)
        if len(leaves) < take:
            raise ValueError(f"an Adam state over {keys} needs {take} leaves, got {len(leaves)}")
        mine, rest = leaves[:take], leaves[take:]
        for k, mu, nu in zip(keys, mine[1:1 + m], mine[1 + m:1 + 2 * m]):
            if mu.shape != template.mu[k].shape or nu.shape != template.nu[k].shape:
                raise ValueError(f"{k}: checkpoint leaves {tuple(mu.shape)} do not match "
                                 f"the parameters' {tuple(template.mu[k].shape)}")
        if take > 1 + 2 * m and int(mine[-1]) != int(mine[0]):
            raise ValueError("the schedule's count differs from Adam's")
        dev = template.count.device
        return AdamState(
            count=mine[0].to(device=dev, dtype=torch.int32).reshape(()),
            mu={k: v.to(dev, torch.float32) for k, v in zip(keys, mine[1:1 + m])},
            nu={k: v.to(dev, torch.float32) for k, v in zip(keys, mine[1 + m:1 + 2 * m])},
        ), rest


def exponential_decay(init_value: float, transition_steps: int, decay_rate: float) -> Callable:
    """optax.exponential_decay(init_value, transition_steps, decay_rate):
    count -> init_value * decay_rate ** (count / transition_steps) in
    float32, init_value at count <= 0. The exponent is a float32 division;
    the power is correctly rounded (float64, then float32), where XLA's
    float32 power is not always: optax run op by op agrees with it on every
    count below 1,201 of the recipe's phase-1 schedule (20.0, 600, 0.1)
    and below 446 of its phase-2 schedule (1e-2, 300, 0.05); inside a
    jitted program XLA fuses the power and rounds some counts otherwise
    (tests/test_torch_flagship.py). Its constants are tensors built once a
    device (at the first call there) and kept: a call copies nothing from
    the host."""
    f32 = lambda x, dev: torch.tensor(np.float32(x).item(), dtype=torch.float32, device=dev)
    if transition_steps <= 0 or decay_rate == 0:
        const = _Constants(lambda dev: f32(init_value, dev))
        return lambda count: const.on(count.device)

    consts = _Constants(lambda dev: (
        f32(transition_steps, dev), f32(init_value, dev),
        torch.tensor(np.float32(decay_rate).item(), dtype=torch.float64, device=dev)))

    def schedule(count: torch.Tensor) -> torch.Tensor:
        steps, init, rate = consts.on(count.device)
        p = count.to(torch.float32) / steps
        power = torch.pow(rate, p.to(torch.float64)).to(torch.float32)
        return torch.where(count <= 0, init, init * power)

    return schedule


class MultiTransformState(NamedTuple):
    inner_states: Dict[str, object]  # label -> that label's optimiser state


class MultiTransform:
    """optax.multi_transform(transforms, param_labels): the fields labelled
    `label` (param_labels: field -> label) go through transforms[label]
    (an optimiser with Adam's interface) alone; each inner optimiser keeps
    its own state, count included, over only its own fields."""

    def __init__(self, transforms: Dict[str, object], param_labels: Dict[str, str]):
        self.transforms, self.param_labels = dict(transforms), dict(param_labels)
        unknown = set(self.param_labels.values()) - set(self.transforms)
        if unknown:
            raise ValueError(f"labels without a transform: {sorted(unknown)}")

    def _part(self, tree: Dict[str, torch.Tensor], label: str) -> Dict[str, torch.Tensor]:
        return {k: v for k, v in tree.items() if self.param_labels[k] == label}

    def init(self, params: Dict[str, torch.Tensor]) -> MultiTransformState:
        return MultiTransformState({label: tx.init(self._part(params, label))
                                    for label, tx in self.transforms.items()})

    def update(self, grads: Dict[str, torch.Tensor], state: MultiTransformState):
        updates, inner = {}, {}
        for label, tx in self.transforms.items():
            u, inner[label] = tx.update(self._part(grads, label), state.inner_states[label])
            updates.update(u)
        return {k: updates[k] for k in grads}, MultiTransformState(inner)

    def state_leaves(self, state: MultiTransformState) -> List[torch.Tensor]:
        """optax's PartitionState leaves: the inner states by sorted label."""
        return [leaf for label in sorted(self.transforms)
                for leaf in self.transforms[label].state_leaves(state.inner_states[label])]

    def state_from_leaves(self, template: MultiTransformState, leaves: List[torch.Tensor]):
        inner = {}
        for label in sorted(self.transforms):
            inner[label], leaves = self.transforms[label].state_from_leaves(
                template.inner_states[label], leaves)
        return MultiTransformState({label: inner[label] for label in self.transforms}), leaves


def apply_updates(params: Dict[str, torch.Tensor], updates: Dict[str, torch.Tensor]):
    """optax.apply_updates: params + updates, field by field."""
    return {k: params[k] + updates[k] for k in params}


def adam_state_from_optax(opt_state, device="cpu", fields=None) -> AdamState:
    """The port's AdamState from an optax adam state, (ScaleByAdamState(count,
    mu, nu), <learning-rate state>): the arrays are read with numpy. fields:
    the entries of mu and nu to take (default all)."""
    adam = opt_state[0]
    t = lambda x: torch.from_numpy(np.array(x, np.float32)).to(device)
    keys = list(adam.mu) if fields is None else list(fields)
    return AdamState(
        count=torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32, device=device),
        mu={k: t(adam.mu[k]) for k in keys},
        nu={k: t(adam.nu[k]) for k in keys},
    )


def multi_transform_state_from_optax(opt_state, param_labels: Dict[str, str],
                                     device="cpu") -> MultiTransformState:
    """The port's MultiTransformState from an optax multi_transform state
    whose transforms are adams: each label's masked adam state, read with
    numpy, over the fields param_labels gives that label."""
    return MultiTransformState({
        label: adam_state_from_optax(
            masked.inner_state, device,
            fields=[f for f, lab in param_labels.items() if lab == label])
        for label, masked in opt_state.inner_states.items()
    })
