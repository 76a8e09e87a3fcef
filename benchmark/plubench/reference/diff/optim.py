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
mu/nu dicts of tensors shaped like the parameters.

``exponential_decay`` and ``MultiTransform`` are optax.exponential_decay
and optax.multi_transform: a learning-rate schedule bit-equal to optax's
on the counts the flagship recipe uses (the power is the correctly
rounded float32 one, as in the bias correction), and one inner optimiser
per label, each with its own count and state over only its own fields.

Every optimiser here flattens its state into the leaves of its optax
counterpart's (``state_leaves``, which reads the fields by name: count,
mu, nu, inner_states) and rebuilds it from such leaves
(``state_from_leaves``): the train check builds the reference's state
from the program's this way.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Tuple, Union

import numpy as np
import torch

from plubench.reference.ops.safemath import _sqrt_rn


class AdamState(NamedTuple):
    count: torch.Tensor  # () int32: updates taken
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """1 - decay**count in float32, the power correctly rounded."""
    power = torch.pow(torch.tensor(np.float32(decay).item(), dtype=torch.float64,
                                   device=count.device), count.to(torch.float64))
    return torch.tensor(1.0, dtype=torch.float32, device=count.device) - power.to(torch.float32)


class Adam:
    """optax.adam(learning_rate, b1, b2, eps) with eps_root = 0.
    learning_rate: a float, or a callable of the update count (an int32
    scalar tensor) returning the step size."""

    def __init__(self, learning_rate: Union[float, Callable] = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.learning_rate, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        dev = next(iter(params.values())).device
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            mu={k: torch.zeros_like(v) for k, v in params.items()},
            nu={k: torch.zeros_like(v) for k, v in params.items()},
        )

    def update(self, grads: Dict[str, torch.Tensor], state: AdamState):
        """(updates, new state) for gradients shaped like the parameters.
        Every constant is a float32 tensor first, as in the JAX program
        (a Python float operand would make torch compute in double)."""
        dev = state.count.device
        f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
        b1, b2 = self.b1, self.b2
        c1, d1, c2, d2 = f32(1 - b1), f32(b1), f32(1 - b2), f32(b2)
        mu = {k: c1 * g + d1 * state.mu[k] for k, g in grads.items()}
        nu = {k: c2 * (g * g) + d2 * state.nu[k] for k, g in grads.items()}
        count = state.count + 1
        bc1, bc2 = _bias_correction(b1, count), _bias_correction(b2, count)
        lr = self.learning_rate(state.count) if callable(self.learning_rate) else self.learning_rate
        step = torch.as_tensor(-1 * lr, dtype=torch.float32, device=dev)
        eps, eps_root = f32(self.eps), f32(0.0)
        # divisors expanded to full shape: torch divides by a scalar as a
        # multiplication by its reciprocal, which rounds differently
        full = lambda c, x: c.expand_as(x)
        updates = {k: step * ((mu[k] / full(bc1, mu[k]))
                              / (_sqrt_rn(nu[k] / full(bc2, nu[k]) + eps_root) + eps))
                   for k in grads}
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
    (tests/test_torch_flagship.py)."""
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: torch.tensor(np.float32(init_value).item(), dtype=torch.float32,
                                          device=count.device)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        dev = count.device
        f32 = lambda x: torch.tensor(np.float32(x).item(), dtype=torch.float32, device=dev)
        p = count.to(torch.float32) / f32(transition_steps)
        power = torch.pow(torch.tensor(np.float32(decay_rate).item(), dtype=torch.float64,
                                       device=dev), p.to(torch.float64)).to(torch.float32)
        return torch.where(count <= 0, f32(init_value), f32(init_value) * power)

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
