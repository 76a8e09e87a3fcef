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
nearest (_sqrt_rn). torch.optim.Adam rounds in another order and is not
used.

State: ``AdamState(count, mu, nu)``, count an int32 scalar tensor and
mu/nu dicts of tensors shaped like the parameters. ``adam_state_from_optax``
carries an optax adam state (anything shaped like it: arrays that numpy
can read) into the port.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Union

import numpy as np
import torch


class AdamState(NamedTuple):
    count: torch.Tensor  # () int32: updates taken
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """1 - decay**count in float32, the power correctly rounded."""
    power = torch.pow(torch.tensor(np.float32(decay).item(), dtype=torch.float64,
                                   device=count.device), count.to(torch.float64))
    return torch.tensor(1.0, dtype=torch.float32, device=count.device) - power.to(torch.float32)


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 sqrt rounded to nearest, as IEEE (and XLA) round it. torch's
    vectorised CPU sqrt is off by one unit in the last place on some inputs;
    the candidate next to it is taken where x lies beyond the midpoint's
    square, which float64 holds exactly. On a correct sqrt this is a no-op."""
    s = torch.sqrt(x)
    lo, hi = torch.nextafter(s, torch.zeros_like(s)), torch.nextafter(s, torch.full_like(s, 1e38))
    xd, sd = x.double(), s.double()
    mid_lo, mid_hi = (lo.double() + sd) * 0.5, (sd + hi.double()) * 0.5
    return torch.where(xd < mid_lo * mid_lo, lo, torch.where(xd > mid_hi * mid_hi, hi, s))


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


def apply_updates(params: Dict[str, torch.Tensor], updates: Dict[str, torch.Tensor]):
    """optax.apply_updates: params + updates, field by field."""
    return {k: params[k] + updates[k] for k in params}


def adam_state_from_optax(opt_state, device="cpu") -> AdamState:
    """The port's AdamState from an optax adam state, (ScaleByAdamState(count,
    mu, nu), <learning-rate state>): the arrays are read with numpy."""
    adam = opt_state[0]
    t = lambda x: torch.from_numpy(np.array(x, np.float32)).to(device)
    return AdamState(
        count=torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32, device=device),
        mu={k: t(v) for k, v in adam.mu.items()},
        nu={k: t(v) for k, v in adam.nu.items()},
    )
