"""Guarded elementary ops, with derivative rules that stay finite.

The port of plutracer_tpu/ops/safemath.py. The reverse-mode rule of
``x / y`` contains ``-g * x / y**2``: a guard floor such as
``clamp(y, min=1e-20)`` keeps the primal finite, but ``y**2 = 1e-40``
flushes to 0 under flush-to-zero arithmetic, so a lane whose cotangent is
already zero computes ``0 * x / 0 = NaN``, and one NaN lane poisons the
whole summed parameter gradient. ``rsqrt(u + 1e-30)`` is worse: its
derivative factor ``u**-1.5 = 1e45`` overflows float32 outright.

``sqrt`` is the square root rounded to nearest on every device: torch's
CUDA sqrt is IEEE (the kernels match it bit for bit), but its vectorised
CPU sqrt is off by one unit in the last place on some inputs (about 0.6%
of uniform float32 values in [0, 100), at every position of a tensor),
where XLA's, which the JAX package runs, rounds to nearest. On a CPU
tensor the root is taken in float64 and rounded (``_sqrt_rn``); its
derivative is JAX's, ``g * (0.5 / sqrt(x))``.

``safe_div``, ``safe_recip`` and ``safe_rsqrt`` keep their primals
BIT-IDENTICAL to the plain ops (the CUDA kernels are pinned against them
bit for bit) and clamp only inside the derivative, as the JAX package's
custom JVP rules do: |y| is treated as at least DIV_EPS and u as at least
RSQRT_EPS, and the quotient's derivative reuses the primal quotient
(``(g - out * dy) / y``), so y is never squared. The cotangent is applied
before the large-but-finite factors, so zero-cotangent lanes give exact
zeros. Each is a ``torch.autograd.Function``; when no input requires a
gradient the plain op runs directly.
"""

from __future__ import annotations

import torch

# |y| floor inside derivatives: y, y**2 and their reciprocals all stay
# normal float32 (min normal 1.18e-38) with headroom for chain products
DIV_EPS = 1e-15
# u floor inside rsqrt derivatives: uc**-1.5 <= 1e30 << f32 max 3.4e38
RSQRT_EPS = 1e-20


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of length 3, in a fixed order: (x + y) + z.
    Written out (not torch.sum) so the rounding order is the same on
    every device and in the CUDA kernels."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        -1,
    )


def _mag_clamp(y: torch.Tensor, eps: float) -> torch.Tensor:
    """y pushed away from 0 to at least +-eps, preserving sign (exact
    zeros become +eps; guarded call sites never pass exact zeros)."""
    return torch.where(y.abs() < eps, torch.where(y < 0.0, -eps, eps), y)


def _reduce(g: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A broadcast operand's gradient summed back to its shape."""
    return g if g.shape == like.shape else g.sum_to_size(like.shape)


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 sqrt rounded to nearest, as IEEE (and XLA) round it: the
    root taken in float64 and rounded to float32. The root of a float32 is
    never near enough to a float32 midpoint for the float64 step's rounding
    to move it (53 >= 2 * 24 + 2 bits), so the double rounding is exact."""
    return torch.sqrt(x.double()).to(x.dtype)


class _SqrtRn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = _sqrt_rn(x)
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        return g * (0.5 / out)


class _SafeDiv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y):
        out = x / y
        ctx.save_for_backward(x, y, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, y, out = ctx.saved_tensors
        q = g / _mag_clamp(y, DIV_EPS)
        gx = _reduce(q, x) if ctx.needs_input_grad[0] else None
        gy = _reduce(-(q * out), y) if ctx.needs_input_grad[1] else None
        return gx, gy


class _SafeRecip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        ctx.save_for_backward(y)
        return 1.0 / y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        rc = 1.0 / _mag_clamp(y, DIV_EPS)
        return (-rc * rc) * g


class _SafeRsqrt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u):
        ctx.save_for_backward(u)
        return torch.rsqrt(u)

    @staticmethod
    def backward(ctx, g):
        (u,) = ctx.saved_tensors
        rc = torch.rsqrt(torch.clamp(u, min=RSQRT_EPS))
        return (-0.5 * rc * rc * rc) * g


def _wants_grad(*xs: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def safe_div(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x / y with a derivative that treats |y| as >= DIV_EPS."""
    return _SafeDiv.apply(x, y) if _wants_grad(x, y) else x / y


def safe_recip(y: torch.Tensor) -> torch.Tensor:
    """1 / y with a derivative that treats |y| as >= DIV_EPS."""
    return _SafeRecip.apply(y) if _wants_grad(y) else 1.0 / y


def safe_rsqrt(u: torch.Tensor) -> torch.Tensor:
    """rsqrt(u) with a derivative that treats u as >= RSQRT_EPS."""
    return _SafeRsqrt.apply(u) if _wants_grad(u) else torch.rsqrt(u)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The square root rounded to nearest: torch.sqrt on CUDA, _sqrt_rn on
    the CPU."""
    if x.device.type == "cuda":
        return torch.sqrt(x)
    return _SqrtRn.apply(x) if _wants_grad(x) else _sqrt_rn(x)


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt that is exactly 0 for x <= 0 (the JAX package's masked form:
    its gradient is 0, not inf, at x <= 0)."""
    pos = x > 0.0
    return sqrt(torch.where(pos, x, 1.0)) * pos.to(x.dtype)


def normalize(v: torch.Tensor, axis: int = -1, eps: float = 1e-30) -> torch.Tensor:
    """v * rsqrt(sum(v * v, axis) + eps), through the guarded rsqrt:
    derivative finite even at |v| -> 0. Over a last axis of length 3 the
    sum is ``dot``'s fixed order, which the kernels round alike; over any
    other axis it is torch.sum."""
    if axis % v.dim() == v.dim() - 1 and v.shape[-1] == 3:
        return v * safe_rsqrt(dot(v, v) + eps)[..., None]
    return v * safe_rsqrt(torch.sum(v * v, axis, keepdim=True) + eps)
