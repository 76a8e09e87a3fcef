"""Guarded elementary ops: primals only.

The JAX package (plutracer_tpu/ops/safemath.py) wraps these in custom
derivative rules whose clamps keep reverse-mode transposes finite; the
primals are the plain ops, bit-identical. The port is forward-only for
now, so these are the primals; the derivative-side clamps arrive with
gradients as torch.autograd.Functions.
"""

from __future__ import annotations

import torch


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


def safe_div(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x / y


def safe_recip(y: torch.Tensor) -> torch.Tensor:
    return 1.0 / y


def safe_rsqrt(u: torch.Tensor) -> torch.Tensor:
    return torch.rsqrt(u)


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt that is exactly 0 for x <= 0 (the JAX package's masked form)."""
    pos = x > 0.0
    return torch.sqrt(torch.where(pos, x, 1.0)) * pos.to(x.dtype)


def normalize(v: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """v * rsqrt(|v|^2 + eps) over the last axis."""
    return v * safe_rsqrt(dot(v, v) + eps)[..., None]
