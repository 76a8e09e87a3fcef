"""Sampling distributions (reference inc/cmmn.h:239-299), batched over
uniforms drawn by the caller (plubench.reference.rng).

Every square root is ops/safemath.sqrt (rounded to nearest on the CPU too)
and every division by a number divides by a float32 tensor on the
dividend's device (render/renderer.over): on CUDA torch turns a division
by a Python number into a product with its reciprocal.
"""

from __future__ import annotations

import math

import torch

from plubench.reference.ops.safemath import sqrt


def concentric_disk_sample(u: torch.Tensor) -> torch.Tensor:
    """Concentric square->disk map (inc/cmmn.h:252-270). u: (...,2) in [0,1)."""
    u = 2.0 * u - 1.0
    ux, uy = u[..., 0], u[..., 1]
    zero = (ux == 0.0) & (uy == 0.0)

    # region selection per the reference's nested conditionals
    cond_a = ux >= -uy
    cond_b = ux > uy
    cond_c = ux <= uy

    safe = lambda x: torch.where(x == 0.0, 1.0, x)
    phi_a1 = torch.where(uy > 0.0, uy / safe(ux), 8.0 + uy / safe(ux))
    phi_a2 = 2.0 - ux / safe(uy)
    phi_b1 = 4.0 - uy / safe(ux)
    phi_b2 = 6.0 - ux / safe(uy)

    r = torch.where(cond_a, torch.where(cond_b, ux, uy),
                    torch.where(cond_c, -ux, -uy))
    phi = torch.where(cond_a, torch.where(cond_b, phi_a1, phi_a2),
                      torch.where(cond_c, phi_b1, phi_b2))
    phi = phi * (math.pi * 0.25)
    out = torch.stack([torch.cos(phi), torch.sin(phi)], -1) * r[..., None]
    return torch.where(zero[..., None], 0.0, out)


def uniform_sphere_sample(u: torch.Tensor) -> torch.Tensor:
    z = 1.0 - 2.0 * u[..., 0]
    r = sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


def cosine_hemisphere_sample(u: torch.Tensor) -> torch.Tensor:
    d = concentric_disk_sample(u)
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    z = sqrt(torch.clamp(1.0 - d2, min=0.0))
    return torch.cat([d, z[..., None]], -1)

