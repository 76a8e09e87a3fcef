"""Postprocess: white-preserving luma-based Reinhard tonemap + gamma 1/2.2.

Reference: plu::postprocesser (src/main.cpp:77-112). Deviation: the
reference divides by luma unguarded, turning pure-black pixels into NaN; we
map black to black.
"""

from __future__ import annotations

import torch

from plutracer_tpu_torch.utils import profiling

WHITE = 2.0


def reinhard(color: torch.Tensor) -> torch.Tensor:
    """(..., 3) linear -> tonemapped + gamma. Vectorized over any batch.
    Its span is ``plu.tonemap``."""
    with profiling.span("plu.tonemap"):
        w = torch.tensor([0.2126, 0.7152, 0.0722], device=color.device)
        cw = color * w
        luma = (cw[..., 0:1] + cw[..., 1:2]) + cw[..., 2:3]
        tone = luma * (1.0 + luma / (WHITE * WHITE)) / (1.0 + luma)
        scale = torch.where(luma > 0.0, tone / torch.where(luma == 0.0, 1.0, luma), 0.0)
        c = torch.clamp(color * scale, min=0.0)
        return c ** (1.0 / 2.2)


# the JAX package's name for reinhard over a full (H, W, 3) image
postprocess_image = reinhard
