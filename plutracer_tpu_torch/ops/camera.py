"""Camera ray generation (reference: inc/camera.h:25-37).

Batched: px (B,2) pixel-space sample positions -> ray origins/directions.
NDC spans [-1,1]^2 on both axes with a y flip and NO aspect compensation;
the film plane sits at distance w=2.5 along `look` with the 1.5-scaled
right/up basis. Thin-lens depth of field refocuses through the plane at
focal_distance measured along *world z* (the reference divides by d.z).
"""

from __future__ import annotations

import torch

from plutracer_tpu_torch.ops.sampling import concentric_disk_sample
from plutracer_tpu_torch.scene.types import CameraParams


def generate_rays(cam: CameraParams, px: torch.Tensor, lens_u: torch.Tensor):
    """px: (B,2) sample positions in pixels; lens_u: (B,2) in [0,1)^2.

    Returns (o, d): (B,3) each.
    """
    uv = px * cam.inv_image_size * 2.0 - 1.0
    flip = uv.new_ones(2)
    flip[1:].fill_(-1.0)  # filled on the device: no host copy, so a CUDA graph can capture it
    uv = uv * flip
    d = cam.w * cam.look + uv[..., 0:1] * cam.right + uv[..., 1:2] * cam.up
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = cam.pos.expand(d.shape)

    # thin lens: computed for every ray and selected, as the reference's
    # branch on lens_radius > 0 (no host round-trip for the flag)
    l = concentric_disk_sample(lens_u) * cam.lens_radius
    pof = o + d * (cam.focal_distance / d[..., 2:3])
    o2 = o + torch.cat([l, torch.zeros_like(l[..., :1])], -1)
    d2 = pof - o2
    d2 = d2 / torch.linalg.norm(d2, dim=-1, keepdim=True)
    use_lens = cam.lens_radius > 0.0
    return torch.where(use_lens, o2, o), torch.where(use_lens, d2, d)
