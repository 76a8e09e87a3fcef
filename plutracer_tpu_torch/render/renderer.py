"""Render driver: stratified multi-pass accumulation.

Each pixel gets an N x N stratified jittered sample grid (spp = N^2,
src/main.cpp:170). The whole image is one batch of rays per stratum: pass
s handles stratum cell (s%N, s//N) for every pixel at once, and the N^2
passes accumulate into the framebuffer. Keys follow the JAX package
exactly (fold_in(key, s) per pass, split into pixel / lens / path keys),
so a render at the same seed draws the same random numbers.
"""

from __future__ import annotations

import torch

from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS, RenderOptions
from plutracer_tpu_torch import rng
from plutracer_tpu_torch.ops.camera import generate_rays
from plutracer_tpu_torch.render.integrator import radiance


def pixel_centers(width: int, height: int, device="cpu") -> torch.Tensor:
    """(H*W, 2) integer pixel coordinates (x, y), row-major."""
    xs = torch.arange(width, dtype=torch.float32, device=device)
    ys = torch.arange(height, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)


def _trace_stratum(scene, px0, key, stratum: int, n: int, options: RenderOptions):
    """One stratified sample per pixel from the given stratum cell."""
    B = px0.shape[0]
    dev = px0.device
    k_px, k_lens, k_path = rng.split(key, 3)
    # jittered stratified offsets: (cell + u*0.999)/n  (inc/sampler.h:44-50)
    cell = torch.tensor([stratum % n, stratum // n], dtype=torch.float32, device=dev)
    jit_px = rng.uniform(k_px, (B, 2), dev) * 0.999
    jit_lens = rng.uniform(k_lens, (B, 2), dev) * 0.999
    px = px0 + (cell + jit_px) / n
    lens = (cell + jit_lens) / n
    o, d = generate_rays(scene.camera, px, lens)
    return radiance(scene, o, d, k_path, options)


def render_pass(scene, key, stratum: int, width: int, height: int, n: int,
                options: RenderOptions = DEFAULT_OPTIONS):
    """One stratified pass: every pixel gets one sample from the given
    stratum cell, its random numbers drawn from `key` itself (no fold_in
    by stratum). Returns (H*W, 3) radiance; the function the gradient
    checks and the train step differentiate."""
    return _trace_stratum(scene, pixel_centers(width, height, scene.device), key, stratum, n,
                          options)


def render_passes(
    scene, key, start: int, width: int, height: int, n: int, k_passes: int,
    options: RenderOptions = DEFAULT_OPTIONS, accum=None,
):
    """Strata start..start+k_passes accumulated into `accum` ((H*W, 3),
    a fresh zero sum when None), each pass keyed by fold_in(key, s)."""
    px0 = pixel_centers(width, height, scene.device)
    acc = torch.zeros((height * width, 3), device=scene.device) if accum is None else accum
    for s in range(start, start + k_passes):
        acc = acc + _trace_stratum(scene, px0, rng.fold_in(key, s), s, n, options)
    return acc


def _finalize(accum, spp: int, width: int, height: int):
    # divide (not multiply-by-reciprocal), as the JAX package does
    return (accum / float(spp)).reshape(height, width, 3)


def render(
    scene, width: int, height: int, n: int, key,
    options: RenderOptions = DEFAULT_OPTIONS,
):
    """Full render: N^2 stratified passes accumulated, averaged by 1/spp.
    Returns the linear-radiance image (H, W, 3) on the scene's device."""
    spp = n * n
    accum = render_passes(scene, key, 0, width, height, n, spp, options)
    return _finalize(accum, spp, width, height)
