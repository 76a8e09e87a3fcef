"""Render driver: stratified multi-pass accumulation.

Each pixel gets an N x N stratified jittered sample grid (spp = N^2,
src/main.cpp:170). The whole image is one batch of rays per stratum: pass
s handles stratum cell (s%N, s//N) for every pixel at once, and the N^2
passes accumulate into the framebuffer. Keys follow the JAX package
exactly (fold_in(key, s) per pass, split into pixel / lens / path keys),
so a render at the same seed draws the same random numbers.

On the kernel path (a CUDA scene the kernels take) one launch traces
several strata: enough that it holds at least LAUNCH_RAYS rays, at most
MAX_STRATA strata (the JAX package's render_passes runs up to PASS_CHUNK
= 16 strata in one dispatch). A 256x256 pass is 65,536 rays, a quarter of
what keeps the card's warps busy while a few long paths finish. Each
stratum's rays and uniforms are drawn exactly as they are alone, the
kernels compute every ray independently of its place in the batch, and
the strata are accumulated in order, so the image is bit-identical to one
stratum a launch. The plain path keeps one stratum a call: torch's
vectorised CPU kernels round some lanes differently by position.
"""

from __future__ import annotations

import torch

from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS, RenderOptions
from plutracer_tpu_torch import rng
from plutracer_tpu_torch.ops.camera import generate_rays
from plutracer_tpu_torch.render.integrator import (
    draw_uniforms,
    radiance_of_uniforms,
    resolve_integrator_backend,
)

# rays a kernel launch of the pass loop holds at least, and the most strata
# it takes
LAUNCH_RAYS = 262144
MAX_STRATA = 16


def pixel_centers(width: int, height: int, device="cpu") -> torch.Tensor:
    """(H*W, 2) integer pixel coordinates (x, y), row-major."""
    xs = torch.arange(width, dtype=torch.float32, device=device)
    ys = torch.arange(height, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)


def _stratum_rays(scene, px0, key, stratum: int, n: int, options: RenderOptions):
    """The primary rays o, d and the path uniforms u of one stratified
    sample per pixel from the given stratum cell."""
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
    return o, d, draw_uniforms(k_path, B, options.max_bounces, dev)


def _trace_stratum(scene, px0, key, stratum: int, n: int, options: RenderOptions):
    """One stratified sample per pixel from the given stratum cell."""
    return radiance_of_uniforms(scene, *_stratum_rays(scene, px0, key, stratum, n, options),
                                options)


def render_pass(scene, key, stratum: int, width: int, height: int, n: int,
                options: RenderOptions = DEFAULT_OPTIONS):
    """One stratified pass: every pixel gets one sample from the given
    stratum cell, its random numbers drawn from `key` itself (no fold_in
    by stratum). Returns (H*W, 3) radiance; the function the gradient
    checks and the train step differentiate."""
    return _trace_stratum(scene, pixel_centers(width, height, scene.device), key, stratum, n,
                          options)


def strata_per_launch(scene, options: RenderOptions, rays: int) -> int:
    """Strata one launch of the pass loop traces: on the kernel path of a
    CUDA scene enough for LAUNCH_RAYS rays, at most MAX_STRATA; else 1."""
    if (scene.device.type != "cuda"
            or resolve_integrator_backend(scene, options, scene.device) != "kernel"):
        return 1
    return max(1, min(MAX_STRATA, -(-LAUNCH_RAYS // rays)))


def render_passes(
    scene, key, start: int, width: int, height: int, n: int, k_passes: int,
    options: RenderOptions = DEFAULT_OPTIONS, accum=None,
):
    """Strata start..start+k_passes accumulated in order into `accum`
    ((H*W, 3), a fresh zero sum when None), each pass keyed by
    fold_in(key, s); strata_per_launch strata a launch."""
    px0 = pixel_centers(width, height, scene.device)
    B = px0.shape[0]
    acc = torch.zeros((height * width, 3), device=scene.device) if accum is None else accum
    per = strata_per_launch(scene, options, B)
    end = start + k_passes
    for s0 in range(start, end, per):
        strata = range(s0, min(s0 + per, end))
        o, d, u = zip(*(_stratum_rays(scene, px0, rng.fold_in(key, s), s, n, options)
                        for s in strata))
        L = radiance_of_uniforms(scene, torch.cat(o), torch.cat(d), torch.cat(u, 1), options)
        for j in range(len(strata)):
            acc = acc + L[j * B:(j + 1) * B]
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
