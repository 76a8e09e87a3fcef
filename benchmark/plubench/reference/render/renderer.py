"""The render driver's plain stages: stratified keys, path uniforms,
camera rays and the average.

Each pixel gets an N x N stratified jittered sample grid (spp = N^2,
src/main.cpp:170): pass s takes stratum cell (s%N, s//N) for every pixel,
keyed fold_in(key, s), split into pixel / lens / path keys. Bounce i's path
uniforms are uniform(fold_in(k_path, i), (B, 12)); the pixel and lens
jitter uniform(k_px, (B, 2)) and uniform(k_lens, (B, 2)). Every division
by a count divides by a float32 tensor on the dividend's device: on CUDA
torch computes a tensor divided by a Python number as a product with its
reciprocal.
"""

from __future__ import annotations

import torch

from plubench.reference import rng
from plubench.reference.ops.camera import generate_rays


def over(x: torch.Tensor, count) -> torch.Tensor:
    """x divided by the number `count`, as IEEE division on every device
    (the divisor is filled on the device: no host-to-device copy)."""
    return x / x.new_full((), float(count))


def pixel_centers(width: int, height: int, device="cpu") -> torch.Tensor:
    """(H*W, 2) integer pixel coordinates (x, y), row-major."""
    xs = torch.arange(width, dtype=torch.float32, device=device)
    ys = torch.arange(height, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)


def launch_draws(keys, B: int, max_bounces: int, device):
    """The random numbers of a launch of S = len(keys) strata of B rays,
    stratum j keyed keys[j] ((k1, k2) ints), with (k_px, k_lens, k_path) =
    split(keys[j], 3) (renderer.py:36-41 of the JAX package): bounce i's
    path uniforms uniform(fold_in(k_path, i), (B, 12)) (integrator.py:
    283-284), drawn here, and the jitter keys (k_px, k_lens) of each
    stratum, handed back as ints for the camera stage to draw the pixel and lens
    jitter from. Returns (jitter keys [(k_px, k_lens)] * S, u (max_bounces,
    S*B, 12): stratum j's rays at rows j*B..(j+1)*B), one rng.uniform_block
    call."""
    trip = [rng.split_words(k, 3) for k in keys]
    u = rng.uniform_block_plain([rng.fold_in_words(t[2], i) for i in range(max_bounces) for t in trip],
                          12 * B, device)
    return [(t[0], t[1]) for t in trip], u.reshape(max_bounces, len(keys) * B, 12)


def jitter_plain(keys, B: int, device):
    """(2, S, B, 2) float32 on `device`: [0, j] = uniform(k_px_j, (B, 2))
    and [1, j] = uniform(k_lens_j, (B, 2)) of the jitter keys keys[j] =
    (k_px_j, k_lens_j), drawn by rng.uniform_block_plain."""
    block = rng.uniform_block_plain([k[0] for k in keys] + [k[1] for k in keys], 2 * B, device)
    return block.reshape(2, len(keys), B, 2)


def jittered_rays(cam, px0, jit, strata, n: int):
    """(o, d), (S*B, 3) each: the primary rays of a launch of S =
    len(strata) strata of the B pixels px0, stratum j from cell strata[j]
    and the jitter jit[:, j] of a jitter_plain block, at rows j*B..(j+1)*B;
    the strata computed together. Each ray's operations are _camera_rays',
    so the rays equal torch.cat of _camera_rays over the launch."""
    S, B = len(strata), px0.shape[0]
    cell = torch.tensor([[s % n, s // n] for s in strata], dtype=torch.float32,
                        device=px0.device)[:, None]
    px = px0 + over(cell + jit[0] * 0.999, n)
    lens = over(cell + jit[1] * 0.999, n)
    return generate_rays(cam, px.reshape(S * B, 2), lens.reshape(S * B, 2))


def camera_rays_plain(cam, px0, keys, strata, n: int):
    """(o, d), (S*B, 3) each: the primary rays of a launch of S =
    len(strata) strata of the B pixels px0, stratum j from cell strata[j]
    and the jitter keys keys[j] = (k_px, k_lens) of launch_draws, at rows
    j*B..(j+1)*B. jitter_plain, then
    jittered_rays."""
    return jittered_rays(cam, px0, jitter_plain(keys, px0.shape[0], px0.device), strata, n)


def _finalize(accum, spp: int, width: int, height: int):
    # divide (not multiply-by-reciprocal), as the JAX package does
    return over(accum, spp).reshape(height, width, 3)
