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
stratum a launch. The plain path keeps one stratum a call.

``render`` runs the strata in chunks of PASS_CHUNK (each through
render_passes), and takes ``accum``/``start_pass`` to resume a partial
render: render/progressive.py checkpoints between chunks. Every division
by a count divides by a float32 tensor on the dividend's device: on CUDA
torch computes a tensor divided by a Python number (a CPU scalar) as a
product with its reciprocal, which can round differently from the JAX
package's division.
"""

from __future__ import annotations

import torch

from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS, RenderOptions
from plutracer_tpu_torch import rng
from plutracer_tpu_torch.ops.camera import generate_rays
from plutracer_tpu_torch.render.integrator import (
    radiance_of_uniforms,
    resolve_integrator_backend,
)

# rays a kernel launch of the pass loop holds at least, and the most strata
# it takes
LAUNCH_RAYS = 262144
MAX_STRATA = 16
# strata a chunk of render: the JAX package's dispatch (and checkpoint) unit
PASS_CHUNK = 16


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
    stratum j keyed keys[j] ((k1, k2) ints): with (k_px, k_lens, k_path) =
    split(keys[j], 3) (renderer.py:36-41 of the JAX package), its pixel
    and lens jitter uniform(k_px, (B, 2)) and uniform(k_lens, (B, 2)), and
    bounce i's path uniforms uniform(fold_in(k_path, i), (B, 12))
    (integrator.py:283-284). Returns (jit (2, S, B, 2): pixel then lens,
    u (max_bounces, S*B, 12): stratum j's rays at rows j*B..(j+1)*B), two
    rng.uniform_block calls: two R1 launches on the card, whatever S."""
    S = len(keys)
    trip = [rng.split_words(k, 3) for k in keys]
    jit = rng.uniform_block([t[0] for t in trip] + [t[1] for t in trip], 2 * B, device)
    u = rng.uniform_block([rng.fold_in_words(t[2], i) for i in range(max_bounces) for t in trip],
                          12 * B, device)
    return jit.reshape(2, S, B, 2), u.reshape(max_bounces, S * B, 12)


def _sample_positions(px0, jit_px, jit_lens, stratum: int, n: int):
    """(px, lens): the jittered pixel and lens positions of one stratified
    sample per pixel from the given stratum cell, (cell + u*0.999)/n
    (inc/sampler.h:44-50), from the (B, 2) uniforms jit_px, jit_lens."""
    cell = torch.tensor([stratum % n, stratum // n], dtype=torch.float32, device=px0.device)
    return px0 + over(cell + jit_px * 0.999, n), over(cell + jit_lens * 0.999, n)


def _camera_rays(scene, px0, jit, j: int, stratum: int, n: int):
    """o, d of stratum j of a launch_draws jitter block, from cell `stratum`."""
    return generate_rays(scene.camera, *_sample_positions(px0, jit[0, j], jit[1, j], stratum, n))


def _stratum_rays(scene, px0, key, stratum: int, n: int, options: RenderOptions):
    """The primary rays o, d and the path uniforms u of one stratified
    sample per pixel from the given stratum cell."""
    jit, u = launch_draws([rng.key_words(key)], px0.shape[0], options.max_bounces, px0.device)
    return (*_camera_rays(scene, px0, jit, 0, stratum, n), u)


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


def stratum_launches(scene, key, pairs, px0, n: int, options: RenderOptions = DEFAULT_OPTIONS):
    """The (rows of px0, 3) radiance of each (key index, stratum) pair, in
    order: pair (j, s) is one sample per pixel of px0 from stratum cell s,
    keyed fold_in(key, j) (a render's pass s is the pair (s, s));
    strata_per_launch strata a launch, yielded launch by launch as lists.
    A launch's random numbers are one launch_draws call."""
    B = px0.shape[0]
    pairs = list(pairs)
    per = strata_per_launch(scene, options, B)
    words = rng.key_words(key)
    for i in range(0, len(pairs), per):
        group = pairs[i:i + per]
        jit, u = launch_draws([rng.fold_in_words(words, j) for j, _ in group], B,
                              options.max_bounces, px0.device)
        o, d = zip(*(_camera_rays(scene, px0, jit, k, s, n) for k, (_, s) in enumerate(group)))
        L = radiance_of_uniforms(scene, torch.cat(o), torch.cat(d), u, options)
        yield [L[j * B:(j + 1) * B] for j in range(len(group))]


def zeros_accum(width: int, height: int, device="cpu") -> torch.Tensor:
    """A (H*W, 3) zero accumulator on `device`."""
    return torch.zeros((height * width, 3), device=device)


def render_passes(
    scene, key, start: int, width: int, height: int, n: int, k_passes: int,
    options: RenderOptions = DEFAULT_OPTIONS, accum=None,
):
    """Strata start..start+k_passes accumulated in order into `accum`
    ((H*W, 3), a fresh zero sum when None), each pass keyed by
    fold_in(key, s); strata_per_launch strata a launch."""
    acc = zeros_accum(width, height, scene.device) if accum is None else accum
    strata = range(start, start + k_passes)
    for launch in stratum_launches(scene, key, [(s, s) for s in strata],
                                   pixel_centers(width, height, scene.device), n, options):
        for L in launch:
            acc = acc + L
    return acc


def _finalize(accum, spp: int, width: int, height: int):
    # divide (not multiply-by-reciprocal), as the JAX package does
    return over(accum, spp).reshape(height, width, 3)


def render(
    scene, width: int, height: int, n: int, key,
    options: RenderOptions = DEFAULT_OPTIONS, accum=None, start_pass: int = 0,
):
    """Full render: N^2 stratified passes accumulated, averaged by 1/spp.
    Returns the linear-radiance image (H, W, 3) on the scene's device.
    `accum` ((H*W, 3), the sum of passes 0..start_pass-1) and `start_pass`
    resume a partial render; the strata run in chunks of PASS_CHUNK."""
    spp = n * n
    if accum is None:
        accum = zeros_accum(width, height, scene.device)
    s = start_pass
    while s < spp:
        k = min(PASS_CHUNK, spp - s)
        accum = render_passes(scene, key, s, width, height, n, k, options, accum=accum)
        s += k
    return _finalize(accum, spp, width, height)


def render_image(scene, width: int, height: int, n: int, seed: int = 0,
                 options: RenderOptions = DEFAULT_OPTIONS) -> torch.Tensor:
    """Render + tonemap: a displayable (H, W, 3) image in [0, 1] on the
    scene's device."""
    from plutracer_tpu_torch.ops.tonemap import postprocess_image

    return postprocess_image(render(scene, width, height, n, rng.PRNGKey(seed), options))
