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

A launch draws from one block of int32 words, ``launch_words``: its keys
derived on the host, the only place their layout is written. The block
reaches the device one way (rng.device_words: on a card one non-blocking
copy from pinned memory), and ``trace_launch`` traces the launch from it:
its path uniforms one rng.uniform_block_words call on the block's first
part (one R1 launch on the card), its camera rays, pixel and lens jitter
included, one launch_rays_table call on its second (one launch of R2,
csrc/camera.cu, bit-equal to its plain twin camera_rays_table_plain).
Nothing in a trace is derived or copied from the host once its words lie
on the device, so a captured CUDA graph (the train step's,
parallel/sharded) draws anew at each replay from the words written
before it.

``render`` runs the strata in chunks of PASS_CHUNK (each through
render_passes), and takes ``accum``/``start_pass`` to resume a partial
render: render/progressive.py checkpoints between chunks. Every division
by a count divides by a float32 tensor on the dividend's device: on CUDA
torch computes a tensor divided by a Python number (a CPU scalar) as a
product with its reciprocal, which can round differently from the JAX
package's division.

The pass loop's layers are spans of utils/profiling (recorded while a
profiler runs): ``plu.render`` (one image, a request), and inside it, a
launch at a time, ``plu.render.keys`` (the launch's words derived on
Python ints), ``plu.render.draws`` (the words' copy and R1's wrapper),
``plu.render.rays`` (R2's), ``plu.render.radiance`` (K1's primary hit and
K2 or K3, with the table build ``plu.tables.pack``),
``plu.render.accumulate``, then ``plu.render.finalize``.
"""

from __future__ import annotations

import numpy as np
import torch

from plutracer_tpu_torch.semantics import DEFAULT_OPTIONS, RenderOptions
from plutracer_tpu_torch import rng
from plutracer_tpu_torch.ops.camera import generate_rays
from plutracer_tpu_torch.render.integrator import (
    radiance_of_uniforms,
    resolve_integrator_backend,
)
from plutracer_tpu_torch.utils import profiling

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


def launch_words(keys, strata, max_bounces: int) -> np.ndarray:
    """The int32 words a launch of S = len(keys) strata draws from, built
    on the host: stratum j is keyed keys[j] ((k1, k2) ints) at cell
    strata[j], with (k_px, k_lens, k_path) = split(keys[j], 3)
    (renderer.py:36-41 of the JAX package). First R1's S * max_bounces
    path keys (k1, k2), bounce-major: row i*S + j is fold_in(k_path_j, i),
    bounce i's path uniforms of stratum j (integrator.py:283-284); then
    R2's S rows: the cell, then k_px's and k_lens's words. Each uint32
    word as its int32 bit pattern."""
    trip = [rng.split_words(k, 3) for k in keys]
    path = [w for i in range(max_bounces) for t in trip for w in rng.fold_in_words(t[2], i)]
    rows = [w for s, t in zip(strata, trip) for w in (int(s), *t[0], *t[1])]
    return np.array(path + rows, dtype=np.uint32).view(np.int32)


def camera_rays_table_plain(cam, px0, table, n: int):
    """(o, d), (S*B, 3) each: the primary rays of a launch of S strata of
    the B pixels px0, stratum j from the cell and the jitter keys (k_px,
    k_lens) of row j of `table` (launch_words' rows, (S, 5) int32, read as
    tensors on px0's device), at rows j*B..(j+1)*B: px = px0 + (cell +
    uniform(k_px, (B, 2)) * 0.999) / n, the lens likewise from k_lens
    (inc/sampler.h:44-50), then generate_rays. The plain twin of R2
    (ops/cuda/camera_kernel.camera_rays_table_cuda)."""
    S, B = table.shape[0], px0.shape[0]
    w = table.to(torch.int64) & 0xFFFFFFFF
    jit = rng.uniform_block_plain(torch.cat([w[:, 1:3], w[:, 3:5]]), 2 * B, px0.device)
    jit = jit.reshape(2, S, B, 2)
    c = w[:, 0]
    cell = torch.stack([c % n, c // n], -1).to(torch.float32)[:, None]
    px = px0 + over(cell + jit[0] * 0.999, n)
    lens = over(cell + jit[1] * 0.999, n)
    return generate_rays(cam, px.reshape(S * B, 2), lens.reshape(S * B, 2))


def launch_rays_table(scene, px0, table, n: int):
    """The primary rays (o, d) of a launch from its R2 rows `table`
    (camera_rays_table_plain's contract): one launch of R2 on a CUDA
    device, reading the table on the card; the plain twin on the CPU; any
    other device raises."""
    dev = px0.device
    with profiling.span("plu.render.rays"):
        if dev.type == "cuda":
            from plutracer_tpu_torch.ops.cuda.camera_kernel import camera_rays_table_cuda

            return camera_rays_table_cuda(scene.camera, px0, table, n)
        if dev.type != "cpu":
            raise ValueError(f"launch_rays_table: no camera rays for device {dev}")
        return camera_rays_table_plain(scene.camera, px0, table, n)


def launch_inputs(scene, px0, words, S: int, n: int, options: RenderOptions):
    """The primary rays o, d ((S*B, 3) each) and the path uniforms u
    ((max_bounces, S*B, 12)) of a launch of S strata of the B pixels px0,
    stratum j at rows j*B..(j+1)*B, drawn from the launch's `words`
    (launch_words' block: a host array, sent by rng.device_words, or a
    tensor already on px0's device): one uniform_block_words call on its
    first part, one launch_rays_table call on its second."""
    B, mb = px0.shape[0], options.max_bounces
    with profiling.span("plu.render.draws"):
        if not isinstance(words, torch.Tensor):
            words = rng.device_words(words, px0.device)
        u = rng.uniform_block_words(words[:2 * S * mb].view(S * mb, 2), 12 * B)
    o, d = launch_rays_table(scene, px0, words[2 * S * mb:].view(S, -1), n)
    return o, d, u.reshape(mb, S * B, 12)


def trace_launch(scene, px0, words, S: int, n: int, options: RenderOptions):
    """The (S*B, 3) radiance of the launch launch_inputs draws."""
    o, d, u = launch_inputs(scene, px0, words, S, n, options)
    with profiling.span("plu.render.radiance"):
        return radiance_of_uniforms(scene, o, d, u, options)


def _stratum_words(key, stratum: int, options: RenderOptions) -> np.ndarray:
    """launch_words of one stratum keyed `key` at cell `stratum`."""
    with profiling.span("plu.render.keys"):
        return launch_words([rng.key_words(key)], [stratum], options.max_bounces)


def _stratum_rays(scene, px0, key, stratum: int, n: int, options: RenderOptions):
    """The primary rays o, d and the path uniforms u of one stratified
    sample per pixel from the given stratum cell."""
    return launch_inputs(scene, px0, _stratum_words(key, stratum, options), 1, n, options)


def _trace_stratum(scene, px0, key, stratum: int, n: int, options: RenderOptions):
    """One stratified sample per pixel from the given stratum cell."""
    return trace_launch(scene, px0, _stratum_words(key, stratum, options), 1, n, options)


def render_pass(scene, key, stratum: int, width: int, height: int, n: int,
                options: RenderOptions = DEFAULT_OPTIONS):
    """One stratified pass: every pixel gets one sample from the given
    stratum cell, its random numbers drawn from `key` itself (no fold_in
    by stratum). Returns (H*W, 3) radiance; the function the gradient
    checks and the train step differentiate."""
    return _trace_stratum(scene, pixel_centers(width, height, scene.device), key, stratum, n,
                          options)


def strata_per_launch(scene, options: RenderOptions, rays: int) -> int:
    """The number of strata one launch of the pass loop traces: on the
    kernel path of a CUDA scene enough for LAUNCH_RAYS rays, at most
    MAX_STRATA; else 1."""
    if (scene.device.type != "cuda"
            or resolve_integrator_backend(scene, options, scene.device) != "kernel"):
        return 1
    return max(1, min(MAX_STRATA, -(-LAUNCH_RAYS // rays)))


def stratum_launches(scene, key, pairs, px0, n: int, options: RenderOptions = DEFAULT_OPTIONS):
    """The (rows of px0, 3) radiance of each (key index, stratum) pair, in
    order: pair (j, s) is one sample per pixel of px0 from stratum cell s,
    keyed fold_in(key, j) (a render's pass s is the pair (s, s));
    strata_per_launch strata a launch, yielded launch by launch as lists.
    A launch is one launch_words block and one trace_launch call. Every
    span closes before the yield."""
    B = px0.shape[0]
    pairs = list(pairs)
    per = strata_per_launch(scene, options, B)
    base = rng.key_words(key)
    for i in range(0, len(pairs), per):
        group = pairs[i:i + per]
        with profiling.span("plu.render.keys"):
            words = launch_words([rng.fold_in_words(base, j) for j, _ in group],
                                 [s for _, s in group], options.max_bounces)
        L = trace_launch(scene, px0, words, len(group), n, options)
        yield [L[j * B:(j + 1) * B] for j in range(len(group))]


def zeros_accum(width: int, height: int, device="cpu") -> torch.Tensor:
    """A (H*W, 3) zero accumulator on `device`."""
    return torch.zeros((height * width, 3), device=device)


def render_passes(
    scene, key, start: int, width: int, height: int, n: int, k_passes: int,
    options: RenderOptions = DEFAULT_OPTIONS, accum=None,
):
    """The strata start..start+k_passes accumulated in order into `accum`
    ((H*W, 3), a fresh zero sum when None), each pass keyed by
    fold_in(key, s); strata_per_launch strata a launch."""
    acc = zeros_accum(width, height, scene.device) if accum is None else accum
    strata = range(start, start + k_passes)
    for launch in stratum_launches(scene, key, [(s, s) for s in strata],
                                   pixel_centers(width, height, scene.device), n, options):
        with profiling.span("plu.render.accumulate"):
            for L in launch:
                acc = acc + L
    return acc


def _finalize(accum, spp: int, width: int, height: int):
    # divide (not multiply-by-reciprocal), as the JAX package does
    with profiling.span("plu.render.finalize"):
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
    with profiling.span("plu.render", request=True):
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
