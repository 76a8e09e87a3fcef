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
stratum a launch. The plain path keeps one stratum a call. A launch's
path uniforms are one launch_draws call (one R1 launch on the card), its
camera rays, pixel and lens jitter included, one launch_rays call: on the
card one launch of R2 (csrc/camera.cu), bit-equal to its plain version
camera_rays_plain.

``render`` runs the strata in chunks of PASS_CHUNK (each through
render_passes), and takes ``accum``/``start_pass`` to resume a partial
render: render/progressive.py checkpoints between chunks. Every division
by a count divides by a float32 tensor on the dividend's device: on CUDA
torch computes a tensor divided by a Python number (a CPU scalar) as a
product with its reciprocal, which can round differently from the JAX
package's division.

The pass loop's layers are spans of utils/profiling (recorded while a
profiler runs): ``plu.render`` (one image, a request), and inside it, a
launch at a time, ``plu.render.keys`` (the launch's keys derived on Python
ints), ``plu.render.draws`` (R1's wrapper), ``plu.render.rays`` (R2's),
``plu.render.radiance`` (K1's primary hit and K2 or K3, with the table
build ``plu.tables.pack``), ``plu.render.accumulate``, then
``plu.render.finalize``.

``trace_stratum_table`` traces one stratum as ``_trace_stratum`` does,
its keys read from a table of words on the device (``stratum_words``)
rather than derived on the host: R1 and R2 read them there on a card, so
a captured CUDA graph (the train step's, parallel/sharded) draws anew at
each replay from the words written before it.
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


def launch_draws(keys, B: int, max_bounces: int, device):
    """The random numbers of a launch of S = len(keys) strata of B rays,
    stratum j keyed keys[j] ((k1, k2) ints), with (k_px, k_lens, k_path) =
    split(keys[j], 3) (renderer.py:36-41 of the JAX package): bounce i's
    path uniforms uniform(fold_in(k_path, i), (B, 12)) (integrator.py:
    283-284), drawn here, and the jitter keys (k_px, k_lens) of each
    stratum, handed back as ints for launch_rays to draw the pixel and lens
    jitter from. Returns (jitter keys [(k_px, k_lens)] * S, u (max_bounces,
    S*B, 12): stratum j's rays at rows j*B..(j+1)*B), one rng.uniform_block
    call: one R1 launch on the card, whatever S."""
    with profiling.span("plu.render.keys"):
        trip = [rng.split_words(k, 3) for k in keys]
        path = [rng.fold_in_words(t[2], i) for i in range(max_bounces) for t in trip]
    with profiling.span("plu.render.draws"):
        u = rng.uniform_block(path, 12 * B, device)
    return [(t[0], t[1]) for t in trip], u.reshape(max_bounces, len(keys) * B, 12)


def jitter_plain(keys, B: int, device):
    """(2, S, B, 2) float32 on `device`: [0, j] = uniform(k_px_j, (B, 2))
    and [1, j] = uniform(k_lens_j, (B, 2)) of the jitter keys keys[j] =
    (k_px_j, k_lens_j), drawn by rng.uniform_block_plain."""
    block = rng.uniform_block_plain([k[0] for k in keys] + [k[1] for k in keys], 2 * B, device)
    return block.reshape(2, len(keys), B, 2)


def _sample_positions(px0, jit_px, jit_lens, stratum: int, n: int):
    """(px, lens): the jittered pixel and lens positions of one stratified
    sample per pixel from the given stratum cell, (cell + u*0.999)/n
    (inc/sampler.h:44-50), from the (B, 2) uniforms jit_px, jit_lens."""
    cell = torch.tensor([stratum % n, stratum // n], dtype=torch.float32, device=px0.device)
    return px0 + over(cell + jit_px * 0.999, n), over(cell + jit_lens * 0.999, n)


def _camera_rays(scene, px0, jit, j: int, stratum: int, n: int):
    """o, d of stratum j of a jitter_plain block, from cell `stratum`."""
    return generate_rays(scene.camera, *_sample_positions(px0, jit[0, j], jit[1, j], stratum, n))


def jittered_rays(cam, px0, jit, strata, n: int):
    """(o, d), (S*B, 3) each: the primary rays of a launch of S =
    len(strata) strata of the B pixels px0, stratum j from cell strata[j]
    and the jitter jit[:, j] of a jitter_plain block, at rows j*B..(j+1)*B;
    the strata computed together. Each ray's operations are _camera_rays',
    so the rays equal torch.cat of _camera_rays over the launch."""
    cell = torch.tensor([[s % n, s // n] for s in strata], dtype=torch.float32,
                        device=px0.device)
    return _rays_of_cells(cam, px0, jit, cell, n)


def _rays_of_cells(cam, px0, jit, cell, n: int):
    """jittered_rays from the strata's (S, 2) float32 cells (x, y)."""
    S, B = cell.shape[0], px0.shape[0]
    cell = cell[:, None]
    px = px0 + over(cell + jit[0] * 0.999, n)
    lens = over(cell + jit[1] * 0.999, n)
    return generate_rays(cam, px.reshape(S * B, 2), lens.reshape(S * B, 2))


def camera_rays_plain(cam, px0, keys, strata, n: int):
    """(o, d), (S*B, 3) each: the primary rays of a launch of S =
    len(strata) strata of the B pixels px0, stratum j from cell strata[j]
    and the jitter keys keys[j] = (k_px, k_lens) of launch_draws, at rows
    j*B..(j+1)*B. The plain version of R2 (csrc/camera.cu): jitter_plain,
    then jittered_rays."""
    return jittered_rays(cam, px0, jitter_plain(keys, px0.shape[0], px0.device), strata, n)


def launch_rays(scene, px0, keys, strata, n: int):
    """The primary rays (o, d) of a launch (camera_rays_plain's contract):
    one launch of R2 on a CUDA device (it raises where it cannot launch),
    camera_rays_plain on the CPU; any other device raises."""
    dev = px0.device
    with profiling.span("plu.render.rays"):
        if dev.type == "cuda":
            from plutracer_tpu_torch.ops.cuda.camera_kernel import camera_rays_cuda

            return camera_rays_cuda(scene.camera, px0, keys, strata, n)
        if dev.type != "cpu":
            raise ValueError(f"launch_rays: no camera rays for device {dev}")
        return camera_rays_plain(scene.camera, px0, keys, strata, n)


def stratum_words(key, stratum: int, max_bounces: int):
    """The int32 bit patterns of the words one stratum keyed `key` draws
    from, in the layout trace_stratum_table reads: the max_bounces path
    keys (k1, k2) of R1's block, then the stratum's cell and its jitter
    keys' words (k_px's, then k_lens's), the row R2 reads
    (ops/cuda/camera_kernel.STRATUM_WORDS). The keys are launch_draws'
    for the one stratum, derived on the host."""
    trip = rng.split_words(rng.key_words(key), 3)
    path = [w for i in range(max_bounces) for w in rng.fold_in_words(trip[2], i)]
    words = path + [int(stratum), *trip[0], *trip[1]]
    return [w - 2**32 if w >= 2**31 else w for w in words]


def camera_rays_table_plain(cam, px0, table, n: int):
    """(o, d), (S*B, 3) each: camera_rays_plain of the strata whose cells
    and jitter key words are the rows of `table`, (S, STRATUM_WORDS) int32
    (stratum_words' last five), read as tensors on px0's device: the plain
    twin of R2's table entry (ops/cuda/camera_kernel.camera_rays_table_cuda)."""
    w = table.to(torch.int64) & 0xFFFFFFFF
    jit = rng.uniform_block_plain(torch.cat([w[:, 1:3], w[:, 3:5]]), 2 * px0.shape[0],
                                  px0.device)
    c = w[:, 0]
    cell = torch.stack([c % n, c // n], -1).to(torch.float32)
    return _rays_of_cells(cam, px0, jit.reshape(2, table.shape[0], px0.shape[0], 2), cell, n)


def launch_rays_table(scene, px0, table, n: int):
    """launch_rays with the strata's cells and jitter keys read from
    `table` (camera_rays_table_plain's contract): one launch of R2's table
    entry on a CUDA device, reading the table on the card; the plain twin
    on the CPU; any other device raises."""
    dev = px0.device
    with profiling.span("plu.render.rays"):
        if dev.type == "cuda":
            from plutracer_tpu_torch.ops.cuda.camera_kernel import camera_rays_table_cuda

            return camera_rays_table_cuda(scene.camera, px0, table, n)
        if dev.type != "cpu":
            raise ValueError(f"launch_rays_table: no camera rays for device {dev}")
        return camera_rays_table_plain(scene.camera, px0, table, n)


def trace_stratum_table(scene, px0, words, n: int, options: RenderOptions):
    """_trace_stratum with its keys read from `words`, stratum_words'
    layout as an int32 tensor on px0's device: the same rays, uniforms and
    radiance, bit for bit, with nothing derived or copied from the host
    (on a card: one R1 and one R2 launch reading the words where they
    lie), so a CUDA graph can capture it."""
    B, mb = px0.shape[0], options.max_bounces
    with profiling.span("plu.render.draws"):
        u = rng.uniform_block_words(words[:2 * mb].view(mb, 2), 12 * B)
    o, d = launch_rays_table(scene, px0, words[2 * mb:].view(1, -1), n)
    return radiance_of_uniforms(scene, o, d, u.reshape(mb, B, 12), options)


def _stratum_rays(scene, px0, key, stratum: int, n: int, options: RenderOptions):
    """The primary rays o, d and the path uniforms u of one stratified
    sample per pixel from the given stratum cell."""
    keys, u = launch_draws([rng.key_words(key)], px0.shape[0], options.max_bounces, px0.device)
    return (*launch_rays(scene, px0, keys, [stratum], n), u)


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
    A launch's path uniforms are one launch_draws call, its camera rays
    one launch_rays call. Every span closes before the yield."""
    B = px0.shape[0]
    pairs = list(pairs)
    per = strata_per_launch(scene, options, B)
    words = rng.key_words(key)
    for i in range(0, len(pairs), per):
        group = pairs[i:i + per]
        with profiling.span("plu.render.keys"):
            keys = [rng.fold_in_words(words, j) for j, _ in group]
        keys, u = launch_draws(keys, B, options.max_bounces, px0.device)
        o, d = launch_rays(scene, px0, keys, [s for _, s in group], n)
        with profiling.span("plu.render.radiance"):
            L = radiance_of_uniforms(scene, o, d, u, options)
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
