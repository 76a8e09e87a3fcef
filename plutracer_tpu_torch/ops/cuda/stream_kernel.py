"""K3 (the stream kernel) and K4 (the one-bounce kernel): the kernel path
for scenes off K2's tier (integrator.kernel_tier: more than 64 primitives,
or tables past K2's shared memory).

``ray_color_stream_cuda`` launches K3 (csrc/megakernel_stream.cu): every
bounce of every ray in one launch, the primary hit found in the kernel,
every closest-hit query a walk of the scene's traversal layout
(scene.walk_nodes / walk_rows). It replaces the JAX
package's _megakernel_call_stream, and its plain version is
render/integrator.ray_color_plain fed the same uniforms.

``onebounce_cuda`` launches K4 (csrc/megakernel_onebounce.cu): one bounce
of the wavefront loop of render/wavefront.py over its Wave (the
lane-major carry, the lanes' rays, the sort keys, the counts, the
radiance at each ray). It replaces the JAX package's
_megakernel_call_stream_onebounce and the host work of its loop, and its
plain version ``onebounce_plain`` is the same contract in torch around
integrator.plain_bounce; ``onebounce`` takes the kernel on CUDA tensors
and the plain version on CPU tensors.

Each launch counts once in utils/profiling: ``launches.k3``,
``launches.k3_debug`` (K3's K5 instantiation, debug=True: the telemetry of
integrator_kernel.ray_color_kernel) or ``launches.k4``.
"""

from __future__ import annotations

import torch

from plutracer_tpu_torch.ops.cuda.intersect_kernel import walk_pointers
from plutracer_tpu_torch.utils import profiling


def _check(name, scene, tables, tensors, options):
    from plutracer_tpu_torch.render.integrator import kernel_tier, megakernel_eligible

    if any(x.requires_grad for x in (*tensors.values(), *tables)):
        raise NotImplementedError(
            f"{name}: the stream kernels have no backward; differentiate through "
            "render.integrator.ray_color (its KernelRadiance Function) or ray_color_plain"
        )
    dev = next(iter(tensors.values())).device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors must be on a CUDA device, got {dev}")
    if not megakernel_eligible(scene, options) or kernel_tier(scene, options) == "k2":
        raise ValueError(f"{name}: the scene is not on the stream tier "
                         "(see megakernel_eligible and kernel_tier)")
    for what, x in (*tensors.items(), ("atlas", scene.atlas), *zip(tables._fields, tables)):
        if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous float32 on {dev}, "
                             f"got {x.dtype} on {x.device}")


def _table_args(scene, tables):
    atlas = scene.atlas
    return (
        tables.prim.data_ptr(), tables.prim.shape[0],
        tables.mat.data_ptr(), tables.mat.shape[0],
        tables.tex.data_ptr(), tables.tex.shape[0],
        tables.light.data_ptr(), tables.light.shape[0],
        atlas.data_ptr(), atlas.shape[0], int(atlas.shape[0] > 1),
        *walk_pointers(scene),
    )


def _flag_args(options):
    return (options.max_bounces, int(options.swapped_light_mis_weight),
            int(options.origin_distance_pdf), int(options.shading_normal_le_gate))


def ray_color_stream_cuda(scene, o, d, u, options, debug: bool = False):
    """K3 on the rays' card and its current stream (no synchronisation):
    radiance (B, 3) for rays o, d (B, 3) and uniforms u (max_bounces, B,
    12); with debug=True K3's K5 instantiation, returning (radiance,
    telemetry (max_bounces, DBG_C, B)). Raises on anything the kernel does
    not take: CPU tensors, a scene off the stream tier, inputs that
    require grad."""
    from plutracer_tpu_torch.ops.cuda import DBG_C, build
    from plutracer_tpu_torch.ops.tables import pack_tables

    tables = pack_tables(scene)
    B = o.shape[0]
    mb = options.max_bounces
    if o.dim() != 2 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError(f"ray_color_stream_cuda: o, d must be (B, 3), got "
                         f"{tuple(o.shape)}, {tuple(d.shape)}")
    if u.shape != (mb, B, 12):
        raise ValueError(f"ray_color_stream_cuda: u must be ({mb}, {B}, 12), got {tuple(u.shape)}")
    o, d = o.contiguous(), d.contiguous()
    u_soa = u.permute(0, 2, 1).reshape(mb * 12, B).contiguous()
    _check("ray_color_stream_cuda", scene, tables, {"o": o, "d": d, "u": u_soa}, options)
    out = torch.empty((B, 3), dtype=torch.float32, device=o.device)
    dbg = torch.empty((mb, DBG_C, B), dtype=torch.float32, device=o.device) if debug else None
    if B == 0:
        return (out, dbg) if debug else out
    lib = build.load().lib
    with build.on_device(o.device) as stream:
        rc = lib.plu_megakernel_stream(
            *_table_args(scene, tables),
            o.data_ptr(), d.data_ptr(), u_soa.data_ptr(), out.data_ptr(),
            dbg.data_ptr() if debug else None, B, *_flag_args(options), stream,
        )
    build.check(rc, "plu_megakernel_stream")
    profiling.count("launches.k3_debug" if debug else "launches.k3")
    return (out, dbg) if debug else out


def onebounce_cuda(scene, tables, wave, i: int, perm, options):
    """K4 on the wave's card and its current stream (no synchronisation):
    vertex i of the wavefront's lanes (render/wavefront.py: launch 0 finds
    the primary hit; under a sort a lane reads its state at perm[lane]),
    writing the Wave's next carry, lane rays, keys, counts and the
    radiance of the rays that end. Raises on anything the kernel does not
    take."""
    from plutracer_tpu_torch.ops.cuda import build
    from plutracer_tpu_torch.render.wavefront import CARRY_W, SORTS

    B, mb = wave.B, options.max_bounces
    if not 0 <= i < mb:
        raise ValueError(f"onebounce_cuda: bounce {i} outside [0, {mb})")
    if wave.sort not in SORTS or (perm is None) != (i == 0 or wave.sort == "none"):
        raise ValueError(f"onebounce_cuda: launch {i} under sort {wave.sort!r} "
                         f"{'needs' if perm is None else 'takes no'} a permutation")
    shapes = {"o": (B, 3), "d": (B, 3), "carry": (B, CARRY_W), "carry_next": (B, CARRY_W),
              "u": (mb, B, 12), "out": (B, 3), "bounds": (6,)}
    floats = {k: getattr(wave, k) for k in shapes}
    for k, want in shapes.items():
        if tuple(floats[k].shape) != want:
            raise ValueError(f"onebounce_cuda: {k} must be {want}, got {tuple(floats[k].shape)}")
    _check("onebounce_cuda", scene, tables, floats, options)
    ints = {"counts": wave.counts, "orig": wave.orig, "orig_next": wave.orig_next,
            "key": wave.key}
    dev = wave.o.device
    for k, x in ints.items():
        if x is not None and (x.device != dev or x.dtype != torch.int32 or not x.is_contiguous()):
            raise ValueError(f"onebounce_cuda: {k} must be contiguous int32 on {dev}")
    if perm is not None and (perm.device != dev or perm.dtype != torch.int64
                             or perm.shape != (B,)):
        raise ValueError("onebounce_cuda: perm must be (B,) int64 on the carry's device")
    if any(x.data_ptr() % 16 for x in (wave.carry, wave.carry_next, wave.u)):
        raise ValueError("onebounce_cuda: carry and u must be 16-byte aligned (float4 reads)")
    if B == 0:
        return
    sorting = wave.sort != "none" and i < mb - 1
    ptr = lambda x: None if x is None else x.data_ptr()
    lib = build.load().lib
    with build.on_device(dev) as stream:
        rc = lib.plu_megakernel_onebounce(
            *_table_args(scene, tables),
            wave.o.data_ptr(), wave.d.data_ptr(), wave.carry.data_ptr(),
            wave.carry_next.data_ptr(), ptr(perm), ptr(wave.orig if i > 0 else None),
            ptr(wave.orig_next if sorting else None), wave.u.data_ptr(), wave.out.data_ptr(),
            ptr(wave.key if sorting else None), wave.counts.data_ptr(), wave.bounds.data_ptr(),
            B, i, SORTS.index(wave.sort), *_flag_args(options), stream,
        )
    build.check(rc, "plu_megakernel_onebounce")
    profiling.count("launches.k4")


def onebounce_plain(scene, tables, wave, i: int, perm, options):
    """K4's plain version: the same contract in torch around
    integrator.plain_bounce (which runs on every lane; only the lanes K4
    runs are written). Its primary hit is intersect.query_lite's, by
    options.intersect_backend."""
    from plutracer_tpu_torch.ops import intersect
    from plutracer_tpu_torch.render.integrator import PathState, plain_bounce
    from plutracer_tpu_torch.render.wavefront import (
        carry_of, live_lanes, sort_keys, state_of,
    )

    B, mb, dev = wave.B, options.max_bounces, wave.o.device
    last = i == mb - 1
    lane = torch.arange(B, device=dev)
    if i == 0:
        o, d = wave.o, wave.d
        found, prim, t = intersect.query_lite(scene, o, d, options)
        carry = carry_of(PathState(
            o=o, d=d, T=torch.ones_like(o), L=torch.zeros_like(o),
            prev_spec=torch.zeros(B, dtype=torch.bool, device=dev),
            alive=torch.ones(B, dtype=torch.bool, device=dev), prim=prim, t=t))
        ray, take = lane, torch.ones(B, dtype=torch.bool, device=dev)
    else:
        src = lane if perm is None else perm
        carry = wave.carry[src]
        take = live_lanes(carry) if perm is None else lane < wave.counts[i - 1]
        # a lane past the live prefix holds no ray (K4 reads nothing there)
        ray = lane if wave.orig is None else torch.where(take, wave.orig[src].long(), lane)
    nxt = carry_of(plain_bounce(scene, tables, state_of(carry), wave.u[i][ray], i, options))
    live_after = take & live_lanes(nxt)
    ended = take & (~live_after | last)
    wave.out[ray[ended]] = nxt[ended, 9:12]
    if not last:
        write = take if wave.sort == "none" else live_after
        wave.carry_next[write] = nxt[write]
        if wave.sort != "none":
            wave.orig_next[take] = ray[take].to(torch.int32)
            lo, hi = wave.bounds[:3], wave.bounds[3:]
            wave.key.copy_(sort_keys(nxt, wave.sort, lo, hi, live=live_after))
    wave.counts[i] += live_after.sum().to(torch.int32)
    wave.counts[mb + i] += ended.sum().to(torch.int32)


def onebounce(scene, tables, wave, i: int, perm, options):
    """One bounce of the wavefront loop: K4 on CUDA tensors, the plain
    version on CPU tensors."""
    if wave.o.is_cuda:
        return onebounce_cuda(scene, tables, wave, i, perm, options)
    return onebounce_plain(scene, tables, wave, i, perm, options)
