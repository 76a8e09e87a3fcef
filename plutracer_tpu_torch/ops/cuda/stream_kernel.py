"""K3 (the stream kernel) and K4 (the one-bounce kernel): the kernel path
for scenes of 64 < P <= 2^20 primitives.

``ray_color_stream_cuda`` launches K3 (csrc/megakernel_stream.cu): every
bounce of every ray in one launch, the primary hit found in the kernel,
every closest-hit query a walk of scene.bvh. It replaces the JAX
package's _megakernel_call_stream, and its plain version is
render/integrator.ray_color fed the same uniforms.

``onebounce_cuda`` launches K4 (csrc/megakernel_onebounce.cu): one bounce
over the (16, B) carry of render/wavefront.py. It replaces the JAX
package's _megakernel_call_stream_onebounce, and its plain version
``onebounce_plain`` is integrator.plain_bounce under the same host loop;
``onebounce`` takes the kernel on CUDA tensors and the plain version on
CPU tensors.

``ray_color_stream_cuda.launches`` and ``onebounce_cuda.launches`` count
kernel launches; ``ray_color_stream_cuda.debug_launches`` counts K3's K5
launches (debug=True: the telemetry of integrator_kernel.ray_color_kernel).
"""

from __future__ import annotations

import torch

from plutracer_tpu_torch.ops.cuda.intersect_kernel import bvh_pointers


def _check(name, scene, tables, tensors, options):
    from plutracer_tpu_torch.render.integrator import MAX_P, megakernel_eligible

    if any(x.requires_grad for x in (*tensors.values(), *tables)):
        raise NotImplementedError(
            f"{name}: the stream kernels have no backward; differentiate through "
            "render.integrator.radiance (its KernelRadiance Function) or ray_color"
        )
    dev = next(iter(tensors.values())).device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors must be on a CUDA device, got {dev}")
    if not megakernel_eligible(scene, options) or scene.prim_type.shape[0] <= MAX_P:
        raise ValueError(f"{name}: the scene is not on the stream tier "
                         "(64 < P within megakernel_eligible's caps)")
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
        *bvh_pointers(scene),
    )


def _flag_args(options):
    return (options.max_bounces, int(options.swapped_light_mis_weight),
            int(options.origin_distance_pdf), int(options.shading_normal_le_gate))


def ray_color_stream_cuda(scene, o, d, u, options, debug: bool = False):
    """K3 on the current stream (no synchronisation): radiance (B, 3) for
    rays o, d (B, 3) and uniforms u (max_bounces, B, 12); with debug=True
    K3's K5 instantiation, returning (radiance, telemetry (max_bounces,
    DBG_C, B)). Raises on anything the kernel does not take: CPU tensors,
    a scene off the stream tier, inputs that require grad."""
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
    rc = build.load().lib.plu_megakernel_stream(
        *_table_args(scene, tables),
        o.data_ptr(), d.data_ptr(), u_soa.data_ptr(), out.data_ptr(),
        dbg.data_ptr() if debug else None, B,
        *_flag_args(options), torch.cuda.current_stream(o.device).cuda_stream,
    )
    build.check(rc, "plu_megakernel_stream")
    if debug:
        ray_color_stream_cuda.debug_launches += 1
        return out, dbg
    ray_color_stream_cuda.launches += 1
    return out


ray_color_stream_cuda.launches = 0
ray_color_stream_cuda.debug_launches = 0


def onebounce_cuda(scene, tables, carry, u_i, i: int, options):
    """K4 on the current stream (no synchronisation): the carry (16, B)
    after vertex i, for the carry before it and the vertex's uniforms u_i
    (12, B). Raises on anything the kernel does not take."""
    from plutracer_tpu_torch.ops.cuda import build

    if carry.dim() != 2 or carry.shape[0] != 16 or u_i.shape != (12, carry.shape[1]):
        raise ValueError(f"onebounce_cuda: carry must be (16, B) and u_i (12, B), got "
                         f"{tuple(carry.shape)}, {tuple(u_i.shape)}")
    if not 0 <= i < options.max_bounces:
        raise ValueError(f"onebounce_cuda: bounce {i} outside [0, {options.max_bounces})")
    carry, u_i = carry.contiguous(), u_i.contiguous()
    _check("onebounce_cuda", scene, tables, {"carry": carry, "u_i": u_i}, options)
    B = carry.shape[1]
    out = torch.empty_like(carry)
    if B == 0:
        return out
    rc = build.load().lib.plu_megakernel_onebounce(
        *_table_args(scene, tables),
        carry.data_ptr(), out.data_ptr(), u_i.data_ptr(), B, i,
        *_flag_args(options), torch.cuda.current_stream(carry.device).cuda_stream,
    )
    build.check(rc, "plu_megakernel_onebounce")
    onebounce_cuda.launches += 1
    return out


onebounce_cuda.launches = 0


def onebounce_plain(scene, tables, carry, u_i, i: int, options):
    """K4's plain version: integrator.plain_bounce on the carry."""
    from plutracer_tpu_torch.render.integrator import plain_bounce
    from plutracer_tpu_torch.render.wavefront import carry_of, state_of

    return carry_of(plain_bounce(scene, tables, state_of(carry), u_i.T, i, options))


def onebounce(scene, tables, carry, u_i, i: int, options):
    """One bounce of the wavefront carry: K4 on CUDA tensors, the plain
    version on CPU tensors."""
    if carry.is_cuda:
        return onebounce_cuda(scene, tables, carry, u_i, i, options)
    return onebounce_plain(scene, tables, carry, u_i, i, options)
