"""K2: the path megakernel (every bounce of every ray in one launch), and
the kernel path's dispatch.

``ray_color_kernel`` takes the plain integrator's inputs (scene, rays,
uniforms u of shape (max_bounces, B, 12)) and goes by
integrator.kernel_tier: "k2" runs ``ray_color_cuda`` (K1 finds the
primary hit, then the CUDA kernel csrc/megakernel.cu), "k3" the stream
kernel (stream_kernel.ray_color_stream_cuda), "k4" the wavefront loop of
render/wavefront.py over the one-bounce kernel. On CPU tensors each takes
its plain version fed the same uniforms: render/integrator.ray_color_plain, or
the wavefront loop over integrator.plain_bounce. K2 replaces the JAX
package's unrolled Pallas megakernel
(plutracer_tpu/ops/pallas/integrator_kernel.py: _build_kernel /
_megakernel_call / ray_color_pallas).

``debug=True`` asks for K5, the per-bounce telemetry of the JAX kernels'
debug mode (integrator_kernel.py:1229-1240, :1856-1867): the same launch
of K2 or K3 in its DEBUG instantiation, which also writes (max_bounces,
DBG_C, B) channels (ops/cuda.DBG_CHANNELS); K4 has none, so a
debug request under stream_wavefront takes K3, as the JAX package does.
The plain version is ray_color_plain(..., debug=True).

Each K2 launch counts once in utils/profiling's ``launches.k2``, each of
its K5 instantiation in ``launches.k2_debug`` (``launches.k3`` and
``launches.k3_debug`` for stream_kernel.ray_color_stream_cuda).
"""

from __future__ import annotations

import torch

from plutracer_tpu_torch.ops import intersect
from plutracer_tpu_torch.ops.cuda import DBG_C
from plutracer_tpu_torch.ops.tables import pack_tables
from plutracer_tpu_torch.utils import profiling


def _check_inputs(scene, o, d, u, options, tables):
    from plutracer_tpu_torch.render.integrator import kernel_tier, megakernel_eligible

    if any(x.requires_grad for x in (o, d, u, *tables)):
        raise NotImplementedError(
            "ray_color_cuda: the megakernel has no backward; differentiate through "
            "render.integrator.ray_color (its KernelRadiance Function) or ray_color_plain"
        )
    if not o.is_cuda:
        raise ValueError(f"ray_color_cuda: rays must be on a CUDA device, got {o.device}")
    if not megakernel_eligible(scene, options) or kernel_tier(scene, options) != "k2":
        raise ValueError("ray_color_cuda: the scene is not on the megakernel's tier "
                         "(see megakernel_eligible and kernel_tier: P > 64 or tables past "
                         "K2's shared memory take K3)")
    B = o.shape[0]
    if o.dim() != 2 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError(f"ray_color_cuda: o, d must be (B, 3), got {tuple(o.shape)}, {tuple(d.shape)}")
    if u.shape != (options.max_bounces, B, 12):
        raise ValueError(f"ray_color_cuda: u must be ({options.max_bounces}, {B}, 12), "
                         f"got {tuple(u.shape)}")
    for name, x in (("o", o), ("d", d), ("u", u), ("atlas", scene.atlas),
                    ("prims_packed", scene.prims_packed)):
        if x.device != o.device or x.dtype != torch.float32:
            raise ValueError(f"ray_color_cuda: {name} must be float32 on {o.device}")


def ray_color_kernel(scene, o, d, u, options, debug: bool = False):
    """Radiance (B, 3) for rays o, d (B, 3) and uniforms u
    (max_bounces, B, 12), by kernel_tier: K2, K3, or the wavefront loop
    over K4; with debug=True, (radiance, telemetry (max_bounces, DBG_C,
    B)) from K2 or K3. CPU tensors: the plain versions."""
    from plutracer_tpu_torch.render.integrator import kernel_tier, ray_color_plain

    tier = kernel_tier(scene, options)
    if tier == "k4" and not debug:
        from plutracer_tpu_torch.render.wavefront import ray_color_wavefront

        return ray_color_wavefront(scene, o, d, u, options)
    if not o.is_cuda:
        return ray_color_plain(scene, o, d, u, options, debug=debug)
    if tier != "k2":
        from plutracer_tpu_torch.ops.cuda.stream_kernel import ray_color_stream_cuda

        return ray_color_stream_cuda(scene, o, d, u, options, debug=debug)
    return ray_color_cuda(scene, o, d, u, options, debug=debug)


def ray_color_cuda(scene, o, d, u, options, debug: bool = False):
    """The primary hit (query_lite by options.intersect_backend: K1 unless
    it names another engine), then K2 on the rays' card and its current
    stream (no synchronisation);
    with debug=True K2's K5 instantiation, returning (radiance, telemetry).
    Raises on anything the kernel does not take: CPU tensors, a scene off
    its tier, inputs that require grad."""
    from plutracer_tpu_torch.ops.cuda import build

    tables = pack_tables(scene)
    _check_inputs(scene, o, d, u, options, tables)
    B = o.shape[0]
    mb = options.max_bounces
    out = torch.empty((B, 3), dtype=torch.float32, device=o.device)
    dbg = torch.empty((mb, DBG_C, B), dtype=torch.float32, device=o.device) if debug else None
    if B == 0:
        return (out, dbg) if debug else out
    # the primary hit by options.intersect_backend; K2 reads t0 only
    # through found = t0 < T_MAX, so a miss's t needs no rewriting
    _, prim0, t0 = intersect.query_lite(scene, o, d, options)
    u_soa = u.permute(0, 2, 1).reshape(mb * 12, B).contiguous()
    o_c, d_c = o.contiguous(), d.contiguous()
    atlas = scene.atlas.contiguous()
    lib = build.load().lib
    with build.on_device(o.device) as stream:
        rc = lib.plu_megakernel(
            tables.prim.data_ptr(), tables.prim.shape[0],
            tables.mat.data_ptr(), tables.mat.shape[0],
            tables.tex.data_ptr(), tables.tex.shape[0],
            tables.light.data_ptr(), tables.light.shape[0],
            scene.prims_packed.data_ptr(), scene.prims_packed.shape[0],
            atlas.data_ptr(), atlas.shape[0], int(atlas.shape[0] > 1),
            o_c.data_ptr(), d_c.data_ptr(), prim0.data_ptr(), t0.data_ptr(),
            u_soa.data_ptr(), out.data_ptr(), dbg.data_ptr() if debug else None, B, mb,
            int(options.swapped_light_mis_weight), int(options.origin_distance_pdf),
            int(options.shading_normal_le_gate), stream,
        )
    build.check(rc, "plu_megakernel")
    profiling.count("launches.k2_debug" if debug else "launches.k2")
    return (out, dbg) if debug else out
