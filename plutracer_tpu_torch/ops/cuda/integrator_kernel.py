"""K2: the path megakernel (every bounce of every ray in one launch).

``ray_color_kernel`` takes the plain integrator's inputs (scene, rays,
uniforms u of shape (max_bounces, B, 12)). On CUDA tensors it finds the
primary hit with K1 and launches the CUDA kernel (csrc/megakernel.cu,
``ray_color_cuda``); on CPU tensors it runs the plain version,
render/integrator.ray_color, fed the same uniforms. The kernel replaces the JAX package's unrolled Pallas
megakernel (plutracer_tpu/ops/pallas/integrator_kernel.py: _build_kernel
/ _megakernel_call / ray_color_pallas).

``ray_color_cuda.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from plutracer_tpu_torch.ops import intersect
from plutracer_tpu_torch.ops.tables import pack_tables


def _check_inputs(scene, o, d, u, options, tables):
    from plutracer_tpu_torch.render.integrator import megakernel_eligible

    if any(x.requires_grad for x in (o, d, u, *tables)):
        raise NotImplementedError(
            "ray_color_cuda: gradients through the megakernel are not "
            "implemented yet; use integrator_backend='plain'"
        )
    if not o.is_cuda:
        raise ValueError(f"ray_color_cuda: rays must be on a CUDA device, got {o.device}")
    if not megakernel_eligible(scene, options):
        raise ValueError("ray_color_cuda: the scene exceeds the megakernel's "
                         "static limits (see megakernel_eligible)")
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


def ray_color_kernel(scene, o, d, u, options):
    """Radiance (B, 3) for rays o, d (B, 3) and uniforms u
    (max_bounces, B, 12). CUDA tensors: ray_color_cuda. CPU tensors: the
    plain ray_color."""
    if o.is_cuda:
        return ray_color_cuda(scene, o, d, u, options)
    from plutracer_tpu_torch.render.integrator import ray_color

    return ray_color(scene, o, d, u, options)


def ray_color_cuda(scene, o, d, u, options):
    """K1 primary hit, then K2 on the current stream (no synchronisation).
    Raises on anything the kernel does not take: CPU tensors, a scene
    beyond the caps, inputs that require grad."""
    from plutracer_tpu_torch.ops.cuda import build

    tables = pack_tables(scene)
    _check_inputs(scene, o, d, u, options, tables)
    B = o.shape[0]
    out = torch.empty((B, 3), dtype=torch.float32, device=o.device)
    if B == 0:
        return out
    found0, prim0, t0 = intersect.query_lite(scene, o, d)
    t0 = torch.where(found0, t0, intersect._BIG)
    mb = options.max_bounces
    u_soa = u.permute(0, 2, 1).reshape(mb * 12, B).contiguous()
    o_c, d_c = o.contiguous(), d.contiguous()
    atlas = scene.atlas.contiguous()
    rc = build.load().lib.plu_megakernel(
        tables.prim.data_ptr(), tables.prim.shape[0],
        tables.mat.data_ptr(), tables.mat.shape[0],
        tables.tex.data_ptr(), tables.tex.shape[0],
        tables.light.data_ptr(), tables.light.shape[0],
        scene.prims_packed.data_ptr(), scene.prims_packed.shape[0],
        atlas.data_ptr(), atlas.shape[0], int(atlas.shape[0] > 1),
        o_c.data_ptr(), d_c.data_ptr(), prim0.data_ptr(), t0.data_ptr(),
        u_soa.data_ptr(), out.data_ptr(), B, mb,
        int(options.swapped_light_mis_weight), int(options.origin_distance_pdf),
        int(options.shading_normal_le_gate),
        torch.cuda.current_stream(o.device).cuda_stream,
    )
    build.check(rc, "plu_megakernel")
    ray_color_cuda.launches += 1
    return out


ray_color_cuda.launches = 0
