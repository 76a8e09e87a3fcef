"""K1: closest hit over the type-partitioned primitive table.

``closest_hit`` runs the CUDA kernel (csrc/closest_hit.cu, launched by
``closest_hit_cuda``) on CUDA tensors and its plain PyTorch version
``closest_hit_plain`` on CPU tensors. The kernel replaces the JAX package's Pallas closest-hit kernel
(plutracer_tpu/ops/pallas/intersect_kernel.py:_kernel): same table, same
accept rules, same strict-< fold in table order.

``closest_hit_cuda.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from plutracer_tpu_torch.ops.intersect import T_MAX, _BIG
from plutracer_tpu_torch.scene.types import PRIM_BOX, PRIM_SPHERE

PACK_W = 24


def _slab(lo, hi, o, rinv):
    """(tmin, tmax) of boxes lo/hi (..., 3) on the ray lines, per axis
    min/max folded x, y, z as the kernel does."""
    t1 = (lo - o) * rinv
    t2 = (hi - o) * rinv
    mn = torch.minimum(t1, t2)
    mx = torch.maximum(t1, t2)
    tmin = torch.maximum(torch.maximum(mn[..., 0], mn[..., 1]), mn[..., 2])
    tmax = torch.minimum(torch.minimum(mx[..., 0], mx[..., 1]), mx[..., 2])
    return tmin, tmax


def packed_ts(packed, o, d):
    """(B, P_pad) t of every ray against every packed row, with the
    kernel's arithmetic (_BIG on a miss)."""
    o3 = o[:, None, :]
    d3 = d[:, None, :]
    ty = packed[None, :, 0]
    a = packed[None, :, 1:4]
    b = packed[None, :, 4:7]
    c = packed[None, :, 7:10]
    rinv = 1.0 / torch.where(d3 == 0.0, 1e-20, d3)
    ox, oy, oz = o3[..., 0], o3[..., 1], o3[..., 2]
    dx, dy, dz = d3[..., 0], d3[..., 1], d3[..., 2]

    # sphere: both roots > 0, parent-AABB line cull in cols 11:17
    vx, vy, vz = ox - a[..., 0], oy - a[..., 1], oz - a[..., 2]
    r = b[..., 0]
    qb = -(vx * dx + vy * dy + vz * dz)
    det = qb * qb - (vx * vx + vy * vy + vz * vz) + r * r
    sq = torch.sqrt(torch.clamp(det, min=0.0))
    i1 = qb - sq
    i2 = qb + sq
    cmin, cmax = _slab(packed[None, :, 11:14], packed[None, :, 14:17], o3, rinv)
    t_s = torch.where((det >= 0.0) & (i1 > 0.0) & (i2 > 0.0) & (cmax >= cmin), i1, _BIG)

    # box: slab test, tmin >= 0
    tmin, tmax = _slab(a, b, o3, rinv)
    t_b = torch.where((tmax >= tmin) & (tmin >= 0.0), tmin, _BIG)

    # triangle: Moller-Trumbore, t > 0
    e1x, e1y, e1z = b[..., 0] - a[..., 0], b[..., 1] - a[..., 1], b[..., 2] - a[..., 2]
    e2x, e2y, e2z = c[..., 0] - a[..., 0], c[..., 1] - a[..., 1], c[..., 2] - a[..., 2]
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det_t = e1x * pvx + e1y * pvy + e1z * pvz
    idet = 1.0 / torch.where(det_t == 0.0, 1.0, det_t)
    tvx, tvy, tvz = ox - a[..., 0], oy - a[..., 1], oz - a[..., 2]
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * idet
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * idet
    t_tr = (e2x * qvx + e2y * qvy + e2z * qvz) * idet
    ok_t = (det_t != 0.0) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t_tr > 0.0)
    t_t = torch.where(ok_t, t_tr, _BIG)

    return torch.where(ty == PRIM_SPHERE, t_s, torch.where(ty == PRIM_BOX, t_b, t_t))


def closest_hit_plain(packed, o, d):
    """K1's plain PyTorch version: (found, prim, t), the first minimum in
    packed-table order winning, as the kernel's strict-< fold does."""
    tmat = packed_ts(packed, o, d)
    k = torch.argmin(tmat, dim=1)
    t = torch.gather(tmat, 1, k[:, None])[:, 0]
    hit = t < _BIG
    prim = torch.where(hit, packed[k, 10].to(torch.int32), 0)
    t = torch.where(hit, t, _BIG)
    return t < T_MAX, prim, t


def _check(packed, o, d):
    for name, x in (("packed", packed), ("o", o), ("d", d)):
        if not x.is_cuda or x.device != o.device:
            raise ValueError(f"closest_hit_cuda: {name} must be on one CUDA device, "
                             f"got {x.device}")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"closest_hit: {name} must be contiguous float32")
    if o.dim() != 2 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError(f"closest_hit: o, d must be (B, 3), got {tuple(o.shape)}, {tuple(d.shape)}")
    if packed.dim() != 2 or packed.shape[1] != PACK_W or packed.shape[0] % 8:
        raise ValueError(f"closest_hit: packed must be (8k, {PACK_W}), got {tuple(packed.shape)}")


def closest_hit(packed, o, d):
    """(found (B,) bool, prim (B,) int32, t (B,) f32) for rays o, d (B, 3)
    against the packed table (scene.prims_packed). CUDA tensors: the K1
    kernel. CPU tensors: closest_hit_plain."""
    if o.is_cuda:
        return closest_hit_cuda(packed, o, d)
    return closest_hit_plain(packed, o, d)


def closest_hit_cuda(packed, o, d):
    """Launch K1 on the current stream (no synchronisation). Raises on
    anything the kernel does not take, CPU tensors included."""
    from plutracer_tpu_torch.ops.cuda import build

    _check(packed, o, d)
    B = o.shape[0]
    t = torch.empty(B, dtype=torch.float32, device=o.device)
    prim = torch.empty(B, dtype=torch.int32, device=o.device)
    if B == 0:
        return t < T_MAX, prim, t
    rc = build.load().lib.plu_closest_hit(
        packed.data_ptr(), packed.shape[0], o.data_ptr(), d.data_ptr(),
        t.data_ptr(), prim.data_ptr(), B, torch.cuda.current_stream(o.device).cuda_stream,
    )
    build.check(rc, "plu_closest_hit")
    closest_hit_cuda.launches += 1
    return t < T_MAX, prim, t


closest_hit_cuda.launches = 0
