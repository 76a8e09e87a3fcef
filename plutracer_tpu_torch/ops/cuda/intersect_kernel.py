"""K1: closest hit over the type-partitioned primitive table, and the
K3 query: the same closest hit found by a walk of the scene's BVH.

``closest_hit`` runs the CUDA kernel (csrc/closest_hit.cu, launched by
``closest_hit_cuda``) on CUDA tensors and its plain PyTorch version
``closest_hit_plain`` on CPU tensors. The kernel replaces the JAX package's Pallas closest-hit kernel
(plutracer_tpu/ops/pallas/intersect_kernel.py:_kernel): same table, same
accept rules, same strict-< fold in table order.

``closest_hit_bvh`` is the closest-hit query of the stream kernels K3 and
K4 as a launch of its own (csrc/bvh_closest.cuh, launched by
``closest_hit_bvh_cuda``), with ``bvh_closest_plain`` as its plain
version. It replaces the streamed brute force of the JAX package's
stream kernel (integrator_kernel.py: _closest_stream / _closest_stream3
over Morton-ordered MegaPack chunks) and answers exactly as K1 does.

``closest_hit_cuda.launches`` and ``closest_hit_bvh_cuda.launches`` count
kernel launches.
"""

from __future__ import annotations

import torch

from plutracer_tpu_torch.ops.intersect import T_MAX, _BIG
from plutracer_tpu_torch.scene.types import PRIM_BOX, PRIM_SPHERE

PACK_W = 24
_NO_ROW = 2**31 - 1


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
    return row_ts(packed[None], o[:, None, :], d[:, None, :])


def row_ts(rows, o3, d3):
    """t of rays o3, d3 (..., 3) against packed rows (..., 24), the
    leading dimensions broadcast: K1's per-row arithmetic (csrc
    path_common.cuh packed_row_t), _BIG on a miss."""
    ty = rows[..., 0]
    a = rows[..., 1:4]
    b = rows[..., 4:7]
    c = rows[..., 7:10]
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
    cmin, cmax = _slab(rows[..., 11:14], rows[..., 14:17], o3, rinv)
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


def bvh_closest_plain(packed, bvh, leaf_row, line_only, margin, o, d):
    """The K3 query's plain version: every ray walks the skip-link BVH
    (found, prim, t), answering as closest_hit_plain does on every ray
    that hits (found, prim and t equal). A miss reports found False, prim
    0 and t _BIG, where closest_hit_plain may report the t of a padding
    row about 1e30 away; no caller reads t on a miss.

    - A leaf tests its packed row (``leaf_row``) with K1's arithmetic,
      parent-AABB sphere cull included, and folds the lexicographic
      minimum of (t, packed row): K1 keeps the first packed row among
      equal t, and the walk visits rows in tree order.
    - An internal node's box, padded by ``margin`` on every side, is
      entered when the ray's LINE crosses it (``line_only`` nodes hold a
      sphere, whose phantom hits of non-unit rays lie outside its box),
      else when the ray's [0, best t] overlaps it. NaN passes the test.
    - Then the walk goes to node + 1, or past the subtree to its skip.

    Rays advance in lockstep; only rays still walking are computed."""
    B = o.shape[0]
    N = bvh.num_nodes
    rinv = 1.0 / torch.where(d == 0.0, 1e-20, d)
    lo = bvh.node_min - margin
    hi = bvh.node_max + margin
    skip = bvh.node_skip.long()
    leaf_row = leaf_row.long()
    node = torch.zeros(B, dtype=torch.long, device=o.device)
    best_t = torch.full((B,), _BIG, dtype=torch.float32, device=o.device)
    best_row = torch.full((B,), _NO_ROW, dtype=torch.long, device=o.device)
    walking = torch.arange(B, device=o.device)
    while walking.numel():
        n = node[walking]
        row = leaf_row[n]
        leaf = row >= 0
        nxt = skip[n]
        # leaves: K1's test of the packed row, lexicographic (t, row) fold
        la, lr = walking[leaf], row[leaf]
        t = row_ts(packed[lr], o[la], d[la])
        bt, br = best_t[la], best_row[la]
        take = (t < bt) | ((t == bt) & (lr < br) & (t < _BIG))
        best_t[la] = torch.where(take, t, bt)
        best_row[la] = torch.where(take, lr, br)
        # internal nodes: the padded box test
        ia, ni = walking[~leaf], n[~leaf]
        tmin, tmax = _slab(lo[ni], hi[ni], o[ia], rinv[ia])
        ray_test = ~(tmax < torch.clamp(tmin, min=0.0)) & ~(tmin > best_t[ia])
        visit = torch.where(line_only[ni], ~(tmax < tmin), ray_test)
        nxt[~leaf] = torch.where(visit, ni + 1, nxt[~leaf])
        node[walking] = nxt
        walking = walking[nxt < N]
    hit = best_t < _BIG
    prim = torch.where(hit, packed[best_row.clamp(max=packed.shape[0] - 1), 10].to(torch.int32), 0)
    return best_t < T_MAX, prim, best_t


def _bvh_args(scene):
    return (scene.prims_packed, scene.bvh, scene.bvh_leaf_row, scene.bvh_line_only,
            scene.bvh_margin)


def closest_hit_bvh(scene, o, d):
    """(found, prim, t) for rays o, d (B, 3) by a walk of scene.bvh,
    equal to closest_hit over scene.prims_packed (t on hits; _BIG on a
    miss, see bvh_closest_plain). CUDA tensors: the K3
    query kernel. CPU tensors: bvh_closest_plain."""
    if o.is_cuda:
        return closest_hit_bvh_cuda(scene, o, d)
    return bvh_closest_plain(*_bvh_args(scene), o, d)


def bvh_pointers(scene):
    """The BVH walk's table arguments of a kernel launch (pointers, node
    count, margin), after checking the tables lie with the packed table on
    one CUDA device in the dtypes the kernel reads."""
    packed, bvh, leaf_row, line_only, margin = _bvh_args(scene)
    want = ((packed, torch.float32), (bvh.node_min, torch.float32),
            (bvh.node_max, torch.float32), (bvh.node_skip, torch.int32),
            (leaf_row, torch.int32), (line_only, torch.bool))
    for x, dtype in want:
        if not x.is_cuda or x.device != packed.device or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"BVH tables must be contiguous {dtype} on {packed.device}, "
                             f"got {x.dtype} on {x.device}")
    return (packed.data_ptr(), bvh.node_min.data_ptr(), bvh.node_max.data_ptr(),
            bvh.node_skip.data_ptr(), leaf_row.data_ptr(), line_only.data_ptr(),
            bvh.num_nodes, float(margin))


def closest_hit_bvh_cuda(scene, o, d):
    """Launch the K3 query kernel on the current stream (no
    synchronisation). Raises on anything the kernel does not take, CPU
    tensors included."""
    from plutracer_tpu_torch.ops.cuda import build

    _check(scene.prims_packed, o, d)
    tables = bvh_pointers(scene)
    B = o.shape[0]
    t = torch.empty(B, dtype=torch.float32, device=o.device)
    prim = torch.empty(B, dtype=torch.int32, device=o.device)
    if B == 0:
        return t < T_MAX, prim, t
    rc = build.load().lib.plu_closest_hit_bvh(
        *tables, o.data_ptr(), d.data_ptr(), t.data_ptr(), prim.data_ptr(), B,
        torch.cuda.current_stream(o.device).cuda_stream,
    )
    build.check(rc, "plu_closest_hit_bvh")
    closest_hit_bvh_cuda.launches += 1
    return t < T_MAX, prim, t


closest_hit_bvh_cuda.launches = 0
