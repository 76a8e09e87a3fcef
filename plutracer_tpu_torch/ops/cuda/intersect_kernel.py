"""K1: closest hit over the type-partitioned primitive table, and the
K3 query: the same closest hit found by a walk of the scene's BVH.

``closest_hit`` runs the CUDA kernel (csrc/closest_hit.cu, launched by
``closest_hit_cuda``) on CUDA tensors and its plain PyTorch version
``closest_hit_plain`` on CPU tensors. The kernel replaces the JAX
package's Pallas closest-hit kernel
(plutracer_tpu/ops/pallas/intersect_kernel.py:_kernel): same table, same
accept rules, same strict-< fold in table order. It runs each type
segment of the table with that type's test only;
``closest_hit_segments_plain`` is that fold in plain PyTorch.

``closest_hit_bvh`` is the closest-hit query of the stream kernels K3 and
K4 as a launch of its own (csrc/bvh_closest.cuh, launched by
``closest_hit_bvh_cuda``): an ordered walk of the scene's traversal
layout (scene.walk_nodes, scene.walk_rows), with ``walk_closest_plain``
as its plain version. It replaces the streamed brute force of the JAX
package's stream kernel (integrator_kernel.py: _closest_stream /
_closest_stream3 over Morton-ordered MegaPack chunks) and answers exactly
as K1 does.

Each launch counts once in utils/profiling's ``launches.k1`` (K1) or
``launches.k1_bvh`` (the K3 query).
"""

from __future__ import annotations

import torch

from plutracer_tpu_torch.ops.intersect import T_MAX, _BIG
from plutracer_tpu_torch.ops.safemath import sqrt
from plutracer_tpu_torch.scene.types import PRIM_BOX, PRIM_SPHERE
from plutracer_tpu_torch.utils import profiling

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


def sphere_ts(rows, o3, d3, rinv):
    """K1's sphere test: both roots > 0, parent-AABB line cull in cols
    11:17; _BIG on a miss."""
    a = rows[..., 1:4]
    vx, vy, vz = o3[..., 0] - a[..., 0], o3[..., 1] - a[..., 1], o3[..., 2] - a[..., 2]
    r = rows[..., 4]
    qb = -(vx * d3[..., 0] + vy * d3[..., 1] + vz * d3[..., 2])
    det = qb * qb - (vx * vx + vy * vy + vz * vz) + r * r
    sq = sqrt(torch.clamp(det, min=0.0))
    i1 = qb - sq
    i2 = qb + sq
    cmin, cmax = _slab(rows[..., 11:14], rows[..., 14:17], o3, rinv)
    return torch.where((det >= 0.0) & (i1 > 0.0) & (i2 > 0.0) & (cmax >= cmin), i1, _BIG)


def box_ts(rows, o3, d3, rinv):
    """K1's box test: the slab, tmin >= 0; _BIG on a miss."""
    tmin, tmax = _slab(rows[..., 1:4], rows[..., 4:7], o3, rinv)
    return torch.where((tmax >= tmin) & (tmin >= 0.0), tmin, _BIG)


def triangle_ts(rows, o3, d3, rinv):
    """K1's triangle test: Moller-Trumbore, t > 0; _BIG on a miss."""
    a, b, c = rows[..., 1:4], rows[..., 4:7], rows[..., 7:10]
    ox, oy, oz = o3[..., 0], o3[..., 1], o3[..., 2]
    dx, dy, dz = d3[..., 0], d3[..., 1], d3[..., 2]
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
    return torch.where(ok_t, t_tr, _BIG)


def _rinv(d3):
    return 1.0 / torch.where(d3 == 0.0, 1e-20, d3)


def row_ts(rows, o3, d3):
    """t of rays o3, d3 (..., 3) against packed rows (..., 24), the
    leading dimensions broadcast: K1's per-row arithmetic (csrc
    path_common.cuh packed_row_t), _BIG on a miss."""
    ty = rows[..., 0]
    rinv = _rinv(d3)
    t_s, t_b, t_t = (f(rows, o3, d3, rinv) for f in (sphere_ts, box_ts, triangle_ts))
    return torch.where(ty == PRIM_SPHERE, t_s, torch.where(ty == PRIM_BOX, t_b, t_t))


def _fold(packed, tmat):
    """(found, prim, t) of the first minimum of tmat (B, P_pad) in table
    order, as the kernel's strict-< fold finds it."""
    k = torch.argmin(tmat, dim=1)
    t = torch.gather(tmat, 1, k[:, None])[:, 0]
    hit = t < _BIG
    prim = torch.where(hit, packed[k, 10].to(torch.int32), 0)
    t = torch.where(hit, t, _BIG)
    return t < T_MAX, prim, t


def closest_hit_plain(packed, o, d):
    """K1's plain PyTorch version: (found, prim, t), the first minimum in
    packed-table order winning, as the kernel's strict-< fold does."""
    return _fold(packed, packed_ts(packed, o, d))


def closest_hit_segments_plain(packed, o, d, type_rows):
    """K1's fold as the kernel runs it: each type segment of the table
    (type_rows = scene.packed_type_rows: sphere rows, box rows, the rest
    triangles) tested with its type's body only, the segments in table
    order; equal to closest_hit_plain on every ray."""
    n_sph, n_box = type_rows[0], type_rows[1]
    o3, d3 = o[:, None, :], d[:, None, :]
    rinv = _rinv(d3)
    parts = (packed[:n_sph], packed[n_sph:n_sph + n_box], packed[n_sph + n_box:])
    tmat = torch.cat([f(rows[None], o3, d3, rinv)
                      for f, rows in zip((sphere_ts, box_ts, triangle_ts), parts)], 1)
    return _fold(packed, tmat)


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


def closest_hit(packed, o, d, type_rows=None):
    """(found (B,) bool, prim (B,) int32, t (B,) f32) for rays o, d (B, 3)
    against the packed table (scene.prims_packed) whose type segments are
    type_rows (scene.packed_type_rows). CUDA tensors: the K1 kernel
    (closest_hit_cuda). CPU tensors: closest_hit_plain."""
    if o.is_cuda:
        return closest_hit_cuda(packed, o, d, type_rows)
    return closest_hit_plain(packed, o, d)


def closest_hit_cuda(packed, o, d, type_rows=None):
    """Launch K1 on the tensors' card and its current stream (no
    synchronisation): one launch, which writes found, prim and t.
    type_rows gives the rows of the sphere and box segments (the rest are
    triangles). The kernel's plan splits the table across blocks when the
    rays alone cannot fill the card. Raises on anything the kernel does
    not take, CPU tensors included."""
    import ctypes

    from plutracer_tpu_torch.ops.cuda import build

    _check(packed, o, d)
    n_rows = packed.shape[0]
    if type_rows is None or len(type_rows) != 3:
        raise ValueError("closest_hit_cuda: type_rows (sphere, box, triangle rows of the "
                         "table: scene.packed_type_rows) is required")
    n_sph, n_box = int(type_rows[0]), int(type_rows[1])
    if n_sph % 8 or n_box % 8 or n_sph < 0 or n_box < 0 or n_sph + n_box > n_rows:
        raise ValueError(f"closest_hit_cuda: type_rows {tuple(type_rows)} do not partition "
                         f"a table of {n_rows} rows")
    if packed.data_ptr() % 16:
        raise ValueError("closest_hit_cuda: packed must be 16-byte aligned (float4 rows)")
    B = o.shape[0]
    dev = o.device
    t = torch.empty(B, dtype=torch.float32, device=dev)
    prim = torch.empty(B, dtype=torch.int32, device=dev)
    found = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        return found, prim, t
    lib = build.load().lib
    tiles = ctypes.c_int(0)
    with build.on_device(dev) as stream:  # the plan reads this card's SM count
        splits = lib.plu_closest_hit_plan(n_rows, B, ctypes.byref(tiles))
        build.check(-min(splits, 0), "plu_closest_hit_plan")
        part_t = part_k = arrivals = None
        if splits > 1:  # the splits' partial answers and each ray tile's arrivals
            part_t = torch.empty(splits * B, dtype=torch.float32, device=dev)
            part_k = torch.empty(splits * B, dtype=torch.int32, device=dev)
            arrivals = build.arrivals(dev, tiles.value, stream)
        ptr = lambda x: None if x is None else x.data_ptr()
        rc = lib.plu_closest_hit(
            packed.data_ptr(), n_rows, n_sph, n_box, o.data_ptr(), d.data_ptr(), t.data_ptr(),
            prim.data_ptr(), found.data_ptr(), B, splits, ptr(part_t), ptr(part_k), ptr(arrivals),
            stream,
        )
    build.check(rc, "plu_closest_hit")
    profiling.count("launches.k1")
    return found, prim, t


_POP = 1 << 40  # walk_closest_plain: the ray's next step is a pop of its stack


def walk_closest_plain(packed, nodes, rows, o, d, any_hit: bool = False, count: bool = False):
    """The K3 query's plain version: every ray walks the traversal layout
    of scene/compile.walk_tables (``nodes`` = scene.walk_nodes, ``rows`` =
    scene.walk_rows) as csrc/bvh_closest.cuh does, and answers (found,
    prim, t) as closest_hit_plain does on every ray that hits (a miss
    reports prim 0 and t _BIG). With count=True also (nodes, leaves,
    rows) per ray: the internal node records the walk visited (each tests
    both children's boxes), the leaves it visited, and (B, 3) the rows it
    tested of each type (sphere, box, triangle).

    - An internal node tests both children's padded boxes: a child whose
      subtree holds a sphere is entered when the ray's LINE crosses its
      box, any other when the ray's [0, best t] overlaps it (NaN enters).
      If both enter, the walk goes to the one whose box the ray enters
      first and pushes the other with its entry t (-inf for a LINE
      child); a pushed child is skipped when popped if its entry t now
      exceeds best t.
    - A leaf tests its 1 to 4 rows with K1's arithmetic and folds the
      lexicographic minimum of (t, packed row), so the answer does not
      depend on the order of the visits.
    - ``any_hit``: the shadow ray of a point light, which needs only
      found: best t starts at T_MAX (so the walk culls what lies beyond)
      and the walk stops at the first row with t < T_MAX.

    Rays advance in lockstep, one step a ray per round."""
    from plutracer_tpu_torch.scene.compile import WALK_LEAF_ROWS, WALK_STACK

    B = o.shape[0]
    dev = o.device
    rinv = 1.0 / torch.where(d == 0.0, 1e-20, d)
    boxes = nodes.view(torch.float32)[:, :12]
    sides = ((boxes[:, 0:3], boxes[:, 3:6]), (boxes[:, 6:9], boxes[:, 9:12]))
    child = nodes[:, 12:14].long()
    flags = nodes[:, 14].long()
    stack = torch.zeros((B, WALK_STACK), dtype=torch.long, device=dev)
    stack_t = torch.zeros((B, WALK_STACK), dtype=torch.float32, device=dev)
    sp = torch.zeros(B, dtype=torch.long, device=dev)
    ref = torch.zeros(B, dtype=torch.long, device=dev)  # the root
    best_t = torch.full((B,), T_MAX if any_hit else _BIG, dtype=torch.float32, device=dev)
    best_row = torch.full((B,), _NO_ROW, dtype=torch.long, device=dev)
    visits = torch.zeros(B, dtype=torch.long, device=dev)
    leaves = torch.zeros(B, dtype=torch.long, device=dev)
    tested = torch.zeros((B, 3), dtype=torch.long, device=dev)
    active = torch.arange(B, device=dev)
    while active.numel():
        r = ref[active]
        # internal nodes: both children's box tests
        m = (r >= 0) & (r != _POP)
        ia, n = active[m], r[m]
        oi, ri, bt = o[ia], rinv[ia], best_t[ia]
        enter, tmin, line = [], [], []
        for side, (lo, hi) in enumerate(sides):
            tmn, tmx = _slab(lo[n], hi[n], oi, ri)
            ln = ((flags[n] >> side) & 1) == 1
            ok = torch.where(ln, ~(tmx < tmn), ~(tmx < torch.clamp(tmn, min=0.0)) & ~(tmn > bt))
            enter.append(ok & (child[n, side] != 0))
            tmin.append(tmn)
            line.append(ln)
        el, er = enter
        rfirst = tmin[1] < tmin[0]
        near = torch.where(rfirst, child[n, 1], child[n, 0])
        far = torch.where(rfirst, child[n, 0], child[n, 1])
        far_t = torch.where(rfirst, torch.where(line[0], -torch.inf, tmin[0]),
                            torch.where(line[1], -torch.inf, tmin[1]))
        both = el & er
        pb = ia[both]
        stack[pb, sp[pb]] = far[both]
        stack_t[pb, sp[pb]] = far_t[both]
        sp[pb] += 1
        ref[ia] = torch.where(both, near, torch.where(el, child[n, 0],
                                                      torch.where(er, child[n, 1], _POP)))
        visits[ia] += 1
        # leaves: their rows, lexicographic (t, packed row) fold
        m = r < 0
        la, code = active[m], -1 - r[m]
        first, cnt = code >> 2, (code & 3) + 1
        for k in range(WALK_LEAF_ROWS):
            has = k < cnt
            ka, row = la[has], first[has] + k
            t = row_ts(rows[row], o[ka], d[ka])
            prow = rows[row, 10].long()
            bt, br = best_t[ka], best_row[ka]
            take = (t < bt) | ((t == bt) & (prow < br) & (t < _BIG))
            best_t[ka] = torch.where(take, t, bt)
            best_row[ka] = torch.where(take, prow, br)
            tested.index_put_((ka, rows[row, 0].long()), torch.ones_like(ka), accumulate=True)
        ref[la] = _POP
        leaves[la] += 1
        # pops (rays whose previous step ended), culled by the entry t
        m = r == _POP
        finished = torch.zeros(B, dtype=torch.bool, device=dev)
        finished[active[m & (sp[active] == 0)]] = True
        pa = active[m & (sp[active] > 0)]
        sp[pa] -= 1
        ent, ent_t = stack[pa, sp[pa]], stack_t[pa, sp[pa]]
        ref[pa] = torch.where(ent_t > best_t[pa], _POP, ent)
        if any_hit:
            finished[active] |= best_t[active] < T_MAX
        active = active[~finished[active]]
    found = best_t < T_MAX
    hit = found if any_hit else best_t < _BIG
    prim = torch.where(hit, packed[best_row.clamp(max=packed.shape[0] - 1), 10].to(torch.int32), 0)
    t = torch.where(found, best_t, _BIG) if any_hit else best_t
    out = (found, prim, t)
    return out + (visits, leaves, tested) if count else out


def closest_hit_bvh(scene, o, d):
    """(found, prim, t) for rays o, d (B, 3) by a walk of the scene's
    traversal layout (scene.walk_nodes / walk_rows), equal to closest_hit
    over scene.prims_packed (t on hits; _BIG on a miss, see
    walk_closest_plain). CUDA tensors: the K3 query kernel. CPU tensors:
    walk_closest_plain."""
    if o.is_cuda:
        return closest_hit_bvh_cuda(scene, o, d)
    return walk_closest_plain(scene.prims_packed, scene.walk_nodes, scene.walk_rows, o, d)


def walk_pointers(scene):
    """The walk's table arguments of a kernel launch (packed table, node
    records, walk rows), after checking they lie on one CUDA device in the
    dtypes the kernel reads."""
    want = ((scene.prims_packed, torch.float32), (scene.walk_nodes, torch.int32),
            (scene.walk_rows, torch.float32))
    dev = scene.prims_packed.device
    for x, dtype in want:
        if not x.is_cuda or x.device != dev or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"walk tables must be contiguous {dtype} on {dev}, "
                             f"got {x.dtype} on {x.device}")
    return tuple(x.data_ptr() for x, _ in want)


def closest_hit_bvh_cuda(scene, o, d):
    """Launch the K3 query kernel on the tensors' card and its current
    stream (no synchronisation). Raises on anything the kernel does not
    take, CPU tensors included."""
    from plutracer_tpu_torch.ops.cuda import build

    _check(scene.prims_packed, o, d)
    tables = walk_pointers(scene)
    B = o.shape[0]
    t = torch.empty(B, dtype=torch.float32, device=o.device)
    prim = torch.empty(B, dtype=torch.int32, device=o.device)
    if B == 0:
        return t < T_MAX, prim, t
    lib = build.load().lib
    with build.on_device(o.device) as stream:
        rc = lib.plu_closest_hit_bvh(
            *tables, o.data_ptr(), d.data_ptr(), t.data_ptr(), prim.data_ptr(), B, stream)
    build.check(rc, "plu_closest_hit_bvh")
    profiling.count("launches.k1_bvh")
    return t < T_MAX, prim, t
