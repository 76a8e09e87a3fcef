"""G1: the backward of the table-row gather on the card.

``ops/tables._rows`` gathers rows with ``table[idx]``. When the table lies
on a card and takes a gradient, it gathers through ``RowGather``, whose
forward is that same indexing and whose backward launches csrc/row_grad.cu
(``row_grad_cuda``): out[r] = the sum of grad[i] over the rays i with
idx[i] == r. The JAX package has no Pallas kernel here: it leaves the
gather's VJP to XLA's scatter-add.

The sums are deterministic by construction: their order is fixed by the
rays' rows, B and the table's shape (``plan``), so a train step, and a
resumed run, gives the same bits in every run and process without
torch's deterministic ``index_put_`` (a sort, then one warp summing each
run of equal indices alone). A table whose rows fit a warp's slice of
shared memory is summed by ``row_grad`` in the rays' order; a larger one
(a prim field) by ``row_grad_sorted``, a segmented reduction over the
rays sorted stably by row (``torch.sort``: the kernel sums, the sort only
orders). ``row_grad_plain`` is the plain twin: the same orders in plain
PyTorch, which the card tests hold G1 bit-equal to. Each launch counts
once in utils/profiling's ``launches.g1``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from plutracer_tpu_torch.utils import profiling

BLOCK = 256  # threads a block, and sorted rays a tile (csrc/row_grad.cu: BLOCK)
WARPS = BLOCK // 32
WIDTHS = (1, 8, 12, 32)  # the widths row_grad.cu instantiates: every table's and a column's
MIN_CHUNK = 2048  # rays a block at the least
MAX_CHUNKS = 128  # chunks of rays, each a block, at the most
# a warp's slice of the table: 47 KB of shared memory a block, under the 48 KB a launch gets
# without opting in, with the kernel's static shared memory
SLICE_FLOATS = 47 * 1024 // 4 // WARPS


class Plan(NamedTuple):
    sorted: bool  # the table is past a warp's slice: the rays sorted by row, in tiles
    chunk: int  # rays a block, a multiple of BLOCK (BLOCK when sorted: a tile)
    chunks: int  # blocks; their partials are folded in order


def plan(B: int, R: int, W: int) -> Plan:
    """How G1 splits B rays over a table of R rows of W floats: from the
    shape alone, so the order of every sum is too (past one tile of the
    sorted rays, the rays' rows place the tiles' bounds)."""
    up = lambda a, b: -(-a // b)
    if R * W > SLICE_FLOATS:
        return Plan(True, BLOCK, max(1, up(B, BLOCK)))
    chunks = max(1, min(up(B, MIN_CHUNK), MAX_CHUNKS))
    chunk = max(BLOCK, up(up(B, chunks), BLOCK) * BLOCK)
    return Plan(False, chunk, max(1, up(B, chunk)))


def sort_rows(idx: torch.Tensor):
    """(rows, perm): the rays' rows sorted as int32, equal rows in ray
    order, and the ray of each (int64)."""
    return torch.sort(idx.int(), stable=True)


def _width(shape) -> int:
    if len(shape) not in (1, 2) or shape[0] < 1:
        raise ValueError(f"G1: a table is (R,) or (R, W) with R >= 1, got {tuple(shape)}")
    return 1 if len(shape) == 1 else int(shape[1])


def _flat(idx: torch.Tensor, grad: torch.Tensor, shape):
    W = _width(shape)
    if idx.dtype != torch.int64:
        raise ValueError(f"G1: idx must be int64, got {idx.dtype}")
    if tuple(grad.shape) != tuple(idx.shape) + tuple(shape[1:]):
        raise ValueError(f"G1: grad {tuple(grad.shape)} is not idx {tuple(idx.shape)} x "
                         f"the table's row {tuple(shape[1:])}")
    if grad.dtype != torch.float32:
        raise ValueError(f"G1: grad must be float32, got {grad.dtype}")
    return idx.reshape(-1).contiguous(), grad.reshape(-1, W).contiguous(), int(shape[0]), W


def row_grad_cuda(idx: torch.Tensor, grad: torch.Tensor, shape) -> torch.Tensor:
    """The gradient of the table (shape (R,) or (R, W)) from the gradient of
    table[idx]: one G1 launch on the tensors' card and its current stream
    (no synchronisation), after a sort of the rays by row for a table past
    a warp's slice. idx holds rows in [0, R) (``_rows`` clamps them);
    raises on anything the kernel does not take, a CPU tensor included."""
    from plutracer_tpu_torch.ops.cuda import build

    if not (idx.is_cuda and grad.is_cuda) or idx.device != grad.device:
        raise ValueError(f"G1: idx and grad must lie on one CUDA device, got {idx.device} "
                         f"and {grad.device}")
    idx, g, R, W = _flat(idx, grad, shape)
    if W not in WIDTHS:
        raise ValueError(f"G1: row_grad.cu takes tables of {WIDTHS} columns, got {W}")
    B = idx.numel()
    if B >= 2**31 - BLOCK:
        raise ValueError(f"G1: at most 2**31 - {BLOCK + 1} rays a call, got {B}")
    dev = grad.device
    if B == 0:
        return torch.zeros(tuple(shape), dtype=torch.float32, device=dev)
    p = plan(B, R, W)
    part = None  # the chunks' partials, or each tile's first and last segments' sums
    if p.chunks > 1:
        part = torch.empty(p.chunks * (2 * W if p.sorted else R * W), dtype=torch.float32,
                           device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()
    lib = build.load().lib
    if p.sorted:
        rows, perm = sort_rows(idx)
        out = torch.zeros(tuple(shape), dtype=torch.float32, device=dev)
        with build.on_device(dev) as stream:
            arrivals = build.arrivals(dev, 1, stream) if p.chunks > 1 else None
            rc = lib.plu_row_grad_sorted(rows.data_ptr(), perm.data_ptr(), g.data_ptr(),
                                         ptr(part), out.data_ptr(), ptr(arrivals), B, R, W,
                                         p.chunks, stream)
        build.check(rc, "plu_row_grad_sorted")
    else:
        out = torch.empty(tuple(shape), dtype=torch.float32, device=dev)
        with build.on_device(dev) as stream:
            arrivals = build.arrivals(dev, 1, stream) if p.chunks > 1 else None
            rc = lib.plu_row_grad(idx.data_ptr(), g.data_ptr(), ptr(part), out.data_ptr(),
                                  ptr(arrivals), B, R, W, p.chunk, p.chunks, stream)
        build.check(rc, "plu_row_grad")
    profiling.count("launches.g1")
    return out


def _merge(keys: torch.Tensor, vals: torch.Tensor):
    """Sum the rows of vals with equal keys (at most two, so the order of
    the two does not matter: float addition commutes). Returns (keys,
    sums) with keys unique and sorted."""
    uniq, inv = torch.unique(keys, return_inverse=True)
    return uniq, torch.zeros((uniq.numel(), vals.shape[1]), dtype=vals.dtype,
                             device=vals.device).index_add_(0, inv, vals)


def _in_order(keys: torch.Tensor, step: torch.Tensor, vals: torch.Tensor, steps: int):
    """Sum the rows of vals with equal keys in the order of `step` (at most
    one a key a step): ((0 + v_0) + v_1) + ... Returns (keys, sums)."""
    uniq, inv = torch.unique(keys, return_inverse=True)
    acc = torch.zeros((uniq.numel(), vals.shape[1]), dtype=vals.dtype, device=vals.device)
    for s in range(steps):
        at = step == s
        acc.index_add_(0, inv[at], vals[at])
    return uniq, acc


def _shift(x: torch.Tensor, d: int, dim: int) -> torch.Tensor:
    """x moved d places up along dim (entry l holds x's l - d; the first d
    keep their own, as a __shfl_up_sync does)."""
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, 0, d), x.narrow(dim, 0, n - d)], dim)


def _sorted_plain(idx: torch.Tensor, g: torch.Tensor, R: int, W: int, p: Plan):
    """csrc/row_grad.cu's row_grad_sorted (its steps 1-4) in plain PyTorch."""
    B, T, dev = idx.numel(), p.chunks, g.device
    rows, perm = sort_rows(idx)
    r = torch.full((T * BLOCK,), R, dtype=torch.int64, device=dev)  # past the rays: R
    r[:B] = rows.long()
    v = torch.zeros((T * BLOCK, W), dtype=torch.float32, device=dev)
    v[:B] = g[perm] + 0.0
    r, v = r.reshape(T, WARPS, 32), v.reshape(T, WARPS, 32, W)
    # 1. each warp's segmented scan: at d, lane l adds lane l - d where both hold one row
    lane = torch.arange(32, device=dev)
    for d in (1, 2, 4, 8, 16):
        same = (lane >= d) & (_shift(r, d, 2) == r)
        v = torch.where(same[..., None], _shift(v, d, 2) + v, v)
    # 2. the warps' last lanes folded in warp order where they hold one row, then the carry
    tails, tail_row = v[:, :, 31].clone(), r[:, :, 31]
    for q in range(1, WARPS):
        on = (tail_row[:, q] == tail_row[:, q - 1])[:, None]
        tails[:, q] = torch.where(on, tails[:, q - 1] + tails[:, q], tails[:, q])
    for q in range(1, WARPS):
        on = (r[:, q] == tail_row[:, q - 1, None])[..., None]
        v[:, q] = torch.where(on, tails[:, q - 1, None] + v[:, q], v[:, q])
    # 3. each segment's end in its tile: whole in the tile, to out; the tiles' first and
    # last segments' sums
    r, v = r.reshape(T, BLOCK), v.reshape(T, BLOCK, W)
    first, final = r[:, 0], r[:, -1]
    head_open = torch.zeros(T, dtype=torch.bool, device=dev)
    head_open[1:] = final[:-1] == first[1:]
    tail_open = torch.zeros(T, dtype=torch.bool, device=dev)
    tail_open[:-1] = first[1:] == final[:-1]
    is_last = torch.zeros(BLOCK, dtype=torch.bool, device=dev)
    is_last[-1] = True
    ends = (r < R) & (is_last | (r.roll(-1, 1) != r))  # a lane's next is in its tile
    is_first = r == first[:, None]
    direct = ends & ~(is_first & head_open[:, None]) & ~(is_last & tail_open[:, None])
    out = torch.zeros((R, W), dtype=torch.float32, device=dev)
    out[r[direct]] = v[direct]
    first_sum = v[ends & is_first]  # one a tile, in tile order
    last_sum = v[:, -1]
    # 4. a segment over several tiles: its first tile's last sum, then the next tiles'
    # first sums in tile order
    a = torch.nonzero(tail_open & ~(head_open & (first == final)))[:, 0]
    row = final[a]
    b = (torch.searchsorted(rows.long(), row, right=True) - 1) // BLOCK
    acc = last_sum[a]
    for j in range(1, int((b - a).max()) + 1 if a.numel() else 1):
        on = (a + j <= b)[:, None]
        acc = torch.where(on, acc + first_sum[(a + j).clamp(max=T - 1)], acc)
    out[row] = acc
    return out


def row_grad_plain(idx: torch.Tensor, grad: torch.Tensor, shape) -> torch.Tensor:
    """G1's plain twin: the same sums in the same order as csrc/row_grad.cu
    (row_grad's steps 1-4, or row_grad_sorted's for a table past a warp's
    slice), in plain PyTorch on any device. Rows no ray names get +0; idx
    holds rows in [0, R)."""
    idx, g, R, W = _flat(idx, grad, shape)
    B = idx.numel()
    if B == 0:
        return torch.zeros(tuple(shape), dtype=torch.float32, device=grad.device)
    p = plan(B, R, W)
    if p.sorted:
        return _sorted_plain(idx, g, R, W, p).reshape(tuple(shape))
    ray = torch.arange(B, device=idx.device)
    # 1. each warp iteration (32 rays) sums each of its rows in the shuffle
    # tree: at offset s, lane l < s adds lane l + s (absent rows are +0)
    group, lane, row, vals = ray // 32, ray % 32, idx, g + 0.0
    for s in (16, 8, 4, 2, 1):
        lane = torch.where(lane >= s, lane - s, lane)
        keys, vals = _merge((group * 32 + lane) * R + row, vals)
        group, lane, row = keys // R // 32, keys // R % 32, keys % R
    first = group * 32  # the iteration's first ray
    c, k, w = first // p.chunk, first % p.chunk // BLOCK, first % BLOCK // 32
    # 2. each warp's slice of a row, iteration after iteration
    keys, vals = _in_order((c * WARPS + w) * R + row, k, vals, p.chunk // BLOCK)
    # 3. each chunk's partial, the warps' slices in warp order
    c, w, row = keys // R // WARPS, keys // R % WARPS, keys % R
    keys, vals = _in_order(c * R + row, w, vals, WARPS)
    part = torch.zeros((p.chunks * R, W), dtype=torch.float32, device=grad.device)
    part[keys] = vals
    # 4. the chunks' partials in chunk order
    part = part.reshape(p.chunks, R, W)
    out = part[0]
    for j in range(1, p.chunks):
        out = out + part[j]
    return out.reshape(tuple(shape))


class RowGather(torch.autograd.Function):
    """``table[idx]`` whose backward is G1 (``row_grad_cuda``): the forward
    is the plain indexing, so its bits do not change. idx holds rows in
    [0, R)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.shape = tuple(table.shape)
        return table[idx]

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return row_grad_cuda(idx, grad, ctx.shape), None
