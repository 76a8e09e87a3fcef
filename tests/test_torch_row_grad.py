"""G1's plain twin and the gather that uses it, on the CPU.

G1 (csrc/row_grad.cu) is the backward of the table-row gather on a card;
the card tests (tests/test_torch_cuda.py -k g1) hold it bit-equal to its
plain twin, ops/cuda/row_grad_kernel.row_grad_plain. Here:

- the twin against a lane-by-lane transcription of the kernels' loops
  (numpy float32, small shapes; row_grad for a table within a warp's
  slice, row_grad_sorted past it): bit-equal;
- the twin against torch's ``index_put_(accumulate=True)`` and against
  the float64 sum. Tolerance: a float32 sum of n terms in any order whose
  additions nest d deep is within gamma(d) * sum|x| of the exact sum
  (gamma(d) = d * u / (1 - d * u), u = 2**-24; Higham, Accuracy and
  Stability of Numerical Algorithms, 4.2).
  The twin's depth is 5 (the lanes' tree) + the iterations of a warp + the
  warps + the chunks - 1 (past a warp's slice: 5 (the warp's scan) + the
  warps + the tiles, the same sum with a tile's one iteration), torch's
  sequential sum's at most the row's count n; so twin - float64 within
  gamma(d_twin) * sum|x| and twin - torch within gamma(d_twin + n) *
  sum|x|, entry by entry;
- ``_rows`` on the CPU: today's bits forward and backward, and no G1
  launch (``launches.g1`` stays 0);
- RowGather's forward and backward plumbing, its backward's G1 replaced
  by the twin.
"""

import numpy as np
import pytest
import torch

from plutracer_tpu_torch.ops import tables
from plutracer_tpu_torch.ops.cuda import row_grad_kernel as g1
from plutracer_tpu_torch.utils import profiling
from torch_cpu import one_torch_thread  # noqa: F401 (autouse: one torch thread)

U = 2.0**-24


def rows_and_grad(B, R, W, seed):
    """B rays' rows (half of them among the first three rows, so rows
    repeat) and a gradient of mixed magnitudes with some -0.0 entries."""
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, R, (B,), generator=g)
    idx[: B // 2] = torch.randint(0, min(R, 3), (B // 2,), generator=g)
    scale = 10.0 ** torch.randint(-3, 3, (B, 1), generator=g).float()
    grad = torch.randn((B, W), generator=g) * scale
    grad[torch.rand((B, W), generator=g) < 0.05] = -0.0
    return idx, grad


def kernel_loops(idx, g, R, W):
    """csrc/row_grad.cu's loops, lane by lane, in float32 numpy."""
    f = np.float32
    B = idx.shape[0]
    p = g1.plan(B, R, W)
    if p.sorted:
        return sorted_kernel_loops(idx, g, R, W)
    part = np.zeros((p.chunks, R, W), f)
    for c in range(p.chunks):
        slices = np.zeros((g1.WARPS, R, W), f)
        end = min(B, c * p.chunk + p.chunk)
        for k in range(p.chunk // g1.BLOCK):
            for w in range(g1.WARPS):
                rays = c * p.chunk + k * g1.BLOCK + w * 32 + np.arange(32)
                row = np.where(rays < end, idx[np.minimum(rays, B - 1)], -1)
                v = np.where((row >= 0)[:, None], g[np.minimum(rays, B - 1)] + f(0), f(0))
                done = set()
                for lane in range(32):  # each row once, from its first lane
                    r = int(row[lane])
                    if r < 0 or r in done:
                        continue
                    done.add(r)
                    s = np.where((row == r)[:, None], v, f(0)).astype(f)
                    for off in (16, 8, 4, 2, 1):  # __shfl_down_sync: past 31, its own
                        s = s + np.concatenate([s[off:], s[32 - off:]])
                    slices[w, r] = slices[w, r] + s[0]
        acc = slices[0].copy()
        for q in range(1, g1.WARPS):
            acc = acc + slices[q]
        part[c] = acc
    out = part[0].copy()
    for c in range(1, p.chunks):
        out = out + part[c]
    return out


def sorted_kernel_loops(idx, g, R, W):
    """row_grad_sorted's loops, tile by tile and lane by lane, in float32
    numpy, over the rays sorted stably by row."""
    f, T, BLOCK = np.float32, g1.plan(idx.shape[0], R, W).chunks, g1.BLOCK
    B = idx.shape[0]
    order = np.argsort(idx, kind="stable")
    rows = idx[order]
    out = np.zeros((R, W), f)
    part = np.zeros((T, 2, W), f)
    for t in range(T):
        e = t * BLOCK + np.arange(BLOCK)
        r = np.where(e < B, rows[np.minimum(e, B - 1)], R)
        v = np.where((e < B)[:, None], g[order[np.minimum(e, B - 1)]] + f(0), f(0)).astype(f)
        next_row = rows[t * BLOCK + BLOCK] if t * BLOCK + BLOCK < B else R + 1
        for q in range(g1.WARPS):  # 1. each warp's segmented scan
            rq, vq = r[q * 32:q * 32 + 32], v[q * 32:q * 32 + 32]
            for d in (1, 2, 4, 8, 16):
                prev = vq.copy()
                for lane in range(d, 32):
                    if rq[lane - d] == rq[lane]:
                        vq[lane] = prev[lane - d] + prev[lane]
        tails, tail_row = v[31::32].copy(), r[31::32]  # 2. the warps in order, the carry
        for q in range(1, g1.WARPS):
            if tail_row[q] == tail_row[q - 1]:
                tails[q] = tails[q - 1] + tails[q]
        for i in range(32, BLOCK):
            if r[i] == tail_row[i // 32 - 1]:
                v[i] = tails[i // 32 - 1] + v[i]
        first, final = r[0], r[BLOCK - 1]  # 3. each segment's end in the tile
        head_open = t > 0 and rows[t * BLOCK - 1] == first
        tail_open = next_row == final
        for i in range(BLOCK):
            is_last = i == BLOCK - 1
            if r[i] < R and (is_last or r[i + 1] != r[i]):
                is_first = r[i] == first
                if is_first:
                    part[t, 0] = v[i]
                if is_last:
                    part[t, 1] = v[i]
                if not (is_first and head_open) and not (is_last and tail_open):
                    out[r[i]] = v[i]
    for a in range(T - 1):  # 4. the segments over several tiles, in tile order
        ra = rows[a * BLOCK + BLOCK - 1]
        if rows[a * BLOCK + BLOCK] == ra and not (a > 0 and rows[a * BLOCK - 1] == ra):
            end = a * BLOCK + BLOCK
            while end + 1 < B and rows[end + 1] == ra:
                end += 1
            s = part[a, 1].copy()
            for k in range(a + 1, end // BLOCK + 1):
                s = s + part[k, 0]
            out[ra] = s
    return out


@pytest.mark.parametrize("B,R,W", [(1, 1, 8), (2049, 5, 12), (4500, 31, 32), (3000, 1, 1),
                                   (700, 2000, 8), (2600, 400, 12), (4500, 47, 32),
                                   (3000, 1600, 1), (5000, 60, 32), (1, 2000, 12)])
def test_twin_follows_the_kernel_loops(B, R, W):
    """Bit-equal (int32 views) to the kernels' loops, over one and several
    chunks, and over one and several tiles of sorted rays with rows that
    span many tiles."""
    idx, grad = rows_and_grad(B, R, W, seed=B + R + W)
    want = kernel_loops(idx.numpy(), grad.numpy(), R, W)
    got = g1.row_grad_plain(idx, grad, (R, W)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def twin_depth(B, R, W):
    p = g1.plan(B, R, W)
    return 5 + p.chunk // g1.BLOCK + g1.WARPS + p.chunks - 1


@pytest.mark.parametrize("B", [0, 1, 2047, 2049, 262144])
@pytest.mark.parametrize("W", [1, 8, 12, 32])
@pytest.mark.parametrize("R", [1, 5, 31, 20000])
def test_twin_matches_index_put(R, W, B):
    """Within float32 reordering rounding (the module's docstring) of
    torch's index_put_(accumulate=True) and of the float64 sum."""
    idx, grad = rows_and_grad(B, R, W, seed=R * W + B)
    shape = (R,) if W == 1 and R == 5 else (R, W)  # a 1-D column too
    got = g1.row_grad_plain(idx, grad.reshape((B,) + shape[1:]), shape).reshape(R, W)
    torch_sum = torch.zeros(R, W).index_put_((idx,), grad, accumulate=True)
    exact = torch.zeros(R, W, dtype=torch.float64).index_add_(0, idx, grad.double())
    mag = torch.zeros(R, W, dtype=torch.float64).index_add_(0, idx, grad.double().abs())
    count = torch.bincount(idx, minlength=R).double()[:, None]
    d = twin_depth(B, R, W) if B else 0
    gamma = lambda n: n * U / (1 - n * U)
    assert got.dtype == torch.float32 and got.shape == (R, W)
    assert ((got.double() - exact).abs() <= gamma(d) * mag).all()
    assert ((got.double() - torch_sum.double()).abs() <= gamma(d + count) * mag).all()
    assert torch.equal(got[count[:, 0] == 0], torch.zeros_like(got[count[:, 0] == 0]))


@pytest.mark.parametrize("B,R,W", [(262144, 1, 8), (262144, 5, 12), (262144, 20000, 32),
                                   (5, 20000, 1), (2**20, 65536, 32)])
def test_plan_fits_the_kernel(B, R, W):
    """Within a warp's slice: whole blocks of rays, at most MAX_CHUNKS,
    a block's slices in 47 KB (48 KB less the kernel's static shared
    memory). Past it: tiles of BLOCK sorted rays, as many as cover B."""
    p = g1.plan(B, R, W)
    assert p.chunk % g1.BLOCK == 0 and (p.chunks - 1) * p.chunk < B <= p.chunks * p.chunk
    assert p.sorted == (g1.WARPS * R * W * 4 > 47 * 1024)
    if p.sorted:
        assert p.chunk == g1.BLOCK
    else:
        assert 1 <= p.chunks <= g1.MAX_CHUNKS


def test_rows_on_the_cpu_keep_their_bits():
    """_rows on the CPU is torch's indexing, forward and backward (the CPU
    tests hold its gradients against the JAX package), and launches no
    G1, also where the table takes a gradient."""
    idx, grad = rows_and_grad(3000, 7, 12, seed=3)
    idx[::7] = -1  # the -1 sentinel reads row 0
    idx[::11] = 9  # past the table: the last row
    table = torch.randn(7, 12, requires_grad=True)
    with profiling.recording():
        before = profiling.counter("launches.g1")
        got = tables._rows(table, idx)
        (g,) = torch.autograd.grad(got, table, grad)
        col = table[:, 3]
        (gc,) = torch.autograd.grad(tables._rows(col, idx), table, grad[:, 0])
        assert profiling.counter("launches.g1") == before
    clamped = idx.clamp(0, 6)
    assert torch.equal(got, table.detach()[clamped])
    assert torch.equal(g, torch.zeros(7, 12).index_put_((clamped,), grad, accumulate=True))
    want_c = torch.zeros(7, 12)
    want_c[:, 3] = torch.zeros(7).index_put_((clamped,), grad[:, 0], accumulate=True)
    assert torch.equal(gc, want_c)


@pytest.mark.parametrize("shape", [(31, 32), (4, 8), (31,)])
def test_row_gather_function(monkeypatch, shape):
    """RowGather: the forward is table[idx] bit for bit; the backward hands
    G1 the rays' rows, the gradient and the table's shape (a 1-D column
    read as (R, 1)), here with the twin in G1's place."""
    calls = []

    def twin(idx, grad, table_shape):
        calls.append((tuple(idx.shape), tuple(grad.shape), table_shape))
        return g1.row_grad_plain(idx, grad, table_shape)

    monkeypatch.setattr(g1, "row_grad_cuda", twin)
    table = torch.randn(shape, requires_grad=True)
    idx = torch.randint(0, shape[0], (40, 50))
    out = g1.RowGather.apply(table, idx)
    assert torch.equal(out, table.detach()[idx])
    up = torch.randn(out.shape)
    (g,) = torch.autograd.grad(out, table, up)
    assert calls == [((40, 50), (40, 50) + shape[1:], shape)]
    assert torch.equal(g, g1.row_grad_plain(idx, up, shape))
    torch.testing.assert_close(g, torch.zeros(shape).index_put_((idx,), up, accumulate=True),
                               rtol=0, atol=1e-4)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    idx = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="one CUDA device"):
        g1.row_grad_cuda(idx, torch.zeros(4, 8), (3, 8))
    with pytest.raises(ValueError, match="int64"):
        g1.row_grad_plain(idx.int(), torch.zeros(4, 8), (3, 8))
    with pytest.raises(ValueError, match="is not idx"):
        g1.row_grad_plain(idx, torch.zeros(4, 12), (3, 8))
    with pytest.raises(ValueError, match="float32"):
        g1.row_grad_plain(idx, torch.zeros(4, 8, dtype=torch.float64), (3, 8))
