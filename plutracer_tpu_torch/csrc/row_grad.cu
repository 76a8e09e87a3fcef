// G1: the backward of the table-row gather, a deterministic row sum.
//
// Replaces no Pallas kernel: the JAX package gathers table rows with plain
// indexing (plutracer_tpu/ops/tables.py) and leaves the gather's VJP to
// XLA's scatter-add. The port's gather is `table[idx]`
// (ops/tables._rows); on a card, when the table takes a gradient, its
// backward is G1: out[r, :] = the sum of grad[i, :] over the rays i with
// idx[i] == r, for every row r of an (R, W) table.
//
// Every sum's order is fixed by the rays' rows, B, R and W alone
// (ops/cuda/row_grad_kernel.plan), never by scheduling or the card's SM
// count, so the same inputs give the same bits in every run and process.
// No thread or warp walks a row's duplicates alone. Two kernels, by the
// table's size:
//
// row_grad, a table whose R x W floats fit a warp's slice of shared
// memory (the train step's material and light tables):
//   1. a warp iteration takes 32 consecutive rays, one a lane; for each
//      row among them, the lanes' values (+0 on the lanes of other rows)
//      are summed into lane 0 by the shuffle tree 16, 8, 4, 2, 1;
//   2. lane 0 adds that sum to its warp's slice of the row, iteration
//      after iteration;
//   3. the block folds its warps' slices in warp order into its chunk's
//      partial;
//   4. the last block to arrive (its count in `arrivals`, set back to 0
//      after: the count decides who folds, never the order) folds the
//      chunks' partials in chunk order.
//
// row_grad_sorted, a larger table (a prim field): the rays sorted by row,
// stably (row_grad_kernel.row_grad_cuda sorts them; equal rows stay in ray
// order), then a segmented reduction over tiles of BLOCK sorted rays:
//   1. each warp scans its 32 rays, segmented by row: at d = 1, 2, 4, 8,
//      16, lane l adds lane l - d's value where both hold one row;
//   2. the warps' last lanes are folded in warp order where they hold one
//      row, and each lane adds the fold of the warps before it where its
//      row reaches back into them; a segment's last ray then holds the
//      segment's sum within the tile;
//   3. a segment whole inside its tile is written to out; each tile keeps
//      the in-tile sums of its first and last segments;
//   4. the last block to arrive sums each segment that reaches past its
//      first tile: its first tile's last sum, then the next tiles' first
//      sums, in tile order.
//
// Each value enters as g + 0.0f (a -0.0 becomes +0.0), so the +0 of other
// rows' lanes changes no sum; row_grad_kernel.row_grad_plain, the plain
// twin, reproduces both orders bit for bit.
//
// What bounds it: bytes. A ray's index and W floats are read once (the
// sort reads and writes the indices a few times more) and the table's
// gradient is written once; the adds are a few a byte, and the partials
// stay small. At the train step's shapes (262,144 rays, the material
// table's 12 columns) that is some 15 MB, 4.4 us at 3.35 TB/s. The design
// keeps the reads in flight: a thread loads the indices of several
// iterations, then their values, before it sums any; the last blocks load
// many partials at once and add them in order; a block holds its sums in
// registers and shared memory, so no global atomic touches a sum.
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;  // ops/cuda/row_grad_kernel.BLOCK
constexpr int WARPS = BLOCK / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int FOLD = 16;  // partials a thread of a last block loads at once

// idx: (B,) row of each ray, in [0, R); grad: (B, W); part: (chunks, R, W)
// or null for one chunk; out: (R, W). Grid: the chunks; chunk a multiple of
// BLOCK; dynamic shared memory WARPS x R x W floats.
template <int W>
__global__ void __launch_bounds__(BLOCK)
    row_grad(const long long* __restrict__ idx, const float* __restrict__ grad, float* part,
             float* __restrict__ out, int* arrivals, int B, int R, int chunk) {
  extern __shared__ float slices[];
  __shared__ bool last;
  const int chunks = gridDim.x, n = R * W;
  const int lane = threadIdx.x % 32;
  float* slice = slices + (threadIdx.x / 32) * n;
  for (int e = threadIdx.x; e < WARPS * n; e += BLOCK) slices[e] = 0.0f;
  __syncthreads();

  // AHEAD iterations' indices, then their values, are loaded together
  // before any of them is summed: a few round trips to memory a chunk
  constexpr int AHEAD = W >= 32 ? 2 : 4;
  const long long start = (long long)blockIdx.x * chunk;
  const long long end = min((long long)B, start + chunk);
  const int iters = chunk / BLOCK;
  for (int k0 = 0; k0 < iters; k0 += AHEAD) {
    int row[AHEAD];
    float v[AHEAD][W];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      const long long ray = start + (long long)(k0 + u) * BLOCK + threadIdx.x;
      row[u] = (k0 + u < iters && ray < end) ? (int)idx[ray] : -1;
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      const long long ray = start + (long long)(k0 + u) * BLOCK + threadIdx.x;
#pragma unroll
      for (int w = 0; w < W; ++w)
        v[u][w] = row[u] >= 0 ? __ldg(grad + ray * W + w) + 0.0f : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      unsigned todo = __ballot_sync(FULL, row[u] >= 0);
      while (todo) {
        const int r = __shfl_sync(FULL, row[u], __ffs(todo) - 1);
        const bool in = row[u] == r;
        todo &= ~__ballot_sync(FULL, in);
#pragma unroll
        for (int w = 0; w < W; ++w) {
          float s = in ? v[u][w] : 0.0f;
          s += __shfl_down_sync(FULL, s, 16);
          s += __shfl_down_sync(FULL, s, 8);
          s += __shfl_down_sync(FULL, s, 4);
          s += __shfl_down_sync(FULL, s, 2);
          s += __shfl_down_sync(FULL, s, 1);
          if (lane == 0) slice[r * W + w] += s;
        }
      }
    }
  }
  __syncthreads();

  float* dst = chunks == 1 ? out : part + (size_t)blockIdx.x * n;
  for (int e = threadIdx.x; e < n; e += BLOCK) {
    float s = slices[e];
#pragma unroll
    for (int q = 1; q < WARPS; ++q) s += slices[q * n + e];
    dst[e] = s;
  }
  if (chunks == 1) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(arrivals, 1) == chunks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int e = threadIdx.x; e < n; e += BLOCK) {
    const float* p = part + e;
    float s = __ldcg(p);
    for (int c0 = 1; c0 < chunks; c0 += FOLD) {  // FOLD loads in flight, added in order
      float got[FOLD];
#pragma unroll
      for (int j = 0; j < FOLD; ++j)
        got[j] = c0 + j < chunks ? __ldcg(p + (size_t)(c0 + j) * n) : 0.0f;
#pragma unroll
      for (int j = 0; j < FOLD; ++j)
        if (c0 + j < chunks) s += got[j];
    }
    out[e] = s;
  }
  if (threadIdx.x == 0) arrivals[0] = 0;
}

// rows: (B,) the rays' rows in [0, R), sorted (equal rows in ray order);
// perm: (B,) the ray of each; grad: (B, W); part: (tiles, 2, W), each
// tile's first and last segments' in-tile sums, or null for one tile;
// out: (R, W), zero before the launch. Grid: the tiles of BLOCK rays.
template <int W>
__global__ void __launch_bounds__(BLOCK)
    row_grad_sorted(const int* __restrict__ rows, const long long* __restrict__ perm,
                    const float* __restrict__ grad, float* part, float* __restrict__ out,
                    int* arrivals, int B, int R) {
  __shared__ int row_of[BLOCK + 1];  // the tile's rows, then the next tile's first
  __shared__ int tail_row[WARPS];
  __shared__ float tails[WARPS][W];
  __shared__ int span_a[BLOCK], span_b[BLOCK], spans;
  __shared__ bool last;
  const int tiles = gridDim.x, t = blockIdx.x;
  const int lane = threadIdx.x % 32, q = threadIdx.x / 32;
  const long long e0 = (long long)t * BLOCK, e = e0 + threadIdx.x;
  const int r = e < B ? rows[e] : R;  // past the rays: a row past the table's, after all
  float v[W];
  if (e < B) {
    const float* g = grad + perm[e] * W;
#pragma unroll
    for (int w = 0; w < W; ++w) v[w] = __ldg(g + w) + 0.0f;
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) v[w] = 0.0f;
  }
  row_of[threadIdx.x] = r;
  if (threadIdx.x == 0) row_of[BLOCK] = e0 + BLOCK < B ? rows[e0 + BLOCK] : R + 1;

  // 1. the warp's segmented scan
  unsigned same = 0;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int ru = __shfl_up_sync(FULL, r, 1 << k);
    if (lane >= (1 << k) && ru == r) same |= 1u << k;
  }
#pragma unroll
  for (int k = 0; k < 5; ++k) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float u = __shfl_up_sync(FULL, v[w], 1 << k);
      if (same >> k & 1) v[w] = u + v[w];
    }
  }
  // 2. the warps' last lanes in warp order, then each lane's carry
  if (lane == 31) {
    tail_row[q] = r;
#pragma unroll
    for (int w = 0; w < W; ++w) tails[q][w] = v[w];
  }
  __syncthreads();
  if (threadIdx.x < W)
    for (int p = 1; p < WARPS; ++p)
      if (tail_row[p] == tail_row[p - 1])
        tails[p][threadIdx.x] = tails[p - 1][threadIdx.x] + tails[p][threadIdx.x];
  __syncthreads();
  if (q > 0 && r == tail_row[q - 1]) {
#pragma unroll
    for (int w = 0; w < W; ++w) v[w] = tails[q - 1][w] + v[w];
  }

  // 3. each segment's end in the tile
  const int first = row_of[0], final_row = row_of[BLOCK - 1];
  const bool head_open = t > 0 && rows[e0 - 1] == first;
  const bool tail_open = row_of[BLOCK] == final_row;
  const bool is_last = threadIdx.x == BLOCK - 1;
  if (r < R && (is_last || row_of[threadIdx.x + 1] != r)) {
    const bool is_first = r == first;
    if (tiles > 1 && is_first) {
#pragma unroll
      for (int w = 0; w < W; ++w) part[(size_t)t * 2 * W + w] = v[w];
    }
    if (tiles > 1 && is_last) {
#pragma unroll
      for (int w = 0; w < W; ++w) part[((size_t)t * 2 + 1) * W + w] = v[w];
    }
    if (!(is_first && head_open) && !(is_last && tail_open)) {
#pragma unroll
      for (int w = 0; w < W; ++w) out[(size_t)r * W + w] = v[w];
    }
  }
  if (tiles == 1) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(arrivals, 1) == tiles - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // 4. the segments that reach past their first tile, BLOCK tiles a round:
  // a segment starts its span in tile a when it holds a's last ray, goes
  // on into a + 1 and does not come from a - 1; it ends in tile b
  for (int base = 0; base < tiles; base += BLOCK) {
    if (threadIdx.x == 0) spans = 0;
    __syncthreads();
    const int a = base + threadIdx.x;
    if (a + 1 < tiles) {
      const long long end_a = (long long)a * BLOCK + BLOCK;  // the next tile's first ray
      const int ra = rows[end_a - 1];
      if (rows[end_a] == ra && !(a > 0 && rows[end_a - BLOCK - 1] == ra)) {
        long long lo = end_a, hi = B;  // the first ray past ra's, by bisection
        while (hi - lo > 1) {
          const long long mid = (lo + hi) / 2;
          if (rows[mid] == ra) lo = mid; else hi = mid;
        }
        const int slot = atomicAdd(&spans, 1);  // the slot decides who folds, never the order
        span_a[slot] = a;
        span_b[slot] = (int)(lo / BLOCK);
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < spans * W; j += BLOCK) {
      const int sa = span_a[j / W], sb = span_b[j / W], w = j % W;
      float s = __ldcg(part + ((size_t)sa * 2 + 1) * W + w);
      for (int k0 = sa + 1; k0 <= sb; k0 += FOLD) {  // FOLD loads in flight, added in order
        float got[FOLD];
#pragma unroll
        for (int i = 0; i < FOLD; ++i)
          got[i] = k0 + i <= sb ? __ldcg(part + (size_t)(k0 + i) * 2 * W + w) : 0.0f;
#pragma unroll
        for (int i = 0; i < FOLD; ++i)
          if (k0 + i <= sb) s += got[i];
      }
      out[(size_t)rows[(long long)sa * BLOCK + BLOCK - 1] * W + w] = s;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) arrivals[0] = 0;
}

template <int W>
void launch(int chunks, cudaStream_t st, const long long* idx, const float* grad, float* part,
            float* out, int* arrivals, int B, int R, int chunk) {
  const size_t smem = sizeof(float) * WARPS * R * W;
  row_grad<W><<<chunks, BLOCK, smem, st>>>(idx, grad, part, out, arrivals, B, R, chunk);
}

template <int W>
void launch_sorted(int tiles, cudaStream_t st, const int* rows, const long long* perm,
                   const float* grad, float* part, float* out, int* arrivals, int B, int R) {
  row_grad_sorted<W><<<tiles, BLOCK, 0, st>>>(rows, perm, grad, part, out, arrivals, B, R);
}

}  // namespace

// idx (B,) int64 rows in [0, R); grad (B, W) float32; part (chunks x R x W)
// and arrivals (one int, 0) when chunks > 1, else null; out (R, W). chunk
// and chunks from row_grad_kernel.plan, R x W within a warp's slice; W one
// of 1, 8, 12, 32 (else cudaErrorInvalidValue).
extern "C" int plu_row_grad(const long long* idx, const float* grad, float* part, float* out,
                            int* arrivals, int B, int R, int W, int chunk, int chunks,
                            void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (W) {
    case 1: launch<1>(chunks, st, idx, grad, part, out, arrivals, B, R, chunk); break;
    case 8: launch<8>(chunks, st, idx, grad, part, out, arrivals, B, R, chunk); break;
    case 12: launch<12>(chunks, st, idx, grad, part, out, arrivals, B, R, chunk); break;
    case 32: launch<32>(chunks, st, idx, grad, part, out, arrivals, B, R, chunk); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// rows (B,) int32 sorted, equal rows in ray order; perm (B,) int64 the ray
// of each; grad (B, W) float32; part (tiles x 2 x W) and arrivals (one int,
// 0) when tiles > 1, else null; out (R, W) zeroed. tiles = ceil(B / 256);
// W one of 1, 8, 12, 32 (else cudaErrorInvalidValue).
extern "C" int plu_row_grad_sorted(const int* rows, const long long* perm, const float* grad,
                                   float* part, float* out, int* arrivals, int B, int R, int W,
                                   int tiles, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (W) {
    case 1: launch_sorted<1>(tiles, st, rows, perm, grad, part, out, arrivals, B, R); break;
    case 8: launch_sorted<8>(tiles, st, rows, perm, grad, part, out, arrivals, B, R); break;
    case 12: launch_sorted<12>(tiles, st, rows, perm, grad, part, out, arrivals, B, R); break;
    case 32: launch_sorted<32>(tiles, st, rows, perm, grad, part, out, arrivals, B, R); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
