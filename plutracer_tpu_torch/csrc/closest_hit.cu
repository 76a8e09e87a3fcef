// K1: brute-force closest hit over the type-partitioned primitive table.
//
// Replaces the JAX package's Pallas closest-hit kernel
// (plutracer_tpu/ops/pallas/intersect_kernel.py: _kernel, launched by
// _pallas_closest, entered by intersect_lite_pallas). Same table (the
// (P_pad, 24) pack_prims_np layout: spheres, boxes, triangles, each padded
// to 8 rows with never-hit rows of its type), same accept rules (sphere
// both roots > 0 with the parent-AABB line cull, box slab tmin >= 0,
// Moller-Trumbore t > 0), same fold: a strict-< running minimum in table
// order, so the winner (original row id, col 10) and t equal the Pallas
// kernel's, and found = t < T_MAX.
//
// What bounds it: arithmetic. A ray-row test is 26-60 float32 operations
// against 96 bytes of table that every ray of a block reads from shared
// memory, so the work is rays x rows x operations; device memory sees the
// rays once and the table once a block. The design:
// - type-specialised segments: the wrapper passes the segment bounds
//   (scene.packed_type_rows), and the kernel runs one loop per type with
//   that type's body only (the Pallas kernel's chunk_type), so no row
//   branches on its type; a row's 24 floats arrive as six float4 loads,
//   and a winner is kept as its table index (its scene row is read once,
//   at the end). The segments are folded in table order;
// - RAYS rays a thread: one row read from shared memory serves RAYS
//   folds, each its own and in table order; the ragged last tile of rays
//   is masked;
// - the table streams through a ring of STAGES tiles of TILE rows in
//   shared memory, each filled by cp.async while the tiles before it are
//   tested, in place of load, sync, test, sync (a table of one tile,
//   demo-box's 16 rows, is read once a block);
// - when the rays alone cannot fill the card (65,536 rays are 256
//   blocks), the table is split across blocks as well, and the last block
//   of a ray tile folds the splits' answers in table order, in the same
//   launch. A table held whole in shared memory by persistent blocks was
//   measured and lost: slower on demo-box, and 2.3x slower on mesh0, whose
//   192 KB table leaves one block an SM (PERF.md, Findings).
// The kernel writes found itself: one launch a call.
#include <cuda_runtime.h>

#include "path_common.cuh"

using namespace plu;

namespace {

// threads a block and rays a thread: from a sweep of both without spills
// (tools/experiments/torch_kernels_ab.py --sweep; PERF.md, Findings)
constexpr int BLOCK = 128;
constexpr int RAYS = 4;
constexpr int TILE = 128;        // table rows of one ring tile (12 KB)
constexpr int STAGES = 3;        // ring tiles in flight
constexpr int MAX_SPLITS = 16;   // splits of a table across blocks
constexpr int ROW4 = PACK_W / 4;  // float4 a row
// waves of blocks the splits aim for: shorter blocks end closer together;
// a table of fewer tiles than MIN_SPLIT_TILES is not split, its fold too
// short to pay for the partial answers and their merge
// (tools/experiments/k1_splits.py; PERF.md, Findings)
constexpr int SPLIT_WAVES = 8;
constexpr int MIN_SPLIT_TILES = 8;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// RAYS rays of one thread and their running minima (t, table index)
struct Rays {
  V3 o[RAYS], d[RAYS], rinv[RAYS];
  float best_t[RAYS];
  int best_k[RAYS];
};

// Each body below is packed_row_t's branch for its type, with the same
// operations in the same order (the terms that depend on the row alone
// computed once for the RAYS rays), and the strict-< fold of fold_rows.

__device__ __forceinline__ void fold_spheres(const float4* rows, int i0, int i1, int base,
                                             Rays& r) {
  for (int i = i0; i < i1; ++i) {
    const float4* p = rows + i * ROW4;
    const float4 x0 = p[0], x1 = p[1], x2 = p[2], x3 = p[3], x4 = p[4];
    const float lo[3] = {x2.w, x3.x, x3.y}, hi[3] = {x3.z, x3.w, x4.x};
    const float rad = x1.x;
#pragma unroll
    for (int j = 0; j < RAYS; ++j) {
      const V3 o = r.o[j], d = r.d[j];
      const float vx = o.x - x0.y, vy = o.y - x0.z, vz = o.z - x0.w;
      const float qb = -(vx * d.x + vy * d.y + vz * d.z);
      const float det = qb * qb - (vx * vx + vy * vy + vz * vz) + rad * rad;
      const float sq = sqrtf(pmax(det, 0.0f));
      const float i1 = qb - sq, i2 = qb + sq;
      float cmin, cmax;
      slab(lo, hi, o, r.rinv[j], &cmin, &cmax);
      const float t = (det >= 0.0f && i1 > 0.0f && i2 > 0.0f && cmax >= cmin) ? i1 : BIG;
      if (t < r.best_t[j]) {
        r.best_t[j] = t;
        r.best_k[j] = base + i;
      }
    }
  }
}

__device__ __forceinline__ void fold_boxes(const float4* rows, int i0, int i1, int base,
                                           Rays& r) {
  for (int i = i0; i < i1; ++i) {
    const float4* p = rows + i * ROW4;
    const float4 x0 = p[0], x1 = p[1];
    const float lo[3] = {x0.y, x0.z, x0.w}, hi[3] = {x1.x, x1.y, x1.z};
#pragma unroll
    for (int j = 0; j < RAYS; ++j) {
      float tmin, tmax;
      slab(lo, hi, r.o[j], r.rinv[j], &tmin, &tmax);
      const float t = (tmax >= tmin && tmin >= 0.0f) ? tmin : BIG;
      if (t < r.best_t[j]) {
        r.best_t[j] = t;
        r.best_k[j] = base + i;
      }
    }
  }
}

__device__ __forceinline__ void fold_triangles(const float4* rows, int i0, int i1, int base,
                                               Rays& r) {
  for (int i = i0; i < i1; ++i) {
    const float4* p = rows + i * ROW4;
    const float4 x0 = p[0], x1 = p[1], x2 = p[2];
    const V3 a = V3{x0.y, x0.z, x0.w};
    const V3 e1 = V3{x1.x, x1.y, x1.z} - a, e2 = V3{x1.w, x2.x, x2.y} - a;
#pragma unroll
    for (int j = 0; j < RAYS; ++j) {
      const V3 o = r.o[j], d = r.d[j];
      const V3 pv = cross(d, e2);
      const float det = dot(e1, pv);
      const float idet = 1.0f / (det == 0.0f ? 1.0f : det);
      const V3 tv = o - a;
      const float u = dot(tv, pv) * idet;
      const V3 qv = cross(tv, e1);
      const float v = dot(d, qv) * idet;
      const float tt = dot(e2, qv) * idet;
      const bool ok = det != 0.0f && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
                      tt > 0.0f;
      const float t = ok ? tt : BIG;
      if (t < r.best_t[j]) {
        r.best_t[j] = t;
        r.best_k[j] = base + i;
      }
    }
  }
}

// Fold table rows [base, base + n), held at `rows` in shared memory, in
// table order: the sphere rows (below n_sph), the box rows (below n_sb),
// then the triangle rows.
__device__ __forceinline__ void fold_tile(const float4* rows, int base, int n, int n_sph,
                                          int n_sb, Rays& r) {
  const int s1 = min(max(n_sph - base, 0), n), b1 = min(max(n_sb - base, 0), n);
  fold_spheres(rows, 0, s1, base, r);
  fold_boxes(rows, s1, b1, base, r);
  fold_triangles(rows, b1, n, base, r);
}

__device__ __forceinline__ void load_rays(const float* o, const float* d, int first, int B,
                                          Rays& r) {
#pragma unroll
  for (int j = 0; j < RAYS; ++j) {
    const int ray = min(first + j * BLOCK, B - 1);  // the ragged tile's spare rays
    r.o[j] = ld3(o + 3 * ray);
    r.d[j] = ld3(d + 3 * ray);
    r.rinv[j] = slab_rinv(r.d[j]);
    r.best_t[j] = BIG;
    r.best_k[j] = -1;
  }
}

__device__ __forceinline__ void store_rays(const float* packed, int first, int B, const Rays& r,
                                           float* t_out, int* prim_out, bool* found_out) {
#pragma unroll
  for (int j = 0; j < RAYS; ++j) {
    const int ray = first + j * BLOCK;
    if (ray >= B) continue;
    const int k = r.best_k[j];
    t_out[ray] = r.best_t[j];
    prim_out[ray] = k < 0 ? 0 : (int)packed[(size_t)k * PACK_W + 10];
    found_out[ray] = r.best_t[j] < T_MAX;
  }
}

// The table streamed through a ring of STAGES tiles, a block a tile of rays
// and a split of the table: blockIdx.y of gridDim.y splits, each a run of
// whole tiles in table order. Without SPLIT (one split) the block answers
// its rays; with it each block writes its partial fold (t, table index) to
// part_t / part_k, and the last block of the ray tile to arrive (its count
// in `arrivals`, set back to 0 after) folds the partials in split order
// with the same strict <, which is the fold of the whole table in table
// order.
template <bool SPLIT>
__global__ void __launch_bounds__(BLOCK)
    closest_hit_ring(const float* __restrict__ packed, int n_rows, int n_sph, int n_sb,
                     const float* __restrict__ o, const float* __restrict__ d,
                     float* __restrict__ t_out, int* __restrict__ prim_out,
                     bool* __restrict__ found_out, int B, float* part_t, int* part_k,
                     int* arrivals) {
  __shared__ float4 ring[STAGES][TILE * ROW4];
  __shared__ bool last;
  const float4* src = reinterpret_cast<const float4*>(packed);
  const int splits = gridDim.y;
  const int tiles = (n_rows + TILE - 1) / TILE, per = (tiles + splits - 1) / splits;
  const int t0 = min(blockIdx.y * per, tiles), t1 = min(t0 + per, tiles);
  auto fill = [&](int tile) {  // one commit group a tile, empty past the split
    if (tile < t1) {
      const int n = min(TILE, n_rows - tile * TILE) * ROW4;
      const float4* from = src + (size_t)tile * TILE * ROW4;
      float4* to = ring[(tile - t0) % STAGES];
      for (int i = threadIdx.x; i < n; i += BLOCK) cp_async16(to + i, from + i);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) fill(t0 + s);
  const int first = blockIdx.x * BLOCK * RAYS + threadIdx.x;
  Rays r;
  load_rays(o, d, first, B, r);
  for (int tile = t0; tile < t1; ++tile) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of `tile` have landed
    __syncthreads();              // everyone's have, and tile - 1 is tested
    fill(tile + STAGES - 1);      // into the slot of tile - 1
    fold_tile(ring[(tile - t0) % STAGES], tile * TILE, min(TILE, n_rows - tile * TILE), n_sph,
              n_sb, r);
  }
  if constexpr (SPLIT) {
#pragma unroll
    for (int j = 0; j < RAYS; ++j) {
      const int ray = first + j * BLOCK;
      if (ray < B) {
        part_t[(size_t)blockIdx.y * B + ray] = r.best_t[j];
        part_k[(size_t)blockIdx.y * B + ray] = r.best_k[j];
      }
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(arrivals + blockIdx.x, 1) == splits - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
#pragma unroll
    for (int j = 0; j < RAYS; ++j) {
      const int ray = min(first + j * BLOCK, B - 1);
      r.best_t[j] = BIG;
      r.best_k[j] = -1;
      for (int s = 0; s < splits; ++s) {
        const float t = __ldcg(part_t + (size_t)s * B + ray);
        if (t < r.best_t[j]) {
          r.best_t[j] = t;
          r.best_k[j] = __ldcg(part_k + (size_t)s * B + ray);
        }
      }
    }
    if (threadIdx.x == 0) arrivals[blockIdx.x] = 0;
  }
  store_rays(packed, first, B, r, t_out, prim_out, found_out);
}

// the card's SM count and how many ring blocks fit on an SM (queried once)
cudaError_t card_shape(int* sms, int* ring_per_sm) {
  static int s = 0, per = 0;
  if (!s) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, closest_hit_ring<true>, BLOCK, 0);
    if (err != cudaSuccess) {
      s = 0;
      return err;
    }
  }
  *sms = s;
  *ring_per_sm = per;
  return cudaSuccess;
}

}  // namespace

// How a call of n_rows rows and B rays runs: returns the splits of the
// table (or a negative cudaError_t), and the tiles of rays in *tiles. The
// splits fill the card: enough blocks for SPLIT_WAVES waves of every SM's
// ring slots, at most MAX_SPLITS, at most one a table tile, none for a
// table of fewer than MIN_SPLIT_TILES tiles.
extern "C" int plu_closest_hit_plan(int n_rows, int B, int* tiles) {
  *tiles = (B + BLOCK * RAYS - 1) / (BLOCK * RAYS);
  int sms = 0, per = 0;
  const cudaError_t err = card_shape(&sms, &per);
  if (err != cudaSuccess) return -(int)err;
  const int row_tiles = (n_rows + TILE - 1) / TILE;
  if (row_tiles < MIN_SPLIT_TILES) return 1;
  const int want = (SPLIT_WAVES * sms * max(per, 1) + *tiles - 1) / max(*tiles, 1);
  return max(1, min(min(want, MAX_SPLITS), row_tiles));
}

// splits from plu_closest_hit_plan; part_t, part_k (splits x B) and
// arrivals (one int a ray tile, all 0) when splits > 1, else null
extern "C" int plu_closest_hit(const float* packed, int n_rows, int n_sph, int n_box,
                               const float* o, const float* d, float* t_out, int* prim_out,
                               bool* found_out, int B, int splits, float* part_t, int* part_k,
                               int* arrivals, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int n_sb = n_sph + n_box;
  const int tiles = (B + BLOCK * RAYS - 1) / (BLOCK * RAYS);
  if (splits <= 1)
    closest_hit_ring<false><<<tiles, BLOCK, 0, st>>>(packed, n_rows, n_sph, n_sb, o, d, t_out,
                                                      prim_out, found_out, B, part_t, part_k,
                                                      arrivals);
  else
    closest_hit_ring<true><<<dim3(tiles, splits), BLOCK, 0, st>>>(
        packed, n_rows, n_sph, n_sb, o, d, t_out, prim_out, found_out, B, part_t, part_k,
        arrivals);
  return (int)cudaGetLastError();
}
