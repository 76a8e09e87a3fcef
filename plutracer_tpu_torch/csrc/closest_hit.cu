// K1: brute-force closest hit over the type-partitioned primitive table.
//
// Replaces the JAX package's Pallas closest-hit kernel
// (plutracer_tpu/ops/pallas/intersect_kernel.py: _kernel, launched by
// _pallas_closest, entered by intersect_lite_pallas). Same table (the
// (P_pad, 24) pack_prims_np layout: spheres, boxes, triangles, each padded
// to 8 rows with never-hit rows), same accept rules (sphere both roots > 0
// with the parent-AABB line cull, box slab tmin >= 0, Moller-Trumbore
// t > 0), same fold: a strict-< running minimum in table order, so the
// winner (original row id, col 10) and t equal the Pallas kernel's.
//
// Design: one thread per ray, rays (B, 3) in, t (B,) and prim (B,) out.
// The block stages the table through shared memory in tiles of TILE rows
// (every thread reads the same row at once: a shared-memory broadcast), so
// one kernel serves the small tables of the megakernel path and the large
// tables of the plain path. The types are partitioned, so the branch on a
// row's type is uniform across the warp. Per ray-primitive pair it is
// 30-40 flops against 96 bytes of table read once per block: the kernel is
// bounded by arithmetic, not by device memory.
#include <cuda_runtime.h>

#include "path_common.cuh"

using namespace plu;

namespace {

constexpr int BLOCK = 256;
constexpr int TILE = 256;  // table rows per shared-memory tile (24 KB)

__global__ void __launch_bounds__(BLOCK)
    closest_hit_kernel(const float* __restrict__ packed, int n_rows, const float* __restrict__ o,
                       const float* __restrict__ d, float* __restrict__ t_out,
                       int* __restrict__ prim_out, int B) {
  __shared__ float tile[TILE * PACK_W];
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = ray < B;
  V3 ro = V3{0.0f, 0.0f, 0.0f}, rd = V3{0.0f, 0.0f, 1.0f};
  if (live) {
    ro = ld3(o + 3 * ray);
    rd = ld3(d + 3 * ray);
  }
  const V3 rinv = slab_rinv(rd);
  float best_t = BIG;
  int best_p = 0;
  for (int base = 0; base < n_rows; base += TILE) {
    const int n = min(TILE, n_rows - base);
    __syncthreads();
    for (int i = threadIdx.x; i < n * PACK_W; i += blockDim.x)
      tile[i] = packed[base * PACK_W + i];
    __syncthreads();
    if (live) fold_rows(tile, n, ro, rd, rinv, &best_t, &best_p);
  }
  if (live) {
    t_out[ray] = best_t;
    prim_out[ray] = best_p;
  }
}

}  // namespace

extern "C" int plu_closest_hit(const float* packed, int n_rows, const float* o, const float* d,
                               float* t_out, int* prim_out, int B, void* stream) {
  const int grid = (B + BLOCK - 1) / BLOCK;
  closest_hit_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(packed, n_rows, o, d, t_out,
                                                               prim_out, B);
  return (int)cudaGetLastError();
}
