// K2: the path megakernel. Every bounce of every ray in one launch.
//
// Replaces the JAX package's unrolled Pallas megakernel
// (plutracer_tpu/ops/pallas/integrator_kernel.py: `kernel` built by
// _build_kernel, launched by _megakernel_call, entered by
// ray_color_pallas) for scenes of P <= 64 primitives whose tables fit the
// 48 KB of dynamic shared memory a block takes without opting in
// (render/integrator.kernel_tier: K2_SMEM_MAX).
//
// Semantics: the plain integrator plutracer_tpu_torch/render/integrator.py
// (ray_color), per ray, with the same uniforms: u is (max_bounces * 12, B),
// structure of arrays, so neighbouring threads read neighbouring words.
// Inputs are the primary rays, the primary hit from K1 (prim, t; t = BIG
// on a miss) and the uniforms; the output is radiance (B, 3).
//
// Design: one thread per ray with all path state in registers across the
// 8 bounces; each bounce is path_common.cuh's path_vertex, the body K3 and
// K4 share. Each block copies the scene tables (packed closest-hit table,
// prim, mat, tex, light: 3.2 KB on demo-box, at most 48 KB) into shared
// memory once, so every row fetch is an indexed shared load; the image
// atlas stays in
// global memory (read through L1/L2). The kernel does a few thousand flops
// a vertex and no device-memory traffic beyond the uniforms: it is bounded
// by operations, register pressure (occupancy) and the latency of
// dependent math, not by bytes. What the design does about it:
// - a path that has ended stops (about half of demo-box's vertices run);
// - a vertex issues only the queries whose answer can reach the result
//   (path_vertex), and those share ONE pass over the table (closest3): each
//   row is read from shared memory once for up to three rays, and its
//   origin-only terms are computed once;
// - __launch_bounds__ on a short block (BLOCK below).
// Divergence between material and primitive branches within a warp is
// the other cost; reordering rays is later work.
//
// K5 (the JAX kernel's debug=True, integrator_kernel.py:1229-1240): with a
// non-null `dbg` the launch takes the megakernel<true> instantiation, which
// also writes every vertex's 12 telemetry channels to dbg, laid out
// (max_bounces, 12, B) as the JAX kernel's output: one coalesced row per
// channel, and runs every vertex of every ray (ended paths report their
// channels too) with every query. The default instantiation is the kernel
// without them.
#include <cuda_runtime.h>

#include "path_common.cuh"

using namespace plu;

namespace {

// threads a block, with __launch_bounds__(BLOCK, 1): the fastest launch
// bounds without spills on the demo-box pass, from a sweep of block sizes
// and minimum blocks (PERF.md, Findings)
constexpr int BLOCK = 128;

// K1's brute force over the packed table in shared memory: a vertex's
// queries share one pass over the rows (closest3)
struct BruteForce {
  const float* packed;
  int n;
  __device__ void three(V3 o, const V3* dirs, const bool* want, bool, Query* q) const {
    closest3(packed, n, o, dirs, want, q);
  }
};

struct Params {
  const float *prim, *mat, *tex, *light, *packed, *atlas;
  int P, M, T, L, P_pad, A;
  int has_images;
  const float *o, *d, *t0;
  const int* prim0;
  const float* u;
  float* out;
  float* dbg;  // (max_bounces, DBG_C, B) telemetry, null when off
  int B, max_bounces;
  int swapped_mis, origin_pdf, shading_gate;
};

template <bool DEBUG>
__global__ void __launch_bounds__(BLOCK, 1) megakernel(Params k) {
  extern __shared__ float smem[];
  float* s_packed = smem;
  float* s_prim = s_packed + k.P_pad * PACK_W;
  float* s_mat = s_prim + k.P * PRIM_W;
  float* s_tex = s_mat + k.M * MAT_W;
  float* s_light = s_tex + k.T * TEX_W;
  const int n_words = k.P_pad * PACK_W + k.P * PRIM_W + k.M * MAT_W + k.T * TEX_W +
                      k.L * LIGHT_W;
  for (int i = threadIdx.x; i < n_words; i += blockDim.x) {
    const int a = k.P_pad * PACK_W, b = a + k.P * PRIM_W, c = b + k.M * MAT_W,
              e = c + k.T * TEX_W;
    smem[i] = i < a   ? k.packed[i]
              : i < b ? k.prim[i - a]
              : i < c ? k.mat[i - b]
              : i < e ? k.tex[i - c]
                      : k.light[i - e];
  }
  __syncthreads();

  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= k.B) return;

  const Tables tb{s_prim, s_mat, s_tex, s_light, k.atlas, k.P, k.M, k.T, k.L, k.A,
                  k.has_images != 0};
  const Flags fl{k.max_bounces, k.swapped_mis != 0, k.origin_pdf != 0, k.shading_gate != 0};
  const BruteForce closest_hit{s_packed, k.P_pad};
  PathState s{ld3(k.o + 3 * ray), ld3(k.d + 3 * ray), V3{1.0f, 1.0f, 1.0f},
              V3{0.0f, 0.0f, 0.0f}, false, true, k.prim0[ray], k.t0[ray]};
  for (int i = 0; i < k.max_bounces; ++i) {
    if (!DEBUG && !(s.alive && s.t < T_MAX)) break;  // no later vertex adds radiance
    float u[12];
    for (int j = 0; j < 12; ++j) u[j] = k.u[(size_t)(i * 12 + j) * k.B + ray];
    path_vertex<DEBUG>(tb, closest_hit, fl, i, u, s,
                       DEBUG ? k.dbg + (size_t)i * DBG_C * k.B + ray : nullptr, k.B);
  }
  k.out[3 * ray + 0] = s.L.x;
  k.out[3 * ray + 1] = s.L.y;
  k.out[3 * ray + 2] = s.L.z;
}

}  // namespace

extern "C" int plu_megakernel(const float* prim, int P, const float* mat, int M,
                              const float* tex, int T, const float* light, int L,
                              const float* packed, int P_pad, const float* atlas, int A,
                              int has_images, const float* o, const float* d,
                              const int* prim0, const float* t0, const float* u,
                              float* out, float* dbg, int B, int max_bounces,
                              int swapped_mis, int origin_pdf, int shading_gate, void* stream) {
  Params k{prim,  mat, tex, light, packed, atlas, P,  M,  T,  L,
           P_pad, A,   has_images, o,  d,  t0,    prim0, u, out, dbg, B,
           max_bounces, swapped_mis, origin_pdf, shading_gate};
  const size_t smem =
      sizeof(float) * (P_pad * PACK_W + P * PRIM_W + M * MAT_W + T * TEX_W + L * LIGHT_W);
  const int grid = (B + BLOCK - 1) / BLOCK;
  if (dbg)
    megakernel<true><<<grid, BLOCK, smem, (cudaStream_t)stream>>>(k);
  else
    megakernel<false><<<grid, BLOCK, smem, (cudaStream_t)stream>>>(k);
  return (int)cudaGetLastError();
}
