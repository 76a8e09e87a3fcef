// K3: the stream kernel. Every bounce of every ray in one launch, for
// scenes off K2's tier (more than 64 primitives, or tables past K2's shared
// memory: render/integrator.kernel_tier); and the K3 query (the BVH closest
// hit) as a launch of its own.
//
// Replaces the JAX package's stream megakernel
// (plutracer_tpu/ops/pallas/integrator_kernel.py: `kernel` built by
// _build_kernel_stream, launched by _megakernel_call_stream, entered by
// ray_color_pallas for P > MAX_P). Its primary hit is found in the kernel,
// as there (_closest_stream at :1905-1908); then all max_bounces vertices
// run through path_common.cuh's path_vertex, the body K2 and K4 share,
// with every closest-hit query an ordered walk of the BVH
// (bvh_closest.cuh) in place of the TPU's chunk streaming.
//
// Input contract of K2: rays o, d (B, 3), uniforms (max_bounces * 12, B)
// in structure of arrays, radiance (B, 3) out, so K3 is held lane by lane
// against the plain ray_color fed the same uniforms.
//
// Design: one thread per ray with the path state in registers. The tables
// (packed closest-hit table, prim, mat, tex, light rows, the walk layout)
// and the image atlas stay in global memory, read through L1/L2: at mesh
// sizes they are megabytes, far beyond shared memory. The kernel is bounded
// by the latency of the walks' dependent loads and by divergence between
// the rays of a warp, not by bandwidth. What the design does about it:
// - the walk (bvh_closest.cuh) fetches one 64-byte record a node, decides
//   both children at once, visits near children first and culls far ones
//   by the best hit, and tests small subtrees as one leaf;
// - a vertex walks only for the queries whose answer can reach the result
//   (path_vertex): mirror and glass vertices walk once, a point light's
//   shadow ray stops at its first blocker, and a path that has ended stops;
// - the pass loop (render/renderer.render_passes) hands a launch several
//   strata, at least 262,144 rays, so the card holds enough warps to hide
//   the loads of the few long paths;
// - one walk body serves the three queries of a vertex (WalkQueries), which
//   keeps the kernel's code and registers small;
// - short blocks with __launch_bounds__(BLOCK, 8) (below).
//
// K5 (the JAX stream kernel's debug=True, integrator_kernel.py:1856-1867):
// with a non-null `dbg` the launch takes megakernel_stream<true>, which
// writes every vertex's 12 telemetry channels to dbg, (max_bounces, 12, B)
// as K2's. It runs every vertex of every ray with every query, ended paths
// included (their radiance cannot change, but the JAX kernel reports their
// channels too).
#include <cuda_runtime.h>

#include "bvh_closest.cuh"

using namespace plu;

namespace {

// threads a block, with __launch_bounds__(BLOCK, 8): the fastest launch
// bounds without spills on the mesh1 and mesh2 launches, from a sweep of
// block sizes and minimum blocks (PERF.md, Findings)
constexpr int BLOCK = 64;

template <bool DEBUG>
__global__ void __launch_bounds__(BLOCK, 8)
    megakernel_stream(const Tables tb, const Walk walk, const Flags fl, const float* __restrict__ o,
                  const float* __restrict__ d, const float* __restrict__ u,
                  float* __restrict__ out, float* __restrict__ dbg, int B) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= B) return;
  const WalkQueries queries{walk};
  PathState s;
  s.o = ld3(o + 3 * ray);
  s.d = ld3(d + 3 * ray);
  const Query q = queries(s.o, s.d);
  s.T = V3{1.0f, 1.0f, 1.0f};
  s.L = V3{0.0f, 0.0f, 0.0f};
  s.prev_spec = false;
  s.alive = true;
  s.prim = q.prim;
  s.t = q.found ? q.t : BIG;
  for (int i = 0; i < fl.max_bounces; ++i) {
    if (!DEBUG && !(s.alive && s.t < T_MAX)) break;  // no later vertex adds radiance
    float uu[12];
    for (int j = 0; j < 12; ++j) uu[j] = u[(size_t)(i * 12 + j) * B + ray];
    path_vertex<DEBUG>(tb, queries, fl, i, uu, s,
                       DEBUG ? dbg + (size_t)i * DBG_C * B + ray : nullptr, B);
  }
  out[3 * ray + 0] = s.L.x;
  out[3 * ray + 1] = s.L.y;
  out[3 * ray + 2] = s.L.z;
}

__global__ void __launch_bounds__(256)
    closest_hit_bvh_kernel(const Walk walk, const float* __restrict__ o,
                           const float* __restrict__ d, float* __restrict__ t_out,
                           int* __restrict__ prim_out, int B) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= B) return;
  const Query q = walk_closest(walk, ld3(o + 3 * ray), ld3(d + 3 * ray), false);
  t_out[ray] = q.t;
  prim_out[ray] = q.prim;
}

}  // namespace

extern "C" int plu_closest_hit_bvh(const float* packed, const int* nodes, const float* rows,
                                   const float* o, const float* d, float* t_out, int* prim_out,
                                   int B, void* stream) {
  const Walk walk{packed, (const int4*)nodes, (const float4*)rows};
  closest_hit_bvh_kernel<<<(B + 255) / 256, 256, 0, (cudaStream_t)stream>>>(walk, o, d, t_out,
                                                                            prim_out, B);
  return (int)cudaGetLastError();
}

extern "C" int plu_megakernel_stream(const float* prim, int P, const float* mat, int M,
                                     const float* tex, int T, const float* light, int L,
                                     const float* atlas, int A, int has_images,
                                     const float* packed, const int* nodes, const float* rows,
                                     const float* o, const float* d, const float* u, float* out,
                                     float* dbg, int B, int max_bounces, int swapped_mis,
                                     int origin_pdf, int shading_gate, void* stream) {
  const Tables tb{prim, mat, tex, light, atlas, P, M, T, L, A, has_images != 0};
  const Walk walk{packed, (const int4*)nodes, (const float4*)rows};
  const Flags fl{max_bounces, swapped_mis != 0, origin_pdf != 0, shading_gate != 0};
  const int grid = (B + BLOCK - 1) / BLOCK;
  if (dbg)
    megakernel_stream<true><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(tb, walk, fl, o, d, u,
                                                                      out, dbg, B);
  else
    megakernel_stream<false><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(tb, walk, fl, o, d, u,
                                                                       out, dbg, B);
  return (int)cudaGetLastError();
}
