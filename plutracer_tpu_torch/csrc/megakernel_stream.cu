// K3: the stream kernel. Every bounce of every ray in one launch, for
// scenes of 64 < P <= 2^20 primitives; and the K3 query (the BVH closest
// hit) as a launch of its own.
//
// Replaces the JAX package's stream megakernel
// (plutracer_tpu/ops/pallas/integrator_kernel.py: `kernel` built by
// _build_kernel_stream, launched by _megakernel_call_stream, entered by
// ray_color_pallas for P > MAX_P). Its primary hit is found in the kernel,
// as there (_closest_stream at :1905-1908); then all max_bounces vertices
// run through path_common.cuh's path_vertex, the body K2 and K4 share,
// with every closest-hit query a walk of the BVH (bvh_closest.cuh) in
// place of the TPU's chunk streaming.
//
// Input contract of K2: rays o, d (B, 3), uniforms (max_bounces * 12, B)
// in structure of arrays, radiance (B, 3) out, so K3 is held lane by lane
// against the plain ray_color fed the same uniforms.
//
// Design: one thread per ray with the path state in registers. The tables
// (packed closest-hit table, prim, mat, tex, light rows, the BVH) and the
// image atlas stay in global memory, read through L1/L2: at mesh sizes
// they are megabytes, far beyond shared memory. Per vertex a thread walks
// the tree three times (shadow, NEE-BSDF, extension), so the kernel is
// bounded by the latency of dependent loads in the walk and by divergence
// between the rays of a warp, not by bandwidth. A path that has ended
// stops early (its radiance cannot change). Ordered traversal, ray
// sorting, shared-memory top levels and occupancy tuning are later work.
//
// K5 (the JAX stream kernel's debug=True, integrator_kernel.py:1856-1867):
// with a non-null `dbg` the launch takes megakernel_stream<true>, which
// writes every vertex's 12 telemetry channels to dbg, (max_bounces, 12, B)
// as K2's. It runs every vertex of every ray, ended paths included (their
// radiance cannot change, but the JAX kernel reports their channels too).
#include <cuda_runtime.h>

#include "bvh_closest.cuh"

using namespace plu;

namespace {

constexpr int BLOCK = 128;

template <bool DEBUG>
__global__ void __launch_bounds__(BLOCK)
    megakernel_stream(const Tables tb, const Bvh bvh, const Flags fl, const float* __restrict__ o,
                      const float* __restrict__ d, const float* __restrict__ u,
                      float* __restrict__ out, float* __restrict__ dbg, int B) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= B) return;
  const BvhWalk walk{bvh};
  PathState s;
  s.o = ld3(o + 3 * ray);
  s.d = ld3(d + 3 * ray);
  const Query q = walk(s.o, s.d);
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
    path_vertex<DEBUG>(tb, walk, fl, i, uu, s,
                       DEBUG ? dbg + (size_t)i * DBG_C * B + ray : nullptr, B);
  }
  out[3 * ray + 0] = s.L.x;
  out[3 * ray + 1] = s.L.y;
  out[3 * ray + 2] = s.L.z;
}

__global__ void __launch_bounds__(256)
    closest_hit_bvh_kernel(const Bvh bvh, const float* __restrict__ o,
                           const float* __restrict__ d, float* __restrict__ t_out,
                           int* __restrict__ prim_out, int B) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= B) return;
  const Query q = bvh_closest(bvh, ld3(o + 3 * ray), ld3(d + 3 * ray));
  t_out[ray] = q.t;
  prim_out[ray] = q.prim;
}

}  // namespace

extern "C" int plu_closest_hit_bvh(const float* packed, const float* node_min,
                                   const float* node_max, const int* skip, const int* leaf_row,
                                   const unsigned char* line_only, int N, float margin,
                                   const float* o, const float* d, float* t_out,
                                   int* prim_out,
                                   int B, void* stream) {
  const Bvh bvh{packed, node_min, node_max, skip, leaf_row, line_only, N, margin};
  closest_hit_bvh_kernel<<<(B + 255) / 256, 256, 0, (cudaStream_t)stream>>>(bvh, o, d, t_out,
                                                                            prim_out, B);
  return (int)cudaGetLastError();
}

extern "C" int plu_megakernel_stream(const float* prim, int P, const float* mat, int M,
                                     const float* tex, int T, const float* light, int L,
                                     const float* atlas, int A, int has_images,
                                     const float* packed, const float* node_min,
                                     const float* node_max, const int* skip,
                                     const int* leaf_row, const unsigned char* line_only, int N,
                                     float margin, const float* o, const float* d,
                                     const float* u, float* out, float* dbg, int B,
                                     int max_bounces, int swapped_mis, int origin_pdf,
                                     int shading_gate, void* stream) {
  const Tables tb{prim, mat, tex, light, atlas, P, M, T, L, A, has_images != 0};
  const Bvh bvh{packed, node_min, node_max, skip, leaf_row, line_only, N, margin};
  const Flags fl{max_bounces, swapped_mis != 0, origin_pdf != 0, shading_gate != 0};
  const int grid = (B + BLOCK - 1) / BLOCK;
  if (dbg)
    megakernel_stream<true><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(tb, bvh, fl, o, d, u, out,
                                                                      dbg, B);
  else
    megakernel_stream<false><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(tb, bvh, fl, o, d, u, out,
                                                                       dbg, B);
  return (int)cudaGetLastError();
}
