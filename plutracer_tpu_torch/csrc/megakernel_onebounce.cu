// K4: the one-bounce kernel. One shading vertex of every lane per launch,
// over a carry that a host loop (render/wavefront.py) may reorder between
// bounces.
//
// Replaces the JAX package's one-bounce stream kernel
// (plutracer_tpu/ops/pallas/integrator_kernel.py: `kernel_ob` built by
// _build_kernel_stream(one_bounce=True), launched by
// _megakernel_call_stream_onebounce from _ray_color_stream_wavefront).
// Like it, the carry is 16 arrays in and out, here the rows of one
// (16, B) float32 tensor: o (3) | d (3) | T (3) | L (3) | prev_spec | alive |
// prim (a scene row, exact in float32) | t; the uniforms of the bounce are
// (12, B); the bounce index is an argument. The vertex is path_common.cuh's
// path_vertex with the BVH walk of bvh_closest.cuh, the body K3 runs, so a
// lane computes exactly what it computes in K3, and it gains what K3's
// redesign gained (the walk layout, the queries a vertex skips).
//
// Design: one thread per lane, every read and write of the carry and the
// uniforms coalesced (structure of arrays). What bounds it is what bounds
// K3 (the walk's dependent loads and divergence), plus one round trip of
// the 64-byte carry through device memory per lane and bounce. A lane whose
// path has ended is copied through with alive = 0; a lane that ends at this
// vertex leaves prim 0 and t BIG (its extension query is not run), which no
// later step reads: the host loop's sort keys and K4 test alive first.
#include <cuda_runtime.h>

#include "bvh_closest.cuh"

using namespace plu;

namespace {

// threads a block, with __launch_bounds__(BLOCK, 1): the fastest launch
// bounds without spills on the mesh1 launch, from a sweep of block sizes and
// minimum blocks (PERF.md, Findings; without a minimum K4 spills)
constexpr int BLOCK = 128;
constexpr int CARRY_W = 16;

__global__ void __launch_bounds__(BLOCK, 1)
    megakernel_onebounce(const Tables tb, const Walk walk, const Flags fl,
                         const float* __restrict__ cin, float* __restrict__ cout,
                         const float* __restrict__ u, int B, int bounce) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  float c[CARRY_W];
  for (int j = 0; j < CARRY_W; ++j) c[j] = cin[(size_t)j * B + lane];
  PathState s{V3{c[0], c[1], c[2]}, V3{c[3], c[4], c[5]}, V3{c[6], c[7], c[8]},
              V3{c[9], c[10], c[11]}, c[12] != 0.0f, c[13] != 0.0f, (int)c[14], c[15]};
  if (s.alive && s.t < T_MAX) {
    float uu[12];
    for (int j = 0; j < 12; ++j) uu[j] = u[(size_t)j * B + lane];
    path_vertex(tb, WalkQueries{walk}, fl, bounce, uu, s);
  } else {
    s.alive = false;
  }
  const float w[CARRY_W] = {s.o.x, s.o.y, s.o.z, s.d.x, s.d.y, s.d.z, s.T.x, s.T.y,
                            s.T.z, s.L.x, s.L.y, s.L.z, s.prev_spec ? 1.0f : 0.0f,
                            s.alive ? 1.0f : 0.0f, (float)s.prim, s.t};
  for (int j = 0; j < CARRY_W; ++j) cout[(size_t)j * B + lane] = w[j];
}

}  // namespace

extern "C" int plu_megakernel_onebounce(const float* prim, int P, const float* mat, int M,
                                        const float* tex, int T, const float* light, int L,
                                        const float* atlas, int A, int has_images,
                                        const float* packed, const int* nodes,
                                        const float* rows, const float* cin, float* cout,
                                        const float* u, int B, int bounce, int max_bounces,
                                        int swapped_mis, int origin_pdf, int shading_gate,
                                        void* stream) {
  const Tables tb{prim, mat, tex, light, atlas, P, M, T, L, A, has_images != 0};
  const Walk walk{packed, (const int4*)nodes, (const float4*)rows};
  const Flags fl{max_bounces, swapped_mis != 0, origin_pdf != 0, shading_gate != 0};
  megakernel_onebounce<<<(B + BLOCK - 1) / BLOCK, BLOCK, 0, (cudaStream_t)stream>>>(
      tb, walk, fl, cin, cout, u, B, bounce);
  return (int)cudaGetLastError();
}
