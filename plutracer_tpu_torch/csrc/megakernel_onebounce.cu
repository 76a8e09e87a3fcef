// K4: the one-bounce kernel. One shading vertex of every live lane per
// launch, under the wavefront loop of render/wavefront.py.
//
// Replaces the JAX package's one-bounce stream kernel
// (plutracer_tpu/ops/pallas/integrator_kernel.py: `kernel_ob` built by
// _build_kernel_stream(one_bounce=True), launched by
// _megakernel_call_stream_onebounce), and the host work of its loop
// (_ray_color_stream_wavefront: the primary hit, the sort keys, the
// gathers of the carry and the uniforms, the final scatter). The vertex is
// path_common.cuh's path_vertex with the BVH walk of bvh_closest.cuh, the
// body K3 runs, so a lane computes exactly what it computes in K3.
//
// The contract (plain version: render/wavefront.py, onebounce_plain):
// - launch 0 takes the rays o, d (B, 3), finds the primary hit with the
//   walk K3 uses, and starts every lane's state (T 1, L 0, prev_spec 0,
//   alive 1) itself: lane = ray, in pixel order;
// - the carry is lane-major, (B, 16) float32, 64 bytes a lane:
//   o (3) | d (3) | T (3) | L (3) | prev_spec | alive | prim | t (prim a
//   scene row, exact in float32); read as four float4 and written in lane
//   order;
// - under a sort, launch i > 0 reads lane `lane` of the previous launch's
//   carry at perm[lane] (a stable argsort of the keys that launch wrote),
//   and the lane's ray index with it: orig_out[lane] = orig_in[perm[lane]].
//   The live lanes then form a prefix of counts[i - 1] lanes (the count of
//   lanes the previous launch left alive), and the lanes past it only mark
//   their key dead. Under "none" the carry is updated in place, lane =
//   ray, and a lane whose path has ended returns at once;
// - the bounce's uniforms are read from u (max_bounces, B, 12) at the
//   lane's ray: 48 contiguous bytes, three float4;
// - a lane writes its radiance to out[ray] at the launch where its path
//   ends (alive && t < T_MAX fails after its vertex, the JAX loop's test),
//   and the last launch writes every lane it runs: each ray once. Each
//   block adds its lanes left alive to counts[i] and its lanes ended to
//   counts[max_bounces + i] (one atomic add of each a block), so the host
//   never waits on the card;
// - when a sort follows, every lane writes the next sort key: morton, the
//   Morton code of its new origin (render/wavefront.morton_key, bit for
//   bit: the same IEEE division, clamp, x1023 and truncation); morton5,
//   the direction octant's three bits ahead of that code >> 3; compact, 0;
//   and a dead lane DEAD_KEY (compact: 1).
//
// What bounds it is what bounds K3 (the walk's dependent loads and the
// divergence of a warp's paths); the design moves the loop's host work
// into the launch, where it costs the lane's own loads and stores, and
// sends no lane that has ended through a launch under a sort.
#include <cuda_runtime.h>

#include "bvh_closest.cuh"

using namespace plu;

namespace {

// threads a block, with __launch_bounds__(BLOCK, 4): the fastest launch
// bounds without spills on the mesh1 launch, from a sweep of block sizes and
// minimum blocks (PERF.md, Findings)
constexpr int BLOCK = 64;
constexpr int CARRY4 = 4;  // float4 a lane of the carry
constexpr int DEAD_KEY = 1 << 30;
constexpr int SORT_NONE = 0, SORT_COMPACT = 1, SORT_MORTON = 2, SORT_MORTON5 = 3;

struct Wave {
  const float *o, *d;        // launch 0: the rays (B, 3)
  const float4* cin;         // (B, 16) carry before the vertex (launch > 0)
  float4* cout;              // (B, 16) carry after it (under none: cin)
  const long long* perm;     // (B,) lane -> previous lane, null without a sort
  const int* orig_in;        // (B,) ray of each previous lane (null: lane = ray)
  int* orig_out;             // (B,) ray of each lane, null under none
  const float4* u;           // (max_bounces, B, 12) uniforms, three float4 a ray
  float* out;                // (B, 3) radiance at its ray
  int* key;                  // (B,) the next sort key, null when none follows
  int* counts;               // (2, max_bounces): lanes left alive, lanes ended
  const float* bounds;       // the Morton grid's lo (3) and hi (3)
  int B, bounce, sort;
};

// wavefront.morton_key's bit spread of a 10-bit integer
PLU_FN int spread(int v) {
  v = (v | (v << 16)) & 0x030000FF;
  v = (v | (v << 8)) & 0x0300F00F;
  v = (v | (v << 4)) & 0x030C30C3;
  v = (v | (v << 2)) & 0x09249249;
  return v;
}

PLU_FN int morton_axis(float p, float lo, float hi) {
  const float g = clampf((p - lo) / pmax(hi - lo, 1e-9f), 0.0f, 1.0f);
  return spread((int)(g * 1023.0f));
}

PLU_FN int sort_key(int sort, V3 o, V3 d, const float* b) {
  if (sort == SORT_COMPACT) return 0;
  int key = morton_axis(o.x, b[0], b[3]) | (morton_axis(o.y, b[1], b[4]) << 1) |
            (morton_axis(o.z, b[2], b[5]) << 2);
  if (sort == SORT_MORTON5) {
    const int octant = (d.x >= 0.0f ? 4 : 0) + (d.y >= 0.0f ? 2 : 0) + (d.z >= 0.0f ? 1 : 0);
    key = (octant << 27) | (key >> 3);
  }
  return key;
}

__global__ void __launch_bounds__(BLOCK, 4)
    megakernel_onebounce(const Tables tb, const Walk walk, const Flags fl, const Wave w) {
  const int lane = blockIdx.x * BLOCK + threadIdx.x;
  const bool last = w.bounce == fl.max_bounces - 1;
  const bool sorted = w.perm != nullptr;
  const int dead_key = w.sort == SORT_COMPACT ? 1 : DEAD_KEY;
  bool take = lane < w.B && (!sorted || lane < w.counts[w.bounce - 1]);
  bool live_after = false, ended = false;
  if (take) {
    PathState s;
    int ray = lane;
    if (w.bounce == 0) {
      s.o = ld3(w.o + 3 * lane);
      s.d = ld3(w.d + 3 * lane);
      const Query q = WalkQueries{walk}(s.o, s.d);
      s.T = V3{1.0f, 1.0f, 1.0f};
      s.L = V3{0.0f, 0.0f, 0.0f};
      s.prev_spec = false;
      s.alive = true;
      s.prim = q.prim;
      s.t = q.found ? q.t : BIG;
    } else {
      const int src = sorted ? (int)w.perm[lane] : lane;
      if (w.orig_in) ray = w.orig_in[src];
      const float4* c = w.cin + (size_t)src * CARRY4;
      const float4 c0 = c[0], c1 = c[1], c2 = c[2], c3 = c[3];
      s = PathState{V3{c0.x, c0.y, c0.z}, V3{c0.w, c1.x, c1.y}, V3{c1.z, c1.w, c2.x},
                    V3{c2.y, c2.z, c2.w}, c3.x != 0.0f, c3.y != 0.0f, (int)c3.z, c3.w};
    }
    const bool live_in = s.alive && s.t < T_MAX;
    if (!live_in && w.bounce > 0 && !sorted) {
      take = false;  // under none: ended at an earlier launch, radiance written
    } else {
      if (live_in) {
        const float4* up = w.u + ((size_t)w.bounce * w.B + ray) * 3;
        const float4 u0 = up[0], u1 = up[1], u2 = up[2];
        const float uu[12] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y,
                              u1.z, u1.w, u2.x, u2.y, u2.z, u2.w};
        path_vertex(tb, WalkQueries{walk}, fl, w.bounce, uu, s);
      } else {
        s.alive = false;
      }
      live_after = s.alive && s.t < T_MAX;
      ended = !live_after || last;
      if (ended) {
        w.out[3 * ray + 0] = s.L.x;
        w.out[3 * ray + 1] = s.L.y;
        w.out[3 * ray + 2] = s.L.z;
      }
      if (!last && (w.sort == SORT_NONE || live_after)) {
        float4* c = w.cout + (size_t)lane * CARRY4;
        c[0] = make_float4(s.o.x, s.o.y, s.o.z, s.d.x);
        c[1] = make_float4(s.d.y, s.d.z, s.T.x, s.T.y);
        c[2] = make_float4(s.T.z, s.L.x, s.L.y, s.L.z);
        c[3] = make_float4(s.prev_spec ? 1.0f : 0.0f, s.alive ? 1.0f : 0.0f, (float)s.prim, s.t);
      }
      if (w.orig_out) w.orig_out[lane] = ray;
      if (w.key) w.key[lane] = live_after ? sort_key(w.sort, s.o, s.d, w.bounds) : dead_key;
    }
  }
  if (!take && w.key && lane < w.B) w.key[lane] = dead_key;
  const int n_live = __syncthreads_count(live_after);
  const int n_ended = __syncthreads_count(ended);
  if (threadIdx.x == 0) {
    if (n_live) atomicAdd(w.counts + w.bounce, n_live);
    if (n_ended) atomicAdd(w.counts + fl.max_bounces + w.bounce, n_ended);
  }
}

}  // namespace

extern "C" int plu_megakernel_onebounce(
    const float* prim, int P, const float* mat, int M, const float* tex, int T,
    const float* light, int L, const float* atlas, int A, int has_images, const float* packed,
    const int* nodes, const float* rows, const float* o, const float* d, const float* cin,
    float* cout, const long long* perm, const int* orig_in, int* orig_out, const float* u,
    float* out, int* key, int* counts, const float* bounds, int B, int bounce, int sort,
    int max_bounces, int swapped_mis, int origin_pdf, int shading_gate, void* stream) {
  const Tables tb{prim, mat, tex, light, atlas, P, M, T, L, A, has_images != 0};
  const Walk walk{packed, (const int4*)nodes, (const float4*)rows};
  const Flags fl{max_bounces, swapped_mis != 0, origin_pdf != 0, shading_gate != 0};
  const Wave w{o,        d,        (const float4*)cin, (float4*)cout, perm, orig_in,
               orig_out, (const float4*)u, out, key, counts, bounds, B, bounce, sort};
  megakernel_onebounce<<<(B + BLOCK - 1) / BLOCK, BLOCK, 0, (cudaStream_t)stream>>>(tb, walk, fl,
                                                                                    w);
  return (int)cudaGetLastError();
}
