// The K3 query: closest hit by a walk of the scene's skip-link BVH, one
// thread per ray, answering exactly as K1's brute force does.
//
// Replaces the streamed brute force inside the JAX package's stream kernel
// (plutracer_tpu/ops/pallas/integrator_kernel.py: _closest_stream,
// _closest_stream3 over Morton-ordered MegaPack chunks with a cluster-AABB
// cull, fed from HBM by _fetch_stream's slab DMA). That streaming is how a
// TPU feeds VMEM; what it computes is the closest hit over all P rows. Its
// JAX twin is ops/bvh.bvh_closest (a lockstep skip-link walk, measured not
// to map to the TPU); on Hopper the walk is a plain per-thread loop.
//
// The walk (plain version: ops/cuda/intersect_kernel.bvh_closest_plain):
// - the tree is the depth-first skip-link layout of scene/bvh.build_bvh:
//   entering a node goes to node + 1, passing it goes to skip[node];
// - a leaf tests its row of the packed table (leaf_row) with K1's
//   packed_row_t, sphere parent-AABB line cull included, and folds the
//   lexicographic minimum of (t, packed row): K1 keeps the first packed row
//   among equal t, and shared mesh edges make exact ties real;
// - an internal node's box, padded by `margin` on every side so that a hit
//   K1 accepts on a face or an edge is never culled by rounding, is entered
//   when the ray's LINE crosses it if its subtree holds a sphere
//   (line_only: a phantom hit of a non-unit ray lies outside the sphere's
//   own box), else when the ray's [0, best t] overlaps it; NaN enters;
// - a miss returns t = BIG (K1 may report the t of a padding row about
//   1e30 away instead; found and prim agree, and no caller reads t on a
//   miss).
//
// The tables stay in global memory (about 30 MB for mesh2, served by L2
// and HBM). The walk is unordered (left child first), so its cost is the
// node visits of a depth-first search; ordered traversal is later work.
#pragma once

#include "path_common.cuh"

namespace plu {

struct Bvh {
  const float* packed;               // (P_pad, 24): K1's table
  const float *node_min, *node_max;  // (N, 3)
  const int* skip;                   // (N,)
  const int* leaf_row;               // (N,): packed row at a leaf, -1 inside
  const unsigned char* line_only;    // (N,) bool
  int N;
  float margin;
};

PLU_FN bool bvh_enter(const Bvh& b, int n, V3 o, V3 rinv, float best_t) {
  const float* mn = b.node_min + 3 * n;
  const float* mx = b.node_max + 3 * n;
  const float lo[3] = {mn[0] - b.margin, mn[1] - b.margin, mn[2] - b.margin};
  const float hi[3] = {mx[0] + b.margin, mx[1] + b.margin, mx[2] + b.margin};
  float tmin, tmax;
  slab(lo, hi, o, rinv, &tmin, &tmax);
  if (b.line_only[n]) return !(tmax < tmin);
  return !(tmax < pmax(tmin, 0.0f)) && !(tmin > best_t);
}

PLU_FN Query bvh_closest(const Bvh& b, V3 o, V3 d) {
  const V3 rinv = slab_rinv(d);
  float best_t = BIG;
  int best_row = 0x7fffffff;
  int node = 0;
  while (node < b.N) {
    const int row = b.leaf_row[node];
    if (row >= 0) {
      const float t = packed_row_t(b.packed + row * PACK_W, o, d, rinv);
      if (t < best_t || (t == best_t && row < best_row && t < BIG)) {
        best_t = t;
        best_row = row;
      }
      node = b.skip[node];
    } else {
      node = bvh_enter(b, node, o, rinv, best_t) ? node + 1 : b.skip[node];
    }
  }
  const int prim = best_t < BIG ? (int)b.packed[best_row * PACK_W + 10] : 0;
  return Query{best_t < T_MAX, prim, best_t};
}

// the closest-hit functor of path_vertex for K3 and K4
struct BvhWalk {
  Bvh b;
  __device__ Query operator()(V3 o, V3 d) const { return bvh_closest(b, o, d); }
};

}  // namespace plu
