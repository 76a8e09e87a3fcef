// The K3 query: closest hit by an ordered walk of the scene's BVH, one
// thread per ray, answering exactly as K1's brute force does.
//
// Replaces the streamed brute force inside the JAX package's stream kernel
// (plutracer_tpu/ops/pallas/integrator_kernel.py: _closest_stream,
// _closest_stream3 over Morton-ordered MegaPack chunks with a cluster-AABB
// cull, fed from HBM by _fetch_stream's slab DMA). That streaming is how a
// TPU feeds VMEM; what it computes is the closest hit over all P rows.
//
// The layout (scene/compile.walk_tables; plain version
// ops/cuda/intersect_kernel.walk_closest_plain) is the reference's
// median-split tree, whose nodes it keeps, laid out for traversal:
// - one 64-byte record per internal node, read as four int4 through the
//   read-only path: both children's boxes, already padded by the scene's
//   margin, their references and their LINE flags, so one fetch decides
//   both children;
// - subtrees of at most WALK_LEAF_ROWS primitives are leaves whose rows
//   lie contiguous in walk_rows (the packed rows in leaf order, 80 bytes
//   each, col 10 the row's index in K1's packed table).
//
// The walk (exact by construction; the rules of the tree walk before it):
// - a child is entered when the ray's LINE crosses its padded box if its
//   subtree holds a sphere (a phantom hit of a non-unit ray lies outside
//   the sphere's own box at any t), else when the ray's [0, best t]
//   overlaps it; NaN enters. The margin keeps every hit K1 accepts on a
//   face or an edge inside its ancestors' boxes, so the winner is never
//   culled, whatever the order of the visits;
// - nearer child first: the farther one goes on a per-thread stack with
//   its entry t (-inf for a LINE child) and is skipped when popped if
//   that t now exceeds best t;
// - a leaf tests its rows with K1's packed_row_t, sphere parent-AABB line
//   cull included, and folds the lexicographic minimum of (t, packed row):
//   K1 keeps the first packed row among equal t, and shared mesh edges make
//   exact ties real. So the answer is K1's, on every ray;
// - a miss returns t = BIG (K1 may report the t of a padding row about
//   1e30 away instead; found and prim agree, and no caller reads t on a
//   miss);
// - any_hit (a point light's shadow ray, which needs only found): best t
//   starts at T_MAX, so what lies beyond is culled, and the walk ends at
//   the first row with t < T_MAX. found is the closest walk's: the
//   winner's ancestors all pass a test bounded at T_MAX.
//
// What bounds it on the H100: the latency of dependent loads (a node
// record, then a child, then rows) and divergence between the rays of a
// warp; the tables (about 7 MB for mesh2) live in L2. The design cuts the
// dependent loads: a node visit is 4 vector loads of one 64-byte record
// in place of 9 scalar loads from 5 arrays, both children are decided at
// once, small subtrees cost one leaf visit, and the ordered walk with its
// best-t cull skips far subtrees.
#pragma once

#include "path_common.cuh"

namespace plu {

// scene/compile.py's constants of the same names
constexpr int WALK_LEAF_ROWS = 4;
constexpr int WALK_STACK = 32;
constexpr int WALK_ROW_W = 20;
constexpr int NO_ROW = 0x7fffffff;

struct Walk {
  const float* packed;  // (P_pad, 24): K1's table, for the winner's scene row
  const int4* nodes;    // (Nw, 4) int4: the 64-byte internal-node records
  const float4* rows;   // (P, 5) float4: the walk rows
};

// the padded child box (lo, hi) on the ray: entered, and its entry t
PLU_FN bool walk_enter(const float* lo, const float* hi, bool line, V3 o, V3 rinv,
                       float best_t, float* tmin) {
  float tmax;
  slab(lo, hi, o, rinv, tmin, &tmax);
  if (line) return !(tmax < *tmin);
  return !(tmax < pmax(*tmin, 0.0f)) && !(*tmin > best_t);
}

// fold the rows of leaf `ref` into (best_t, best_row)
PLU_FN void walk_leaf(const Walk& w, int ref, V3 o, V3 d, V3 rinv, float* best_t,
                      int* best_row) {
  const int code = -1 - ref;
  const float4* p = w.rows + (size_t)(code >> 2) * (WALK_ROW_W / 4);
  const int n = (code & 3) + 1;
  for (int k = 0; k < n; ++k, p += WALK_ROW_W / 4) {
    float row[WALK_ROW_W];
    const float4 x0 = __ldg(p), x1 = __ldg(p + 1), x2 = __ldg(p + 2);
    row[0] = x0.x, row[1] = x0.y, row[2] = x0.z, row[3] = x0.w;
    row[4] = x1.x, row[5] = x1.y, row[6] = x1.z, row[7] = x1.w;
    row[8] = x2.x, row[9] = x2.y, row[10] = x2.z, row[11] = x2.w;
    if ((int)row[0] == PRIM_SPHERE) {  // the parent-AABB cull box, cols 11:17
      const float4 x3 = __ldg(p + 3), x4 = __ldg(p + 4);
      row[12] = x3.x, row[13] = x3.y, row[14] = x3.z, row[15] = x3.w;
      row[16] = x4.x;
    } else {
      row[12] = row[13] = row[14] = row[15] = row[16] = 0.0f;
    }
    const float t = packed_row_t(row, o, d, rinv);
    const int prow = (int)row[10];
    if (t < *best_t || (t == *best_t && prow < *best_row && t < BIG)) {
      *best_t = t;
      *best_row = prow;
    }
  }
}

PLU_FN Query walk_closest(const Walk& w, V3 o, V3 d, bool any_hit) {
  const V3 rinv = slab_rinv(d);
  float best_t = any_hit ? T_MAX : BIG;
  int best_row = NO_ROW;
  int stack_ref[WALK_STACK];
  float stack_t[WALK_STACK];
  int sp = 0;
  int ref = 0;  // the root, an internal node
  while (true) {
    bool next = false;  // ref holds the next node to visit
    if (ref >= 0) {
      const int4* nd = w.nodes + 4 * (size_t)ref;
      const int4 a = __ldg(nd), b = __ldg(nd + 1), c = __ldg(nd + 2), e = __ldg(nd + 3);
      const float llo[3] = {__int_as_float(a.x), __int_as_float(a.y), __int_as_float(a.z)};
      const float lhi[3] = {__int_as_float(a.w), __int_as_float(b.x), __int_as_float(b.y)};
      const float rlo[3] = {__int_as_float(b.z), __int_as_float(b.w), __int_as_float(c.x)};
      const float rhi[3] = {__int_as_float(c.y), __int_as_float(c.z), __int_as_float(c.w)};
      float tl = 0.0f, tr = 0.0f;
      const bool el = e.x != 0 && walk_enter(llo, lhi, e.z & 1, o, rinv, best_t, &tl);
      const bool er = e.y != 0 && walk_enter(rlo, rhi, e.z & 2, o, rinv, best_t, &tr);
      if (el && er) {
        const bool rfirst = tr < tl;
        stack_ref[sp] = rfirst ? e.x : e.y;
        stack_t[sp] = (e.z & (rfirst ? 1 : 2)) ? -INFINITY : (rfirst ? tl : tr);
        ++sp;
        ref = rfirst ? e.y : e.x;
        next = true;
      } else if (el || er) {
        ref = el ? e.x : e.y;
        next = true;
      }
    } else {
      walk_leaf(w, ref, o, d, rinv, &best_t, &best_row);
      if (any_hit && best_t < T_MAX) break;
    }
    while (!next && sp > 0) {
      --sp;
      if (stack_t[sp] > best_t) continue;  // its entry lies beyond the best hit
      ref = stack_ref[sp];
      next = true;
    }
    if (!next) break;
  }
  const bool found = best_t < T_MAX;
  const bool hit = any_hit ? found : best_t < BIG;
  const int prim = hit ? (int)w.packed[(size_t)best_row * PACK_W + 10] : 0;
  return Query{found, prim, any_hit && !found ? BIG : best_t};
}

// the closest-hit functor of path_vertex for K3 and K4: each wanted query
// is its own walk; one loop body serves the three, so the walk's code is
// emitted once per kernel
struct WalkQueries {
  Walk w;
  __device__ Query operator()(V3 o, V3 d) const { return walk_closest(w, o, d, false); }
  __device__ void three(V3 o, const V3* dirs, const bool* want, bool shadow_any,
                        Query* q) const {
#pragma unroll 1
    for (int k = 0; k < 3; ++k) {
      const V3 dk = k == 0 ? dirs[0] : (k == 1 ? dirs[1] : dirs[2]);
      const bool on = k == 0 ? want[0] : (k == 1 ? want[1] : want[2]);
      const Query r = on ? walk_closest(w, o, dk, k == 0 && shadow_any) : Query{false, 0, BIG};
      if (k == 0) q[0] = r;
      else if (k == 1) q[1] = r;
      else q[2] = r;
    }
  }
};

}  // namespace plu
