// K2: the path megakernel. Every bounce of every ray in one launch.
//
// Replaces the JAX package's unrolled Pallas megakernel
// (plutracer_tpu/ops/pallas/integrator_kernel.py: `kernel` built by
// _build_kernel, launched by _megakernel_call, entered by
// ray_color_pallas) for scenes within megakernel_eligible's caps
// (P <= 64, M <= 16, T <= 8, 1 <= L <= 8, atlas <= 4096 texels).
//
// Semantics: the plain integrator plutracer_tpu_torch/render/integrator.py
// (ray_color), per ray, with the same uniforms: u is (max_bounces * 12, B),
// structure of arrays, so neighbouring threads read neighbouring words.
// Inputs are the primary rays, the primary hit from K1 (prim, t; t = BIG
// on a miss) and the uniforms; the output is radiance (B, 3).
//
// Design: one thread per ray with all path state in registers across the
// 8 bounces. Each block copies the scene tables (packed closest-hit table,
// prim, mat, tex, light: under 21 KB at the caps) into shared memory once,
// so every row fetch is an indexed shared load; the image atlas stays in
// global memory (read through L1/L2). Per vertex the thread runs three
// closest-hit queries over all P rows (shadow, NEE-BSDF, extension), which
// with the shading math is a few thousand flops and no device-memory
// traffic beyond the uniforms: the kernel is bounded by register pressure
// (occupancy) and the latency of dependent math, not by bytes. Hence
// __launch_bounds__(128) and a short block. Divergence between material
// and primitive branches within a warp is the other cost; reordering rays
// is a later optimisation.
#include <cuda_runtime.h>

#include "path_common.cuh"

using namespace plu;

namespace {

constexpr int BLOCK = 128;

struct Params {
  const float *prim, *mat, *tex, *light, *packed, *atlas;
  int P, M, T, L, P_pad, A;
  int has_images;
  const float *o, *d, *t0;
  const int* prim0;
  const float* u;
  float* out;
  int B, max_bounces;
  int swapped_mis, origin_pdf, shading_gate;
};

__global__ void __launch_bounds__(BLOCK) megakernel(Params k) {
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

  const int nl = k.L;
  V3 o = ld3(k.o + 3 * ray), d = ld3(k.d + 3 * ray);
  int prim = k.prim0[ray];
  float t = k.t0[ray];
  bool found = t < T_MAX;
  V3 T = V3{1.0f, 1.0f, 1.0f}, Lr = V3{0.0f, 0.0f, 0.0f};
  bool prev_spec = false, alive = true;
  const V3 zero = V3{0.0f, 0.0f, 0.0f};

  for (int i = 0; i < k.max_bounces; ++i) {
    float u[12];
    for (int j = 0; j < 12; ++j) u[j] = k.u[(size_t)(i * 12 + j) * k.B + ray];

    const float* row = s_prim + clampi(prim, k.P) * PRIM_W;
    Detail h = hit_detail(row, o, d, t, found);
    const bool cur = alive && found;
    const V3 wwo = -d;
    const float* mrow = s_mat + row_id(row[25], k.M) * MAT_W;
    const int mtype = (int)mrow[0];
    const float* trow = s_tex + row_id(pmax(mrow[4], 0.0f), k.T) * TEX_W;
    V3 albedo = eval_albedo(mrow, trow, h.u, h.v, k.atlas, k.A, k.has_images != 0);
    Frame fr = make_frame(h.norm, h.dpdu);

    // emitted light at the vertex (first or post-specular only)
    const int own = (int)row[26];
    if (cur && (i == 0 || prev_spec) && own >= 0 && dot(h.norm, wwo) > 0.0f)
      Lr = Lr + T * ld3(s_light + clampi(own, k.L) * LIGHT_W + 4);

    // next-event estimation: one light picked uniformly
    const int li = min((int)floorf(u[0] * (float)nl), nl - 1);
    const float* lrow = s_light + clampi(li, k.L) * LIGHT_W;
    const float* carrier = s_prim + row_id(pmax(lrow[7], 0.0f), k.P) * PRIM_W;
    LightSample ls =
        sample_light(lrow, carrier, h.p, u[1], u[2], u[3], u[4], k.origin_pdf != 0);
    V3 eta = ld3(mrow + 5), kk = ld3(mrow + 8);
    BsdfSample bn =
        bsdf_sample(fr, mtype, albedo, eta, kk, wwo, u[5], u[6], u[7], true);
    BsdfSample bs =
        bsdf_sample(fr, mtype, albedo, eta, kk, wwo, u[9], u[10], u[11], false);

    // three closest-hit queries from the shading point
    Query sq = closest(s_packed, k.P_pad, h.p, ls.wi);
    Query nq = closest(s_packed, k.P_pad, h.p, bn.wwi);
    Query xq = closest(s_packed, k.P_pad, h.p, bs.wwi);
    const bool s_hits = (int)s_prim[clampi(sq.prim, k.P) * PRIM_W + 26] == li;
    const bool n_hits = (int)s_prim[clampi(nq.prim, k.P) * PRIM_W + 26] == li;

    // ---- NEE, light-sampling strategy (integrator._nee_contributions) ----
    V3 f = (mtype == MAT_DIFFUSE && dot(ls.wi, h.norm) * dot(wwo, h.norm) > 0.0f)
               ? albedo * INV_PI
               : zero;
    const bool unoccl = !sq.found || (!ls.delta && s_hits);
    float b_pdf = 0.0f;
    if (mtype == MAT_DIFFUSE) {
      float wiz = dot(ls.wi, fr.n);
      b_pdf = dot(wwo, fr.n) * wiz > 0.0f ? fabsf(wiz) * INV_PI : 0.0f;
    }
    const float bp = clip_pdf(b_pdf), lp = clip_pdf(ls.pdf);
    float w = k.swapped_mis ? (bp * bp) / (bp * bp + lp * lp)
                            : (lp * lp) / (bp * bp + lp * lp);
    w = (b_pdf == 0.0f && ls.pdf == 0.0f) ? 0.0f : w;
    w = ls.delta ? 1.0f : w;
    const bool gate_l =
        ls.pdf > 0.0f && dot(ls.Li, ls.Li) > 0.0f && dot(f, f) > 0.0f && unoccl;
    const float scale_l = gate_l ? (fabsf(dot(ls.wi, h.norm)) * w) / lp : 0.0f;
    const V3 cl = gate_l ? (f * ls.Li) * scale_l : zero;

    // ---- NEE, BSDF-sampling strategy (non-delta lights only) ----
    const float l_pdf2 = (int)lrow[0] == LIGHT_AREA
                             ? surface_pdf(carrier, h.p, bn.wwi, k.origin_pdf != 0)
                             : 0.0f;
    const float bp2 = clip_pdf(bn.pdf), lp2 = clip_pdf(l_pdf2);
    float w2 = (bp2 * bp2) / (bp2 * bp2 + lp2 * lp2);
    w2 = (bn.pdf == 0.0f && l_pdf2 == 0.0f) ? 0.0f : w2;
    w2 = bn.spec ? 1.0f : w2;
    bool le_gate;
    if (k.shading_gate) {
      // the reference gates emission on the SHADING normal (renderer.cpp:42)
      le_gate = dot(h.norm, -bn.wwi) > 0.0f;
    } else {
      const float* nrow = s_prim + clampi(nq.prim, k.P) * PRIM_W;
      le_gate = dot(detail_norm(nrow, hit_point(h.p, bn.wwi, nq.t, nq.found)), -bn.wwi) > 0.0f;
    }
    const V3 Li2 = (nq.found && n_hits && le_gate) ? ld3(lrow + 4) : zero;
    const bool gate_b = !ls.delta && dot(bn.f, bn.f) > 0.0f && bn.pdf > 0.0f &&
                        (bn.spec || l_pdf2 != 0.0f) && nq.found && dot(Li2, Li2) > 0.0f;
    const float scale_b = gate_b ? (fabsf(dot(bn.wwi, h.norm)) * w2) / bp2 : 0.0f;
    const V3 cb = gate_b ? (bn.f * Li2) * scale_b : zero;
    if (cur) {
      Lr = Lr + (T * cl) * (float)nl;
      Lr = Lr + (T * cb) * (float)nl;
    }

    // throughput update (clamped 1e12 per bounce, 1e16 overall) and
    // termination after the last shading vertex
    const bool ok = dot(bs.f, bs.f) > 0.0f && bs.pdf > 0.0f;
    const bool alive_next = cur && ok && i <= k.max_bounces - 2;
    if (alive_next) {
      const float s = fabsf(dot(bs.wwi, h.norm)) / clip_pdf(bs.pdf);
      T = vmin(T * vmin(bs.f * s, 1.0e12f), 1.0e16f);
    }
    o = h.p;
    d = bs.wwi;
    prev_spec = bs.spec;
    alive = alive_next;
    found = xq.found;
    prim = xq.prim;
    t = xq.t;
  }
  k.out[3 * ray + 0] = Lr.x;
  k.out[3 * ray + 1] = Lr.y;
  k.out[3 * ray + 2] = Lr.z;
}

}  // namespace

extern "C" int plu_megakernel(const float* prim, int P, const float* mat, int M,
                              const float* tex, int T, const float* light, int L,
                              const float* packed, int P_pad, const float* atlas, int A,
                              int has_images, const float* o, const float* d,
                              const int* prim0, const float* t0, const float* u,
                              float* out, int B, int max_bounces, int swapped_mis,
                              int origin_pdf, int shading_gate, void* stream) {
  Params k{prim,  mat, tex, light, packed, atlas, P,  M,  T,  L,
           P_pad, A,   has_images, o,  d,  t0,    prim0, u, out, B,
           max_bounces, swapped_mis, origin_pdf, shading_gate};
  const size_t smem =
      sizeof(float) * (P_pad * PACK_W + P * PRIM_W + M * MAT_W + T * TEX_W + L * LIGHT_W);
  const int grid = (B + BLOCK - 1) / BLOCK;
  megakernel<<<grid, BLOCK, smem, (cudaStream_t)stream>>>(k);
  return (int)cudaGetLastError();
}
