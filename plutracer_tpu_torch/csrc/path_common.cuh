// Device functions shared by the closest-hit kernel K1 (closest_hit.cu),
// the path megakernel K2 (megakernel.cu), the stream kernel K3
// (megakernel_stream.cu) and the one-bounce kernel K4
// (megakernel_onebounce.cu). path_vertex, at the end, is the one shading
// vertex all three path kernels run.
//
// Each function is the per-ray form of a plain PyTorch op of this package
// (plutracer_tpu_torch/ops/*.py), written with the same operations in the
// same order. The build turns FMA contraction off (-fmad=false) and keeps
// IEEE division and sqrt, so a function rounds exactly as its PyTorch twin
// does on the card; transcendentals (acosf, sinf, cosf, rsqrtf) are the
// CUDA math library's, as PyTorch's CUDA kernels use.
//
// Table layouts (float32 rows; integer ids are exact in f32 below 2^24):
//   packed closest-hit table (P_pad, 24), type-partitioned:
//     0 type | 1:4 a | 4:7 b | 7:10 c | 10 original row | 11:14 cull min |
//     14:17 cull max
//   prim (P, 32): 0 type | 1:4 a | 4:7 b | 7:10 c | 10:19 n0 n1 n2 |
//     19:25 uv0 uv1 uv2 | 25 material | 26 light | 27 area
//   mat (M, 12): 0 type | 1:4 color | 4 tex | 5:8 eta | 8:11 k
//   tex (T, 12): 0 type | 1:4 c0 | 4:7 c1 | 7 scale | 8 line | 9 ofs | 10 w | 11 h
//   light (L, 8): 0 type | 1:4 pos | 4:7 intensity | 7 prim
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace plu {

constexpr float T_MAX = 100000.0f;  // hit_record initial t (inc/cmmn.h:228)
constexpr float BIG = 3.0e37f;      // "no hit" sentinel in reductions
constexpr float INV_PI = (float)(1.0 / 3.14159265358979323846);
constexpr float TWO_PI = (float)(2.0 * 3.14159265358979323846);
constexpr float TWO_OVER_PI = (float)(2.0 / 3.14159265358979323846);
constexpr float QUARTER_PI = (float)(3.14159265358979323846 * 0.25);

constexpr int PRIM_SPHERE = 0, PRIM_BOX = 1;
constexpr int MAT_DIFFUSE = 0, MAT_MIRROR = 1, MAT_REFRACT = 2, MAT_GLASS = 3;
constexpr int TEX_CHECKERBOARD = 0, TEX_GRID = 1;
constexpr int LIGHT_POINT = 0, LIGHT_AREA = 1;

constexpr int PACK_W = 24, PRIM_W = 32, MAT_W = 12, TEX_W = 12, LIGHT_W = 8;

struct V3 {
  float x, y, z;
};

#define PLU_FN static __device__ __forceinline__

PLU_FN V3 ld3(const float* p) { return V3{p[0], p[1], p[2]}; }
PLU_FN V3 operator+(V3 a, V3 b) { return V3{a.x + b.x, a.y + b.y, a.z + b.z}; }
PLU_FN V3 operator-(V3 a, V3 b) { return V3{a.x - b.x, a.y - b.y, a.z - b.z}; }
PLU_FN V3 operator-(V3 a) { return V3{-a.x, -a.y, -a.z}; }
PLU_FN V3 operator*(V3 a, V3 b) { return V3{a.x * b.x, a.y * b.y, a.z * b.z}; }
PLU_FN V3 operator*(V3 a, float s) { return V3{a.x * s, a.y * s, a.z * s}; }
PLU_FN V3 operator/(V3 a, float s) { return V3{a.x / s, a.y / s, a.z / s}; }
// (x + y) + z: the order of safemath.dot
PLU_FN float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
PLU_FN V3 cross(V3 a, V3 b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
// torch.minimum / torch.maximum: NaN propagates (fminf would drop it)
PLU_FN float pmin(float a, float b) { return (a < b || a != a) ? a : b; }
PLU_FN float pmax(float a, float b) { return (a > b || a != a) ? a : b; }
PLU_FN float clampf(float x, float lo, float hi) { return pmin(pmax(x, lo), hi); }
PLU_FN V3 vmin(V3 a, float s) { return V3{pmin(a.x, s), pmin(a.y, s), pmin(a.z, s)}; }
// safemath.safe_sqrt: exactly 0 for x <= 0
PLU_FN float safe_sqrt(float x) { return x > 0.0f ? sqrtf(x) : 0.0f; }
// safemath.normalize: v * rsqrt(|v|^2 + 1e-30)
PLU_FN V3 normalize(V3 v) { return v * rsqrtf(dot(v, v) + 1e-30f); }
PLU_FN float clip_pdf(float x) { return clampf(x, 1e-12f, 1e9f); }
PLU_FN int clampi(int i, int n) { return i < 0 ? 0 : (i >= n ? n - 1 : i); }
PLU_FN int row_id(float f, int n) { return clampi((int)f, n); }

// ---------------------------------------------------------------------------
// closest hit over the packed table (K1's arithmetic: the JAX package's
// Pallas kernel, plutracer_tpu/ops/pallas/intersect_kernel.py:_kernel)
// ---------------------------------------------------------------------------

struct Query {
  bool found;
  int prim;
  float t;
};

// 1/d with exact zeros replaced by 1e-20 (the kernel's slab guard)
PLU_FN V3 slab_rinv(V3 d) {
  return V3{1.0f / (d.x == 0.0f ? 1e-20f : d.x), 1.0f / (d.y == 0.0f ? 1e-20f : d.y),
            1.0f / (d.z == 0.0f ? 1e-20f : d.z)};
}

// slab interval [tmin, tmax] of box (lo, hi) on the ray line
PLU_FN void slab(const float* lo, const float* hi, V3 o, V3 r, float* tmin, float* tmax) {
  float t1x = (lo[0] - o.x) * r.x, t2x = (hi[0] - o.x) * r.x;
  float t1y = (lo[1] - o.y) * r.y, t2y = (hi[1] - o.y) * r.y;
  float t1z = (lo[2] - o.z) * r.z, t2z = (hi[2] - o.z) * r.z;
  *tmin = pmax(pmax(pmin(t1x, t2x), pmin(t1y, t2y)), pmin(t1z, t2z));
  *tmax = pmin(pmin(pmax(t1x, t2x), pmax(t1y, t2y)), pmax(t1z, t2z));
}

// t of one packed row: sphere (both roots > 0, parent-AABB line cull in
// cols 11:17), box (slab, tmin >= 0), triangle (Moller-Trumbore, t > 0)
PLU_FN float packed_row_t(const float* row, V3 o, V3 d, V3 rinv) {
  const int ty = (int)row[0];
  if (ty == PRIM_SPHERE) {
    float vx = o.x - row[1], vy = o.y - row[2], vz = o.z - row[3];
    float r = row[4];
    float qb = -(vx * d.x + vy * d.y + vz * d.z);
    float det = qb * qb - (vx * vx + vy * vy + vz * vz) + r * r;
    float sq = sqrtf(pmax(det, 0.0f));
    float i1 = qb - sq, i2 = qb + sq;
    float cmin, cmax;
    slab(row + 11, row + 14, o, rinv, &cmin, &cmax);
    return (det >= 0.0f && i1 > 0.0f && i2 > 0.0f && cmax >= cmin) ? i1 : BIG;
  }
  if (ty == PRIM_BOX) {
    float tmin, tmax;
    slab(row + 1, row + 4, o, rinv, &tmin, &tmax);
    return (tmax >= tmin && tmin >= 0.0f) ? tmin : BIG;
  }
  V3 a = ld3(row + 1);
  V3 e1 = ld3(row + 4) - a, e2 = ld3(row + 7) - a;
  V3 pv = cross(d, e2);
  float det = dot(e1, pv);
  float idet = 1.0f / (det == 0.0f ? 1.0f : det);
  V3 tv = o - a;
  float u = dot(tv, pv) * idet;
  V3 qv = cross(tv, e1);
  float v = dot(d, qv) * idet;
  float t = dot(e2, qv) * idet;
  bool ok = det != 0.0f && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f;
  return ok ? t : BIG;
}

// fold rows [0, n) into a running strict-< minimum (first winner in table
// order); the winner is reported by its original scene row (col 10)
PLU_FN void fold_rows(const float* rows, int n, V3 o, V3 d, V3 rinv, float* best_t,
                      int* best_p) {
  for (int k = 0; k < n; ++k) {
    const float* row = rows + k * PACK_W;
    float tk = packed_row_t(row, o, d, rinv);
    if (tk < *best_t) {
      *best_t = tk;
      *best_p = (int)row[10];
    }
  }
}

PLU_FN Query closest(const float* packed, int n, V3 o, V3 d) {
  float best_t = BIG;
  int best_p = 0;
  fold_rows(packed, n, o, d, slab_rinv(d), &best_t, &best_p);
  return Query{best_t < T_MAX, best_p, best_t};
}

// ---------------------------------------------------------------------------
// t against one primitive row (ops/intersect.py:prim_t_rows: the plain
// accept rules, whose box guard replaces |d| < 1e-12 by 1e-12)
// ---------------------------------------------------------------------------

PLU_FN float prim_row_t(const float* row, V3 o, V3 d) {
  const int ty = (int)row[0];
  V3 a = ld3(row + 1), b = ld3(row + 4);
  if (ty == PRIM_SPHERE) {
    V3 v = o - a;
    float qb = -dot(v, d);
    float det = qb * qb - dot(v, v) + b.x * b.x;
    float sq = safe_sqrt(det);
    float i1 = qb - sq, i2 = qb + sq;
    return (det >= 0.0f && i1 > 0.0f && i2 > 0.0f) ? i1 : BIG;
  }
  if (ty == PRIM_BOX) {
    float r[3], oo[3] = {o.x, o.y, o.z}, dd[3] = {d.x, d.y, d.z};
    float lo[3] = {a.x, a.y, a.z}, hi[3] = {b.x, b.y, b.z};
    float tmin = 0.0f, tmax = 0.0f;
    for (int i = 0; i < 3; ++i) {
      r[i] = 1.0f / (fabsf(dd[i]) < 1e-12f ? 1e-12f : dd[i]);
      float t1 = (lo[i] - oo[i]) * r[i], t2 = (hi[i] - oo[i]) * r[i];
      float mn = pmin(t1, t2), mx = pmax(t1, t2);
      tmin = i == 0 ? mn : pmax(tmin, mn);
      tmax = i == 0 ? mx : pmin(tmax, mx);
    }
    return (tmax >= tmin && tmin >= 0.0f) ? tmin : BIG;
  }
  return packed_row_t(row, o, d, V3{0.0f, 0.0f, 0.0f});  // triangle (no slab)
}

// ---------------------------------------------------------------------------
// shading detail (ops/intersect.py:hit_detail_rows)
// ---------------------------------------------------------------------------

struct Detail {
  V3 p, norm, dpdu;
  float u, v;
};

PLU_FN int box_face(V3 p, V3 lo, V3 hi, V3* norm) {
  V3 c = (lo + hi) * 0.5f;
  V3 ext = hi - c, np = p - c;
  float d0 = fabsf(ext.x - fabsf(np.x)), d1 = fabsf(ext.y - fabsf(np.y));
  float d2 = fabsf(ext.z - fabsf(np.z));
  int mci = (d0 <= d1 && d0 <= d2) ? 0 : (d1 <= d2 ? 1 : 2);  // first minimum
  float npm = mci == 0 ? np.x : (mci == 1 ? np.y : np.z);
  float s = npm < 0.0f ? -1.0f : 1.0f;  // sign(0) -> +1
  *norm = V3{mci == 0 ? s : 0.0f * s, mci == 1 ? s : 0.0f * s, mci == 2 ? s : 0.0f * s};
  return mci;
}

// normalized edges U, V of a triangle row; returns cross(U, V), unnormalized
PLU_FN V3 tri_norm(const float* row, V3* U) {
  V3 a = ld3(row + 1);
  V3 e1 = ld3(row + 4) - a, e2 = ld3(row + 7) - a;
  *U = e1 / pmax(safe_sqrt(dot(e1, e1)), 1e-20f);
  V3 V = e2 / pmax(safe_sqrt(dot(e2, e2)), 1e-20f);
  return cross(*U, V);
}

// geometric normal only, at hit point p (sphere / box / triangle)
PLU_FN V3 detail_norm(const float* row, V3 p) {
  const int ty = (int)row[0];
  V3 n, U;
  if (ty == PRIM_SPHERE) return normalize(p - ld3(row + 1));
  if (ty == PRIM_BOX) {
    box_face(p, ld3(row + 1), ld3(row + 4), &n);
    return n;
  }
  return tri_norm(row, &U);
}

PLU_FN V3 hit_point(V3 o, V3 d, float t, bool found) {
  return o + d * (found ? pmin(t, T_MAX) : 1.0f);
}

PLU_FN Detail hit_detail(const float* row, V3 o, V3 d, float t, bool found) {
  Detail h;
  h.p = hit_point(o, d, t, found);
  const int ty = (int)row[0];
  if (ty == PRIM_SPHERE) {
    // polar uv (src/surfaces/sphere.cpp:28-44); dpdu from the world point
    V3 n = normalize(h.p - ld3(row + 1));
    float phi = acosf(clampf(-n.y, -1.0f, 1.0f));
    float sin_phi = sinf(phi);
    h.v = phi * INV_PI;
    float safe_sin = sin_phi == 0.0f ? 1.0f : sin_phi;
    float ct = clampf(-n.z / safe_sin, -1.0f, 1.0f);
    float theta = acosf(ct) * TWO_OVER_PI;
    theta = sin_phi == 0.0f ? 0.0f : theta;
    h.u = n.x >= 0.0f ? 1.0f - theta : theta;
    V3 dpdu = V3{-TWO_PI * h.p.y, TWO_PI * h.p.x, 0.0f};
    h.dpdu = dot(dpdu, dpdu) < 1e-20f ? V3{n.z, 0.0f, -n.x} : dpdu;
    h.norm = n;
  } else if (ty == PRIM_BOX) {
    // uv/dpdu maps of box.cpp:29-33: mci 0 -> (x,y),x; 1 -> (x,z),x; 2 -> (y,x),y
    int mci = box_face(h.p, ld3(row + 1), ld3(row + 4), &h.norm);
    int iu = mci == 2 ? 1 : 0;
    int iv = mci == 0 ? 1 : (mci == 1 ? 2 : 0);
    float pc[3] = {h.p.x, h.p.y, h.p.z};
    h.u = pc[iu];
    h.v = pc[iv];
    h.dpdu = V3{iu == 0 ? 1.0f : 0.0f, iu == 1 ? 1.0f : 0.0f, 0.0f};
  } else {
    // Moller-Trumbore barycentrics with the reference's swapped uv weights
    V3 a = ld3(row + 1);
    V3 e1 = ld3(row + 4) - a, e2 = ld3(row + 7) - a;
    V3 pv = cross(d, e2);
    float det = dot(e1, pv);
    float idet = 1.0f / (det == 0.0f ? 1.0f : det);
    V3 tv = o - a;
    float bu = dot(tv, pv) * idet;
    V3 qv = cross(tv, e1);
    float bv = dot(d, qv) * idet;
    float bw = 1.0f - (bu + bv);
    h.norm = tri_norm(row, &h.dpdu);
    h.u = row[19] * bu + row[21] * bv + row[23] * bw;
    h.v = row[20] * bu + row[22] * bv + row[24] * bw;
  }
  return h;
}

// ---------------------------------------------------------------------------
// textures (ops/texture.py:eval_color_rows)
// ---------------------------------------------------------------------------

PLU_FN float floor_mod(float a, float b) {  // torch.remainder
  float m = fmodf(a, b);
  return (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) ? m + b : m;
}

PLU_FN V3 eval_albedo(const float* mrow, const float* trow, float u, float v,
                      const float* atlas, int A, bool has_images) {
  if ((int)mrow[4] < 0) return ld3(mrow + 1);
  const int ttype = (int)trow[0];
  V3 c0 = ld3(trow + 1), c1 = ld3(trow + 4);
  float scale = trow[7];
  if (ttype == TEX_CHECKERBOARD || (ttype != TEX_GRID && !has_images)) {
    float idx = floor_mod(floorf(u * scale) + floorf(v * scale), 2.0f);
    return idx < 1.0f ? c0 : c1;
  }
  if (ttype == TEX_GRID) {
    float fu = u * scale, fv = v * scale;
    float gu = trow[8] >= fu - floorf(fu) ? 1.0f : 0.0f;
    float gv = trow[8] >= fv - floorf(fv) ? 1.0f : 0.0f;
    return c1 + (c0 - c1) * pmax(gu, gv);
  }
  // image: wrap-mode nearest texel (texture.h:53-60)
  int w = (int)trow[10], h = (int)trow[11];
  float cu = floor_mod(u, 1.0f), cv = floor_mod(v, 1.0f);
  int icx = min((int)floorf(cu * (float)w), w - 1);
  int icy = min((int)floorf(cv * (float)h), h - 1);
  int flat = clampi((int)trow[9] + icy * w + icx, A);
  return ld3(atlas + 3 * flat);
}

// ---------------------------------------------------------------------------
// sampling (ops/sampling.py)
// ---------------------------------------------------------------------------

PLU_FN V3 cosine_hemisphere(float u0, float u1) {
  float ux = 2.0f * u0 - 1.0f, uy = 2.0f * u1 - 1.0f;
  bool zero = ux == 0.0f && uy == 0.0f;
  float sx = ux == 0.0f ? 1.0f : ux, sy = uy == 0.0f ? 1.0f : uy;
  float r, phi;
  if (ux >= -uy) {
    if (ux > uy) {
      r = ux;
      phi = uy > 0.0f ? uy / sx : 8.0f + uy / sx;
    } else {
      r = uy;
      phi = 2.0f - ux / sy;
    }
  } else if (ux <= uy) {
    r = -ux;
    phi = 4.0f - uy / sx;
  } else {
    r = -uy;
    phi = 6.0f - ux / sy;
  }
  phi = phi * QUARTER_PI;
  float dx = zero ? 0.0f : cosf(phi) * r;
  float dy = zero ? 0.0f : sinf(phi) * r;
  return V3{dx, dy, sqrtf(pmax(1.0f - (dx * dx + dy * dy), 0.0f))};
}

PLU_FN V3 uniform_sphere(float u0, float u1) {
  float z = 1.0f - 2.0f * u0;
  float r = sqrtf(pmax(1.0f - z * z, 0.0f));
  float phi = TWO_PI * u1;
  return V3{r * cosf(phi), r * sinf(phi), z};
}

// ---------------------------------------------------------------------------
// BSDF (ops/bsdf.py)
// ---------------------------------------------------------------------------

struct Frame {
  V3 s, t, n;
};

PLU_FN Frame make_frame(V3 norm, V3 dpdu) {
  V3 s = normalize(dpdu);
  return Frame{s, cross(norm, s), norm};
}
PLU_FN V3 w2l(const Frame& f, V3 v) { return V3{dot(v, f.s), dot(v, f.t), dot(v, f.n)}; }
PLU_FN V3 l2w(const Frame& f, V3 v) { return (f.s * v.x + f.t * v.y) + f.n * v.z; }

struct BsdfSample {
  V3 f, wwi;
  float pdf;
  bool spec;
};

PLU_FN float fresnel_dielectric(float cos_i, float fr_eta_i, float fr_eta_t) {
  float ci = clampf(cos_i, -1.0f, 1.0f);
  bool entering = ci > 0.0f;
  fr_eta_i = fr_eta_i == 0.0f ? 1.0f : fr_eta_i;
  fr_eta_t = fr_eta_t == 0.0f ? 1.0f : fr_eta_t;
  float ei = entering ? fr_eta_t : fr_eta_i;
  float et = entering ? fr_eta_i : fr_eta_t;
  float sin_t = ei / et * safe_sqrt(1.0f - ci * ci);
  if (sin_t >= 1.0f) return 1.0f;  // total internal reflection
  float cos_t = safe_sqrt(1.0f - sin_t * sin_t);
  float aci = fabsf(ci);
  float rparl = (et * aci - ei * cos_t) / (et * aci + ei * cos_t);
  float rperp = (ei * aci - et * cos_t) / (ei * aci + et * cos_t);
  return (rparl * rparl + rperp * rperp) * 0.5f;
}

// specular_transmission::sampleF (inc/material.h:137-150)
PLU_FN bool transmission(float et_ctor, float ei_ctor, V3 wo, V3 albedo, V3* f, V3* wi) {
  et_ctor = et_ctor == 0.0f ? 1.0f : et_ctor;
  ei_ctor = ei_ctor == 0.0f ? 1.0f : ei_ctor;
  float cos_wo = wo.z;
  bool entering = cos_wo > 0.0f;
  float ei = entering ? et_ctor : ei_ctor;
  float et = entering ? ei_ctor : et_ctor;
  float sin2_i = pmax(1.0f - cos_wo * cos_wo, 0.0f);
  float eta = ei / et;
  float sin2_t = eta * eta * sin2_i;
  bool tir = sin2_t >= 1.0f;
  float cos_t = safe_sqrt(1.0f - sin2_t);
  cos_t = entering ? -cos_t : cos_t;
  *wi = V3{eta * -wo.x, eta * -wo.y, cos_t};
  float fr = fresnel_dielectric(cos_wo, et_ctor, ei_ctor);
  float scale = (et * et) / (ei * ei);
  float denom = pmax(fabsf(cos_t), 1e-20f);
  *f = tir ? V3{0.0f, 0.0f, 0.0f} : (albedo * (scale * (1.0f - fr))) / denom;
  return !tir;
}

// bsdf::sampleF. non_specular_only: only lambert matches (the NEE draw)
PLU_FN BsdfSample bsdf_sample(const Frame& fr, int mtype, V3 albedo, V3 eta, V3 k, V3 wwo,
                              float u_select, float u0, float u1, bool non_specular_only) {
  V3 zero = V3{0.0f, 0.0f, 0.0f};
  V3 wo = w2l(fr, wwo);
  float cos_wo = wo.z;
  if (mtype == MAT_DIFFUSE) {
    V3 wi = cosine_hemisphere(u0, u1);
    wi.z = wi.z * (cos_wo < 0.0f ? -1.0f : 1.0f);
    V3 wwi = l2w(fr, wi);
    bool same_side = dot(wwi, fr.n) * dot(wwo, fr.n) > 0.0f;
    return BsdfSample{same_side ? albedo * INV_PI : zero, wwi, fabsf(wi.z) * INV_PI, false};
  }
  if (non_specular_only || (mtype != MAT_MIRROR && mtype != MAT_REFRACT && mtype != MAT_GLASS))
    return BsdfSample{zero, wwo, 0.0f, false};
  V3 wwi_r = l2w(fr, V3{-wo.x, -wo.y, wo.z});
  float abs_cos_r = pmax(fabsf(wo.z), 1e-20f);
  if (mtype == MAT_MIRROR) {
    // conductor Fresnel with the reference's Rperp2 == 1 (material.h:36-45)
    float ci = fabsf(cos_wo);
    float fc[3], e[3] = {eta.x, eta.y, eta.z}, kk[3] = {k.x, k.y, k.z};
    for (int j = 0; j < 3; ++j) {
      float tmp1 = (e[j] * e[j] + kk[j] * kk[j]) * ci * ci;
      float rparl2 = (tmp1 - 2.0f * e[j] * ci + 1.0f) / (tmp1 + 2.0f * e[j] * ci + 1.0f);
      fc[j] = (rparl2 + 1.0f) * 0.5f;
    }
    V3 f = V3{fc[0] * albedo.x, fc[1] * albedo.y, fc[2] * albedo.z} / abs_cos_r;
    return BsdfSample{f, wwi_r, 1.0f, true};
  }
  V3 f, wi;
  if (mtype == MAT_REFRACT) {
    bool ok = transmission(eta.x, eta.y, wo, albedo, &f, &wi);
    return BsdfSample{f, l2w(fr, wi), ok ? 1.0f : 0.0f, true};
  }
  // glass: uniform choice between reflection and transmission, pdf 1/2
  bool ok = transmission(1.0f, eta.x, wo, albedo, &f, &wi);
  if (u_select < 0.5f) {
    float fg = fresnel_dielectric(cos_wo, 1.0f, eta.x);
    return BsdfSample{(albedo * fg) / abs_cos_r, wwi_r, 0.5f, true};
  }
  return BsdfSample{f, l2w(fr, wi), ok ? 0.5f : 0.0f, true};
}

// ---------------------------------------------------------------------------
// lights (ops/lights.py)
// ---------------------------------------------------------------------------

// surface::pdf(p, wi) against the carrier row (origin-distance quirk)
PLU_FN float surface_pdf(const float* row, V3 p, V3 wi, bool origin_pdf) {
  float t = prim_row_t(row, p, wi);
  bool found = t < T_MAX;
  float ts = found ? t : 0.0f;
  V3 hitp = p + wi * ts;
  V3 n = detail_norm(row, hit_point(p, wi, ts, found));
  float dist2 = origin_pdf ? dot(hitp, hitp) : ts * ts;
  float denom = fabsf(dot(n, -wi)) * row[27];
  return found ? dist2 / pmax(denom, 1e-20f) : 0.0f;
}

struct LightSample {
  V3 Li, wi;
  float pdf;
  bool delta;
};

PLU_FN LightSample sample_light(const float* lrow, const float* carrier, V3 p, float u0,
                                float u1, float u_face, float u_axis, bool origin_pdf) {
  V3 intensity = ld3(lrow + 4);
  if ((int)lrow[0] == LIGHT_POINT) {
    V3 l2p = ld3(lrow + 1) - p;
    float len2 = pmax(dot(l2p, l2p), 1e-20f);
    return LightSample{intensity / len2, l2p / sqrtf(len2), 1.0f, true};
  }
  // carrier-surface sample (sphere / box / triangle)
  const int ty = (int)carrier[0];
  V3 a = ld3(carrier + 1), b = ld3(carrier + 4), c = ld3(carrier + 7);
  V3 ps, ns;
  if (ty == PRIM_SPHERE) {
    ns = uniform_sphere(u0, u1);
    ps = a + ns * b.x;
  } else if (ty == PRIM_BOX) {
    float U[3] = {u0, u_face, u1};
    int mi = min((int)(u_axis * 3.0f), 2);
    float picked = U[mi];
    float s = picked > 0.5f ? 1.0f : -1.0f;
    U[mi] = picked > 0.5f ? 1.0f : 0.0f;
    ps = a + V3{U[0], U[1], U[2]} * (b - a);
    ns = V3{mi == 0 ? s : 0.0f * s, mi == 1 ? s : 0.0f * s, mi == 2 ? s : 0.0f * s};
  } else {
    float wz = 1.0f - (u0 + u1);
    ps = (a * u0 + b * u1) + c * wz;
    ns = (ld3(carrier + 10) * u0 + ld3(carrier + 13) * u1) + ld3(carrier + 16) * wz;
  }
  V3 wi = normalize(ps - p);
  float pdf = surface_pdf(carrier, p, wi, origin_pdf);
  bool front = dot(ns, -wi) > 0.0f;
  return LightSample{front ? intensity : V3{0.0f, 0.0f, 0.0f}, wi, pdf, false};
}

// ---------------------------------------------------------------------------
// one shading vertex (render/integrator.py:plain_bounce), shared by K2, K3
// and K4
// ---------------------------------------------------------------------------

// the per-ray state between vertices (integrator.PathState); found is
// t < T_MAX
struct PathState {
  V3 o, d, T, L;
  bool prev_spec, alive;
  int prim;
  float t;
};

// the scene tables a vertex reads rows from: shared memory in K2, global
// memory in K3 and K4; the atlas is always in global memory
struct Tables {
  const float *prim, *mat, *tex, *light, *atlas;
  int P, M, T, L, A;
  bool has_images;
};

struct Flags {
  int max_bounces;
  bool swapped_mis, origin_pdf, shading_gate;
};

// the per-bounce telemetry channels of K5 (the JAX megakernel's debug
// output, integrator_kernel.py:1229-1240; ops/cuda/__init__.py DBG_CHANNELS)
constexpr int DBG_C = 12;

// Vertex i of one ray with its 12 uniforms u. `closest(o, d)` answers a
// closest-hit query as K1 does (K2: brute force over the shared packed
// table; K3/K4: the BVH walk of bvh_closest.cuh).
//
// DEBUG (K5): also write the vertex's DBG_C telemetry channels to
// dbg[c * stride], where dbg points at this ray's entry of vertex i's first
// channel row: the caller's (max_bounces, DBG_C, B) layout has one
// coalesced row of B floats per channel. The stores read values the vertex
// computes anyway (only the channel sum of Ld is extra), so the arithmetic
// of the state, and of L, is the same in both instantiations.
template <bool DEBUG = false, class Closest>
PLU_FN void path_vertex(const Tables& tb, const Closest& closest, const Flags& fl, int i,
                        const float* u, PathState& s, float* dbg = nullptr, int stride = 0) {
  const int nl = tb.L;
  const V3 zero = V3{0.0f, 0.0f, 0.0f};
  const bool found = s.t < T_MAX;
  const float* row = tb.prim + clampi(s.prim, tb.P) * PRIM_W;
  Detail h = hit_detail(row, s.o, s.d, s.t, found);
  const bool cur = s.alive && found;
  const V3 wwo = -s.d;
  const float* mrow = tb.mat + row_id(row[25], tb.M) * MAT_W;
  const int mtype = (int)mrow[0];
  const float* trow = tb.tex + row_id(pmax(mrow[4], 0.0f), tb.T) * TEX_W;
  V3 albedo = eval_albedo(mrow, trow, h.u, h.v, tb.atlas, tb.A, tb.has_images);
  Frame fr = make_frame(h.norm, h.dpdu);

  // emitted light at the vertex (first or post-specular only)
  const int own = (int)row[26];
  if (cur && (i == 0 || s.prev_spec) && own >= 0 && dot(h.norm, wwo) > 0.0f)
    s.L = s.L + s.T * ld3(tb.light + clampi(own, tb.L) * LIGHT_W + 4);

  // next-event estimation: one light picked uniformly
  const int li = min((int)floorf(u[0] * (float)nl), nl - 1);
  const float* lrow = tb.light + clampi(li, tb.L) * LIGHT_W;
  const float* carrier = tb.prim + row_id(pmax(lrow[7], 0.0f), tb.P) * PRIM_W;
  LightSample ls = sample_light(lrow, carrier, h.p, u[1], u[2], u[3], u[4], fl.origin_pdf);
  V3 eta = ld3(mrow + 5), kk = ld3(mrow + 8);
  BsdfSample bn = bsdf_sample(fr, mtype, albedo, eta, kk, wwo, u[5], u[6], u[7], true);
  BsdfSample bs = bsdf_sample(fr, mtype, albedo, eta, kk, wwo, u[9], u[10], u[11], false);

  // three closest-hit queries from the shading point
  Query sq = closest(h.p, ls.wi);
  Query nq = closest(h.p, bn.wwi);
  Query xq = closest(h.p, bs.wwi);
  const bool s_hits = (int)tb.prim[clampi(sq.prim, tb.P) * PRIM_W + 26] == li;
  const bool n_hits = (int)tb.prim[clampi(nq.prim, tb.P) * PRIM_W + 26] == li;

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
  float w = fl.swapped_mis ? (bp * bp) / (bp * bp + lp * lp) : (lp * lp) / (bp * bp + lp * lp);
  w = (b_pdf == 0.0f && ls.pdf == 0.0f) ? 0.0f : w;
  w = ls.delta ? 1.0f : w;
  const bool gate_l = ls.pdf > 0.0f && dot(ls.Li, ls.Li) > 0.0f && dot(f, f) > 0.0f && unoccl;
  const float scale_l = gate_l ? (fabsf(dot(ls.wi, h.norm)) * w) / lp : 0.0f;
  const V3 cl = gate_l ? (f * ls.Li) * scale_l : zero;

  // ---- NEE, BSDF-sampling strategy (non-delta lights only) ----
  const float l_pdf2 =
      (int)lrow[0] == LIGHT_AREA ? surface_pdf(carrier, h.p, bn.wwi, fl.origin_pdf) : 0.0f;
  const float bp2 = clip_pdf(bn.pdf), lp2 = clip_pdf(l_pdf2);
  float w2 = (bp2 * bp2) / (bp2 * bp2 + lp2 * lp2);
  w2 = (bn.pdf == 0.0f && l_pdf2 == 0.0f) ? 0.0f : w2;
  w2 = bn.spec ? 1.0f : w2;
  bool le_gate;
  if (fl.shading_gate) {
    // the reference gates emission on the SHADING normal (renderer.cpp:42)
    le_gate = dot(h.norm, -bn.wwi) > 0.0f;
  } else {
    const float* nrow = tb.prim + clampi(nq.prim, tb.P) * PRIM_W;
    le_gate = dot(detail_norm(nrow, hit_point(h.p, bn.wwi, nq.t, nq.found)), -bn.wwi) > 0.0f;
  }
  const V3 Li2 = (nq.found && n_hits && le_gate) ? ld3(lrow + 4) : zero;
  const bool gate_b = !ls.delta && dot(bn.f, bn.f) > 0.0f && bn.pdf > 0.0f &&
                      (bn.spec || l_pdf2 != 0.0f) && nq.found && dot(Li2, Li2) > 0.0f;
  const float scale_b = gate_b ? (fabsf(dot(bn.wwi, h.norm)) * w2) / bp2 : 0.0f;
  const V3 cb = gate_b ? (bn.f * Li2) * scale_b : zero;
  if (cur) {
    s.L = s.L + (s.T * cl) * (float)nl;
    s.L = s.L + (s.T * cb) * (float)nl;
  }

  // throughput update (clamped 1e12 per bounce, 1e16 overall) and
  // termination after the last shading vertex
  const bool ok = dot(bs.f, bs.f) > 0.0f && bs.pdf > 0.0f;
  const bool alive_next = cur && ok && i <= fl.max_bounces - 2;
  if (alive_next) {
    const float sc = fabsf(dot(bs.wwi, h.norm)) / clip_pdf(bs.pdf);
    s.T = vmin(s.T * vmin(bs.f * sc, 1.0e12f), 1.0e16f);
  }
  if constexpr (DEBUG) {
    const V3 ld = cl + cb;
    const float ch[DBG_C] = {found ? s.t : BIG,          (float)s.prim,
                             pmax(pmax(s.T.x, s.T.y), s.T.z), bs.pdf,
                             dot(bs.f, bs.f),            ls.pdf,
                             l_pdf2,                     ld.x + ld.y + ld.z,
                             cur ? 1.0f : 0.0f,          xq.t,
                             (float)xq.prim,             bs.spec ? 1.0f : 0.0f};
    for (int c = 0; c < DBG_C; ++c) dbg[(size_t)c * stride] = ch[c];
  }
  s.o = h.p;
  s.d = bs.wwi;
  s.prev_spec = bs.spec;
  s.alive = alive_next;
  s.prim = xq.prim;
  s.t = xq.t;
}

}  // namespace plu
