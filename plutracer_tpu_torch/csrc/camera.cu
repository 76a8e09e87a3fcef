// R2: the pass loop's camera stage, every stratum of a launch at once:
// the pixel and lens jitter drawn in registers, then the primary rays.
//
// Replaces no Pallas kernel: the JAX package computes its primary rays
// inside the jitted render_passes (plutracer_tpu/render/renderer.py:36-43,
// plutracer_tpu/ops/camera.py:18-45, ops/sampling.py concentric_disk_sample),
// where XLA fuses the jitter draw (jax.random.uniform of k_px and k_lens),
// the jittered sample positions, the camera basis, the normalisations and
// the thin lens into device code. This kernel is that fusion whole for a
// launch of S strata of B pixels: from each stratum's cell and its k_px
// and k_lens keys, read from a small table on the card (a launch's words,
// render/renderer.launch_words, written there before it runs, as a
// captured CUDA graph's are before each replay), it writes o and d of all
// S * B rays, stratum j at rows j*B..(j+1)*B.
//
// What it computes for pixel p of stratum j, cell c = table[j][0], as
// plutracer_tpu_torch.render.renderer.camera_rays_table_plain does on the
// card (the same words and the same IEEE float32 operations in the same
// order; built without FMA contraction and without fast math, so each
// rounds as torch's elementwise kernel does):
//   jit_px = (words 2p and 2p+1 of k_px's stream), jit_lens likewise of
//   k_lens: plu_uniform_word (threefry.cuh), so uniform(k, (B, 2))[p];
//   px = px0[p] + (cell + jit_px * 0.999) / n, lens = (cell + jit_lens * 0.999) / n
//   (cell = (c % n, c / n); an IEEE division by float(n));
//   uv = (px * inv_image_size) * 2 - 1, its y negated;
//   d = ((w * look) + uv.x * right) + uv.y * up, divided by its norm;
//   o = pos; with lens_radius > 0 (tested here, as torch.where selects):
//   l = concentric_disk_sample(lens) * lens_radius, pof = o + d * (focal / d.z),
//   o = o + (l.x, l.y, 0), d = pof - o divided by its norm.
// A pinhole camera (lens_radius <= 0) never reads the lens jitter, so its
// two words are not drawn. The norm is torch.linalg.norm's on the card:
// its reduction kernel splits a row of three over two lanes (x and z on
// one, y on the other) and adds the lanes, so sqrt((x*x + z*z) + y*y).
// cos and sin are the CUDA math library's (cosf/sinf), as torch's; never
// the fast intrinsics.
//
// What bounds it: the bytes, barely. A ray writes 24 bytes (o and d) and
// reads its pixel's 8 (from HBM once a launch: later strata find them in
// L2); its jitter costs 2 hashes (pinhole) or 4 (lens) of 75 integer
// operations, and the ray about 45 float operations (90 with the lens).
// The design: one thread a ray, its hashes independent (instruction-level
// parallelism, as R1's 4 words a thread); no jitter in device memory; a
// stratum's cell and key words are one row of 20 bytes that every thread
// of the stratum reads (one cached line); the camera from a small table
// on the card (ops/cuda/camera_kernel.camera_table); the grid's y axis
// walks the strata, so no thread divides to find its stratum; three
// scalar stores a ray and array (a warp's cover 384 contiguous bytes,
// which L2 merges): staging a block's rays in shared memory for 16-byte
// vector stores took 1.2-1.4x as long on an H100 (more registers, a
// barrier; PERF.md).
#include <cuda_runtime.h>

#include "threefry.cuh"

constexpr int PLU_MAX_STRATA = 16;  // renderer.MAX_STRATA: the most strata a launch
// int32 words a stratum of the table: its cell, then its jitter keys'
// four words (ops/cuda/camera_kernel.STRATUM_WORDS)
constexpr int STRATUM_WORDS = 5;

namespace {

constexpr int BLOCK = 256;

// the camera table's layout (ops/cuda/camera_kernel.camera_table)
constexpr int POS = 0, LOOK = 3, RIGHT = 6, UP = 9, INV = 12, W = 14, LENS = 15, FOCAL = 16;

// torch's float32 views of the Python constants 0.999 and math.pi * 0.25
constexpr float JITTER_SCALE = (float)0.999;
constexpr float QUARTER_PI = (float)0.7853981633974483;

__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf((x * x + z * z) + y * y);
}

// ops/sampling.concentric_disk_sample of one (u.x, u.y) in [0, 1)^2
__device__ __forceinline__ float2 concentric_disk(float ux, float uy) {
  const float x = 2.0f * ux - 1.0f, y = 2.0f * uy - 1.0f;
  if (x == 0.0f && y == 0.0f) return make_float2(0.0f, 0.0f);
  const float sx = x == 0.0f ? 1.0f : x, sy = y == 0.0f ? 1.0f : y;
  float r, phi;
  if (x >= -y) {
    if (x > y) {
      r = x;
      phi = y > 0.0f ? y / sx : 8.0f + y / sx;
    } else {
      r = y;
      phi = 2.0f - x / sy;
    }
  } else if (x <= y) {
    r = -x;
    phi = 4.0f - y / sx;
  } else {
    r = -y;
    phi = 6.0f - x / sy;
  }
  phi = phi * QUARTER_PI;
  return make_float2(cosf(phi) * r, sinf(phi) * r);
}

// words 2p and 2p+1 of the stream of key (k0, k1): uniform(key, (B, 2))[p]
__device__ __forceinline__ float2 jitter(uint32_t k0, uint32_t k1, uint32_t p) {
  const uint32_t k2 = k0 ^ k1 ^ PLU_THREEFRY_PARITY;
  return make_float2(plu_uniform_word(k0, k1, k2, 2u * p),
                     plu_uniform_word(k0, k1, k2, 2u * p + 1u));
}

// The camera ray (o, d) of the sample at pixel q of cell (cx, cy) of an n
// grid (nf = float(n)), jittered by jp (pixel) and jl (lens).
__device__ __forceinline__ void camera_ray(const float* __restrict__ cam, float2 q, float cx,
                                           float cy, float nf, float2 jp, float2 jl, float* ro,
                                           float* rd) {
  // the jittered sample positions (renderer.camera_rays_table_plain)
  const float sx = q.x + (cx + jp.x * JITTER_SCALE) / nf;
  const float sy = q.y + (cy + jp.y * JITTER_SCALE) / nf;
  const float lx = (cx + jl.x * JITTER_SCALE) / nf;
  const float ly = (cy + jl.y * JITTER_SCALE) / nf;

  // ops/camera.generate_rays
  const float ux = (sx * cam[INV]) * 2.0f - 1.0f;
  const float uy = ((sy * cam[INV + 1]) * 2.0f - 1.0f) * -1.0f;
  const float w = cam[W];
  float dx = (w * cam[LOOK] + ux * cam[RIGHT]) + uy * cam[UP];
  float dy = (w * cam[LOOK + 1] + ux * cam[RIGHT + 1]) + uy * cam[UP + 1];
  float dz = (w * cam[LOOK + 2] + ux * cam[RIGHT + 2]) + uy * cam[UP + 2];
  float len = norm3(dx, dy, dz);
  dx = dx / len;
  dy = dy / len;
  dz = dz / len;
  float ox = cam[POS], oy = cam[POS + 1], oz = cam[POS + 2];

  const float lens_radius = cam[LENS];
  if (lens_radius > 0.0f) {
    const float2 disk = concentric_disk(lx, ly);
    const float t = cam[FOCAL] / dz;
    const float fx = ox + dx * t, fy = oy + dy * t, fz = oz + dz * t;
    ox = ox + disk.x * lens_radius;
    oy = oy + disk.y * lens_radius;
    oz = oz + 0.0f;
    dx = fx - ox;
    dy = fy - oy;
    dz = fz - oz;
    len = norm3(dx, dy, dz);
    dx = dx / len;
    dy = dy / len;
    dz = dz / len;
  }
  ro[0] = ox;
  ro[1] = oy;
  ro[2] = oz;
  rd[0] = dx;
  rd[1] = dy;
  rd[2] = dz;
}

// cam: the camera table; px0: (B, 2); table: (S, STRATUM_WORDS) int32,
// each stratum's cell, then k_px's and k_lens's words; o, d: (S * B, 3)
__global__ void __launch_bounds__(BLOCK) camera_rays_table(const float* __restrict__ cam,
                                                           const float2* __restrict__ px0,
                                                           const int* __restrict__ table,
                                                           int B, int n,
                                                           float* __restrict__ o,
                                                           float* __restrict__ d) {
  const int p = blockIdx.x * BLOCK + threadIdx.x;
  if (p >= B) return;
  const int j = blockIdx.y;
  const int* row = table + j * STRATUM_WORDS;
  const int c = row[0];
  // the hashes first, independent of each other; a pinhole camera never
  // reads the lens jitter
  float2 jp, jl = make_float2(0.0f, 0.0f);
  if (cam[LENS] > 0.0f) {
    jp = jitter((uint32_t)row[1], (uint32_t)row[2], (uint32_t)p);
    jl = jitter((uint32_t)row[3], (uint32_t)row[4], (uint32_t)p);
  } else {
    jp = jitter((uint32_t)row[1], (uint32_t)row[2], (uint32_t)p);
  }
  float ro[3], rd[3];
  camera_ray(cam, px0[p], (float)(c % n), (float)(c / n), (float)n, jp, jl, ro, rd);
  const long long ray = (long long)j * B + p;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[ray * 3 + k] = ro[k];
    d[ray * 3 + k] = rd[k];
  }
}

}  // namespace

// cam: the camera table on the card; px0: B pixel positions (x, y);
// table: the strata's cells and jitter keys, (S, STRATUM_WORDS) int32 on
// the card, 1 <= S <= PLU_MAX_STRATA; o, d: S * B rays each. cam and px0
// 8-byte aligned, table, o and d 4-byte. Returns a cudaError_t.
extern "C" int plu_camera_rays_table(const void* cam, const void* px0, const void* table, int S,
                                     int B, int n, void* o, void* d, void* stream) {
  if (B <= 0) return 0;
  if (S < 1 || S > PLU_MAX_STRATA || n < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((B + BLOCK - 1) / BLOCK), (unsigned)S);
  camera_rays_table<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      (const float*)cam, (const float2*)px0, (const int*)table, B, n, (float*)o, (float*)d);
  return (int)cudaGetLastError();
}
