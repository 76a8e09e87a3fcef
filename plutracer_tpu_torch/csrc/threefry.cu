// R1: threefry2x32 uniforms, a table of keys at a time.
//
// Replaces no Pallas kernel: the JAX package draws its path uniforms and
// its pixel and lens jitter with jax.random.uniform inside the jitted
// render_passes (plutracer_tpu/render/integrator.py:283-284,
// plutracer_tpu/render/renderer.py:39-40), where XLA fuses the threefry
// hash into device code. This kernel is that fused pass: row k of the
// output holds uniform(keys[k], (n,)) for every key of the table, so one
// launch writes all the path uniforms of a pass-loop launch
// ((max_bounces * strata) keys); R2 draws the pixel and lens jitter
// itself from the same hash (camera.cu).
//
// What it computes: row k holds the words c = 0..n-1 of
// plu_uniform_word (threefry.cuh, the hash R2 shares) under keys[k], so
// it is bit-equal to plutracer_tpu_torch.rng.uniform_plain and to
// jax.random.uniform.
//
// What bounds it: the operations. A word takes 75 32-bit integer
// operations (threefry.cuh) against 4 bytes stored; at an H100 SM's 128
// 32-bit lanes a clock that is about twice the time HBM takes to absorb
// the stores (a demo-box stratum's 25 M words: 0.056 ms against 0.030).
// The design: one thread a group of WORDS consecutive words of one key's
// row, the hashes of the group independent (instruction-level
// parallelism), rotations by __funnelshift_l, one 16-byte store where the
// row length keeps the group aligned, 64-bit output indexing; the grid's
// y axis walks the key table, so no thread divides to find its key.
#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int WORDS = 4;         // words a thread
constexpr int MAX_KEYS = 65535;  // the grid's y extent

// keys: (K, 2) uint32 words; out: (K, n) float32, row k from keys[k]
__global__ void __launch_bounds__(BLOCK) threefry_uniform(const uint32_t* __restrict__ keys,
                                                          long long n, float* __restrict__ out) {
  const long long row = blockIdx.y;
  const uint32_t k0 = keys[2 * row], k1 = keys[2 * row + 1];
  const uint32_t k2 = k0 ^ k1 ^ PLU_THREEFRY_PARITY;
  const long long c0 = ((long long)blockIdx.x * BLOCK + threadIdx.x) * WORDS;
  if (c0 >= n) return;
  float v[WORDS];
#pragma unroll
  for (int w = 0; w < WORDS; ++w) v[w] = plu_uniform_word(k0, k1, k2, (uint32_t)(c0 + w));
  float* dst = out + row * n + c0;
  if ((n % WORDS) == 0) {  // every row starts 16-byte aligned: one vector store
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int w = 0; w < WORDS; ++w)
      if (c0 + w < n) dst[w] = v[w];
  }
}

}  // namespace

// keys: K (k0, k1) pairs on the card; n words a key, 0 < n < 2^32;
// out: K * n floats (16-byte aligned). Returns a cudaError_t.
extern "C" int plu_threefry_uniform(const void* keys, int K, long long n, void* out,
                                    void* stream) {
  if (K <= 0 || n <= 0) return 0;
  if (K > MAX_KEYS || n >= (1LL << 32)) return (int)cudaErrorInvalidValue;
  const long long per_block = (long long)BLOCK * WORDS;
  const dim3 grid((unsigned)((n + per_block - 1) / per_block), (unsigned)K);
  threefry_uniform<<<grid, BLOCK, 0, (cudaStream_t)stream>>>((const uint32_t*)keys, n,
                                                             (float*)out);
  return (int)cudaGetLastError();
}
