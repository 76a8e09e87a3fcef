// The threefry2x32 uniform word that R1 (threefry.cu) writes and R2
// (camera.cu) draws in registers: one copy of the 20 rounds.
//
// For key (k0, k1) and counter c < 2^32 (the partitionable layout of
// jax.random, jax_threefry_partitionable=True): (a, b) =
// threefry2x32(k0, k1, (0, c)), 20 rounds; bits = a ^ b;
// u = bitcast<float>((bits >> 9) | 0x3F800000) - 1.0f, which is exact.
// So u is bit-equal to plutracer_tpu_torch.rng.uniform_plain and to
// jax.random.uniform.
//
// A word takes 75 32-bit integer operations: 20 rounds of add, funnel
// shift and xor; 5 key injections of two adds, each step's key word plus
// its count hoisted out of the word; the counter's add; the final xor,
// shift, or and subtract. The caller passes k2 = k0 ^ k1 ^
// PLU_THREEFRY_PARITY, computed once a key.
#pragma once

#include <cstdint>

constexpr uint32_t PLU_THREEFRY_PARITY = 0x1BD11BDAu;  // Threefry's key-schedule constant

namespace {

__device__ __forceinline__ uint32_t plu_rotl(uint32_t v, int r) {
  return __funnelshift_l(v, v, r);
}

// four rounds with the given rotations, then the key injection of step s
#define PLU_ROUNDS(r0, r1, r2, r3, ka, kb, s) \
  a += b; b = plu_rotl(b, r0) ^ a;           \
  a += b; b = plu_rotl(b, r1) ^ a;           \
  a += b; b = plu_rotl(b, r2) ^ a;           \
  a += b; b = plu_rotl(b, r3) ^ a;           \
  a += ka; b += kb + (s);

__device__ __forceinline__ float plu_uniform_word(uint32_t k0, uint32_t k1, uint32_t k2,
                                                  uint32_t c) {
  uint32_t a = k0;  // the counter's high word is 0
  uint32_t b = c + k1;
  PLU_ROUNDS(13, 15, 26, 6, k1, k2, 1u)
  PLU_ROUNDS(17, 29, 16, 24, k2, k0, 2u)
  PLU_ROUNDS(13, 15, 26, 6, k0, k1, 3u)
  PLU_ROUNDS(17, 29, 16, 24, k1, k2, 4u)
  PLU_ROUNDS(13, 15, 26, 6, k2, k0, 5u)
  const uint32_t bits = a ^ b;
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}

#undef PLU_ROUNDS

}  // namespace
