// Threefry-2x32 device code shared by the kernels that draw jax.random's
// numbers: threefry.cu (every draw of ops/prng.py), frame_setup.cu (a
// frame's key chain and seed) and camera_rays.cu (the camera jitter).
// kernels.py hashes every header a source includes into the library's
// name, so an edit here rebuilds all three.
//
// The plain version is ops/prng.py threefry2x32 / uniform_plain, bit-exact
// with jax.random under jax_threefry_partitionable=True: a draw of n words
// hashes the 64-bit iota (x0, x1) = (0, c), c in [0, n), and a 32-bit word
// is b1 ^ b2; split(key, n) takes key c = (b1, b2) of count c; fold_in(key,
// data) is the pair of count (0, data).

#pragma once

#include <stdint.h>

namespace mm {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// prng.py threefry2x32: rotations (13, 15, 26, 6) / (17, 29, 16, 24), key
// injections ks[(i + 1) % 3] and ks[(i + 2) % 3] + (i + 1) after round group i.
__device__ __forceinline__ void threefry(uint32_t k1, uint32_t k2, uint32_t& x0,
                                         uint32_t& x1) {
  const uint32_t ks0 = k1, ks1 = k2, ks2 = k1 ^ k2 ^ 0x1BD11BDAu;
  x0 += ks0;
  x1 += ks1;
#define MM_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r) ^ x0;
#define MM_EVEN MM_ROUND(13) MM_ROUND(15) MM_ROUND(26) MM_ROUND(6)
#define MM_ODD MM_ROUND(17) MM_ROUND(29) MM_ROUND(16) MM_ROUND(24)
  MM_EVEN x0 += ks1; x1 += ks2 + 1u;
  MM_ODD  x0 += ks2; x1 += ks0 + 2u;
  MM_EVEN x0 += ks0; x1 += ks1 + 3u;
  MM_ODD  x0 += ks1; x1 += ks2 + 4u;
  MM_EVEN x0 += ks2; x1 += ks0 + 5u;
#undef MM_EVEN
#undef MM_ODD
#undef MM_ROUND
}

// A key as two uint32 words (the port's int64 [2] layout holds one each).
struct Key {
  uint32_t k1, k2;
};

__device__ __forceinline__ Key load_key(const long long* key) {
  return Key{(uint32_t)key[0], (uint32_t)key[1]};
}

// The key of count c: split's key c, fold_in's key for data c.
__device__ __forceinline__ Key child(Key k, uint32_t c) {
  uint32_t x0 = 0, x1 = c;
  threefry(k.k1, k.k2, x0, x1);
  return Key{x0, x1};
}

// The 32-bit word c of a random_bits draw: b1 ^ b2.
__device__ __forceinline__ uint32_t word(Key k, uint32_t c) {
  uint32_t x0 = 0, x1 = c;
  threefry(k.k1, k.k2, x0, x1);
  return x0 ^ x1;
}

// prng.uniform's arithmetic on one 32-bit word.
__device__ __forceinline__ float to_uniform(uint32_t bits, float lo, float hi) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  const float v = __fadd_rn(__fmul_rn(f, __fsub_rn(hi, lo)), lo);
  return (v > lo || isnan(v)) ? v : lo;  // torch.maximum(lo, v): NaN propagates
}

}  // namespace mm
