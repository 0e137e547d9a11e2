// Threefry-2x32 (20 rounds) on uint32_t, in registers: the one device-side
// copy of the port's counter-based generator (repro_torch/rng.py), shared by
// every kernel that draws its own random numbers.
//
// Bit-for-bit what rng.py computes with int64 tensor ops (and what
// jax.random computes for typed keys under the partitionable threefry):
//
//   threefry(k, (x0, x1))  rotations (13, 15, 26, 6) / (17, 29, 16, 24),
//                          key schedule (k0, k1, k0 ^ k1 ^ 0x1BD11BDA),
//                          a key injection after every 4 rounds
//   fold_in(k, d)          threefry(k, (0, d)): a new key
//   uniform(k, j)          element j of uniform(k, n): the bits
//                          o0 ^ o1 of threefry(k, (0, j)), as the float
//                          bitcast((bits >> 9) | 0x3F800000) - 1 in [0, 1)
//
// Keys enter the kernels as the port's (..., 2) int64 tensors, whose two
// elements hold the uint32 words: read_key takes the low 32 bits of each.

#pragma once

#include <cstdint>

namespace threefry {

struct Key {
  uint32_t k0, k1;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry2x32 of the counter (x0, x1) under key k; the output in place
__device__ __forceinline__ void block(Key k, uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k.k0, k.k1, k.k0 ^ k.k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = rotl(x1, rot[g % 2][i]) ^ x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + static_cast<uint32_t>(g + 1);
  }
}

__device__ __forceinline__ Key read_key(const long long* keys, long long row) {
  return Key{static_cast<uint32_t>(keys[2 * row]),
             static_cast<uint32_t>(keys[2 * row + 1])};
}

__device__ __forceinline__ Key fold_in(Key k, uint32_t d) {
  uint32_t x0 = 0, x1 = d;
  block(k, x0, x1);
  return Key{x0, x1};
}

__device__ __forceinline__ float uniform(Key k, uint32_t j) {
  uint32_t x0 = 0, x1 = j;
  block(k, x0, x1);
  const uint32_t bits = x0 ^ x1;
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

}  // namespace threefry
