// Threefry-2x32 (20 rounds) as device code, shared by the fused draw.
//
// Replaces the in-kernel PRNG of the TPU draw, src/repro/kernels/threefry.py
// (threefry2x32, fold, bits_to_uniform, uniforms). It has no launch of its
// own on the main path: fused_draw.cu calls it per lane. Bound on the card:
// integer operations only (about 100 per lane), far below either roof; the
// design keeps one cipher call per lane and no table.
#pragma once
#include <cstdint>

__device__ __forceinline__ uint32_t rt_rotl32(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

// Encrypt (x0, x1) in place under the key (k0, k1).
__device__ __forceinline__ void rt_threefry2x32(uint32_t k0, uint32_t k1,
                                                uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = rt_rotl32(x1, rot[g & 1][i]) ^ x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + (uint32_t)(g + 1);
  }
}

// Subkey of stream `data`: the stream id encrypted under the parent key.
__device__ __forceinline__ void rt_fold(uint32_t k0, uint32_t k1,
                                        uint32_t data, uint32_t& s0,
                                        uint32_t& s1) {
  s0 = data;
  s1 = 0u;
  rt_threefry2x32(k0, k1, s0, s1);
}

// Top 23 bits as the mantissa of a float in [1, 2), minus 1: exact.
__device__ __forceinline__ float rt_bits_to_uniform(uint32_t bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}

// The uniform of counter lane `ctr` under subkey (s0, s1).
__device__ __forceinline__ float rt_uniform_at(uint32_t s0, uint32_t s1,
                                               uint32_t ctr) {
  uint32_t x0 = ctr, x1 = 0u;
  rt_threefry2x32(s0, s1, x0, x1);
  return rt_bits_to_uniform(x0);
}
