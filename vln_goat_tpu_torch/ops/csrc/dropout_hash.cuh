// Counter-based keep mask of the fused attention's in-kernel dropout.
//
// bits = murmur3_32 of the four counter words (b, h, q, k) under the key
// seed[b]; an attention probability is kept iff bits >= thresh, where
// thresh = min(floor(rate * 2^32), 2^32 - 1) (the JAX package's rule,
// vln_goat_tpu/ops/attention.py `_keep_mask`), and a kept one is scaled
// by 1 / (1 - rate).  The mask depends on (seed, b, h, q, k) only, never
// on a thread or tile index, so the forward and backward kernels draw the
// same mask whatever their tiling.  `keep_bits` in ops/dropout.py computes
// the same bits in torch int64 arithmetic for the plain version.
#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t murmur_rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t murmur_word(uint32_t h, uint32_t w) {
  w *= 0xcc9e2d51u;
  w = murmur_rotl(w, 15);
  w *= 0x1b873593u;
  h ^= w;
  h = murmur_rotl(h, 13);
  return h * 5u + 0xe6546b64u;
}

// The hash state after the first three counter words: one (b, h, q) row's
// prefix, shared by its keys.
__device__ __forceinline__ uint32_t dropout_row(uint32_t seed, uint32_t b,
                                                uint32_t h, uint32_t q) {
  return murmur_word(murmur_word(murmur_word(seed, b), h), q);
}

// The bits of key k of a row, from the row's prefix.
__device__ __forceinline__ uint32_t dropout_bits_at(uint32_t row,
                                                    uint32_t k) {
  uint32_t x = murmur_word(row, k);
  x ^= 16u;                      // length of the key in bytes
  x ^= x >> 16;
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t dropout_bits(uint32_t seed, uint32_t b,
                                                 uint32_t h, uint32_t q,
                                                 uint32_t k) {
  return dropout_bits_at(dropout_row(seed, b, h, q), k);
}
