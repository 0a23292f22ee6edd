// Counter-based dropout bits shared by the attention forward and backward.
//
// The TPU kernels draw their dropout bits from a sequential per-grid-step
// PRNG stream (pltpu.prng_seed / prng_random_bits), which a backward that
// tiles differently from the forward cannot replay.  Here every entry's bits
// are a pure function of (seed, b * nh + h, query row i, key column j):
//
//     row  = fmix32(fmix32(seed ^ (bh + 1) * 0x9E3779B9) ^ (i + 1) * 0x85EBCA6B)
//     bits = fmix32(row ^ (j + 1) * 0xC2B2AE35)
//
// (uint32 arithmetic, fmix32 = MurmurHash3's finaliser), and an entry is
// kept when bits >= thr, thr = round(rate * 2^32), as the TPU kernel keeps
// it.  ops/attention.py::dropout_keep_mask computes the same bits in int64
// tensor arithmetic, so kernel and plain version agree exactly.
#pragma once

#include <stdint.h>

static __host__ __device__ __forceinline__ uint32_t dst_fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// key of one (sequence, head, query row): hashed once per row
static __host__ __device__ __forceinline__ uint32_t dst_row_key(uint32_t seed, uint32_t bh,
                                                                uint32_t i) {
  const uint32_t k = dst_fmix32(seed ^ ((bh + 1u) * 0x9E3779B9u));
  return dst_fmix32(k ^ ((i + 1u) * 0x85EBCA6Bu));
}

static __host__ __device__ __forceinline__ uint32_t dst_bits(uint32_t row_key, uint32_t j) {
  return dst_fmix32(row_key ^ ((j + 1u) * 0xC2B2AE35u));
}
