// Goldilocks field arithmetic (p = 2^64 - 2^32 + 1) on native uint64_t.
//
// Replaces starky_bn254_tpu/pallas/u64ops.py, which carries every u64 as a
// (lo, hi) u32 pair because Mosaic has no 64-bit integers. Hopper has 64-bit
// adds, compares and shifts, and __umul64hi gives the high half of the
// 128-bit product, so each op here is the branchless sequence of the JAX
// package's goldilocks.py:80-143 written on one uint64_t: the same EPSILON
// reduction (2^64 = 2^32 - 1, 2^96 = -1 mod p), the same canonical output.
// Shared by ntt.cu and poseidon.cu.
#pragma once

#include <stdint.h>

#define GL_P 0xFFFFFFFF00000001ULL
#define GL_EPS 0xFFFFFFFFULL

__device__ __forceinline__ uint64_t gl_add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;  // a + b < 2p < 2^65: on wrap, true sum = s + EPS (mod p)
  if (s < a) s += GL_EPS;
  if (s >= GL_P) s -= GL_P;
  return s;
}

__device__ __forceinline__ uint64_t gl_sub(uint64_t a, uint64_t b) {
  uint64_t d = a - b;
  if (a < b) d -= GL_EPS;
  if (d >= GL_P) d -= GL_P;
  return d;
}

// hi * 2^64 + lo  (mod p)
__device__ __forceinline__ uint64_t gl_reduce128(uint64_t hi, uint64_t lo) {
  uint64_t hi_hi = hi >> 32;
  uint64_t hi_lo = hi & GL_EPS;
  uint64_t t0 = lo - hi_hi;
  if (lo < hi_hi) t0 -= GL_EPS;
  uint64_t t1 = hi_lo * GL_EPS;  // < 2^64 exactly
  uint64_t s = t0 + t1;
  if (s < t1) s += GL_EPS;
  if (s >= GL_P) s -= GL_P;
  return s;
}

__device__ __forceinline__ uint64_t gl_mul(uint64_t a, uint64_t b) {
  return gl_reduce128(__umul64hi(a, b), a * b);
}

// read-only cached load of one u64 word
__device__ __forceinline__ uint64_t gl_ldg(const uint64_t* p) {
  return (uint64_t)__ldg((const unsigned long long*)p);
}
