// Goldilocks field arithmetic (p = 2^64 - 2^32 + 1) for the port's kernels.
//
// Elements are uint64_t, canonical in [0, p) at every kernel boundary.  The
// 128-bit product comes from a * b and __umul64hi; reduce128 folds it with
// 2^64 == EPSILON and 2^96 == -1 (mod p).  The *_nc forms return any 64-bit
// representative and are only used inside the Poseidon permutation, whose
// digest is canonicalised once at the end.
#pragma once
#include <cstdint>

namespace gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 mod p

__device__ __forceinline__ uint64_t canon(uint64_t x) { return x >= P ? x - P : x; }

// a < 2^64, b < p: a + b reduced below 2^64 (no second overflow since b < p).
__device__ __forceinline__ uint64_t add_nc(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  return s < a ? s + EPS : s;
}

__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) { return canon(add_nc(a, b)); }

// Canonical a, b -> canonical a - b.
__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
  uint64_t d = a - b;
  return a < b ? d - EPS : d;
}

// Any 128-bit lo + hi * 2^64 -> a representative below 2^64.
__device__ __forceinline__ uint64_t reduce128(uint64_t lo, uint64_t hi) {
  uint64_t hi_hi = hi >> 32;
  uint64_t hi_lo = hi & EPS;
  uint64_t t0 = lo - hi_hi;
  if (lo < hi_hi) t0 -= EPS;
  uint64_t t1 = hi_lo * EPS;
  uint64_t t2 = t0 + t1;
  if (t2 < t1) t2 += EPS;
  return t2;
}

__device__ __forceinline__ uint64_t mul_nc(uint64_t a, uint64_t b) {
  return reduce128(a * b, __umul64hi(a, b));
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) { return canon(mul_nc(a, b)); }

}  // namespace gl
