// Goldilocks field arithmetic (p = 2^64 - 2^32 + 1) for the port's kernels.
//
// Elements are uint64_t, canonical in [0, p) at every kernel boundary.  The
// 128-bit product is four 32x32->64 products (inline PTX mul.wide.u32 /
// mad.wide.u32, one IMAD.WIDE.U32 each on sm_90a) where a * b plus
// __umul64hi lower to more; reduce128 folds it with 2^64 == EPSILON and
// 2^96 == -1 (mod p).  Two forms of each: mul_wide/reduce128 for code
// bound by latency, mul_wide_split/reduce128_cc for code bound by issue
// throughput (PERF.md).  The *_nc forms return any 64-bit
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

// reduce128 with the borrow and the carry taken from add.cc/sub.cc chains
// (on a borrow add p, i.e. subtract EPSILON; on a carry add EPSILON;
// neither can borrow or carry again).  Fewer integer-ALU instructions,
// a longer dependent chain.
__device__ __forceinline__ uint64_t reduce128_cc(uint64_t lo, uint64_t hi) {
  uint64_t r;
  asm("{\n\t.reg .u32 l0, l1, h0, h1, t0, t1, br, u0, u1, c;\n\t"
      "mov.b64 {l0, l1}, %1;\n\t"
      "mov.b64 {h0, h1}, %2;\n\t"
      "sub.cc.u32 t0, l0, h1;\n\t"
      "subc.cc.u32 t1, l1, 0;\n\t"
      "subc.u32 br, 0, 0;\n\t"
      "sub.cc.u32 t0, t0, br;\n\t"
      "subc.u32 t1, t1, 0;\n\t"
      "sub.cc.u32 u0, 0, h0;\n\t"
      "subc.u32 u1, h0, 0;\n\t"
      "add.cc.u32 t0, t0, u0;\n\t"
      "addc.cc.u32 t1, t1, u1;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "neg.s32 c, c;\n\t"
      "add.cc.u32 t0, t0, c;\n\t"
      "addc.u32 t1, t1, 0;\n\t"
      "mov.b64 %0, {t0, t1};\n\t}"
      : "=l"(r)
      : "l"(lo), "l"(hi));
  return r;
}

// a * b = lo + hi * 2^64 by schoolbook on 32-bit halves, four
// mul.wide.u32 / mad.wide.u32 products.  Three of them take their carries
// in a 64-bit addend: each partial sum fits 64 bits, (2^32 - 1)^2 +
// 2^32 - 1 < 2^64.  The short dependent chain suits latency-bound code
// (K6); an IMAD.WIDE.U32 with a 64-bit addend issues at about half the
// rate of one without (chip_smoke.py phase 8).
__device__ __forceinline__ void mul_wide(uint64_t a, uint64_t b, uint64_t& lo, uint64_t& hi) {
  uint32_t a0, a1, b0, b1;
  asm("mov.b64 {%0, %1}, %2;" : "=r"(a0), "=r"(a1) : "l"(a));
  asm("mov.b64 {%0, %1}, %2;" : "=r"(b0), "=r"(b1) : "l"(b));
  uint64_t t, u, v, w;
  asm("mul.wide.u32 %0, %1, %2;" : "=l"(t) : "r"(a0), "r"(b0));
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(u) : "r"(a0), "r"(b1), "l"(t >> 32));
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(v) : "r"(a1), "r"(b0), "l"(u & EPS));
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(w) : "r"(a1), "r"(b1), "l"(u >> 32));
  lo = (t & EPS) | (v << 32);
  hi = w + (v >> 32);
}

// The same product as four mul.wide.u32 without addends, the carries in
// one add.cc chain on the integer ALU: fewer multiply-pipe cycles, for
// throughput-bound code (K1, K2).
__device__ __forceinline__ void mul_wide_split(uint64_t a, uint64_t b, uint64_t& lo,
                                               uint64_t& hi) {
  uint32_t a0, a1, b0, b1;
  asm("mov.b64 {%0, %1}, %2;" : "=r"(a0), "=r"(a1) : "l"(a));
  asm("mov.b64 {%0, %1}, %2;" : "=r"(b0), "=r"(b1) : "l"(b));
  uint64_t t, u, v, w;
  asm("mul.wide.u32 %0, %1, %2;" : "=l"(t) : "r"(a0), "r"(b0));
  asm("mul.wide.u32 %0, %1, %2;" : "=l"(u) : "r"(a0), "r"(b1));
  asm("mul.wide.u32 %0, %1, %2;" : "=l"(v) : "r"(a1), "r"(b0));
  asm("mul.wide.u32 %0, %1, %2;" : "=l"(w) : "r"(a1), "r"(b1));
  // mid = u + v (65 bits); lo = t + mid * 2^32; hi = w + mid / 2^32 + carry
  asm("{\n\t.reg .u32 t0, t1, u0, u1, v0, v1, w0, w1, m0, m1, m2, l1, h0, h1;\n\t"
      "mov.b64 {t0, t1}, %2;\n\t"
      "mov.b64 {u0, u1}, %3;\n\t"
      "mov.b64 {v0, v1}, %4;\n\t"
      "mov.b64 {w0, w1}, %5;\n\t"
      "add.cc.u32 m0, u0, v0;\n\t"
      "addc.cc.u32 m1, u1, v1;\n\t"
      "addc.u32 m2, 0, 0;\n\t"
      "add.cc.u32 l1, t1, m0;\n\t"
      "addc.cc.u32 h0, w0, m1;\n\t"
      "addc.u32 h1, w1, m2;\n\t"
      "mov.b64 %0, {t0, l1};\n\t"
      "mov.b64 %1, {h0, h1};\n\t}"
      : "=l"(lo), "=l"(hi)
      : "l"(t), "l"(u), "l"(v), "l"(w));
}

// a * a in mul_wide_split's form: the cross product is taken once and
// doubled by the add.cc chain (three products instead of four).
__device__ __forceinline__ void square_wide_split(uint64_t a, uint64_t& lo, uint64_t& hi) {
  uint32_t a0, a1;
  asm("mov.b64 {%0, %1}, %2;" : "=r"(a0), "=r"(a1) : "l"(a));
  uint64_t t, u, w;
  asm("mul.wide.u32 %0, %1, %2;" : "=l"(t) : "r"(a0), "r"(a0));
  asm("mul.wide.u32 %0, %1, %2;" : "=l"(u) : "r"(a0), "r"(a1));
  asm("mul.wide.u32 %0, %1, %2;" : "=l"(w) : "r"(a1), "r"(a1));
  asm("{\n\t.reg .u32 t0, t1, u0, u1, w0, w1, m0, m1, m2, l1, h0, h1;\n\t"
      "mov.b64 {t0, t1}, %2;\n\t"
      "mov.b64 {u0, u1}, %3;\n\t"
      "mov.b64 {w0, w1}, %4;\n\t"
      "add.cc.u32 m0, u0, u0;\n\t"
      "addc.cc.u32 m1, u1, u1;\n\t"
      "addc.u32 m2, 0, 0;\n\t"
      "add.cc.u32 l1, t1, m0;\n\t"
      "addc.cc.u32 h0, w0, m1;\n\t"
      "addc.u32 h1, w1, m2;\n\t"
      "mov.b64 %0, {t0, l1};\n\t"
      "mov.b64 %1, {h0, h1};\n\t}"
      : "=l"(lo), "=l"(hi)
      : "l"(t), "l"(u), "l"(w));
}

__device__ __forceinline__ uint64_t mul_nc(uint64_t a, uint64_t b) {
  uint64_t lo, hi;
  mul_wide(a, b, lo, hi);
  return reduce128(lo, hi);
}

// mul_nc in the throughput forms.
__device__ __forceinline__ uint64_t mul_nc_split(uint64_t a, uint64_t b) {
  uint64_t lo, hi;
  mul_wide_split(a, b, lo, hi);
  return reduce128_cc(lo, hi);
}

__device__ __forceinline__ uint64_t square_nc_split(uint64_t a) {
  uint64_t lo, hi;
  square_wide_split(a, lo, hi);
  return reduce128_cc(lo, hi);
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) { return canon(mul_nc(a, b)); }

}  // namespace gl
