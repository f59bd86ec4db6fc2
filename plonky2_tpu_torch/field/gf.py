"""Goldilocks arithmetic on int64 tensors that carry u64 bit patterns.

The port's counterpart of plonky2_tpu/field/gf_jax.py, written against the
one storage format of the port (one int64 per element instead of a uint32
pair).  PyTorch has no unsigned 64-bit arithmetic on the CPU, so:

* add, subtract and multiply wrap modulo 2^64 on int64, which is the u64
  result bit for bit (products of 32-bit halves included);
* ``>>`` sign-extends, so every logical right shift goes through ``srl``;
* unsigned order goes through ``ult``, which flips the sign bit first.

Each function computes exactly the representative its gf_jax namesake does,
the non-canonical ``*_nc`` ones included, so the tests can compare bits.
These are the plain versions; the CUDA kernels use csrc/goldilocks.cuh.
"""
from __future__ import annotations

import torch

from .goldilocks import P

EPS = 0xFFFFFFFF
M32 = 0xFFFFFFFF
_SIGN = -(1 << 63)
P_I64 = P - (1 << 64)           # p as a signed int64 literal


def as_i64(x: int) -> int:
    """A u64 python int as the int64 with the same bits."""
    x %= 1 << 64
    return x - (1 << 64) if x >= 1 << 63 else x


def ult(a, b):
    """Unsigned a < b on int64 bit patterns."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def srl(a, k: int):
    """Logical right shift by 0 < k < 64."""
    return (a >> k) & ((1 << (64 - k)) - 1)


def canon(x):
    """One conditional subtract of p: [0, 2^64) -> [0, p)."""
    return torch.where(ult(x, P_I64), x, x + EPS)


def add_nc(a, b):
    """a + b, on 2^64 overflow plus EPSILON; < 2^64 but maybe >= p."""
    s = a + b
    return torch.where(ult(s, a), s + EPS, s)


def add(a, b):
    return canon(add_nc(a, b))


def sub(a, b):
    d = a - b
    return torch.where(ult(a, b), d - EPS, d)


def mul_wide(a, b):
    """64x64 -> 128-bit product as (lo64, hi64) int64 bit patterns."""
    a_lo, a_hi = a & M32, srl(a, 32)
    b_lo, b_hi = b & M32, srl(b, 32)
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    mid = lh + a_hi * b_lo
    mid_carry = ult(mid, lh).to(torch.int64)
    lo = ll + (mid << 32)
    carry2 = ult(lo, ll).to(torch.int64)
    hi = a_hi * b_hi + srl(mid, 32) + (mid_carry << 32) + carry2
    return lo, hi


def reduce128_nc(lo, hi):
    """(lo + hi * 2^64) mod p as lo - hi_hi + hi_lo * EPSILON, without the
    final subtract of p (result < 2^64)."""
    hi_hi, hi_lo = srl(hi, 32), hi & M32
    t0 = lo - hi_hi
    t0 = torch.where(ult(lo, hi_hi), t0 - EPS, t0)
    t1 = hi_lo * EPS
    t2 = t0 + t1
    return torch.where(ult(t2, t1), t2 + EPS, t2)


def reduce128(lo, hi):
    return canon(reduce128_nc(lo, hi))


def mul(a, b):
    return reduce128(*mul_wide(a, b))


def mul_nc(a, b):
    return reduce128_nc(*mul_wide(a, b))


def exp_u64(a, e: int):
    """a ** e (e a python int) by square-and-multiply."""
    result = torch.ones_like(a)
    base = a
    while e > 0:
        if e & 1:
            result = mul(result, base)
        e >>= 1
        if e:
            base = mul(base, base)
    return result


def inverse(a):
    """a^(p-2); inverse(0) == 0."""
    return exp_u64(a, P - 2)
