"""Goldilocks field constants and host (numpy uint64) helpers.

The port's own copy of what it needs from plonky2_tpu/field/goldilocks.py:
p = 2^64 - 2^32 + 1, EPSILON = 2^32 - 1 = 2^64 mod p, two-adicity 32, the
canonical two-adic generator, and the host-side ``add``/``sub``/``neg``/
``mul``/``exp_u64``/``inverse``/``powers``/``two_adic_subgroup`` used to
build twiddle, shift and domain tables and by the host layer (gates,
witness generators).  Arrays hold canonical values in [0, p).
"""
from __future__ import annotations

import numpy as np

P = 0xFFFFFFFF_00000001
EPSILON = 0xFFFFFFFF
TWO_ADICITY = 32
MULTIPLICATIVE_GROUP_GENERATOR = 7
POWER_OF_TWO_GENERATOR = pow(7, (P - 1) >> TWO_ADICITY, P)

_U64 = np.uint64
_M32 = _U64(0xFFFFFFFF)
_P = _U64(P)
_EPS = _U64(EPSILON)


def add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a + b, on overflow plus EPSILON, then one subtract of p."""
    a, b = np.asarray(a, _U64), np.asarray(b, _U64)
    with np.errstate(over="ignore"):
        s = a + b
        s = np.where(s < a, s + _EPS, s)
        return np.where(s >= _P, s - _P, s)


def sub(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a - b, on borrow minus EPSILON (canonical for canonical inputs)."""
    a, b = np.asarray(a, _U64), np.asarray(b, _U64)
    with np.errstate(over="ignore"):
        d = a - b
        return np.where(a < b, d - _EPS, d)


def neg(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a, _U64)
    return np.where(a == 0, a, _P - a)


def _mul_wide(a: np.ndarray, b: np.ndarray):
    """64x64 -> 128-bit product as (lo64, hi64) uint64 pairs."""
    with np.errstate(over="ignore"):
        a_lo, a_hi = a & _M32, a >> _U64(32)
        b_lo, b_hi = b & _M32, b >> _U64(32)
        ll = a_lo * b_lo
        lh = a_lo * b_hi
        mid = lh + a_hi * b_lo
        mid_carry = (mid < lh).astype(_U64)
        lo = ll + (mid << _U64(32))
        carry2 = (lo < ll).astype(_U64)
        hi = (a_hi * b_hi + (mid >> _U64(32)) + (mid_carry << _U64(32))
              + carry2)
        return lo, hi


def reduce128(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """(lo + hi * 2^64) mod p, canonical: lo - hi_hi + hi_lo * EPSILON."""
    with np.errstate(over="ignore"):
        hi_hi, hi_lo = hi >> _U64(32), hi & _M32
        t0 = lo - hi_hi
        t0 = np.where(lo < hi_hi, t0 - _EPS, t0)
        t1 = hi_lo * _EPS
        t2 = t0 + t1
        t2 = np.where(t2 < t1, t2 + _EPS, t2)
        return np.where(t2 >= _P, t2 - _P, t2)


def mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return reduce128(*_mul_wide(np.asarray(a, _U64), np.asarray(b, _U64)))


def exp_u64(a: np.ndarray, e: int) -> np.ndarray:
    """a ** e (e a python int) by square-and-multiply, elementwise."""
    a = np.asarray(a, dtype=_U64)
    result = np.full(a.shape, 1, dtype=_U64)
    base = a
    while e > 0:
        if e & 1:
            result = mul(result, base)
        e >>= 1
        if e:
            base = mul(base, base)
    return result


def powers(base: int, n: int) -> np.ndarray:
    """[1, base, base^2, ..., base^(n-1)] by log-doubling."""
    out = np.empty(n, dtype=_U64)
    if n == 0:
        return out
    out[0] = 1
    length = 1
    step = _U64(base % P)
    while length < n:
        take = min(length, n - length)
        out[length:length + take] = mul(out[:take], np.full(take, step, _U64))
        length += take
        step = mul(step, step)
    return out


def inverse(a: np.ndarray) -> np.ndarray:
    """Elementwise a^(p-2) by square-and-multiply; inverse(0) == 0."""
    a = np.asarray(a, _U64)
    result = np.ones_like(a)
    base = a
    e = P - 2
    while e:
        if e & 1:
            result = mul(result, base)
        e >>= 1
        if e:
            base = mul(base, base)
    return result


def s_inv(a: int) -> int:
    return pow(a, P - 2, P)


def primitive_root_of_unity(n_log: int) -> int:
    """The canonical 2^n_log-th root of unity."""
    if not 0 <= n_log <= TWO_ADICITY:
        raise ValueError(f"no 2^{n_log}-th root of unity in Goldilocks")
    return pow(POWER_OF_TWO_GENERATOR, 1 << (TWO_ADICITY - n_log), P)


def two_adic_subgroup(n_log: int) -> np.ndarray:
    """[1, g, ..., g^(2^n_log - 1)] for the canonical 2^n_log-th root g."""
    return powers(primitive_root_of_unity(n_log), 1 << n_log)


def coset_shift() -> int:
    """The LDE coset shift, the multiplicative group generator 7."""
    return MULTIPLICATIVE_GROUP_GENERATOR
