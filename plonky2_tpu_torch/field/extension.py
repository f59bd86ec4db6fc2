"""The quadratic extension F_p[X]/(X^2 - 7) on the host, on python ints.

The port's copy of the scalar helpers of plonky2_tpu/field/extension.py
(``s_mul``, ``s_add``, ``s_sub``, ``s_inv``, ``s_exp``) and of its
``powers``.  An element is a pair (a0, a1) = a0 + a1 X of canonical ints;
W = 7.  The transcript's extension challenges, the opening points and the
FRI batch weights are computed here; the per-point work runs on the device
(field/gf2.py).
"""
from __future__ import annotations

from typing import List, Tuple

from .goldilocks import P

W = 7
Ext = Tuple[int, int]
ONE: Ext = (1, 0)


def s_mul(a, b) -> Ext:
    a0, a1 = int(a[0]), int(a[1])
    b0, b1 = int(b[0]), int(b[1])
    return ((a0 * b0 + W * a1 * b1) % P, (a0 * b1 + a1 * b0) % P)


def s_add(a, b) -> Ext:
    return ((int(a[0]) + int(b[0])) % P, (int(a[1]) + int(b[1])) % P)


def s_sub(a, b) -> Ext:
    return ((int(a[0]) - int(b[0])) % P, (int(a[1]) - int(b[1])) % P)


def s_inv(a) -> Ext:
    """(a0 - a1 X) / (a0^2 - W a1^2); s_inv(0) == 0."""
    a0, a1 = int(a[0]), int(a[1])
    dinv = pow((a0 * a0 - W * a1 * a1) % P, P - 2, P)
    return ((a0 * dinv) % P, (-a1 * dinv) % P)


def s_exp(a, e: int) -> Ext:
    result = ONE
    base = (int(a[0]), int(a[1]))
    while e > 0:
        if e & 1:
            result = s_mul(result, base)
        e >>= 1
        if e:
            base = s_mul(base, base)
    return result


def powers(base, n: int) -> List[Ext]:
    """[1, base, ..., base^(n-1)]."""
    out = [ONE] * min(n, 1)
    for _ in range(1, n):
        out.append(s_mul(out[-1], base))
    return out
