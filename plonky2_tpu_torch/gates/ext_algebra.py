"""Quadratic-extension arithmetic for gate constraints (the port's copy of
plonky2_tpu/gates/ext_algebra.py; reference
field/src/extension/algebra.rs).

An element is a pair of values of the evaluation algebra (plonk/algebra.py)
standing for a0 + a1 X in K[X]/(X^2 - 7), so the same constraints run on
the base field (the quotient's program, the generators' batches) and on
the extension (the verifier at zeta).
"""
from __future__ import annotations

W = 7


def get_local_ext(vars, r: range):
    if len(r) != 2:
        raise ValueError(f"an extension element takes 2 wires, got {r}")
    return (vars.local_wires[r.start], vars.local_wires[r.start + 1])


def ea_from_base(alg, x):
    return (x, alg.zero())


def ea_add(alg, a, b):
    return (alg.add(a[0], b[0]), alg.add(a[1], b[1]))


def ea_sub(alg, a, b):
    return (alg.sub(a[0], b[0]), alg.sub(a[1], b[1]))


def ea_mul(alg, a, b):
    c0 = alg.add(alg.mul(a[0], b[0]), alg.mul_const(alg.mul(a[1], b[1]), W))
    c1 = alg.add(alg.mul(a[0], b[1]), alg.mul(a[1], b[0]))
    return (c0, c1)


def ea_scalar_mul(alg, a, s):
    """a times a value s of the evaluation algebra."""
    return (alg.mul(a[0], s), alg.mul(a[1], s))


def ea_scalar_mul_const(alg, a, c: int):
    return (alg.mul_const(a[0], c), alg.mul_const(a[1], c))
