"""Poseidon's round functions against an algebra, with the fast
partial-round schedule (the port's copy of
plonky2_tpu/hash/poseidon_schedule.py; reference
plonky2/src/hash/poseidon.rs:174-470).

The PoseidonGate stores the fast schedule's S-box inputs as wires, so its
constraints and its witness generator replay this schedule: python ints
for one row, numpy batches for many, extension pairs for the verifier.
The constants are hash/poseidon.py's.
"""
from __future__ import annotations

from . import poseidon as pos
from .poseidon import (FAST_PARTIAL_FIRST_ROUND_CONSTANT,
                       FAST_PARTIAL_ROUND_CONSTANTS,
                       FAST_PARTIAL_ROUND_INITIAL_MATRIX,
                       FAST_PARTIAL_ROUND_VS, FAST_PARTIAL_ROUND_W_HATS)

WIDTH = pos.WIDTH
HALF_N_FULL_ROUNDS = pos.HALF_N_FULL_ROUNDS
N_PARTIAL_ROUNDS = pos.N_PARTIAL_ROUNDS
_CIRC = [int(x) for x in pos.MDS_CIRC]
_DIAG = [int(x) for x in pos.MDS_DIAG]
_RC = [int(x) for x in pos.ALL_ROUND_CONSTANTS]


def constant_layer(alg, state, round_ctr):
    return [alg.add_const(state[i], _RC[round_ctr * WIDTH + i])
            for i in range(WIDTH)]


def sbox_monomial(alg, x):
    x2 = alg.mul(x, x)
    x3 = alg.mul(x2, x)
    x4 = alg.mul(x2, x2)
    return alg.mul(x3, x4)


def sbox_layer(alg, state):
    return [sbox_monomial(alg, s) for s in state]


def mds_row(alg, state, r):
    acc = None
    for i in range(WIDTH):
        t = alg.mul_const(state[(i + r) % WIDTH], _CIRC[i])
        acc = t if acc is None else alg.add(acc, t)
    if _DIAG[r]:
        acc = alg.add(acc, alg.mul_const(state[r], _DIAG[r]))
    return acc


def mds_layer(alg, state):
    return [mds_row(alg, state, r) for r in range(WIDTH)]


def partial_first_constant_layer(alg, state):
    return [alg.add_const(state[i], int(FAST_PARTIAL_FIRST_ROUND_CONSTANT[i]))
            for i in range(WIDTH)]


def mds_partial_layer_init(alg, state):
    result = [state[0]] + [alg.zero() for _ in range(WIDTH - 1)]
    for r in range(1, WIDTH):
        for c in range(1, WIDTH):
            t = int(FAST_PARTIAL_ROUND_INITIAL_MATRIX[r - 1][c - 1])
            result[c] = alg.add(result[c], alg.mul_const(state[r], t))
    return result


def mds_partial_layer_fast(alg, state, r):
    """d = (CIRC[0] + DIAG[0]) s0 + sum w_hat[i] s_i; the rest s_i + s0
    v[i]."""
    d = alg.mul_const(state[0], _CIRC[0] + _DIAG[0])
    for i in range(1, WIDTH):
        d = alg.add(d, alg.mul_const(state[i],
                                     int(FAST_PARTIAL_ROUND_W_HATS[r][i - 1])))
    result = [d]
    for i in range(1, WIDTH):
        v = int(FAST_PARTIAL_ROUND_VS[r][i - 1])
        result.append(alg.add(state[i], alg.mul_const(state[0], v)))
    return result
