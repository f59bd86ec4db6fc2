"""System Zero's Poseidon permutation unit: one width-12 permutation a
row, each s-box's cube witnessed so that every constraint stays at degree 3
(the port's copy of plonky2_tpu/system_zero/permutation_unit.py; reference
system_zero/src/permutation_unit.rs).  The constants are the port's
hash/poseidon.py's."""
from __future__ import annotations

from ..field import goldilocks as gl
from ..hash import poseidon as pos
from . import registers as R

_RC = [int(x) for x in pos.ALL_ROUND_CONSTANTS]
_MDS = [[int(x) for x in row] for row in pos.MDS_MATRIX]
_W = pos.WIDTH


def _mds_ints(state):
    return [sum(_MDS[r][c] * state[c] for c in range(_W)) % gl.P
            for r in range(_W)]


def generate_permutation_unit(row) -> None:
    state = [row[R.col_perm_input(i)] % gl.P for i in range(_W)]

    for r in range(pos.HALF_N_FULL_ROUNDS):
        state = [(state[i] + _RC[_W * r + i]) % gl.P for i in range(_W)]
        for i in range(_W):
            cube = state[i] ** 3 % gl.P
            row[R.col_full_first_mid_sbox(r, i)] = cube
            state[i] = state[i] * cube * cube % gl.P  # x^7
        state = _mds_ints(state)
        for i in range(_W):
            row[R.col_full_first_after_mds(r, i)] = state[i]

    for r in range(pos.N_PARTIAL_ROUNDS):
        rr = pos.HALF_N_FULL_ROUNDS + r
        state = [(state[i] + _RC[_W * rr + i]) % gl.P for i in range(_W)]
        cube = state[0] ** 3 % gl.P
        row[R.col_partial_mid_sbox(r)] = cube
        state[0] = state[0] * cube * cube % gl.P
        row[R.col_partial_after_sbox(r)] = state[0]
        state = _mds_ints(state)

    for r in range(pos.HALF_N_FULL_ROUNDS):
        rr = pos.HALF_N_FULL_ROUNDS + pos.N_PARTIAL_ROUNDS + r
        state = [(state[i] + _RC[_W * rr + i]) % gl.P for i in range(_W)]
        for i in range(_W):
            cube = state[i] ** 3 % gl.P
            row[R.col_full_second_mid_sbox(r, i)] = cube
            state[i] = state[i] * cube * cube % gl.P
        state = _mds_ints(state)
        for i in range(_W):
            row[R.col_full_second_after_mds(r, i)] = state[i]


def _constant_layer(alg, state, round_):
    return [alg.add_const(state[i], _RC[_W * round_ + i]) for i in range(_W)]


def _mds_layer(alg, state):
    out = []
    for r in range(_W):
        acc = alg.mul_const(state[0], _MDS[r][0])
        for c in range(1, _W):
            acc = alg.add(acc, alg.mul_const(state[c], _MDS[r][c]))
        out.append(acc)
    return out


def eval_permutation_unit(alg, vars, yield_constr) -> None:
    lv = vars.local_values
    state = [lv[R.col_perm_input(i)] for i in range(_W)]

    for r in range(pos.HALF_N_FULL_ROUNDS):
        state = _constant_layer(alg, state, r)
        for i in range(_W):
            cubed = alg.mul(state[i], alg.mul(state[i], state[i]))
            yield_constr.constraint(
                alg.sub(cubed, lv[R.col_full_first_mid_sbox(r, i)]))
            wit = lv[R.col_full_first_mid_sbox(r, i)]
            state[i] = alg.mul(state[i], alg.mul(wit, wit))
        state = _mds_layer(alg, state)
        for i in range(_W):
            yield_constr.constraint(
                alg.sub(state[i], lv[R.col_full_first_after_mds(r, i)]))
            state[i] = lv[R.col_full_first_after_mds(r, i)]

    for r in range(pos.N_PARTIAL_ROUNDS):
        state = _constant_layer(alg, state, pos.HALF_N_FULL_ROUNDS + r)
        cubed = alg.mul(state[0], alg.mul(state[0], state[0]))
        yield_constr.constraint(alg.sub(cubed, lv[R.col_partial_mid_sbox(r)]))
        wit = lv[R.col_partial_mid_sbox(r)]
        state[0] = alg.mul(state[0], alg.mul(wit, wit))
        yield_constr.constraint(
            alg.sub(state[0], lv[R.col_partial_after_sbox(r)]))
        state[0] = lv[R.col_partial_after_sbox(r)]
        state = _mds_layer(alg, state)

    for r in range(pos.HALF_N_FULL_ROUNDS):
        rr = pos.HALF_N_FULL_ROUNDS + pos.N_PARTIAL_ROUNDS + r
        state = _constant_layer(alg, state, rr)
        for i in range(_W):
            cubed = alg.mul(state[i], alg.mul(state[i], state[i]))
            yield_constr.constraint(
                alg.sub(cubed, lv[R.col_full_second_mid_sbox(r, i)]))
            wit = lv[R.col_full_second_mid_sbox(r, i)]
            state[i] = alg.mul(state[i], alg.mul(wit, wit))
        state = _mds_layer(alg, state)
        for i in range(_W):
            yield_constr.constraint(
                alg.sub(state[i], lv[R.col_full_second_after_mds(r, i)]))
            state[i] = lv[R.col_full_second_after_mds(r, i)]
