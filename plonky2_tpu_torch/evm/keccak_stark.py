"""The Keccak-f[1600] permutation table: one round a row, 24 rows a
permutation, theta/rho/pi/chi/iota tracked through bit columns.  The
port's counterpart of plonky2_tpu/evm/keccak_stark.py (reference
evm/src/keccak/{columns,keccak_stark,logic,round_flags,constants}.rs),
with its column layout, CTL columns and constraints; ``generate_trace``
computes every permutation's rounds together with numpy array ops and
equals the JAX package's row-by-row generator column for column."""
from __future__ import annotations

from typing import List

import numpy as np

from ..field import goldilocks as gl
from ..hash.keccak import RC
from ..stark.stark import Stark
from .cross_table_lookup import Column

NUM_ROUNDS = 24
NUM_INPUTS = 25

# rotation offsets r[x][y] (reference columns.rs:42-48)
R = [[0, 36, 3, 41, 18],
     [1, 44, 10, 45, 2],
     [62, 6, 43, 15, 61],
     [28, 55, 25, 21, 56],
     [27, 20, 39, 8, 14]]


# -- column layout (reference columns.rs) -------------------------------------

def reg_step(i: int) -> int:
    return i


START_A = NUM_ROUNDS


def reg_a(x: int, y: int) -> int:
    return START_A + (x * 5 + y) * 2


START_C = START_A + 5 * 5 * 2


def reg_c(x: int, z: int) -> int:
    return START_C + x * 64 + z


START_C_PRIME = START_C + 5 * 64


def reg_c_prime(x: int, z: int) -> int:
    return START_C_PRIME + x * 64 + z


START_A_PRIME = START_C_PRIME + 5 * 64


def reg_a_prime(x: int, y: int, z: int) -> int:
    return START_A_PRIME + x * 64 * 5 + y * 64 + z


def reg_b(x: int, y: int, z: int) -> int:
    # B is a rotation of A': B[x, y] = ROT(A'[a, b], r[a, b]) with
    # a = (x + 3y) % 5, b = x
    a = (x + 3 * y) % 5
    b = x
    rot = R[a][b]
    return reg_a_prime(a, b, (z + 64 - rot) % 64)


START_A_PRIME_PRIME = START_A_PRIME + 5 * 5 * 64


def reg_a_prime_prime(x: int, y: int) -> int:
    return START_A_PRIME_PRIME + x * 2 * 5 + y * 2


START_A_PRIME_PRIME_0_0_BITS = START_A_PRIME_PRIME + 5 * 5 * 2


def reg_a_prime_prime_0_0_bit(i: int) -> int:
    return START_A_PRIME_PRIME_0_0_BITS + i


REG_A_PRIME_PRIME_PRIME_0_0_LO = START_A_PRIME_PRIME_0_0_BITS + 64
REG_A_PRIME_PRIME_PRIME_0_0_HI = REG_A_PRIME_PRIME_PRIME_0_0_LO + 1


def reg_a_prime_prime_prime(x: int, y: int) -> int:
    if x == 0 and y == 0:
        return REG_A_PRIME_PRIME_PRIME_0_0_LO
    return reg_a_prime_prime(x, y)


# Copies of the original permutation input, carried across all 24 rows of
# a cycle so the CTL can read (input, output) from one filtered row.  The
# reference instead reads reg_a on the last-round row (columns.rs:15-26),
# which by then holds the round-23 intermediate state, not the preimage —
# one of the reasons its CTLs ship disabled (all_stark.rs:92-106).
PREIMAGE_START = REG_A_PRIME_PRIME_PRIME_0_0_HI + 1


def reg_preimage(x: int, y: int) -> int:
    return PREIMAGE_START + (x * 5 + y) * 2


# 1 on the last-round row of a REAL (non-padding) permutation cycle: the CTL
# filter. The reference filters on reg_step(23) alone with a TODO about
# padding rows (keccak_stark.rs:40-43); this column closes that hole.
REG_FILTER = PREIMAGE_START + 2 * 25

NUM_COLUMNS = REG_FILTER + 1


def reg_input_limb_col(i: int) -> Column:
    i_u64 = i // 2
    y, x = divmod(i_u64, 5)
    return Column.single(reg_preimage(x, y) + (i % 2))


def reg_output_limb(i: int) -> int:
    i_u64 = i // 2
    y, x = divmod(i_u64, 5)
    return reg_a_prime_prime_prime(x, y) + (i % 2)


def ctl_data() -> List[Column]:
    res = [reg_input_limb_col(i) for i in range(2 * NUM_INPUTS)]
    res += Column.singles([reg_output_limb(i) for i in range(2 * NUM_INPUTS)])
    return res


def ctl_filter() -> Column:
    return Column.single(REG_FILTER)


def _xor_gen(alg, x, y):
    """x + y - 2xy: arithmetic generalization of xor on bits."""
    return alg.sub(alg.add(x, y), alg.mul_const(alg.mul(x, y), 2))


def _andn_gen(alg, x, y):
    return alg.mul(alg.sub(alg.one(), x), y)


_M32 = np.uint64(0xFFFFFFFF)
_Z = np.arange(64, dtype=np.uint64)


def _limbs(lanes: np.ndarray) -> np.ndarray:
    """(..., k) u64 lanes -> (..., 2k): each lane's low and high 32 bits."""
    return np.stack([lanes & _M32, lanes >> np.uint64(32)],
                    -1).reshape(lanes.shape[:-1] + (-1,))


def _b_index() -> np.ndarray:
    """Flat A' index (x' * 320 + y' * 64 + z') of each B[x, y, z]."""
    idx = np.empty((5, 5, 64), dtype=np.int64)
    for x in range(5):
        for y in range(5):
            a, b = (x + 3 * y) % 5, x
            for z in range(64):
                idx[x, y, z] = a * 320 + b * 64 + (z + 64 - R[a][b]) % 64
    return idx


_B_INDEX = _b_index()


def _perm_rows(states: np.ndarray, is_real: bool) -> np.ndarray:
    """(P, 25) input states -> (P, 24, COLUMNS) uint64 rows, the rounds
    of all P permutations computed together."""
    n = states.shape[0]
    out = np.zeros((n, NUM_ROUNDS, NUM_COLUMNS), dtype=np.uint64)
    a = states.reshape(n, 5, 5).transpose(0, 2, 1)         # a[:, x, y]
    out[:, :, PREIMAGE_START:PREIMAGE_START + 50] = \
        _limbs(a.reshape(n, 25))[:, None]
    out[:, NUM_ROUNDS - 1, REG_FILTER] = int(is_real)
    for r in range(NUM_ROUNDS):
        row = out[:, r]
        row[:, reg_step(r)] = 1
        row[:, START_A:START_A + 50] = _limbs(a.reshape(n, 25))
        bits = (a[..., None] >> _Z) & np.uint64(1)          # [x, y, z]
        c = np.bitwise_xor.reduce(bits, axis=2)              # [x, z]
        c_prime = c ^ np.roll(c, 1, axis=1) ^ np.roll(np.roll(c, -1, axis=1),
                                                       1, axis=2)
        row[:, START_C:START_C + 320] = c.reshape(n, 320)
        row[:, START_C_PRIME:START_C_PRIME + 320] = c_prime.reshape(n, 320)
        a_prime = bits ^ (c ^ c_prime)[:, :, None, :]
        flat = a_prime.reshape(n, 1600)
        row[:, START_A_PRIME:START_A_PRIME + 1600] = flat
        b = flat[:, _B_INDEX]                                # [x, y, z]
        chi = b ^ ((np.uint64(1) ^ np.roll(b, -1, axis=1))
                   & np.roll(b, -2, axis=1))
        a_pp = (chi << _Z).sum(axis=-1, dtype=np.uint64)     # [x, y]
        row[:, START_A_PRIME_PRIME:START_A_PRIME_PRIME + 50] = \
            _limbs(a_pp.reshape(n, 25))
        val = a_pp[:, 0, 0]
        row[:, START_A_PRIME_PRIME_0_0_BITS:
            START_A_PRIME_PRIME_0_0_BITS + 64] = \
            (val[:, None] >> _Z) & np.uint64(1)
        a_ppp = val ^ np.uint64(RC[r])
        row[:, REG_A_PRIME_PRIME_PRIME_0_0_LO] = a_ppp & _M32
        row[:, REG_A_PRIME_PRIME_PRIME_0_0_HI] = a_ppp >> np.uint64(32)
        a = a_pp.copy()
        a[:, 0, 0] = a_ppp
    return out


class KeccakStark(Stark):
    COLUMNS = NUM_COLUMNS
    PUBLIC_INPUTS = 0

    # -- trace generation (reference keccak_stark.rs:52-204) ---------------

    def generate_trace(self, inputs: List[List[int]],
                       min_rows: int = 8) -> np.ndarray:
        """(COLUMNS, rows) uint64: 24 rows for each input state (25 lanes,
        lane x + 5 y at index x + 5 y), then rows of the all-zero
        permutation (filter 0) up to a power of two, the last one cut
        short.  All permutations go through each round together."""
        num_rows = max(len(inputs) * NUM_ROUNDS, min_rows)
        num_rows = 1 << (num_rows - 1).bit_length()
        n_pad = -(-(num_rows - len(inputs) * NUM_ROUNDS) // NUM_ROUNDS)
        parts = []
        if inputs:
            parts.append(_perm_rows(np.array(inputs, dtype=np.uint64)
                                    .reshape(-1, NUM_INPUTS), True))
        if n_pad:
            pad = _perm_rows(np.zeros((1, NUM_INPUTS), dtype=np.uint64),
                             False)
            parts.append(np.broadcast_to(pad, (n_pad,) + pad.shape[1:]))
        rows = np.concatenate(parts).reshape(-1, NUM_COLUMNS)[:num_rows]
        return np.ascontiguousarray(rows.T)

    # -- constraints (reference keccak_stark.rs:228-376) --------------------

    def eval(self, alg, vars, yield_constr) -> None:
        lv, nv = vars.local_values, vars.next_values
        one = alg.one()

        # round flags rotate (reference round_flags.rs)
        yield_constr.constraint_first_row(alg.sub(lv[reg_step(0)], one))
        for i in range(1, NUM_ROUNDS):
            yield_constr.constraint_first_row(lv[reg_step(i)])
        for i in range(NUM_ROUNDS):
            yield_constr.constraint_transition(
                alg.sub(nv[reg_step((i + 1) % NUM_ROUNDS)], lv[reg_step(i)]))

        # C'[x,z] = xor3(C[x,z], C[x-1,z], C[x+1,z-1])
        for x in range(5):
            for z in range(64):
                x3 = _xor_gen(alg, lv[reg_c(x, z)],
                              _xor_gen(alg, lv[reg_c((x + 4) % 5, z)],
                                       lv[reg_c((x + 1) % 5, (z + 63) % 64)]))
                yield_constr.constraint(alg.sub(lv[reg_c_prime(x, z)], x3))

        # input limbs consistent with A' and C/C'
        for x in range(5):
            for y in range(5):
                lo = alg.zero()
                hi = alg.zero()
                for z in range(63, -1, -1):
                    bit = _xor_gen(alg, lv[reg_a_prime(x, y, z)],
                                   _xor_gen(alg, lv[reg_c(x, z)],
                                            lv[reg_c_prime(x, z)]))
                    if z < 32:
                        lo = alg.add(alg.mul_const(lo, 2), bit)
                    else:
                        hi = alg.add(alg.mul_const(hi, 2), bit)
                yield_constr.constraint(alg.sub(lo, lv[reg_a(x, y)]))
                yield_constr.constraint(alg.sub(hi, lv[reg_a(x, y) + 1]))

        # xor_{i} A'[x,i,z] = C'[x,z]: diff in {0, 2, 4}
        for x in range(5):
            for z in range(64):
                s = alg.zero()
                for i in range(5):
                    s = alg.add(s, lv[reg_a_prime(x, i, z)])
                diff = alg.sub(s, lv[reg_c_prime(x, z)])
                yield_constr.constraint(
                    alg.mul(diff, alg.mul(alg.add_const(diff, gl.P - 2),
                                          alg.add_const(diff, gl.P - 4))))

        # A''[x,y] = xor(B[x,y], andn(B[x+1,y], B[x+2,y])) packed in limbs
        for x in range(5):
            for y in range(5):
                lo = alg.zero()
                hi = alg.zero()
                for z in range(63, -1, -1):
                    bit = _xor_gen(alg, lv[reg_b(x, y, z)],
                                   _andn_gen(alg, lv[reg_b((x + 1) % 5, y, z)],
                                             lv[reg_b((x + 2) % 5, y, z)]))
                    if z < 32:
                        lo = alg.add(alg.mul_const(lo, 2), bit)
                    else:
                        hi = alg.add(alg.mul_const(hi, 2), bit)
                yield_constr.constraint(alg.sub(lo, lv[reg_a_prime_prime(x, y)]))
                yield_constr.constraint(
                    alg.sub(hi, lv[reg_a_prime_prime(x, y) + 1]))

        # A''[0,0] bit decomposition
        bits = [lv[reg_a_prime_prime_0_0_bit(i)] for i in range(64)]
        lo = alg.zero()
        hi = alg.zero()
        for z in range(63, -1, -1):
            if z < 32:
                lo = alg.add(alg.mul_const(lo, 2), bits[z])
            else:
                hi = alg.add(alg.mul_const(hi, 2), bits[z])
        yield_constr.constraint(alg.sub(lo, lv[reg_a_prime_prime(0, 0)]))
        yield_constr.constraint(alg.sub(hi, lv[reg_a_prime_prime(0, 0) + 1]))

        # A'''[0,0] = A''[0,0] xor RC (RC bit selected by the round flag)
        lo = alg.zero()
        hi = alg.zero()
        for z in range(63, -1, -1):
            rc_bit = alg.zero()
            for r in range(NUM_ROUNDS):
                if (RC[r] >> z) & 1:
                    rc_bit = alg.add(rc_bit, lv[reg_step(r)])
            bit = _xor_gen(alg, bits[z], rc_bit)
            if z < 32:
                lo = alg.add(alg.mul_const(lo, 2), bit)
            else:
                hi = alg.add(alg.mul_const(hi, 2), bit)
        yield_constr.constraint(
            alg.sub(lo, lv[REG_A_PRIME_PRIME_PRIME_0_0_LO]))
        yield_constr.constraint(
            alg.sub(hi, lv[REG_A_PRIME_PRIME_PRIME_0_0_HI]))

        # preimage columns hold the original input: they match reg_a on the
        # first round of a cycle and copy forward within the cycle
        for x in range(5):
            for y in range(5):
                for off in (0, 1):
                    yield_constr.constraint(alg.mul(
                        lv[reg_step(0)],
                        alg.sub(lv[reg_preimage(x, y) + off],
                                lv[reg_a(x, y) + off])))

        # this round's output is the next round's input (except last round)
        not_last = alg.sub(one, lv[reg_step(NUM_ROUNDS - 1)])
        for x in range(5):
            for y in range(5):
                for off in (0, 1):
                    yield_constr.constraint_transition(alg.mul(
                        not_last,
                        alg.sub(nv[reg_preimage(x, y) + off],
                                lv[reg_preimage(x, y) + off])))

        # the CTL filter is boolean and may only fire on last-round rows
        yield_constr.constraint(
            alg.mul(lv[REG_FILTER], alg.sub(lv[REG_FILTER], one)))
        yield_constr.constraint(alg.mul(
            lv[REG_FILTER],
            alg.sub(one, lv[reg_step(NUM_ROUNDS - 1)])))
        for x in range(5):
            for y in range(5):
                out_lo = lv[reg_a_prime_prime_prime(x, y)]
                out_hi = lv[reg_a_prime_prime_prime(x, y) + 1]
                yield_constr.constraint_transition(
                    alg.mul(not_last, alg.sub(out_lo, nv[reg_a(x, y)])))
                yield_constr.constraint_transition(
                    alg.mul(not_last, alg.sub(out_hi, nv[reg_a(x, y) + 1])))

    def constraint_degree(self) -> int:
        return 3
