"""System Zero's arithmetic and logic unit: its generation and its
constraints (the port's copy of plonky2_tpu/system_zero/alu.py; reference
system_zero/src/alu/{mod,addition,subtraction,mul_add,division,canonical,
bitops,rotate_shift}.rs).

Generation works on one row (a list of canonical python ints); the
constraints are written against the algebra protocol (plonk/algebra.py),
so stark/quotient_program.py traces them into the quotient's constraint
program and the verifier runs them on extension scalars.
"""
from __future__ import annotations

from typing import List

from ..field import goldilocks as gl
from .registers import *  # noqa: F401,F403  (column constants)

U32_MAX = (1 << 32) - 1


# -- canonical-element helpers (alu/canonical.rs) -----------------------------

def compute_canonical_inv(value: int) -> int:
    hi = (value >> 32) & U32_MAX
    if hi == U32_MAX:
        if value & U32_MAX:
            raise ValueError("Value was not canonical.")
        return 0
    return pow(U32_MAX - hi, gl.P - 2, gl.P)


def combine_u16s_check_canonical(alg, l0, l1, l2, l3, inverse, aux,
                                 yield_constr, filt):
    base = 1 << 16
    limb0_u32 = alg.add(l0, alg.mul_const(l1, base))
    limb1_u32 = alg.add(l2, alg.mul_const(l3, base))
    return combine_u32s_check_canonical(alg, limb0_u32, limb1_u32, inverse,
                                        aux, yield_constr, filt)


def combine_u32s_check_canonical(alg, limb0, limb1, inverse, aux,
                                 yield_constr, filt):
    # The reference leaves this check unfiltered with a "TODO: Needs to be
    # filtered by IS_MUL_ADD" (alu/mul_add.rs:51) — unfiltered it is violated
    # by any other ALU op sharing the range-check columns.  We witness the
    # intermediate hi_not_max = inv*(u32max - hi) - 1 in an extra shared
    # column so both constraints stay at degree 3 under the filter.
    diff = alg.sub(alg.const(U32_MAX), limb1)
    hi_not_max = alg.sub(alg.mul(inverse, diff), alg.one())
    yield_constr.constraint(alg.mul(filt, alg.sub(hi_not_max, aux)))
    yield_constr.constraint(alg.mul(filt, alg.mul(aux, limb0)))
    return alg.add(limb0, alg.mul_const(limb1, 1 << 32))


# -- generation (single row of ints) ------------------------------------------

def generate_addition(v: List[int]) -> None:
    out = v[COL_ADD_INPUT_0] + v[COL_ADD_INPUT_1] + v[COL_ADD_INPUT_2]
    v[COL_ADD_OUTPUT_0] = out & 0xFFFF
    v[COL_ADD_OUTPUT_1] = (out >> 16) & 0xFFFF
    v[COL_ADD_OUTPUT_2] = (out >> 32) & 0xFFFF


def generate_subtraction(v: List[int]) -> None:
    in_1, in_2 = v[COL_SUB_INPUT_0], v[COL_SUB_INPUT_1]
    diff = (in_1 - in_2) & U32_MAX
    br = 1 if in_1 < in_2 else 0
    v[COL_SUB_OUTPUT_0] = diff & 0xFFFF
    v[COL_SUB_OUTPUT_1] = (diff >> 16) & 0xFFFF
    v[COL_SUB_OUTPUT_BORROW] = br


def generate_mul_add(v: List[int]) -> None:
    out = (v[COL_MUL_ADD_FACTOR_0] * v[COL_MUL_ADD_FACTOR_1]
           + v[COL_MUL_ADD_ADDEND])
    inv = compute_canonical_inv(out)
    v[COL_MUL_ADD_RESULT_CANONICAL_INV] = inv
    hi = (out >> 32) & U32_MAX
    v[COL_MUL_ADD_CANONICAL_AUX] = (inv * (U32_MAX - hi) - 1) % gl.P
    v[COL_MUL_ADD_OUTPUT_0] = out & 0xFFFF
    v[COL_MUL_ADD_OUTPUT_1] = (out >> 16) & 0xFFFF
    v[COL_MUL_ADD_OUTPUT_2] = (out >> 32) & 0xFFFF
    v[COL_MUL_ADD_OUTPUT_3] = (out >> 48) & 0xFFFF


def generate_division(v: List[int]) -> None:
    dividend = v[COL_DIV_INPUT_DIVIDEND]
    divisor = v[COL_DIV_INPUT_DIVISOR]
    if divisor == 0:
        v[COL_DIV_OUTPUT_QUOT_0] = 0
        v[COL_DIV_OUTPUT_QUOT_1] = 0
        v[COL_DIV_OUTPUT_REM_0] = 0xFFFF
        v[COL_DIV_OUTPUT_REM_1] = 0xFFFF
        v[COL_DIV_RANGE_CHECKED_TMP_0] = 0
        v[COL_DIV_RANGE_CHECKED_TMP_1] = 0
        v[COL_DIV_INVDIVISOR] = 0
        v[COL_DIV_NONZERO_DIVISOR] = 0
    else:
        quo, rem = divmod(dividend, divisor)
        tmp = divisor - rem - 1
        v[COL_DIV_OUTPUT_QUOT_0] = quo & 0xFFFF
        v[COL_DIV_OUTPUT_QUOT_1] = (quo >> 16) & 0xFFFF
        v[COL_DIV_OUTPUT_REM_0] = rem & 0xFFFF
        v[COL_DIV_OUTPUT_REM_1] = (rem >> 16) & 0xFFFF
        v[COL_DIV_RANGE_CHECKED_TMP_0] = tmp & 0xFFFF
        v[COL_DIV_RANGE_CHECKED_TMP_1] = (tmp >> 16) & 0xFFFF
        v[COL_DIV_INVDIVISOR] = pow(divisor, gl.P - 2, gl.P)
        v[COL_DIV_NONZERO_DIVISOR] = 1


def _bits_to_u32(bits: List[int]) -> int:
    acc = 0
    for i, b in enumerate(bits):
        acc |= (b & 1) << i
    return acc


def generate_bitop(v: List[int], op: int) -> None:
    for in_a, in_b, out_reg in [
            (COL_BIT_DECOMP_INPUT_A_LO_BIN_REGS,
             COL_BIT_DECOMP_INPUT_B_LO_BIN_REGS, COL_BITOP_OUTPUT_0),
            (COL_BIT_DECOMP_INPUT_A_HI_BIN_REGS,
             COL_BIT_DECOMP_INPUT_B_HI_BIN_REGS, COL_BITOP_OUTPUT_1)]:
        a = _bits_to_u32([v[r] for r in in_a])
        b = _bits_to_u32([v[r] for r in in_b])
        if op == IS_AND:
            out = a & b
        elif op == IS_IOR:
            out = a | b
        elif op == IS_XOR:
            out = a ^ b
        elif op == IS_ANDNOT:
            out = a & (~b & U32_MAX)
        else:
            raise ValueError("unrecognized bitop instruction code")
        v[out_reg] = out


def generate_rotate_shift(v: List[int], op: int) -> None:
    input_lo = v[COL_ROTATE_SHIFT_INPUT_LO]
    input_hi = v[COL_ROTATE_SHIFT_INPUT_HI]
    exp_bits = [v[r] for r in COL_ROTATE_SHIFT_EXP_BITS]
    is_right = op in (IS_ROTATE_RIGHT, IS_SHIFT_RIGHT, IS_ARITH_SHIFT_RIGHT)
    exp = sum(b << i for i, b in enumerate(exp_bits))
    delta_mod32 = (32 - exp) % 32 if is_right else exp
    exp_ge32 = v[COL_ROTATE_SHIFT_DELTA_DIV32]
    delta = (exp_ge32 << 5) + delta_mod32

    pow_aux_0 = (exp_bits[0] + 1) * (3 * exp_bits[1] + 1)
    pow_aux_1 = (15 * exp_bits[2] + 1) * (255 * exp_bits[3] + 1)
    pow_aux_2 = pow_aux_0 * pow_aux_1
    pow_exp = pow_aux_2 * (65535 * exp_bits[4] + 1)
    v[COL_ROTATE_SHIFT_POW_EXP_AUX_0] = pow_aux_0
    v[COL_ROTATE_SHIFT_POW_EXP_AUX_1] = pow_aux_1
    v[COL_ROTATE_SHIFT_POW_EXP_AUX_2] = pow_aux_2
    v[COL_ROTATE_SHIFT_POW_EXP] = pow_exp

    lo_shifted = input_lo << exp
    hi_shifted = input_hi << exp
    lo_0, lo_1 = lo_shifted & U32_MAX, (lo_shifted >> 32) & U32_MAX
    hi_0, hi_1 = hi_shifted & U32_MAX, (hi_shifted >> 32) & U32_MAX
    v[COL_ROTATE_SHIFT_INPUT_LO_DISPLACED_0] = lo_0
    v[COL_ROTATE_SHIFT_INPUT_LO_DISPLACED_1] = lo_1
    v[COL_ROTATE_SHIFT_INPUT_HI_DISPLACED_0] = hi_0
    v[COL_ROTATE_SHIFT_INPUT_HI_DISPLACED_1] = hi_1

    for shifted_1, aux0, aux1 in [
            (lo_1, COL_ROTATE_SHIFT_INPUT_LO_DISPLACED_AUX_0,
             COL_ROTATE_SHIFT_INPUT_LO_DISPLACED_AUX_1),
            (hi_1, COL_ROTATE_SHIFT_INPUT_HI_DISPLACED_AUX_0,
             COL_ROTATE_SHIFT_INPUT_HI_DISPLACED_AUX_1)]:
        if shifted_1 != U32_MAX:
            inv = pow(U32_MAX - shifted_1, gl.P - 2, gl.P)
            v[aux0] = inv
            v[aux1] = (U32_MAX - shifted_1) * inv % gl.P
        else:
            v[aux0] = 0
            v[aux1] = 0

    x = (input_hi << 32) | input_lo
    if op == IS_ROTATE_LEFT:
        out = ((x << delta) | (x >> (64 - delta))) & ((1 << 64) - 1) \
            if delta else x
    elif op == IS_ROTATE_RIGHT:
        out = ((x >> delta) | (x << (64 - delta))) & ((1 << 64) - 1) \
            if delta else x
    elif op == IS_SHIFT_LEFT:
        out = (x << delta) & ((1 << 64) - 1)
    elif op == IS_SHIFT_RIGHT:
        out = x >> delta
    elif op == IS_ARITH_SHIFT_RIGHT:
        sx = x - (1 << 64) if x >> 63 else x
        out = (sx >> delta) & ((1 << 64) - 1)
    else:
        raise ValueError("unrecognized rotate/shift instruction code")
    v[COL_ROTATE_SHIFT_OUTPUT_0] = out & U32_MAX
    v[COL_ROTATE_SHIFT_OUTPUT_1] = (out >> 32) & U32_MAX


def generate_alu(v: List[int]) -> None:
    """(reference alu/mod.rs:31-59)."""
    if v[IS_ADD]:
        generate_addition(v)
    elif v[IS_SUB]:
        generate_subtraction(v)
    elif v[IS_MUL_ADD]:
        generate_mul_add(v)
    elif v[IS_DIV]:
        generate_division(v)
    elif v[IS_AND]:
        generate_bitop(v, IS_AND)
    elif v[IS_IOR]:
        generate_bitop(v, IS_IOR)
    elif v[IS_XOR]:
        generate_bitop(v, IS_XOR)
    elif v[IS_ANDNOT]:
        generate_bitop(v, IS_ANDNOT)
    elif v[IS_ROTATE_LEFT]:
        generate_rotate_shift(v, IS_ROTATE_LEFT)
    elif v[IS_ROTATE_RIGHT]:
        generate_rotate_shift(v, IS_ROTATE_RIGHT)
    elif v[IS_SHIFT_LEFT]:
        generate_rotate_shift(v, IS_SHIFT_LEFT)
    elif v[IS_SHIFT_RIGHT]:
        generate_rotate_shift(v, IS_SHIFT_RIGHT)


# -- evaluation (generic algebra) ---------------------------------------------

def eval_addition(alg, lv, yield_constr):
    is_add = lv[IS_ADD]
    out = alg.add(lv[COL_ADD_OUTPUT_0],
                  alg.add(alg.mul_const(lv[COL_ADD_OUTPUT_1], 1 << 16),
                          alg.mul_const(lv[COL_ADD_OUTPUT_2], 1 << 32)))
    computed = alg.add(lv[COL_ADD_INPUT_0],
                       alg.add(lv[COL_ADD_INPUT_1], lv[COL_ADD_INPUT_2]))
    yield_constr.constraint(alg.mul(is_add, alg.sub(out, computed)))


def eval_subtraction(alg, lv, yield_constr):
    is_sub = lv[IS_SUB]
    out_br = alg.mul_const(lv[COL_SUB_OUTPUT_BORROW], 1 << 32)
    lhs = alg.sub(alg.add(out_br, lv[COL_SUB_INPUT_0]), lv[COL_SUB_INPUT_1])
    rhs = alg.add(lv[COL_SUB_OUTPUT_0],
                  alg.mul_const(lv[COL_SUB_OUTPUT_1], 1 << 16))
    yield_constr.constraint(alg.mul(is_sub, alg.sub(lhs, rhs)))


def eval_mul_add(alg, lv, yield_constr):
    is_mul = lv[IS_MUL_ADD]
    computed = alg.add(alg.mul(lv[COL_MUL_ADD_FACTOR_0],
                               lv[COL_MUL_ADD_FACTOR_1]),
                       lv[COL_MUL_ADD_ADDEND])
    output = combine_u16s_check_canonical(
        alg, lv[COL_MUL_ADD_OUTPUT_0], lv[COL_MUL_ADD_OUTPUT_1],
        lv[COL_MUL_ADD_OUTPUT_2], lv[COL_MUL_ADD_OUTPUT_3],
        lv[COL_MUL_ADD_RESULT_CANONICAL_INV],
        lv[COL_MUL_ADD_CANONICAL_AUX], yield_constr, is_mul)
    yield_constr.constraint(alg.mul(is_mul, alg.sub(computed, output)))


def eval_division(alg, lv, yield_constr):
    is_div = lv[IS_DIV]
    one = alg.one()
    u32_max = alg.const(U32_MAX)
    dividend = lv[COL_DIV_INPUT_DIVIDEND]
    divisor = lv[COL_DIV_INPUT_DIVISOR]
    quotient = alg.add(lv[COL_DIV_OUTPUT_QUOT_0],
                       alg.mul_const(lv[COL_DIV_OUTPUT_QUOT_1], 1 << 16))
    remainder = alg.add(lv[COL_DIV_OUTPUT_REM_0],
                        alg.mul_const(lv[COL_DIV_OUTPUT_REM_1], 1 << 16))
    divinv = lv[COL_DIV_INVDIVISOR]
    div_divinv = lv[COL_DIV_NONZERO_DIVISOR]
    tmp = alg.add(lv[COL_DIV_RANGE_CHECKED_TMP_0],
                  alg.mul_const(lv[COL_DIV_RANGE_CHECKED_TMP_1], 1 << 16))

    yield_constr.constraint(
        alg.mul(is_div, alg.sub(alg.mul(divisor, divinv), div_divinv)))
    yield_constr.constraint(alg.mul(is_div, alg.mul(
        alg.sub(div_divinv, one),
        alg.sub(alg.sub(remainder, quotient), u32_max))))
    yield_constr.constraint(
        alg.mul(is_div, alg.mul(divisor, alg.sub(div_divinv, one))))
    yield_constr.constraint(alg.mul(is_div, alg.sub(
        alg.add(quotient, alg.mul(remainder, divinv)),
        alg.mul(divinv, dividend))))
    yield_constr.constraint(alg.mul(is_div, alg.mul(divisor, alg.sub(
        alg.sub(alg.sub(divisor, remainder), one), tmp))))


def _binary_to_u32(alg, bits):
    acc = alg.zero()
    for i, b in enumerate(bits):
        acc = alg.add(acc, alg.mul_const(b, 1 << i))
    return acc


def _eval_bitop_32(alg, lv, in_a, in_b, out_reg, yield_constr):
    is_and, is_ior = lv[IS_AND], lv[IS_IOR]
    is_xor, is_andnot = lv[IS_XOR], lv[IS_ANDNOT]
    a_bits = [lv[r] for r in in_a]
    b_bits = [lv[r] for r in in_b]

    inst = alg.add(alg.add(is_and, is_ior), alg.add(is_xor, is_andnot))
    for v in a_bits + b_bits:
        yield_constr.constraint(alg.mul(inst, alg.sub(alg.mul(v, v), v)))

    output = lv[out_reg]
    a = _binary_to_u32(alg, a_bits)
    b = _binary_to_u32(alg, b_bits)
    a_and_b = _binary_to_u32(alg, [alg.mul(x, y)
                                   for x, y in zip(a_bits, b_bits)])
    constraint = alg.add(
        alg.add(alg.mul(is_and, alg.sub(a_and_b, output)),
                alg.mul(is_ior, alg.sub(alg.sub(alg.add(a, b), a_and_b),
                                        output))),
        alg.add(alg.mul(is_xor, alg.sub(alg.sub(alg.add(a, b),
                                                alg.mul_const(a_and_b, 2)),
                                        output)),
                alg.mul(is_andnot, alg.sub(alg.sub(a, a_and_b), output))))
    yield_constr.constraint(constraint)


def eval_bitop(alg, lv, yield_constr):
    _eval_bitop_32(alg, lv, COL_BIT_DECOMP_INPUT_A_LO_BIN_REGS,
                   COL_BIT_DECOMP_INPUT_B_LO_BIN_REGS, COL_BITOP_OUTPUT_0,
                   yield_constr)
    _eval_bitop_32(alg, lv, COL_BIT_DECOMP_INPUT_A_HI_BIN_REGS,
                   COL_BIT_DECOMP_INPUT_B_HI_BIN_REGS, COL_BITOP_OUTPUT_1,
                   yield_constr)


def _constrain_pow_exp(alg, lv, yield_constr, filt):
    exp_bits = [lv[r] for r in COL_ROTATE_SHIFT_EXP_BITS]
    exp_ge32 = lv[COL_ROTATE_SHIFT_DELTA_DIV32]
    aux0 = lv[COL_ROTATE_SHIFT_POW_EXP_AUX_0]
    aux1 = lv[COL_ROTATE_SHIFT_POW_EXP_AUX_1]
    aux2 = lv[COL_ROTATE_SHIFT_POW_EXP_AUX_2]
    pow_exp = lv[COL_ROTATE_SHIFT_POW_EXP]

    for b in exp_bits + [exp_ge32]:
        yield_constr.constraint(alg.mul(filt, alg.sub(alg.mul(b, b), b)))

    one = alg.one()
    c = [(1 << (1 << i)) - 1 for i in range(1, 5)]
    constr1 = alg.mul(alg.add(exp_bits[0], one),
                      alg.add(alg.mul_const(exp_bits[1], c[0]), one))
    yield_constr.constraint(alg.mul(filt, alg.sub(constr1, aux0)))
    constr2 = alg.mul(alg.add(alg.mul_const(exp_bits[2], c[1]), one),
                      alg.add(alg.mul_const(exp_bits[3], c[2]), one))
    yield_constr.constraint(alg.mul(filt, alg.sub(constr2, aux1)))
    yield_constr.constraint(alg.mul(filt, alg.sub(alg.mul(aux0, aux1), aux2)))
    constr4 = alg.mul(aux2, alg.add(alg.mul_const(exp_bits[4], c[3]), one))
    yield_constr.constraint(alg.mul(filt, alg.sub(constr4, pow_exp)))


def _constrain_shifted_are_valid(alg, lv, yield_constr, filt):
    u32_max = alg.const(U32_MAX)
    one = alg.one()
    for s0, s1, a0, a1 in [
            (COL_ROTATE_SHIFT_INPUT_LO_DISPLACED_0,
             COL_ROTATE_SHIFT_INPUT_LO_DISPLACED_1,
             COL_ROTATE_SHIFT_INPUT_LO_DISPLACED_AUX_0,
             COL_ROTATE_SHIFT_INPUT_LO_DISPLACED_AUX_1),
            (COL_ROTATE_SHIFT_INPUT_HI_DISPLACED_0,
             COL_ROTATE_SHIFT_INPUT_HI_DISPLACED_1,
             COL_ROTATE_SHIFT_INPUT_HI_DISPLACED_AUX_0,
             COL_ROTATE_SHIFT_INPUT_HI_DISPLACED_AUX_1)]:
        constr = alg.mul(lv[a0], alg.sub(u32_max, lv[s1]))
        yield_constr.constraint(alg.mul(filt, alg.sub(constr, lv[a1])))
        is_valid = alg.mul(lv[s0], alg.sub(one, lv[a1]))
        yield_constr.constraint(alg.mul(filt, is_valid))


def _eval_rotate_shift_common(alg, lv, yield_constr, filt):
    _constrain_pow_exp(alg, lv, yield_constr, filt)
    _constrain_shifted_are_valid(alg, lv, yield_constr, filt)

    pow_exp = lv[COL_ROTATE_SHIFT_POW_EXP]
    lo0 = lv[COL_ROTATE_SHIFT_INPUT_LO_DISPLACED_0]
    lo1 = lv[COL_ROTATE_SHIFT_INPUT_LO_DISPLACED_1]
    hi0 = lv[COL_ROTATE_SHIFT_INPUT_HI_DISPLACED_0]
    hi1 = lv[COL_ROTATE_SHIFT_INPUT_HI_DISPLACED_1]
    lo_shifted = alg.add(lo0, alg.mul_const(lo1, 1 << 32))
    hi_shifted = alg.add(hi0, alg.mul_const(hi1, 1 << 32))
    yield_constr.constraint(alg.mul(filt, alg.sub(
        alg.mul(lv[COL_ROTATE_SHIFT_INPUT_LO], pow_exp), lo_shifted)))
    yield_constr.constraint(alg.mul(filt, alg.sub(
        alg.mul(lv[COL_ROTATE_SHIFT_INPUT_HI], pow_exp), hi_shifted)))
    return (lv[COL_ROTATE_SHIFT_DELTA_DIV32], lo0, lo1, hi0, hi1,
            lv[COL_ROTATE_SHIFT_OUTPUT_0], lv[COL_ROTATE_SHIFT_OUTPUT_1])


def _rotate_shift_output_constraints(alg, filt, ge32, lo_pair, hi_pair,
                                     yield_constr):
    """Each pair = (value if delta < 32, value if delta >= 32)."""
    one = alg.one()
    not_ge32 = alg.sub(one, ge32)
    for small, large in (lo_pair, hi_pair):
        constr = alg.add(alg.mul(not_ge32, small), alg.mul(ge32, large))
        yield_constr.constraint(alg.mul(filt, constr))


def eval_rotate_left(alg, lv, yield_constr):
    filt = lv[IS_ROTATE_LEFT]
    ge32, lo0, lo1, hi0, hi1, out_lo, out_hi = \
        _eval_rotate_shift_common(alg, lv, yield_constr, filt)
    lo_small = alg.sub(alg.add(hi1, lo0), out_lo)
    lo_large = alg.sub(alg.add(lo1, hi0), out_lo)
    hi_small = alg.sub(alg.add(lo1, hi0), out_hi)
    hi_large = alg.sub(alg.add(hi1, lo0), out_hi)
    _rotate_shift_output_constraints(alg, filt, ge32, (lo_small, lo_large),
                                     (hi_small, hi_large), yield_constr)


def eval_rotate_right(alg, lv, yield_constr):
    filt = lv[IS_ROTATE_RIGHT]
    ge32, lo0, lo1, hi0, hi1, out_lo, out_hi = \
        _eval_rotate_shift_common(alg, lv, yield_constr, filt)
    lo_small = alg.sub(alg.add(lo1, hi0), out_lo)
    lo_large = alg.sub(alg.add(hi1, lo0), out_lo)
    hi_small = alg.sub(alg.add(hi1, lo0), out_hi)
    hi_large = alg.sub(alg.add(lo1, hi0), out_hi)
    _rotate_shift_output_constraints(alg, filt, ge32, (lo_small, lo_large),
                                     (hi_small, hi_large), yield_constr)


def eval_shift_left(alg, lv, yield_constr):
    filt = lv[IS_SHIFT_LEFT]
    ge32, lo0, lo1, hi0, hi1, out_lo, out_hi = \
        _eval_rotate_shift_common(alg, lv, yield_constr, filt)
    zero = alg.zero()
    lo_small = alg.sub(lo0, out_lo)
    lo_large = alg.sub(zero, out_lo)
    hi_small = alg.sub(alg.add(lo1, hi0), out_hi)
    hi_large = alg.sub(lo0, out_hi)
    _rotate_shift_output_constraints(alg, filt, ge32, (lo_small, lo_large),
                                     (hi_small, hi_large), yield_constr)


def eval_shift_right(alg, lv, yield_constr):
    # Note: the reference's packed eval filters this with IS_SHIFT_LEFT
    # (alu/rotate_shift.rs:328) while its circuit eval uses IS_SHIFT_RIGHT
    # (:617) — we follow the circuit variant, which is the intended one.
    filt = lv[IS_SHIFT_RIGHT]
    ge32, lo0, lo1, hi0, hi1, out_lo, out_hi = \
        _eval_rotate_shift_common(alg, lv, yield_constr, filt)
    zero = alg.zero()
    lo_small = alg.sub(alg.add(lo1, hi0), out_lo)
    lo_large = alg.sub(hi1, out_lo)
    hi_small = alg.sub(hi1, out_hi)
    hi_large = alg.sub(zero, out_hi)
    _rotate_shift_output_constraints(alg, filt, ge32, (lo_small, lo_large),
                                     (hi_small, hi_large), yield_constr)


def eval_alu(alg, lv, yield_constr):
    """(reference alu/mod.rs:62-83)."""
    for col in ALL_OPERATIONS:
        val = lv[col]
        yield_constr.constraint(alg.sub(alg.mul(val, val), val))

    eval_addition(alg, lv, yield_constr)
    eval_subtraction(alg, lv, yield_constr)
    eval_mul_add(alg, lv, yield_constr)
    eval_division(alg, lv, yield_constr)
    eval_bitop(alg, lv, yield_constr)
    eval_rotate_left(alg, lv, yield_constr)
    eval_rotate_right(alg, lv, yield_constr)
    eval_shift_left(alg, lv, yield_constr)
    eval_shift_right(alg, lv, yield_constr)
