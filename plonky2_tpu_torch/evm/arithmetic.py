"""The arithmetic table: 256-bit ADD/SUB/MUL/LT/GT and the modular family
ADDMOD/SUBMOD/MULMOD/MOD/DIV in 16-bit limbs.  The port's copy of
plonky2_tpu/evm/arithmetic.py (reference evm/src/arithmetic/{columns,add,
sub,mul,compare,modular,utils,arithmetic_stark}.rs).

The check (reference mul.rs:1-60, modular.rs:1-110): a 256-bit value A
is a degree-15 polynomial a(x) of 16-bit coefficients, A = a(beta) at
beta = 2^16.  An identity like A*B = C (mod M) holds iff
operation(a, b)(x) - c(x) - q(x) m(x) is divisible by (x - beta), that
is iff it equals (x - beta) s(x) for the witnessed carry polynomial s.
Every constraint is then one of coefficients, in any algebra.

As in the JAX package, and unlike the reference, the product
mod_is_zero * IS_DIV is witnessed in a spare column of the second row
(DIV_DENOM_IS_ZERO, in the unused AUX_INPUT_0_LO range of row 2), so
every constraint has degree 3 or less (the reference's modular.rs:352-371
has degree 5).

With ``range_check`` the 48 limb columns that the CPU's lookups bind
(input0, input1 and the result of the one-row ops) are checked to be
16-bit by permuted-column lookups into a counter column (as
system_zero/lookup.py), which needs 2^16 rows or more; without it the
limbs' range is assumed, as the reference's no-op ``range_check_error!``
(utils.rs:10-31) assumes it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..field import goldilocks as gl
from ..stark.stark import PermutationPair, Stark
from ..system_zero.lookup import permuted_cols
from .cross_table_lookup import Column

LIMB_BITS = 16
N_LIMBS = 16  # 256 / 16
BASE = 1 << LIMB_BITS
MASK = BASE - 1

# --- column layout (reference arithmetic/columns.rs:25-117) ---------------

IS_ADD = 0
IS_MUL = 1
IS_SUB = 2
IS_DIV = 3
IS_MOD = 4
IS_ADDMOD = 5
IS_SUBMOD = 6
IS_MULMOD = 7
IS_LT = 8
IS_GT = 9
IS_SHL = 10
IS_SHR = 11

ALL_OPERATIONS = list(range(12))
START_SHARED_COLS = IS_SHR + 1
NUM_SHARED_COLS = 5 * N_LIMBS

GENERAL_INPUT_0 = range(START_SHARED_COLS, START_SHARED_COLS + N_LIMBS)
GENERAL_INPUT_1 = range(GENERAL_INPUT_0.stop, GENERAL_INPUT_0.stop + N_LIMBS)
GENERAL_INPUT_2 = range(GENERAL_INPUT_1.stop, GENERAL_INPUT_1.stop + N_LIMBS)
GENERAL_INPUT_3 = range(GENERAL_INPUT_2.stop, GENERAL_INPUT_2.stop + N_LIMBS)
AUX_INPUT_0_LO = range(GENERAL_INPUT_3.stop, GENERAL_INPUT_3.stop + N_LIMBS)

# Second-row registers for two-row (modular) ops overlap the general
# input ranges (columns.rs:60-70).
AUX_INPUT_0_HI = range(START_SHARED_COLS, START_SHARED_COLS + N_LIMBS)
AUX_INPUT_1 = range(AUX_INPUT_0_HI.stop, AUX_INPUT_0_HI.stop + 2 * N_LIMBS)
AUX_INPUT_2 = range(AUX_INPUT_1.stop, AUX_INPUT_1.stop + N_LIMBS)

ADD_INPUT_0 = SUB_INPUT_0 = MUL_INPUT_0 = CMP_INPUT_0 = GENERAL_INPUT_0
ADD_INPUT_1 = SUB_INPUT_1 = MUL_INPUT_1 = CMP_INPUT_1 = GENERAL_INPUT_1
ADD_OUTPUT = SUB_OUTPUT = MUL_OUTPUT = GENERAL_INPUT_2
MUL_AUX_INPUT = GENERAL_INPUT_3
CMP_OUTPUT = GENERAL_INPUT_2.start
CMP_AUX_INPUT = GENERAL_INPUT_3

MODULAR_INPUT_0 = GENERAL_INPUT_0
MODULAR_INPUT_1 = GENERAL_INPUT_1
MODULAR_MODULUS = GENERAL_INPUT_2
MODULAR_OUTPUT = GENERAL_INPUT_3
MODULAR_QUO_INPUT_LO = AUX_INPUT_0_LO
MODULAR_QUO_INPUT_HI = AUX_INPUT_0_HI           # second row
MODULAR_AUX_INPUT = range(AUX_INPUT_1.start, AUX_INPUT_1.stop - 1)  # row 2
MODULAR_MOD_IS_ZERO = AUX_INPUT_1.stop - 1      # second row
MODULAR_OUT_AUX_RED = AUX_INPUT_2               # second row
# Witnessed mod_is_zero*IS_DIV product (our degree-reduction column; lives
# in the wasted AUX_INPUT_0_LO slot of the second row — see module doc).
DIV_DENOM_IS_ZERO = AUX_INPUT_0_LO.start        # second row

DIV_NUMERATOR = MODULAR_INPUT_0
DIV_DENOMINATOR = MODULAR_MODULUS
DIV_OUTPUT = MODULAR_QUO_INPUT_LO

NUM_ARITH_COLUMNS = START_SHARED_COLS + NUM_SHARED_COLS

# --- 16-bit range-check extension (closes the reference's no-op
# ``range_check_error!`` hole, utils.rs:10-31; mechanism follows
# system_zero/src/lookup.rs permuted-column lookups).
#
# The CTL binds (input0, input1, result) = GENERAL_INPUT_0..2 on one-row
# op rows; an out-of-range limb there would forge a different 256-bit
# value through the lookup.  Each of those 48 limb columns gets a MASKED
# copy (limb * one-row-op filter — the aux ranges legitimately hold
# signed values on mul/modular rows and must not be range-checked), and
# each masked copy is looked up in a 0..2^16-1 counter column.  Enabling
# this requires trace height >= 2^16 so the counter can cover the table;
# it is therefore an option (production scale) rather than the default
# (unit-test scale), unlike the always-on system_zero lookup whose table
# is sized 2^16 by design.
RC_CHECKED_COLS = (list(GENERAL_INPUT_0) + list(GENERAL_INPUT_1)
                   + list(GENERAL_INPUT_2))
NUM_RC_CHECKED = len(RC_CHECKED_COLS)
RANGE_COUNTER = NUM_ARITH_COLUMNS


def rc_masked_col(i: int) -> int:
    return RANGE_COUNTER + 1 + i


def rc_perm_input_col(i: int) -> int:
    return RANGE_COUNTER + 1 + NUM_RC_CHECKED + 2 * i


def rc_perm_table_col(i: int) -> int:
    return rc_perm_input_col(i) + 1


NUM_ARITH_RC_COLUMNS = RANGE_COUNTER + 1 + 3 * NUM_RC_CHECKED
RC_MIN_ROWS = 1 << LIMB_BITS


# --- limb codecs ----------------------------------------------------------

def to_limbs(v: int, n: int = N_LIMBS) -> List[int]:
    return [(v >> (LIMB_BITS * i)) & MASK for i in range(n)]


def signed_to_limbs(v: int, n: int) -> List[int]:
    """Signed limb expansion (reference modular.rs bigint_to_columns):
    limbs of |v|, all negated if v < 0."""
    if abs(v) >= 1 << (LIMB_BITS * n):
        raise ValueError(f"{v} does not fit {n} limbs")
    limbs = to_limbs(abs(v), n)
    return [-c for c in limbs] if v < 0 else limbs


def eval_limbs(limbs) -> int:
    """Polynomial evaluation at β (reference modular.rs columns_to_bigint)."""
    return sum(int(c) << (LIMB_BITS * i) for i, c in enumerate(limbs))


# --- integer polynomial helpers (reference arithmetic/utils.rs) -----------

def pol_mul_lo_int(a: List[int], b: List[int]) -> List[int]:
    n = len(a)
    return [sum(a[i] * b[d - i] for i in range(d + 1)) for d in range(n)]


def pol_mul_wide_int(a: List[int], b: List[int]) -> List[int]:
    res = [0] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            res[i + j] += ai * bj
    return res


def pol_remove_root_2exp_int(a: List[int], exp: int = LIMB_BITS) -> List[int]:
    """Divide a(x) by (x - 2^exp), which must be exact; last element left 0
    (reference utils.rs:343-368)."""
    n = len(a)
    q = [0] * n
    q[0] = -(a[0] >> exp)
    for deg in range(1, n - 1):
        q[deg] = (q[deg - 1] - a[deg]) >> exp
    return q


# --- operations -----------------------------------------------------------

_FLAG_OF = {"add": IS_ADD, "mul": IS_MUL, "sub": IS_SUB, "div": IS_DIV,
            "mod": IS_MOD, "addmod": IS_ADDMOD, "submod": IS_SUBMOD,
            "mulmod": IS_MULMOD, "lt": IS_LT, "gt": IS_GT}
MODULAR_OPS = ("addmod", "submod", "mulmod", "mod", "div")
U256 = 1 << 256


@dataclass
class Operation:
    op: str
    input0: int
    input1: int = 0
    modulus: Optional[int] = None  # modular family only

    @property
    def result(self) -> int:
        """EVM semantics ground truth (python ints)."""
        a, b, m = self.input0, self.input1, self.modulus
        if self.op == "add":
            return (a + b) % U256
        if self.op == "sub":
            return (a - b) % U256
        if self.op == "mul":
            return (a * b) % U256
        if self.op == "lt":
            return int(a < b)
        if self.op == "gt":
            return int(a > b)
        if self.op == "div":
            return a // m if m else 0
        if m == 0:
            return 0  # EVM: x mod 0 = 0
        if self.op == "addmod":
            return (a + b) % m
        if self.op == "submod":
            return (a - b) % m
        if self.op == "mulmod":
            return (a * b) % m
        if self.op == "mod":
            return a % m
        raise ValueError(self.op)

    def num_rows(self) -> int:
        return 2 if self.op in MODULAR_OPS else 1


# one-row ops the CPU cross-table lookup binds
CTL_OPS = [IS_ADD, IS_MUL, IS_SUB, IS_LT, IS_GT]
# ternary modular ops the CPU executes (ADDMOD/MULMOD opcodes); all four
# payload operands (a, b, m, out) live on the FIRST row of the 2-row pair
TERNARY_CTL_OPS = [IS_ADDMOD, IS_MULMOD]


def _u32_limb_cols(rng) -> List[Column]:
    """The table stores 16-bit limbs while the CPU's memory channels carry
    32-bit limbs; each payload limb is lo + 2^16·hi so the lookup compares
    values in the CPU's basis."""
    return [Column([(rng[2 * i], 1), (rng[2 * i + 1], 1 << LIMB_BITS)])
            for i in range(N_LIMBS // 2)]


def ctl_data() -> List[Column]:
    """Looked-up row shape for the CPU's arithmetic lookup: the one-row op
    flags, then input0/input1/output.  (The reference ships this table
    unconnected; there is no upstream analogue of this CTL.)"""
    cols = Column.singles(CTL_OPS)
    for rng in (GENERAL_INPUT_0, GENERAL_INPUT_1, GENERAL_INPUT_2):
        cols += _u32_limb_cols(rng)
    return cols


def ctl_filter() -> Column:
    return Column.sum_cols(CTL_OPS)


def ctl_data_ternary() -> List[Column]:
    """ADDMOD/MULMOD lookup payload: op flags + (a, b, modulus, output),
    all first-row registers (MODULAR_OUTPUT = GENERAL_INPUT_3)."""
    cols = Column.singles(TERNARY_CTL_OPS)
    for rng in (MODULAR_INPUT_0, MODULAR_INPUT_1, MODULAR_MODULUS,
                MODULAR_OUTPUT):
        cols += _u32_limb_cols(rng)
    return cols


def ctl_filter_ternary() -> Column:
    return Column.sum_cols(TERNARY_CTL_OPS)


def ctl_data_div() -> List[Column]:
    """DIV lookup payload: (numerator, denominator, quotient); the quotient
    is the modular path's first-row QUO_INPUT_LO register."""
    return (_u32_limb_cols(DIV_NUMERATOR) + _u32_limb_cols(DIV_DENOMINATOR)
            + _u32_limb_cols(DIV_OUTPUT))


def ctl_filter_div() -> Column:
    return Column.single(IS_DIV)


def ctl_data_mod() -> List[Column]:
    """MOD lookup payload: (value, modulus, residue=MODULAR_OUTPUT)."""
    return (_u32_limb_cols(MODULAR_INPUT_0) + _u32_limb_cols(MODULAR_MODULUS)
            + _u32_limb_cols(MODULAR_OUTPUT))


def ctl_filter_mod() -> Column:
    return Column.single(IS_MOD)


class ArithmeticStark(Stark):
    COLUMNS = NUM_ARITH_COLUMNS
    PUBLIC_INPUTS = 0

    def __init__(self, range_check: bool = False):
        """With ``range_check``, the CTL-bound limb columns are 16-bit
        range-checked via permuted-column lookups (see RC_CHECKED_COLS
        comment); requires traces of height >= 2^16."""
        self.range_check = range_check
        if range_check:
            self.COLUMNS = NUM_ARITH_RC_COLUMNS

    # --- trace generation (exact python-int arithmetic) -------------------

    def generate_trace(self, operations: List[Operation],
                       min_rows: int = 8) -> np.ndarray:
        rows_needed = sum(op.num_rows() for op in operations)
        if self.range_check:
            min_rows = max(min_rows, RC_MIN_ROWS)
        n = max(rows_needed, min_rows)
        n = 1 << (n - 1).bit_length()
        # keep a padding row, so that no modular op sits on the last row
        # (its constraints read the next row)
        if rows_needed == n and any(o.op in MODULAR_OPS for o in operations):
            n *= 2
        trace = np.zeros((self.COLUMNS, n), dtype=np.uint64)
        j = 0
        for op in operations:
            self._generate_row(trace, j, op)
            j += op.num_rows()
        if self.range_check:
            self._generate_range_check(trace)
        return trace

    def _generate_range_check(self, trace: np.ndarray) -> None:
        n = trace.shape[1]
        if n < RC_MIN_ROWS:
            raise ValueError("range_check needs 2^16 rows or more")
        clock = np.arange(n, dtype=np.uint64)
        trace[RANGE_COUNTER] = np.minimum(clock, np.uint64(MASK))
        filt = trace[CTL_OPS].sum(axis=0)       # one-row CTL-bound ops
        for i, col in enumerate(RC_CHECKED_COLS):
            masked = np.where(filt != 0, trace[col], 0).astype(np.uint64)
            trace[rc_masked_col(i)] = masked
            pi, pt = permuted_cols(masked, trace[RANGE_COUNTER])
            trace[rc_perm_input_col(i)] = pi
            trace[rc_perm_table_col(i)] = pt

    def _generate_row(self, trace: np.ndarray, j: int, op: Operation):
        trace[_FLAG_OF[op.op], j] = 1
        a, b = op.input0, op.input1
        if op.op in ("add", "sub", "mul"):
            self._set(trace, j, GENERAL_INPUT_0, to_limbs(a))
            self._set(trace, j, GENERAL_INPUT_1, to_limbs(b))
            self._set(trace, j, GENERAL_INPUT_2, to_limbs(op.result))
            if op.op == "mul":
                self._gen_mul_aux(trace, j, a, b)
        elif op.op in ("lt", "gt"):
            self._set(trace, j, CMP_INPUT_0, to_limbs(a))
            self._set(trace, j, CMP_INPUT_1, to_limbs(b))
            hi, lo = (b, a) if op.op == "lt" else (a, b)
            # lo - hi == diff + borrow * 2^256 (reference compare.rs:29-44)
            self._set(trace, j, CMP_AUX_INPUT, to_limbs((lo - hi) % U256))
            trace[CMP_OUTPUT, j] = op.result
        elif op.op in MODULAR_OPS:
            self._gen_modular(trace, j, op)
        else:
            raise ValueError(op.op)

    def _gen_mul_aux(self, trace: np.ndarray, j: int, a: int, b: int):
        """s(x) with a(x)b(x) - c(x) = (x - beta)s(x) (mul.rs:70-100)."""
        unreduced = pol_mul_lo_int(to_limbs(a), to_limbs(b))
        out, cy = [0] * N_LIMBS, 0
        for col in range(N_LIMBS):
            t = unreduced[col] + cy
            cy = t >> LIMB_BITS
            out[col] = t & MASK
        aux = pol_remove_root_2exp_int([u - o for u, o in
                                        zip(unreduced, out)])
        aux[N_LIMBS - 1] = -cy
        self._set(trace, j, MUL_AUX_INPUT, aux)

    def _gen_modular(self, trace: np.ndarray, j: int, op: Operation):
        """(reference modular.rs:192-290)."""
        a, b = op.input0, op.input1
        modulus = op.modulus or 0
        a_l, b_l = to_limbs(a), to_limbs(b)
        mod_l = to_limbs(modulus)
        self._set(trace, j, MODULAR_INPUT_0, a_l)
        self._set(trace, j, MODULAR_INPUT_1, b_l)
        self._set(trace, j, MODULAR_MODULUS, mod_l)

        if op.op == "addmod":
            op_poly = [x + y for x, y in zip(a_l, b_l)] + [0] * (N_LIMBS - 1)
        elif op.op == "submod":
            op_poly = [x - y for x, y in zip(a_l, b_l)] + [0] * (N_LIMBS - 1)
        elif op.op == "mulmod":
            op_poly = pol_mul_wide_int(a_l, b_l)
        else:  # mod / div: operation(a, b) = a
            op_poly = a_l + [0] * (N_LIMBS - 1)

        mod_is_zero = 0
        if modulus == 0:
            mod_is_zero = 1
            if op.op == "div":
                modulus = U256            # forces quotient a // 2^256 = 0
            else:
                modulus = 1               # forces output 0
                mod_l = [1] + mod_l[1:]

        input_int = eval_limbs(op_poly)   # negative for some submods
        output = input_int % modulus      # canonical, non-negative
        quot = (input_int - output) // modulus  # exact; may be negative
        out_l = to_limbs(output)
        quot_l = signed_to_limbs(quot, 2 * N_LIMBS)
        out_aux_red = to_limbs(U256 + output - modulus)

        constr = op_poly + [0]            # length 2N
        constr = [c - o for c, o in
                  zip(constr, out_l + [0] * N_LIMBS)]
        prod = pol_mul_wide_int(quot_l, mod_l)
        if any(prod[2 * N_LIMBS:]):
            raise ArithmeticError("the quotient times the modulus "
                                  "overflows 2N limbs")
        constr = [c - p for c, p in zip(constr, prod[:2 * N_LIMBS])]
        aux = pol_remove_root_2exp_int(constr)

        self._set(trace, j, MODULAR_OUTPUT, out_l)
        self._set(trace, j, MODULAR_QUO_INPUT_LO, quot_l[:N_LIMBS])
        self._set(trace, j + 1, MODULAR_QUO_INPUT_HI, quot_l[N_LIMBS:])
        self._set(trace, j + 1, MODULAR_AUX_INPUT, aux[:2 * N_LIMBS - 1])
        trace[MODULAR_MOD_IS_ZERO, j + 1] = mod_is_zero
        self._set(trace, j + 1, MODULAR_OUT_AUX_RED, out_aux_red)
        trace[DIV_DENOM_IS_ZERO, j + 1] = mod_is_zero * (op.op == "div")

    @staticmethod
    def _set(trace: np.ndarray, j: int, cols: range, vals: List[int]):
        for c, v in zip(cols, vals):
            trace[c, j] = v % gl.P

    # --- constraints ------------------------------------------------------

    def eval(self, alg, vars, yield_constr) -> None:
        lv, nv = vars.local_values, vars.next_values
        self._eval_add(alg, lv, yield_constr)
        self._eval_sub(alg, lv, yield_constr)
        self._eval_mul(alg, lv, yield_constr)
        self._eval_cmp(alg, lv, yield_constr)
        self._eval_modular(alg, lv, nv, yield_constr)
        if self.range_check:
            self._eval_range_check(alg, vars, yield_constr)

    def _eval_range_check(self, alg, vars, yield_constr) -> None:
        """Counter column + Halo2 permuted-column lookups
        (system_zero/src/lookup.rs:107-131)."""
        lv, nv = vars.local_values, vars.next_values
        one = alg.one()
        c, cn = lv[RANGE_COUNTER], nv[RANGE_COUNTER]
        yield_constr.constraint_first_row(c)
        delta = alg.sub(cn, c)
        yield_constr.constraint_transition(
            alg.mul(delta, alg.sub(delta, one)))
        yield_constr.constraint_last_row(alg.add_const(c, gl.P - MASK))

        filt = None
        for f in CTL_OPS:
            filt = lv[f] if filt is None else alg.add(filt, lv[f])
        for i, col in enumerate(RC_CHECKED_COLS):
            # masked copy is limb * filter (aux rows contribute 0)
            yield_constr.constraint(alg.sub(lv[rc_masked_col(i)],
                                            alg.mul(filt, lv[col])))
            local_pi = lv[rc_perm_input_col(i)]
            next_pi = nv[rc_perm_input_col(i)]
            next_pt = nv[rc_perm_table_col(i)]
            diff_prev = alg.sub(next_pi, local_pi)
            diff_tab = alg.sub(next_pi, next_pt)
            yield_constr.constraint(alg.mul(diff_prev, diff_tab))
            yield_constr.constraint_last_row(diff_tab)

    def permutation_pairs(self):
        if not self.range_check:
            return []
        pairs = []
        for i in range(NUM_RC_CHECKED):
            pairs.append(PermutationPair.singletons(rc_masked_col(i),
                                                    rc_perm_input_col(i)))
            pairs.append(PermutationPair.singletons(RANGE_COUNTER,
                                                    rc_perm_table_col(i)))
        return pairs

    def _are_equal(self, alg, yield_constr, is_op, larger, smaller,
                   is_two_row_op: bool):
        """Carry-propagating limb equality: for each limb, t = cy + a - b
        must be 0 or 2^16; the carry out is t/2^16
        (reference add.rs:31-70)."""
        inv = pow(BASE, gl.P - 2, gl.P)
        cy = alg.zero()
        for x, y in zip(larger, smaller):
            t = alg.sub(alg.add(cy, x), y)
            c = alg.mul(is_op, alg.mul(t, alg.sub(alg.const(BASE), t)))
            if is_two_row_op:
                yield_constr.constraint_transition(c)
            else:
                yield_constr.constraint(c)
            cy = alg.mul_const(t, inv)
        return cy

    def _eval_add(self, alg, lv, yield_constr):
        """(reference add.rs:108-140)."""
        is_add = lv[IS_ADD]
        computed = [alg.add(lv[i], lv[j])
                    for i, j in zip(ADD_INPUT_0, ADD_INPUT_1)]
        self._are_equal(alg, yield_constr, is_add, computed,
                        [lv[i] for i in ADD_OUTPUT], False)

    def _eval_sub(self, alg, lv, yield_constr):
        """(reference sub.rs:40-62)."""
        is_sub = lv[IS_SUB]
        computed = [alg.sub(lv[i], lv[j])
                    for i, j in zip(SUB_INPUT_0, SUB_INPUT_1)]
        self._are_equal(alg, yield_constr, is_sub,
                        [lv[i] for i in SUB_OUTPUT], computed, False)

    def _eval_mul(self, alg, lv, yield_constr):
        """a(x)b(x) - c(x) - (x-β)s(x) == 0 coefficient-wise
        (reference mul.rs:102-146)."""
        is_mul = lv[IS_MUL]
        a = [lv[i] for i in MUL_INPUT_0]
        b = [lv[i] for i in MUL_INPUT_1]
        out = [lv[i] for i in MUL_OUTPUT]
        aux = [lv[i] for i in MUL_AUX_INPUT]

        constr = self._pol_mul_lo(alg, a, b)
        constr = [alg.sub(c, o) for c, o in zip(constr, out)]
        rhs = self._pol_adjoin_root(alg, aux)
        constr = [alg.sub(c, r) for c, r in zip(constr, rhs)]
        for c in constr:
            yield_constr.constraint(alg.mul(is_mul, c))

    def _eval_lt(self, alg, yield_constr, is_op, input0, input1, aux,
                 output, is_two_row_op: bool):
        """input0 - input1 == aux + output·2^256 (reference
        compare.rs:53-81)."""
        lhs = [alg.sub(x, y) for x, y in zip(input0, input1)]
        cy = self._are_equal(alg, yield_constr, is_op, aux, lhs,
                             is_two_row_op)
        c = alg.mul(is_op, alg.sub(cy, output))
        if is_two_row_op:
            yield_constr.constraint_transition(c)
        else:
            yield_constr.constraint(c)

    def _eval_cmp(self, alg, lv, yield_constr):
        """(reference compare.rs:83-105)."""
        is_lt, is_gt = lv[IS_LT], lv[IS_GT]
        input0 = [lv[i] for i in CMP_INPUT_0]
        input1 = [lv[i] for i in CMP_INPUT_1]
        aux = [lv[i] for i in CMP_AUX_INPUT]
        output = lv[CMP_OUTPUT]

        is_cmp = alg.add(is_lt, is_gt)
        yield_constr.constraint(
            alg.mul(is_cmp, alg.mul(output, alg.sub(output, alg.one()))))
        self._eval_lt(alg, yield_constr, is_lt, input0, input1, aux,
                      output, False)
        self._eval_lt(alg, yield_constr, is_gt, input1, input0, aux,
                      output, False)

    def _eval_modular(self, alg, lv, nv, yield_constr):
        """(reference modular.rs:305-459; degree-5 fix per module doc)."""
        filt = lv[IS_ADDMOD]
        for f in (IS_MULMOD, IS_MOD, IS_SUBMOD, IS_DIV):
            filt = alg.add(filt, lv[f])
        # a modular op reads nv, so it can't sit on the last row
        yield_constr.constraint_last_row(filt)

        modulus = [lv[i] for i in MODULAR_MODULUS]
        mod_is_zero = nv[MODULAR_MOD_IS_ZERO]

        # mod_is_zero ∈ {0,1}, and zero whenever the modulus is non-zero
        yield_constr.constraint_transition(alg.mul(
            filt, alg.sub(alg.mul(mod_is_zero, mod_is_zero), mod_is_zero)))
        limb_sum = modulus[0]
        for m in modulus[1:]:
            limb_sum = alg.add(limb_sum, m)
        yield_constr.constraint_transition(
            alg.mul(filt, alg.mul(limb_sum, mod_is_zero)))
        modulus = [alg.add(modulus[0], mod_is_zero)] + modulus[1:]

        # d witnesses mod_is_zero·IS_DIV (our degree-reduction column)
        d = nv[DIV_DENOM_IS_ZERO]
        yield_constr.constraint_transition(alg.mul(
            filt, alg.sub(d, alg.mul(mod_is_zero, lv[IS_DIV]))))

        output = [lv[i] for i in MODULAR_OUTPUT]
        # For DIV with zero denominator, modulus was bumped to 1 while the
        # claimed remainder equals the numerator; compensate limb 0 and
        # drop the borrow so output-modulus == out_aux_red still balances.
        shifted0 = alg.add(output[0], d)
        is_less_than = alg.sub(alg.one(), d)
        out_aux_red = [nv[i] for i in MODULAR_OUT_AUX_RED]
        self._eval_lt(alg, yield_constr, filt,
                      [shifted0] + output[1:], modulus, out_aux_red,
                      is_less_than, True)

        quot = [lv[i] for i in MODULAR_QUO_INPUT_LO] + \
               [nv[i] for i in MODULAR_QUO_INPUT_HI]
        prod = self._pol_mul_wide(alg, quot, modulus)
        for x in prod[2 * N_LIMBS:]:
            yield_constr.constraint_transition(alg.mul(filt, x))

        constr = prod[:2 * N_LIMBS]
        constr = [alg.add(c, o) for c, o in
                  zip(constr, output)] + constr[N_LIMBS:]
        aux = [nv[i] for i in MODULAR_AUX_INPUT] + [alg.zero()]
        root_part = self._pol_adjoin_root(alg, aux)
        constr = [alg.add(c, r) for c, r in zip(constr, root_part)]

        input0 = [lv[i] for i in MODULAR_INPUT_0]
        input1 = [lv[i] for i in MODULAR_INPUT_1]
        zeros = [alg.zero()] * (N_LIMBS - 1)
        add_input = [alg.add(x, y) for x, y in zip(input0, input1)] + zeros
        sub_input = [alg.sub(x, y) for x, y in zip(input0, input1)] + zeros
        mul_input = self._pol_mul_wide(alg, input0, input1)
        mod_input = input0 + zeros

        for inp, f in ((add_input, lv[IS_ADDMOD]),
                       (sub_input, lv[IS_SUBMOD]),
                       (mul_input, lv[IS_MULMOD]),
                       (mod_input, alg.add(lv[IS_MOD], lv[IS_DIV]))):
            inp = list(inp) + [alg.zero()] * (2 * N_LIMBS - len(inp))
            for c, i in zip(constr, inp):
                yield_constr.constraint_transition(
                    alg.mul(f, alg.sub(c, i)))

    # --- algebra-generic polynomial helpers (reference utils.rs) ----------

    @staticmethod
    def _pol_mul_lo(alg, a, b):
        n = len(a)
        res = []
        for deg in range(n):
            acc = alg.zero()
            for i in range(deg + 1):
                acc = alg.add(acc, alg.mul(a[i], b[deg - i]))
            res.append(acc)
        return res

    @staticmethod
    def _pol_mul_wide(alg, a, b):
        res = [alg.zero()] * (len(a) + len(b) - 1)
        for i, ai in enumerate(a):
            for j, bj in enumerate(b):
                res[i + j] = alg.add(res[i + j], alg.mul(ai, bj))
        return res

    @staticmethod
    def _pol_adjoin_root(alg, a):
        """(x - β)·a(x) (reference utils.rs:297-312)."""
        res = [alg.mul_const(alg.neg(a[0]), BASE)]
        for deg in range(1, len(a)):
            res.append(alg.sub(a[deg - 1], alg.mul_const(a[deg], BASE)))
        return res

    def constraint_degree(self) -> int:
        return 3
