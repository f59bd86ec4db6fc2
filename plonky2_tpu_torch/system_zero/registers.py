"""System Zero's column layout (the port's copy of
plonky2_tpu/system_zero/registers.py; reference
system_zero/src/registers/*.rs)."""
from __future__ import annotations

from ..hash import poseidon as pos

# -- ALU (registers/alu.rs) ---------------------------------------------------

START_ALU = 0
IS_ADD = START_ALU
IS_SUB = IS_ADD + 1
IS_MUL_ADD = IS_SUB + 1
IS_DIV = IS_MUL_ADD + 1
IS_AND = IS_DIV + 1
IS_IOR = IS_AND + 1
IS_XOR = IS_IOR + 1
IS_ANDNOT = IS_XOR + 1
IS_NOT = IS_ANDNOT + 1
IS_ROTATE_LEFT = IS_NOT + 1
IS_ROTATE_RIGHT = IS_ROTATE_LEFT + 1
IS_SHIFT_LEFT = IS_ROTATE_RIGHT + 1
IS_SHIFT_RIGHT = IS_SHIFT_LEFT + 1
IS_ARITH_SHIFT_RIGHT = IS_SHIFT_RIGHT + 1

ALL_OPERATIONS = [IS_ADD, IS_SUB, IS_MUL_ADD, IS_DIV, IS_AND, IS_IOR, IS_XOR,
                  IS_ANDNOT, IS_NOT, IS_ROTATE_LEFT, IS_ROTATE_RIGHT,
                  IS_SHIFT_LEFT, IS_SHIFT_RIGHT, IS_ARITH_SHIFT_RIGHT]

START_SHARED_COLS = IS_ARITH_SHIFT_RIGHT + 1
NUM_SHARED_COLS = 130


def shared_col(i: int) -> int:
    assert i < NUM_SHARED_COLS
    return START_SHARED_COLS + i


END_ALU = START_SHARED_COLS + NUM_SHARED_COLS

# -- Boolean unit (registers/boolean.rs) --------------------------------------

START_BOOLEAN = END_ALU
NUM_BITS = 128


def col_bit(index: int) -> int:
    assert index < NUM_BITS
    return START_BOOLEAN + index


END_BOOLEAN = START_BOOLEAN + NUM_BITS

# -- Core registers (registers/core.rs) ---------------------------------------

START_CORE = END_BOOLEAN
COL_CLOCK = START_CORE
COL_RANGE_16 = COL_CLOCK + 1
COL_INSTRUCTION_PTR = COL_RANGE_16 + 1
COL_FRAME_PTR = COL_INSTRUCTION_PTR + 1
COL_STACK_PTR = COL_FRAME_PTR + 1
END_CORE = COL_STACK_PTR + 1

# -- Logic unit (registers/logic.rs — empty) ----------------------------------

START_LOGIC = END_CORE
END_LOGIC = START_LOGIC

# -- Range check units (registers/range_check_16.rs, range_check_degree.rs) ---
# (declared out of order because the lookup unit references them)

NUM_RANGE_CHECKS_16 = 6
NUM_RANGE_CHECKS_DEGREE = 5

# -- Lookup unit (registers/lookup.rs) ----------------------------------------

START_LOOKUP = END_LOGIC
NUM_LOOKUPS = NUM_RANGE_CHECKS_16 + NUM_RANGE_CHECKS_DEGREE


def col_permuted_input(i: int) -> int:
    assert i < NUM_LOOKUPS
    return START_LOOKUP + 2 * i


def col_permuted_table(i: int) -> int:
    assert i < NUM_LOOKUPS
    return START_LOOKUP + 2 * i + 1


END_LOOKUP = START_LOOKUP + NUM_LOOKUPS * 2

# -- Memory unit (registers/memory.rs — empty) --------------------------------

START_MEMORY = END_LOOKUP
END_MEMORY = START_MEMORY

# -- Permutation unit (registers/permutation.rs) ------------------------------

START_PERMUTATION = END_MEMORY
_W = pos.WIDTH
START_FULL_FIRST = START_PERMUTATION + _W


def col_perm_input(i: int) -> int:
    return START_PERMUTATION + i


def col_full_first_mid_sbox(round_: int, i: int) -> int:
    return START_FULL_FIRST + 2 * round_ * _W + i


def col_full_first_after_mds(round_: int, i: int) -> int:
    return START_FULL_FIRST + (2 * round_ + 1) * _W + i


START_PARTIAL = col_full_first_after_mds(pos.HALF_N_FULL_ROUNDS - 1,
                                         _W - 1) + 1


def col_partial_mid_sbox(round_: int) -> int:
    return START_PARTIAL + 2 * round_


def col_partial_after_sbox(round_: int) -> int:
    return START_PARTIAL + 2 * round_ + 1


START_FULL_SECOND = col_partial_after_sbox(pos.N_PARTIAL_ROUNDS - 1) + 1


def col_full_second_mid_sbox(round_: int, i: int) -> int:
    return START_FULL_SECOND + 2 * round_ * _W + i


def col_full_second_after_mds(round_: int, i: int) -> int:
    return START_FULL_SECOND + (2 * round_ + 1) * _W + i


def col_perm_output(i: int) -> int:
    return col_full_second_after_mds(pos.HALF_N_FULL_ROUNDS - 1, i)


END_PERMUTATION = col_perm_output(_W - 1) + 1

# -- Range checks -------------------------------------------------------------

START_RANGE_CHECK_16 = END_PERMUTATION


def col_rc_16_input(i: int) -> int:
    assert i < NUM_RANGE_CHECKS_16
    return START_RANGE_CHECK_16 + i


END_RANGE_CHECK_16 = START_RANGE_CHECK_16 + NUM_RANGE_CHECKS_16

START_RANGE_CHECK_DEGREE = END_RANGE_CHECK_16


def col_rc_degree_input(i: int) -> int:
    assert i < NUM_RANGE_CHECKS_DEGREE
    return START_RANGE_CHECK_DEGREE + i


END_RANGE_CHECK_DEGREE = START_RANGE_CHECK_DEGREE + NUM_RANGE_CHECKS_DEGREE

NUM_COLUMNS = END_RANGE_CHECK_DEGREE


def lookup_col_input(i: int) -> int:
    if i < NUM_RANGE_CHECKS_16:
        return col_rc_16_input(i)
    return col_rc_degree_input(i - NUM_RANGE_CHECKS_16)


def lookup_col_table(i: int) -> int:
    return COL_RANGE_16 if i < NUM_RANGE_CHECKS_16 else COL_CLOCK


# -- ALU shared-column aliases (registers/alu.rs:48-200) ----------------------

COL_ADD_INPUT_0 = shared_col(0)
COL_ADD_INPUT_1 = shared_col(1)
COL_ADD_INPUT_2 = shared_col(2)
COL_ADD_OUTPUT_0 = col_rc_16_input(0)
COL_ADD_OUTPUT_1 = col_rc_16_input(1)
COL_ADD_OUTPUT_2 = col_rc_16_input(2)

COL_SUB_INPUT_0 = shared_col(0)
COL_SUB_INPUT_1 = shared_col(1)
COL_SUB_OUTPUT_0 = col_rc_16_input(0)
COL_SUB_OUTPUT_1 = col_rc_16_input(1)
COL_SUB_OUTPUT_BORROW = col_bit(0)

COL_MUL_ADD_FACTOR_0 = shared_col(0)
COL_MUL_ADD_FACTOR_1 = shared_col(1)
COL_MUL_ADD_ADDEND = shared_col(2)
COL_MUL_ADD_RESULT_CANONICAL_INV = shared_col(3)
# witnessed hi_not_max = inv*(u32max - hi) - 1, so the canonical check can be
# filtered by IS_MUL_ADD while staying at degree 3 (the reference leaves the
# check unfiltered with a TODO, alu/mul_add.rs:51)
COL_MUL_ADD_CANONICAL_AUX = shared_col(4)
COL_MUL_ADD_OUTPUT_0 = col_rc_16_input(0)
COL_MUL_ADD_OUTPUT_1 = col_rc_16_input(1)
COL_MUL_ADD_OUTPUT_2 = col_rc_16_input(2)
COL_MUL_ADD_OUTPUT_3 = col_rc_16_input(3)

COL_DIV_INPUT_DIVIDEND = shared_col(0)
COL_DIV_INPUT_DIVISOR = shared_col(1)
COL_DIV_INVDIVISOR = shared_col(2)
COL_DIV_NONZERO_DIVISOR = shared_col(3)
COL_DIV_OUTPUT_QUOT_0 = col_rc_16_input(0)
COL_DIV_OUTPUT_QUOT_1 = col_rc_16_input(1)
COL_DIV_OUTPUT_REM_0 = col_rc_16_input(2)
COL_DIV_OUTPUT_REM_1 = col_rc_16_input(3)
COL_DIV_RANGE_CHECKED_TMP_0 = col_rc_16_input(4)
COL_DIV_RANGE_CHECKED_TMP_1 = col_rc_16_input(5)

COL_BIT_DECOMP_INPUT_A_LO_BIN_REGS = [shared_col(i) for i in range(32)]
COL_BIT_DECOMP_INPUT_A_HI_BIN_REGS = [shared_col(32 + i) for i in range(32)]
COL_BIT_DECOMP_INPUT_B_LO_BIN_REGS = [shared_col(64 + i) for i in range(32)]
COL_BIT_DECOMP_INPUT_B_HI_BIN_REGS = [shared_col(96 + i) for i in range(32)]
COL_BITOP_OUTPUT_0 = shared_col(128)
COL_BITOP_OUTPUT_1 = shared_col(129)

COL_ROTATE_SHIFT_INPUT_LO = shared_col(0)
COL_ROTATE_SHIFT_INPUT_HI = shared_col(1)
COL_ROTATE_SHIFT_EXP_BITS = [shared_col(2 + i) for i in range(5)]
COL_ROTATE_SHIFT_DELTA_DIV32 = shared_col(7)
COL_ROTATE_SHIFT_POW_EXP_AUX_0 = shared_col(8)
COL_ROTATE_SHIFT_POW_EXP_AUX_1 = shared_col(9)
COL_ROTATE_SHIFT_POW_EXP_AUX_2 = shared_col(10)
COL_ROTATE_SHIFT_POW_EXP = shared_col(11)
COL_ROTATE_SHIFT_INPUT_LO_DISPLACED_0 = shared_col(12)
COL_ROTATE_SHIFT_INPUT_LO_DISPLACED_1 = shared_col(13)
COL_ROTATE_SHIFT_INPUT_HI_DISPLACED_0 = shared_col(14)
COL_ROTATE_SHIFT_INPUT_HI_DISPLACED_1 = shared_col(15)
COL_ROTATE_SHIFT_INPUT_LO_DISPLACED_AUX_0 = shared_col(16)
COL_ROTATE_SHIFT_INPUT_LO_DISPLACED_AUX_1 = shared_col(17)
COL_ROTATE_SHIFT_INPUT_HI_DISPLACED_AUX_0 = shared_col(18)
COL_ROTATE_SHIFT_INPUT_HI_DISPLACED_AUX_1 = shared_col(19)
COL_ROTATE_SHIFT_OUTPUT_0 = shared_col(20)
COL_ROTATE_SHIFT_OUTPUT_1 = shared_col(21)

# -- public inputs (public_input_layout.rs) -----------------------------------

PI_OLD_STATE_ROOT = 0
PI_NEW_STATE_ROOT = 1
NUM_PUBLIC_INPUTS = 2
