"""Core registers: the clock and the 16-bit range-check table column (the
port's copy of plonky2_tpu/system_zero/core_registers.py; reference
system_zero/src/core_registers.rs)."""
from __future__ import annotations

from . import registers as R

U16_MAX = (1 << 16) - 1


def generate_first_row_core_registers(row) -> None:
    row[R.COL_CLOCK] = 0
    row[R.COL_RANGE_16] = 0
    row[R.COL_INSTRUCTION_PTR] = 0
    row[R.COL_FRAME_PTR] = 0
    row[R.COL_STACK_PTR] = 0


def generate_next_row_core_registers(local_row, next_row) -> None:
    next_row[R.COL_CLOCK] = local_row[R.COL_CLOCK] + 1
    next_row[R.COL_RANGE_16] = min(local_row[R.COL_RANGE_16] + 1, U16_MAX)


def eval_core_registers(alg, vars, yield_constr) -> None:
    local_clock = vars.local_values[R.COL_CLOCK]
    next_clock = vars.next_values[R.COL_CLOCK]
    delta_clock = alg.sub(next_clock, local_clock)
    yield_constr.constraint_first_row(local_clock)
    yield_constr.constraint_transition(alg.sub(delta_clock, alg.one()))

    local_range = vars.local_values[R.COL_RANGE_16]
    next_range = vars.next_values[R.COL_RANGE_16]
    delta_range = alg.sub(next_range, local_range)
    yield_constr.constraint_first_row(local_range)
    yield_constr.constraint_last_row(alg.add_const(local_range,
                                                   -U16_MAX))
    yield_constr.constraint_transition(
        alg.sub(alg.mul(delta_range, delta_range), delta_range))
