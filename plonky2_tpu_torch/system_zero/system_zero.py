"""The System Zero STARK (the port's copy of
plonky2_tpu/system_zero/system_zero.py; reference
system_zero/src/system_zero.rs).

The trace is made column by column: the reference makes its 2^16 rows one
at a time (system_zero.rs:39-68), but its rows are idle (no ALU operation,
the permutation unit on zero inputs), so every column but the core
registers' and the lookups' is constant: one template row, broadcast.
The constraints are traced once into the quotient's constraint program
(stark/quotient_program.py) and run on K6.
"""
from __future__ import annotations

import numpy as np

from ..stark.stark import PermutationPair, Stark
from . import registers as R
from .alu import eval_alu, generate_alu
from .core_registers import (U16_MAX, eval_core_registers,
                             generate_first_row_core_registers)
from .lookup import eval_lookups, generate_lookups
from .permutation_unit import eval_permutation_unit, generate_permutation_unit

MIN_TRACE_ROWS = 1 << 16  # supports efficient 16-bit range checks


class SystemZero(Stark):
    COLUMNS = R.NUM_COLUMNS
    PUBLIC_INPUTS = R.NUM_PUBLIC_INPUTS

    def generate_trace(self, num_rows: int = MIN_TRACE_ROWS) -> np.ndarray:
        """(NUM_COLUMNS, num_rows) uint64 trace values."""
        if num_rows < MIN_TRACE_ROWS or num_rows & (num_rows - 1):
            raise ValueError(f"System Zero takes a power of two of at least "
                             f"{MIN_TRACE_ROWS} rows, got {num_rows}")

        # the template row: core registers zeroed, no ALU operation, the
        # permutation of zeros
        row = [0] * R.NUM_COLUMNS
        generate_first_row_core_registers(row)
        generate_alu(row)
        generate_permutation_unit(row)

        trace = np.zeros((R.NUM_COLUMNS, num_rows), dtype=np.uint64)
        trace[:] = np.array(row, dtype=np.uint64)[:, None]

        # the core registers vary by row
        clock = np.arange(num_rows, dtype=np.uint64)
        trace[R.COL_CLOCK] = clock
        trace[R.COL_RANGE_16] = np.minimum(clock, np.uint64(U16_MAX))

        generate_lookups(trace)
        return trace

    def eval(self, alg, vars, yield_constr) -> None:
        eval_core_registers(alg, vars, yield_constr)
        eval_alu(alg, vars.local_values, yield_constr)
        eval_permutation_unit(alg, vars, yield_constr)
        eval_lookups(alg, vars, yield_constr)

    def constraint_degree(self) -> int:
        return 3

    def permutation_pairs(self):
        pairs = []
        for i in range(R.NUM_LOOKUPS):
            pairs.append(PermutationPair.singletons(
                R.lookup_col_input(i), R.col_permuted_input(i)))
            pairs.append(PermutationPair.singletons(
                R.lookup_col_table(i), R.col_permuted_table(i)))
        return pairs
