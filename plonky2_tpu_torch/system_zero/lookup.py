"""The Halo2-style lookup argument by permuted columns: the port's copy of
plonky2_tpu/system_zero/lookup.py (reference system_zero/src/lookup.rs).
``permuted_cols`` serves System Zero and evm/memory.py."""
from __future__ import annotations

import numpy as np

from . import registers as R


def permuted_cols(inputs: np.ndarray, table: np.ndarray):
    """(permuted inputs, permuted table) for the lookup argument: the
    inputs sorted, and the table permuted so that each run of equal inputs
    starts beside the same table value."""
    n = inputs.shape[0]
    sorted_inputs = np.sort(inputs.astype(np.uint64))
    sorted_table = np.sort(table.astype(np.uint64))

    unused_table_inds = []
    unused_table_vals = []
    permuted_table = np.zeros(n, dtype=np.uint64)
    i = j = 0
    si, st = sorted_inputs.tolist(), sorted_table.tolist()
    while j < n and i < n:
        if si[i] > st[j]:
            unused_table_vals.append(st[j])
            j += 1
        elif si[i] < st[j]:
            if unused_table_vals:
                permuted_table[i] = unused_table_vals.pop()
            else:
                unused_table_inds.append(i)
            i += 1
        else:
            permuted_table[i] = st[j]
            i += 1
            j += 1
    unused_table_vals.extend(st[j:n])
    unused_table_inds.extend(range(i, n))
    for ind, val in zip(unused_table_inds, unused_table_vals):
        permuted_table[ind] = val
    return sorted_inputs, permuted_table


def generate_lookups(trace_cols: np.ndarray) -> None:
    """trace_cols: (NUM_COLUMNS, n); fills the permuted columns in place."""
    for i in range(R.NUM_LOOKUPS):
        pi, pt = permuted_cols(trace_cols[R.lookup_col_input(i)],
                               trace_cols[R.lookup_col_table(i)])
        trace_cols[R.col_permuted_input(i)] = pi
        trace_cols[R.col_permuted_table(i)] = pt


def eval_lookups(alg, vars, yield_constr) -> None:
    """(reference lookup.rs:107-131)."""
    for i in range(R.NUM_LOOKUPS):
        local_perm_input = vars.local_values[R.col_permuted_input(i)]
        next_perm_table = vars.next_values[R.col_permuted_table(i)]
        next_perm_input = vars.next_values[R.col_permuted_input(i)]

        diff_input_prev = alg.sub(next_perm_input, local_perm_input)
        diff_input_table = alg.sub(next_perm_input, next_perm_table)
        yield_constr.constraint(alg.mul(diff_input_prev, diff_input_table))
        # constrains the first row (the last row's next wraps around)
        yield_constr.constraint_last_row(diff_input_table)
