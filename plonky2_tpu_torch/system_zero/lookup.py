"""The permuted columns of the Halo2-style lookup argument: the port's
copy of plonky2_tpu/system_zero/lookup.py:permuted_cols (reference
system_zero/src/lookup.rs:34-105), which evm/memory.py uses."""
from __future__ import annotations

import numpy as np


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
