"""The Fibonacci STARK: the port's copy of
plonky2_tpu/models/fibonacci_stark.py (reference
starky/src/fibonacci_stark.rs).  Columns x0, x1, i, aux; public inputs
x0, x1 and the result; columns i and aux form a permutation pair."""
from __future__ import annotations

import numpy as np

from ..field import goldilocks as gl
from ..stark.stark import PermutationPair, Stark, StarkEvaluationVars


class FibonacciStark(Stark):
    COLUMNS = 4
    PUBLIC_INPUTS = 3
    PI_INDEX_X0 = 0
    PI_INDEX_X1 = 1
    PI_INDEX_RES = 2

    def __init__(self, num_rows: int):
        self.num_rows = num_rows

    def generate_trace(self, x0: int, x1: int) -> np.ndarray:
        """(COLUMNS, num_rows) uint64 trace values."""
        n = self.num_rows
        xs = [0] * (n + 1)
        xs[0], xs[1] = x0 % gl.P, x1 % gl.P
        for r in range(2, n + 1):
            xs[r] = (xs[r - 2] + xs[r - 1]) % gl.P
        seq = np.array(xs, dtype=np.uint64)
        trace = np.empty((self.COLUMNS, n), dtype=np.uint64)
        trace[0], trace[1] = seq[:n], seq[1:]
        trace[2] = np.arange(n, dtype=np.uint64)
        trace[3] = np.arange(1, n + 1, dtype=np.uint64)
        trace[3, n - 1] = 0         # makes columns 2 and 3 a permutation
        return trace

    def expected_result(self, x0: int, x1: int) -> int:
        a, b = x0, x1
        for _ in range(self.num_rows - 1):
            a, b = b, (a + b) % gl.P
        return b

    def eval(self, alg, vars: StarkEvaluationVars, yield_constr) -> None:
        lv, nv, pis = vars.local_values, vars.next_values, vars.public_inputs
        yield_constr.constraint_first_row(alg.sub(lv[0],
                                                  pis[self.PI_INDEX_X0]))
        yield_constr.constraint_first_row(alg.sub(lv[1],
                                                  pis[self.PI_INDEX_X1]))
        yield_constr.constraint_last_row(alg.sub(lv[1],
                                                 pis[self.PI_INDEX_RES]))
        yield_constr.constraint_transition(alg.sub(nv[0], lv[1]))
        yield_constr.constraint_transition(alg.sub(nv[1],
                                                   alg.add(lv[0], lv[1])))

    def constraint_degree(self) -> int:
        return 2

    def permutation_pairs(self):
        return [PermutationPair.singletons(2, 3)]
