"""The gate test harness (the port's copy of plonky2_tpu/gates/testing.py;
reference gates/gate_testing.rs).

- ``test_low_degree``: the gate's constraints on the LDEs of random
  witness polynomials of degree 31 interpolate to degree at most
  31 * gate.degree();
- ``test_eval_fns``: the base-field evaluation (``NumpyBatch``) equals
  the extension evaluation (``ScalarExt``) on base-field inputs, and stays
  in the base field.
"""
from __future__ import annotations

import numpy as np

from ..field import fft
from ..field import goldilocks as gl
from ..field.convert import from_u64, to_u64
from ..plonk.algebra import EvaluationVars, NumpyBatch, ScalarExt
from ..utils.bits import log2_ceil
from .gate import Gate

WITNESS_SIZE = 1 << 5


def _rand(shape, rng):
    return rng.integers(0, gl.P, size=shape, dtype=np.uint64)


def _fft(a: np.ndarray) -> np.ndarray:
    return to_u64(fft.fft(from_u64(a, "cpu")))


def _ifft(a: np.ndarray) -> np.ndarray:
    return to_u64(fft.ifft(from_u64(a, "cpu")))


def test_low_degree(gate: Gate, seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    rate_bits = log2_ceil(gate.degree() + 1)
    n = WITNESS_SIZE << rate_bits

    def ldes(count):
        if count == 0:
            return np.zeros((0, n), dtype=np.uint64)
        coeffs = np.zeros((count, n), dtype=np.uint64)
        coeffs[:, :WITNESS_SIZE] = _rand((count, WITNESS_SIZE), rng)
        return _fft(coeffs)

    wires = ldes(gate.num_wires())
    consts = ldes(gate.num_constants())
    pih = _rand((4,), rng)

    vars = EvaluationVars(list(consts), list(wires),
                          [np.uint64(x) for x in pih])
    constraints = gate.eval_unfiltered(NumpyBatch(), vars)
    if len(constraints) != gate.num_constraints():
        raise AssertionError(f"eval returned {len(constraints)} constraints, "
                             f"num_constraints() says "
                             f"{gate.num_constraints()}")
    max_degree = (WITNESS_SIZE - 1) * gate.degree()
    for k, c in enumerate(constraints):
        c = np.broadcast_to(np.asarray(c, dtype=np.uint64), (n,)).copy()
        nz = np.flatnonzero(_ifft(c))
        deg = int(nz[-1]) if nz.size else 0
        if deg > max_degree:
            raise AssertionError(f"constraint {k} has degree {deg} > "
                                 f"{max_degree} (gate degree "
                                 f"{gate.degree()})")


def test_eval_fns(gate: Gate, seed: int = 1) -> None:
    rng = np.random.default_rng(seed)
    wires = _rand((max(gate.num_wires(), 1),), rng)
    consts = _rand((max(gate.num_constants(), 1),), rng)
    pih = _rand((4,), rng)
    nw, nc = gate.num_wires(), gate.num_constants()

    vars_b = EvaluationVars(list(consts[:nc]), list(wires[:nw]),
                            [np.uint64(x) for x in pih])
    base_out = [int(np.asarray(c))
                for c in gate.eval_unfiltered(NumpyBatch(), vars_b)]
    vars_e = EvaluationVars([(int(c), 0) for c in consts[:nc]],
                            [(int(w), 0) for w in wires[:nw]],
                            [(int(x), 0) for x in pih])
    ext_out = gate.eval_unfiltered(ScalarExt(), vars_e)

    if not len(base_out) == len(ext_out) == gate.num_constraints():
        raise AssertionError("constraint counts differ")
    for k, (b, e) in enumerate(zip(base_out, ext_out)):
        if e[1] != 0:
            raise AssertionError(f"constraint {k} left the base field")
        if b != e[0]:
            raise AssertionError(f"constraint {k}: base {b} != ext {e[0]}")


def check_gate(gate: Gate) -> None:
    test_low_degree(gate)
    test_eval_fns(gate)
