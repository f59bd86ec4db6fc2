"""STARK test harness: the port's counterpart of
plonky2_tpu/stark/testing.py (reference starky/src/stark_testing.rs:23):
the low-degree check of a constraint set and the row-wise check of a
generated trace, on the host (numpy uint64 values, the plain FFT of
field/fft.py), and the check that the constraints evaluated in a circuit
agree with the host's (the one function here that proves, on `device`)."""
from __future__ import annotations

import numpy as np
import torch

from ..field import fft
from ..field import goldilocks as gl
from ..field.convert import from_u64, to_u64
from ..plonk.algebra import CircuitExtAlgebra, NumpyBatch, ScalarExt
from ..utils.bits import log2_ceil, log2_strict
from .stark import ConstraintConsumer, Stark, StarkEvaluationVars

WITNESS_SIZE = 1 << 5


def _lde_values(coeffs: np.ndarray, rate_bits: int) -> np.ndarray:
    """(k, n) coefficients -> (k, n << rate_bits) values on the subgroup."""
    k, n = coeffs.shape
    padded = torch.zeros((k, n << rate_bits), dtype=torch.int64)
    padded[:, :n] = from_u64(coeffs)
    return to_u64(fft.fft(padded))


def test_stark_low_degree(stark: Stark, rng=None) -> None:
    """Apply the constraints to random low-degree witness polynomials and
    check that the composition has the claimed degree (reference
    stark_testing.rs:23-79)."""
    rng = rng or np.random.default_rng(0x57A12)
    rate_bits = log2_ceil(stark.constraint_degree() + 1)
    size = WITNESS_SIZE << rate_bits
    coeffs = rng.integers(0, gl.P, size=(stark.COLUMNS, WITNESS_SIZE),
                          dtype=np.uint64)
    trace_lde = _lde_values(coeffs, rate_bits)
    public_inputs = [int(x) for x in rng.integers(
        0, gl.P, size=stark.PUBLIC_INPUTS, dtype=np.uint64)]

    def selector_lde(pos):
        onehot = np.zeros((1, WITNESS_SIZE), dtype=np.uint64)
        onehot[0, pos] = 1
        return _lde_values(to_u64(fft.ifft(from_u64(onehot))), rate_bits)[0]

    lagrange_first = selector_lde(0)
    lagrange_last = selector_lde(WITNESS_SIZE - 1)
    last = gl.s_inv(gl.primitive_root_of_unity(log2_strict(WITNESS_SIZE)))
    subgroup = gl.powers(gl.primitive_root_of_unity(log2_strict(size)), size)
    z_last = gl.sub(subgroup, np.uint64(last))
    alpha = int(rng.integers(1, gl.P, dtype=np.uint64))

    alg = NumpyBatch()
    vars = StarkEvaluationVars(
        local_values=[trace_lde[c] for c in range(stark.COLUMNS)],
        next_values=[np.roll(trace_lde[c], -(1 << rate_bits))
                     for c in range(stark.COLUMNS)],
        public_inputs=[alg.const(p) for p in public_inputs])
    consumer = ConstraintConsumer(alg, [alg.const(alpha)], z_last,
                                  lagrange_first, lagrange_last)
    stark.eval(alg, vars, consumer)
    evals = np.broadcast_to(consumer.accumulators()[0], (size,)).copy()
    comp_coeffs = to_u64(fft.ifft(from_u64(evals)))
    nonzero = np.nonzero(comp_coeffs)[0]
    degree = int(nonzero[-1]) if len(nonzero) else 0
    maximum = WITNESS_SIZE * stark.constraint_degree() - 1
    if degree > maximum:
        raise AssertionError(f"constraint composition has degree {degree}, "
                             f"exceeding the claimed bound {maximum}")


def test_stark_circuit_constraints(stark: Stark, rng=None,
                                   device=None) -> None:
    """The constraints evaluated at random points on the host agree with
    the same evaluation emitted as gates by the circuit algebra: a circuit
    that connects the two is proved on `device` (default cuda) and
    verified (reference stark_testing.rs:81-157)."""
    from ..iop.witness import PartialWitness
    from ..plonk.circuit_builder import CircuitBuilder
    from ..plonk.config import CircuitConfig
    from ..runtime.session import ProverSession

    rng = rng or np.random.default_rng(0x57A13)

    def rand_ext():
        return (int(rng.integers(0, gl.P, dtype=np.uint64)),
                int(rng.integers(0, gl.P, dtype=np.uint64)))

    local = [rand_ext() for _ in range(stark.COLUMNS)]
    nxt = [rand_ext() for _ in range(stark.COLUMNS)]
    pis = [rand_ext() for _ in range(stark.PUBLIC_INPUTS)]
    alpha = int(rng.integers(0, gl.P, dtype=np.uint64))
    z_last, l_first, l_last = rand_ext(), rand_ext(), rand_ext()

    alg = ScalarExt()
    consumer = ConstraintConsumer(alg, [(alpha, 0)], z_last, l_first, l_last)
    stark.eval(alg, StarkEvaluationVars(local, nxt, pis), consumer)
    native_eval = consumer.accumulators()[0]

    builder = CircuitBuilder(CircuitConfig.standard_recursion_config())
    pw = PartialWitness()
    calg = CircuitExtAlgebra(builder)

    def virt_exts(values):
        ts = builder.add_virtual_extension_targets(len(values))
        pw.set_extension_targets(ts, values)
        return ts

    locals_t, nexts_t, pis_t = virt_exts(local), virt_exts(nxt), virt_exts(pis)
    alpha_t = builder.add_virtual_target()
    pw.set_target(alpha_t, alpha)
    (z_last_t,), (l_first_t,), (l_last_t,) = \
        virt_exts([z_last]), virt_exts([l_first]), virt_exts([l_last])

    c_consumer = ConstraintConsumer(
        calg, [builder.convert_to_ext(alpha_t)], z_last_t, l_first_t, l_last_t)
    stark.eval(calg, StarkEvaluationVars(locals_t, nexts_t, pis_t), c_consumer)
    circuit_eval = c_consumer.accumulators()[0]
    builder.connect_extension(circuit_eval,
                              builder.constant_extension(native_eval))

    session = ProverSession(builder.build(device=device), device)
    session.verify(session.prove(pw))


def trace_constraint_violations(stark: Stark, trace: np.ndarray,
                                public_inputs=()) -> list:
    """The indices of the constraints a concrete (COLUMNS, n) trace
    violates, each evaluated row-wise; next values wrap around, and
    transition constraints skip the wrap row."""
    n = trace.shape[1]
    alg = NumpyBatch()

    class _Recorder:
        def __init__(self):
            self.fails = []
            self.idx = 0

        def _check(self, c, rows):
            arr = np.broadcast_to(np.asarray(c, dtype=np.uint64), (n,))
            if np.any(arr[rows]):
                self.fails.append(self.idx)
            self.idx += 1

        def constraint(self, c):
            self._check(c, slice(None))

        def constraint_transition(self, c):
            self._check(c, slice(0, n - 1))

        def constraint_first_row(self, c):
            self._check(c, slice(0, 1))

        def constraint_last_row(self, c):
            self._check(c, slice(n - 1, n))

    rec = _Recorder()
    vars = StarkEvaluationVars(
        local_values=[trace[c] for c in range(stark.COLUMNS)],
        next_values=[np.roll(trace[c], -1) for c in range(stark.COLUMNS)],
        public_inputs=list(public_inputs))
    stark.eval(alg, vars, rec)
    return rec.fails
