"""ProverSession: the state every proof of one circuit on one device
reuses (the port's counterpart of plonky2_tpu/runtime/session.py).

It holds the circuit's plonk/prover_data.py:ProverData, the quotient
program and one plonk/prover.py:ProverContext, which takes the
constants-sigmas commitment that CircuitBuilder.build made instead of
committing it again.  ``prove`` generates the witness on the session's
device with the circuit's witness plan (iop/device_witness.py; the host
engine, iop/generator.py, only for a circuit the plan refuses, as in the
JAX package's prover), then runs the proof's phases 2-8 there; ``verify``
runs the port's verifier.

With no ``program``, the session takes the shipped flagship program
(plonk/programs/hash_tree_wide_ecc.npz) when the circuit matches it: the
same CircuitShape up to degree_bits and the same gates, which holds for
every hash tree of at least 4 leaves under
CircuitConfig.wide_ecc_config().  Any other circuit needs its program
given; the port has no quotient compiler yet.
"""
from __future__ import annotations

import dataclasses
import functools
import os

from .. import resolve_device
from ..iop import device_witness as dw
from ..iop.generator import generate_partial_witness
from ..plonk import constraint_program as cp
from ..plonk.circuit_shape import CircuitShape
from ..plonk.prover import ProverContext, prove
from ..plonk.prover_data import ProverData
from ..utils.timing import NoopTiming

SHIPPED_PROGRAM = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "plonk", "programs",
    "hash_tree_wide_ecc.npz")


@functools.lru_cache(maxsize=1)
def _shipped():
    prog, shape = cp.load(SHIPPED_PROGRAM)
    return prog, shape, cp.load_gate_ids(SHIPPED_PROGRAM)


def shipped_program(common):
    """The shipped quotient program, if the circuit `common` (a
    CommonCircuitData) is one it was compiled for; else
    NotImplementedError."""
    prog, shape, gate_ids = _shipped()
    want = CircuitShape.from_common(common)
    if (dataclasses.replace(shape, degree_bits=want.degree_bits) != want
            or gate_ids != tuple(g.id() for g in common.gates)):
        raise NotImplementedError(
            "no shipped quotient program for this circuit, and the port "
            "has no quotient compiler (ROADMAP 15c): pass program=")
    return prog


class ProverSession:
    """Made once per circuit and device; ``prove`` once per witness."""

    def __init__(self, data, program=None, device=None):
        """data: the port's CircuitData; program: its quotient
        ConstraintProgram (the shipped one when None); runs on `device`
        (default cuda), where build() must have committed the circuit."""
        self.data = data
        self.device = resolve_device(device)
        if program is None:
            program = shipped_program(data.common)
        self.prover_data = ProverData.from_circuit(data.prover_only,
                                                   data.common, program)
        self.context = ProverContext(
            self.prover_data, self.device,
            cs_batch=data.prover_only.constants_sigmas_commitment)

    def witness(self, inputs, rng=None):
        """The (num_wires, degree) uint64 witness of the PartialWitness
        `inputs`; ``rng`` draws the random wires (iop/generator.py)."""
        return generate_partial_witness(inputs, self.data.prover_only,
                                        self.data.common,
                                        rng=rng).full_witness()

    def prove(self, inputs, rng=None, timing=None):
        """The proof (a plonk.proof.ProofWithPublicInputs) of the
        PartialWitness `inputs`; ``rng`` draws the random wires.
        ``timing.scope(name)`` wraps each stage when given: the witness
        as "device witness" (the plan, built once a circuit as "witness
        plan") or, where the plan is refused, as "witness" (the host
        engine)."""
        timing = timing if timing is not None else NoopTiming()
        po, common = self.data.prover_only, self.data.common
        plan = dw.get_plan(po, common, inputs, self.device, timing=timing)
        if plan is not None and not plan.matches(inputs):
            # another input target set than the plan's: a plan of its own
            plan = dw.get_plan(po, common, inputs, self.device,
                               rebuild=True, timing=timing)
        if plan is None:
            with timing.scope("witness"):
                witness = self.witness(inputs, rng)
        else:
            with timing.scope("device witness"):
                witness, _ = plan.run(inputs, rng)
        return prove(self.prover_data, witness, context=self.context,
                     device=self.device, timing=timing)

    def verify(self, proof) -> None:
        """Raises unless the proof verifies (plonk/verifier.py)."""
        self.data.verify(proof)
