"""ProverSession: the state every proof of one circuit on one device
reuses (the port's counterpart of plonky2_tpu/runtime/session.py).

It holds the circuit's plonk/prover_data.py:ProverData, the quotient
program and one plonk/prover.py:ProverContext, which takes the
constants-sigmas commitment that CircuitBuilder.build made instead of
committing it again.  ``prove`` generates the witness on the session's
device with the circuit's witness plan (iop/device_witness.py; the host
engine, iop/generator.py, only for a circuit the plan refuses, as in the
JAX package's prover), then runs the proof's phases 2-8 there; ``verify``
runs the port's verifier.  The witness does not depend on the hasher, so
a circuit under the Keccak configuration gets its plan as any other
(the JAX package runs its whole non-algebraic prover, witness included,
on the host; the port keeps the LDE, quotient and folds on the device).

The session compiles the circuit's quotient program
(plonk/quotient_program.py:build_quotient_program), once, as the JAX
package's session does: any circuit built from the port's gates proves.
"""
from __future__ import annotations

from .. import resolve_device
from ..iop import device_witness as dw
from ..iop.generator import generate_partial_witness
from ..plonk.prover import ProverContext, prove
from ..plonk.prover_data import ProverData
from ..plonk.quotient_program import build_quotient_program
from ..utils.timing import NoopTiming


class ProverSession:
    """Made once per circuit and device; ``prove`` once per witness."""

    def __init__(self, data, device=None, timing=None):
        """data: the port's CircuitData, whose quotient program is compiled
        here (under ``timing.scope("quotient program")``); runs on
        `device` (default cuda), where build() must have committed the
        circuit."""
        timing = timing if timing is not None else NoopTiming()
        self.data = data
        self.device = resolve_device(device)
        with timing.scope("quotient program"):
            program = build_quotient_program(data.common)
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
