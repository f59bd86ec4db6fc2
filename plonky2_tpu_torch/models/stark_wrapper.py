"""A STARK proof verified in a circuit (tests/test_stark_recursion.py:
17-36 of the JAX package): the proof's targets, the in-circuit STARK
verifier, and the STARK's public inputs as the circuit's.

``place_stark_wrapper`` takes any builder and the recursive-verifier
module of its package, so that the JAX package's builder can build the
same circuit (the tests hold the two against each other);
``stark_wrapper_builder`` gives it on the port's builder, unbuilt.
"""
from __future__ import annotations

from ..plonk.circuit_builder import CircuitBuilder
from ..plonk.config import CircuitConfig
from ..stark import recursive_verifier


def place_stark_wrapper(builder, rv, stark, stark_config, degree_bits: int):
    """The wrapper of a proof of `stark` of 2^degree_bits rows under
    `stark_config` on `builder`; `rv` is the builder's package's
    stark/recursive_verifier module.  Returns the proof's targets."""
    pt = rv.add_virtual_stark_proof_with_pis(builder, stark, stark_config,
                                             degree_bits)
    rv.verify_stark_proof_circuit(builder, stark, pt, stark_config,
                                  degree_bits)
    builder.register_public_inputs(pt.public_inputs)
    return pt


def stark_wrapper_builder(stark, stark_config, degree_bits: int,
                          circuit_config: CircuitConfig | None = None):
    """The wrapper on the port's builder under `circuit_config` (default
    standard_recursion_config), unbuilt: (builder, proof targets)."""
    b = CircuitBuilder(circuit_config
                       or CircuitConfig.standard_recursion_config())
    return b, place_stark_wrapper(b, recursive_verifier, stark,
                                  stark_config, degree_bits)
