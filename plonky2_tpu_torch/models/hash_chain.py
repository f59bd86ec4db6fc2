"""A Poseidon hash chain of configurable length (the port's copy of
plonky2_tpu/models/hash_chain.py): each link is one PoseidonGate row, so
``length`` sets the circuit's degree."""
from __future__ import annotations

import numpy as np

from ..hash import poseidon as pos
from ..iop.witness import PartialWitness
from ..plonk.circuit_builder import CircuitBuilder
from ..plonk.config import CircuitConfig


def build_hash_chain_circuit(config: CircuitConfig | None = None,
                             length: int = 100, device=None):
    """Knowledge of x with H^length([x, 0, ..., 0]) = the public output.
    (data, witness_fn): witness_fn(x) is the PartialWitness of input x;
    ``device`` goes to CircuitBuilder.build."""
    config = config or CircuitConfig.standard_recursion_config()
    builder = CircuitBuilder(config)
    x = builder.add_virtual_target()
    zero = builder.zero()
    state = [x] + [zero] * 11
    for _ in range(length):
        state = builder.permute(state)
    for i in range(4):
        builder.register_public_input(state[i])
    data = builder.build(device=device)

    def witness(x_value: int) -> PartialWitness:
        pw = PartialWitness()
        pw.set_target(x, x_value)
        return pw

    return data, witness


def expected_chain_output(x_value: int, length: int):
    state = np.zeros(12, dtype=np.uint64)
    state[0] = x_value
    for _ in range(length):
        state = pos.poseidon(state)
    return [int(v) for v in state[:4]]
