"""The 100th-Fibonacci example circuit (the port's copy of
plonky2_tpu/models/fibonacci.py; reference plonky2/examples/fibonacci.rs).
"""
from __future__ import annotations

from ..field import goldilocks as gl
from ..iop.witness import PartialWitness
from ..plonk.circuit_builder import CircuitBuilder
from ..plonk.config import CircuitConfig


def build_fibonacci_circuit(config: CircuitConfig | None = None,
                            steps: int = 99, device=None):
    """(CircuitData, PartialWitness, expected public inputs); ``device``
    goes to CircuitBuilder.build."""
    config = config or CircuitConfig.standard_recursion_config()
    builder = CircuitBuilder(config)

    initial_a = builder.add_virtual_target()
    initial_b = builder.add_virtual_target()
    prev, cur = initial_a, initial_b
    for _ in range(steps):
        prev, cur = cur, builder.add(prev, cur)

    builder.register_public_input(initial_a)
    builder.register_public_input(initial_b)
    builder.register_public_input(cur)

    pw = PartialWitness()
    pw.set_target(initial_a, 0)
    pw.set_target(initial_b, 1)

    data = builder.build(device=device)

    a, b = 0, 1
    for _ in range(steps):
        a, b = b, (a + b) % gl.P
    return data, pw, [0, 1, b]
