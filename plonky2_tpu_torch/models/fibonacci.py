"""The 100th-Fibonacci example circuit (the port's copy of
plonky2_tpu/models/fibonacci.py; reference plonky2/examples/fibonacci.rs).

``keccak_fibonacci_config()`` is tests/test_keccak_config.py's config for
the same circuit under the Keccak hasher configuration (rate 3, cap 4, 28
queries, 8 bits of proof of work, arities (4, 5)); build it with
``build_fibonacci_circuit(keccak_fibonacci_config(), gc=KECCAK_CONFIG)``.
"""
from __future__ import annotations

from ..field import goldilocks as gl
from ..fri.config import FriConfig, FriReductionStrategy
from ..iop.witness import PartialWitness
from ..plonk.circuit_builder import CircuitBuilder
from ..plonk.config import CircuitConfig


def keccak_fibonacci_config() -> CircuitConfig:
    return CircuitConfig(fri_config=FriConfig(
        rate_bits=3, cap_height=4, proof_of_work_bits=8,
        reduction_strategy=FriReductionStrategy.ConstantArityBits(4, 5),
        num_query_rounds=28))


def build_fibonacci_circuit(config: CircuitConfig | None = None,
                            steps: int = 99, device=None, gc=None):
    """(CircuitData, PartialWitness, expected public inputs); ``gc`` (the
    hasher configuration) and ``device`` go to CircuitBuilder.build."""
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

    data = builder.build(gc=gc, device=device)

    a, b = 0, 1
    for _ in range(steps):
        a, b = b, (a + b) % gl.P
    return data, pw, [0, 1, b]
