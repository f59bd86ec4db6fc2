"""Circuit configuration presets.

The port's copy of plonky2_tpu/plonk/config.py (reference
plonky2/src/plonk/circuit_data.rs:36-107), on the port's FriConfig.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

from ..fri.config import FriConfig, FriReductionStrategy


def _standard_fri() -> FriConfig:
    return FriConfig(
        rate_bits=3, cap_height=4, proof_of_work_bits=16,
        reduction_strategy=FriReductionStrategy.ConstantArityBits(4, 5),
        num_query_rounds=28)


@dataclass(frozen=True)
class CircuitConfig:
    num_wires: int = 135
    num_routed_wires: int = 80
    num_constants: int = 2
    use_base_arithmetic_gate: bool = True
    security_bits: int = 100
    num_challenges: int = 2
    zero_knowledge: bool = False
    max_quotient_degree_factor: int = 8
    fri_config: FriConfig = field(default_factory=_standard_fri)

    def num_advice_wires(self) -> int:
        return self.num_wires - self.num_routed_wires

    @staticmethod
    def standard_recursion_config() -> "CircuitConfig":
        return CircuitConfig()

    @staticmethod
    def standard_ecc_config() -> "CircuitConfig":
        return CircuitConfig(num_wires=136)

    @staticmethod
    def wide_ecc_config() -> "CircuitConfig":
        return CircuitConfig(num_wires=234, num_routed_wires=80)

    @staticmethod
    def standard_recursion_zk_config() -> "CircuitConfig":
        return replace(CircuitConfig(), zero_knowledge=True)
