"""STARK config: the port's copy of plonky2_tpu/stark/config.py
(reference starky/src/config.rs)."""
from __future__ import annotations

from dataclasses import dataclass

from ..fri.config import FriConfig, FriParams, FriReductionStrategy


@dataclass(frozen=True)
class StarkConfig:
    security_bits: int
    num_challenges: int
    fri_config: FriConfig

    @staticmethod
    def standard_fast_config() -> "StarkConfig":
        return StarkConfig(
            security_bits=100, num_challenges=2,
            fri_config=FriConfig(
                rate_bits=1, cap_height=4, proof_of_work_bits=16,
                reduction_strategy=FriReductionStrategy.ConstantArityBits(4, 5),
                num_query_rounds=84))

    def fri_params(self, degree_bits: int) -> FriParams:
        return self.fri_config.fri_params(degree_bits, False)
