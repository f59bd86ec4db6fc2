"""FRI instance descriptors: which polynomials of which oracles are opened
at which points, and the claimed values.

The port's copy of plonky2_tpu/fri/structure.py, with the same field names.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple


@dataclass
class FriOracleInfo:
    num_polys: int
    blinding: bool


@dataclass
class FriPolynomialInfo:
    oracle_index: int
    polynomial_index: int

    @staticmethod
    def from_range(oracle_index: int, r: range) -> List["FriPolynomialInfo"]:
        return [FriPolynomialInfo(oracle_index, i) for i in r]


@dataclass
class FriBatchInfo:
    point: Tuple[int, int]           # an extension element
    polynomials: List[FriPolynomialInfo]


@dataclass
class FriInstanceInfo:
    oracles: List[FriOracleInfo]
    batches: List[FriBatchInfo]


@dataclass
class FriOpeningBatch:
    values: List[Tuple[int, int]]    # extension elements


@dataclass
class FriOpenings:
    batches: List[FriOpeningBatch]
