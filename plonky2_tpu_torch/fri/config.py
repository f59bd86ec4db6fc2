"""FRI configuration.

The port's copy of plonky2_tpu/fri/config.py: the reduction strategies
(fixed arities, a constant arity down to a final-polynomial size, or the
arity sequence of the smallest proof), ``FriConfig`` and the per-circuit
``FriParams`` they give.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class FriReductionStrategy:
    """kind: 'fixed' | 'constant_arity' | 'min_size'."""
    kind: str = "constant_arity"
    arities: Tuple[int, ...] = ()          # for 'fixed'
    arity_bits: int = 4                    # for 'constant_arity'
    final_poly_bits: int = 5               # for 'constant_arity'
    max_arity_bits: Optional[int] = None   # for 'min_size'

    @staticmethod
    def Fixed(arities) -> "FriReductionStrategy":
        return FriReductionStrategy(kind="fixed", arities=tuple(arities))

    @staticmethod
    def ConstantArityBits(arity_bits: int,
                          final_poly_bits: int) -> "FriReductionStrategy":
        return FriReductionStrategy(kind="constant_arity",
                                    arity_bits=arity_bits,
                                    final_poly_bits=final_poly_bits)

    @staticmethod
    def MinSize(max_arity_bits: Optional[int] = None
                ) -> "FriReductionStrategy":
        return FriReductionStrategy(kind="min_size",
                                    max_arity_bits=max_arity_bits)

    def reduction_arity_bits(self, degree_bits: int, rate_bits: int,
                             cap_height: int, num_queries: int) -> List[int]:
        if self.kind == "fixed":
            return list(self.arities)
        if self.kind == "constant_arity":
            result = []
            db = degree_bits
            while (db > self.final_poly_bits
                   and db + rate_bits - self.arity_bits >= cap_height):
                result.append(self.arity_bits)
                db -= self.arity_bits
            return result
        if self.kind == "min_size":
            return _min_size_arity_bits(degree_bits, rate_bits, num_queries,
                                        self.max_arity_bits or 4)
        raise ValueError(f"unknown reduction strategy {self.kind!r}")


def _relative_proof_size(degree_bits: int, rate_bits: int, num_queries: int,
                         arity_bits: List[int]) -> int:
    """Approximate FRI proof size in field elements."""
    D = 4
    current = degree_bits + rate_bits
    total = 0
    for ab in arity_bits:
        total += ((1 << ab) - 1) * D * num_queries      # sibling evaluations
        total += current * 4 * num_queries              # Merkle siblings
        current -= ab
    total += D * (1 << (current - rate_bits))           # final polynomial
    return total


def _min_size_arity_bits(degree_bits: int, rate_bits: int, num_queries: int,
                         max_arity_bits: int,
                         prefix: tuple = ()) -> List[int]:
    """Exhaustive search for the smallest proof over non-increasing arity
    sequences."""
    current = degree_bits + rate_bits - sum(prefix)
    best = list(prefix)
    best_size = _relative_proof_size(degree_bits, rate_bits, num_queries,
                                     list(prefix))
    cap = min(prefix[-1] if prefix else max_arity_bits, current - rate_bits)
    for nxt in range(1, cap + 1):
        cand = _min_size_arity_bits(degree_bits, rate_bits, num_queries,
                                    max_arity_bits, prefix + (nxt,))
        size = _relative_proof_size(degree_bits, rate_bits, num_queries, cand)
        if size < best_size:
            best, best_size = cand, size
    return best


@dataclass(frozen=True)
class FriConfig:
    rate_bits: int
    cap_height: int
    proof_of_work_bits: int
    reduction_strategy: FriReductionStrategy
    num_query_rounds: int

    def num_cap_elements(self) -> int:
        return 1 << self.cap_height

    def fri_params(self, degree_bits: int, hiding: bool) -> "FriParams":
        rab = self.reduction_strategy.reduction_arity_bits(
            degree_bits, self.rate_bits, self.cap_height,
            self.num_query_rounds)
        return FriParams(config=self, hiding=hiding, degree_bits=degree_bits,
                         reduction_arity_bits=tuple(rab))


@dataclass(frozen=True)
class FriParams:
    config: FriConfig
    hiding: bool
    degree_bits: int
    reduction_arity_bits: Tuple[int, ...]

    def total_arities(self) -> int:
        return sum(self.reduction_arity_bits)

    def lde_bits(self) -> int:
        return self.degree_bits + self.config.rate_bits

    def lde_size(self) -> int:
        return 1 << self.lde_bits()

    def final_poly_bits(self) -> int:
        return self.degree_bits - self.total_arities()

    def final_poly_len(self) -> int:
        return 1 << self.final_poly_bits()
