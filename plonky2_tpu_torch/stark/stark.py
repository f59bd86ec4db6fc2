"""The Stark base class and its constraint consumer: the port's copy of
plonky2_tpu/stark/stark.py (reference starky/src/stark.rs,
constraint_consumer.rs, vars.rs).

A Stark subclass writes its constraints once, ``eval(alg, vars,
consumer)``, against an algebra (plonk/algebra.py): the same code is
traced into a constraint program for the quotient (stark/
quotient_program.py), runs on numpy arrays in the tests' checks and on
extension scalars in the verifier."""
from __future__ import annotations

from typing import List, Tuple

from ..field import extension as ext
from ..fri.structure import (FriBatchInfo, FriInstanceInfo, FriOracleInfo,
                             FriPolynomialInfo)


class StarkEvaluationVars:
    def __init__(self, local_values, next_values, public_inputs):
        self.local_values = local_values
        self.next_values = next_values
        self.public_inputs = public_inputs


class PermutationPair:
    def __init__(self, column_pairs: List[Tuple[int, int]]):
        self.column_pairs = column_pairs

    @staticmethod
    def singletons(lhs: int, rhs: int) -> "PermutationPair":
        return PermutationPair([(lhs, rhs)])


class ConstraintConsumer:
    """Accumulates each constraint into one sum per alpha (reference
    constraint_consumer.rs:12-77); the alphas are algebra values."""

    def __init__(self, alg, alphas, z_last, lagrange_basis_first,
                 lagrange_basis_last):
        self.alg = alg
        self.alphas = alphas
        self.accs = [alg.zero() for _ in alphas]
        self.z_last = z_last
        self.lagrange_basis_first = lagrange_basis_first
        self.lagrange_basis_last = lagrange_basis_last

    def accumulators(self):
        return self.accs

    def constraint(self, c):
        for i, alpha in enumerate(self.alphas):
            self.accs[i] = self.alg.add(self.alg.mul(self.accs[i], alpha), c)

    def constraint_transition(self, c):
        self.constraint(self.alg.mul(c, self.z_last))

    def constraint_first_row(self, c):
        self.constraint(self.alg.mul(c, self.lagrange_basis_first))

    def constraint_last_row(self, c):
        self.constraint(self.alg.mul(c, self.lagrange_basis_last))


class Stark:
    COLUMNS: int = 0
    PUBLIC_INPUTS: int = 0

    def eval(self, alg, vars: StarkEvaluationVars,
             yield_constr: ConstraintConsumer) -> None:
        raise NotImplementedError

    def constraint_degree(self) -> int:
        raise NotImplementedError

    def quotient_degree_factor(self) -> int:
        return max(1, self.constraint_degree() - 1)

    def permutation_pairs(self) -> List[PermutationPair]:
        return []

    def uses_permutation_args(self) -> bool:
        return bool(self.permutation_pairs())

    def permutation_batch_size(self) -> int:
        return self.quotient_degree_factor()

    def num_permutation_instances(self, config) -> int:
        return len(self.permutation_pairs()) * config.num_challenges

    def num_permutation_batches(self, config) -> int:
        return -(-self.num_permutation_instances(config)
                 // self.permutation_batch_size())

    def fri_instance(self, zeta, g: int, config) -> FriInstanceInfo:
        """(reference stark.rs:88-137)."""
        oracles = [FriOracleInfo(self.COLUMNS, False)]
        trace_info = FriPolynomialInfo.from_range(0, range(self.COLUMNS))
        if self.uses_permutation_args():
            nz = self.num_permutation_batches(config)
            perm_info = FriPolynomialInfo.from_range(len(oracles), range(nz))
            oracles.append(FriOracleInfo(nz, False))
        else:
            perm_info = []
        nq = self.quotient_degree_factor() * config.num_challenges
        quot_info = FriPolynomialInfo.from_range(len(oracles), range(nq))
        oracles.append(FriOracleInfo(nq, False))
        zeta_next = ext.s_mul(zeta, (g, 0))
        return FriInstanceInfo(
            oracles=oracles,
            batches=[FriBatchInfo(zeta, trace_info + perm_info + quot_info),
                     FriBatchInfo(zeta_next, trace_info + perm_info)])
