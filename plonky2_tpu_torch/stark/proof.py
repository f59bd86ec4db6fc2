"""STARK proof containers: the port's counterpart of
plonky2_tpu/stark/proof.py (reference starky/src/proof.rs), with the same
field names.  The opened values come from the commitments' resident
coefficients (ops/openings.py); only the (B, 2) values reach the host."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..field import extension as ext
from ..fri.proof import FriChallenges, FriProof
from ..fri.structure import FriOpeningBatch, FriOpenings
from ..hash.merkle import MerkleCap
from ..ops.openings import eval_openings_batched


def _pairs(arr) -> list:
    return [(int(v[0]), int(v[1])) for v in arr]


@dataclass
class StarkOpeningSet:
    local_values: np.ndarray       # (COLUMNS, 2)
    next_values: np.ndarray
    permutation_zs: Optional[np.ndarray]
    permutation_zs_next: Optional[np.ndarray]
    quotient_polys: np.ndarray

    @staticmethod
    def new(zeta, g: int, trace_commitment, permutation_zs_commitment,
            quotient_commitment) -> "StarkOpeningSet":
        zeta_next = ext.s_mul(zeta, (g, 0))
        shifted = [trace_commitment]
        if permutation_zs_commitment is not None:
            shifted.append(permutation_zs_commitment)
        both = eval_openings_batched(shifted, [zeta, zeta_next])
        (quotient,), = eval_openings_batched([quotient_commitment], [zeta])
        perm = both[1] if permutation_zs_commitment is not None else None
        return StarkOpeningSet(
            local_values=both[0][0], next_values=both[0][1],
            permutation_zs=None if perm is None else perm[0],
            permutation_zs_next=None if perm is None else perm[1],
            quotient_polys=quotient)

    def to_fri_openings(self) -> FriOpenings:
        zeta_values = _pairs(self.local_values)
        if self.permutation_zs is not None:
            zeta_values += _pairs(self.permutation_zs)
        zeta_values += _pairs(self.quotient_polys)
        zeta_next_values = _pairs(self.next_values)
        if self.permutation_zs_next is not None:
            zeta_next_values += _pairs(self.permutation_zs_next)
        return FriOpenings(batches=[FriOpeningBatch(zeta_values),
                                    FriOpeningBatch(zeta_next_values)])


@dataclass
class StarkProof:
    trace_cap: MerkleCap
    permutation_zs_cap: Optional[MerkleCap]
    quotient_polys_cap: MerkleCap
    openings: StarkOpeningSet
    opening_proof: FriProof

    def recover_degree_bits(self, config) -> int:
        initial_merkle_proof = self.opening_proof.query_round_proofs[0] \
            .initial_trees_proof.evals_proofs[0][1]
        lde_bits = (config.fri_config.cap_height
                    + len(initial_merkle_proof.siblings))
        return lde_bits - config.fri_config.rate_bits


@dataclass
class StarkProofWithPublicInputs:
    proof: StarkProof
    public_inputs: List[int]


@dataclass
class StarkProofChallenges:
    permutation_challenge_sets: Optional[list]
    stark_alphas: List[int]
    stark_zeta: Tuple[int, int]
    fri_challenges: FriChallenges
