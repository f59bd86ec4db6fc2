"""FRI proof containers.

The port's copy of plonky2_tpu/fri/proof.py, with the same field names, so
that a proof converts to the JAX package's field by field, and the
challenges the verifier replays.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..hash.merkle import MerkleCap, MerkleProof

SALT_SIZE = 4


@dataclass
class FriInitialTreeProof:
    # per oracle: (leaf row (L,) uint64, its Merkle proof)
    evals_proofs: List[Tuple[np.ndarray, MerkleProof]]

    def unsalted_eval(self, oracle_index: int, poly_index: int,
                      salted: bool) -> int:
        evals = self.evals_proofs[oracle_index][0]
        n = len(evals) - (SALT_SIZE if salted else 0)
        return int(evals[:n][poly_index])


@dataclass
class FriQueryStep:
    evals: np.ndarray   # (arity, 2) extension elements
    merkle_proof: MerkleProof


@dataclass
class FriQueryRound:
    initial_trees_proof: FriInitialTreeProof
    steps: List[FriQueryStep]


@dataclass
class FriProof:
    commit_phase_merkle_caps: List[MerkleCap]
    query_round_proofs: List[FriQueryRound]
    final_poly: np.ndarray  # (final_len, 2) extension coefficients
    pow_witness: int


@dataclass
class FriChallenges:
    fri_alpha: Tuple[int, int]
    fri_betas: List[Tuple[int, int]]
    fri_pow_response: int
    fri_query_indices: List[int]
