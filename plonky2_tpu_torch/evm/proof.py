"""Multi-table proof containers: the port's copy of
plonky2_tpu/evm/proof.py (reference evm/src/proof.rs), with the same field
names."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..fri.proof import FriProof
from ..fri.structure import FriOpeningBatch, FriOpenings
from ..hash.merkle import MerkleCap


def _pairs(arr) -> list:
    return [(int(v[0]), int(v[1])) for v in arr]


@dataclass
class EvmStarkOpeningSet:
    """(reference proof.rs:174-259)."""
    local_values: np.ndarray            # (COLUMNS, 2) extension values
    next_values: np.ndarray
    permutation_ctl_zs: np.ndarray      # (num_perm + num_ctl, 2)
    permutation_ctl_zs_next: np.ndarray
    ctl_zs_last: List[int]              # base-field values at g^-1
    quotient_polys: np.ndarray

    def to_fri_openings(self) -> FriOpenings:
        return FriOpenings(batches=[
            FriOpeningBatch(_pairs(self.local_values)
                            + _pairs(self.permutation_ctl_zs)
                            + _pairs(self.quotient_polys)),
            FriOpeningBatch(_pairs(self.next_values)
                            + _pairs(self.permutation_ctl_zs_next)),
            FriOpeningBatch([(int(v), 0) for v in self.ctl_zs_last])])


@dataclass
class EvmStarkProof:
    trace_cap: MerkleCap
    permutation_ctl_zs_cap: MerkleCap
    quotient_polys_cap: MerkleCap
    openings: EvmStarkOpeningSet
    opening_proof: FriProof


@dataclass
class AllProof:
    stark_proofs: List[EvmStarkProof]
    degree_bits: List[int]
    public_values: Optional[object] = None
