"""Merkle proofs verified in the circuit (the port's copy of
plonky2_tpu/gadgets/merkle.py; reference
plonky2/src/hash/merkle_proofs.rs:105-158, hash/hash_types.rs).

A HashOutTarget is a tuple of 4 targets, a cap a list of them, a
MerkleProofTarget the sibling digests from the leaf level up.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from ..iop.target import Target

HashOutTarget = Tuple[Target, Target, Target, Target]


@dataclass
class MerkleProofTarget:
    siblings: List[HashOutTarget]


class MerkleGadgets:
    """Mixed into CircuitBuilder; uses its permute_swapped, hash_or_noop
    and random_access."""

    def add_virtual_hash(self) -> HashOutTarget:
        return tuple(self.add_virtual_targets(4))

    def add_virtual_cap(self, cap_height: int) -> List[HashOutTarget]:
        return [self.add_virtual_hash() for _ in range(1 << cap_height)]

    def add_virtual_merkle_proof(self,
                                 len_siblings: int) -> MerkleProofTarget:
        return MerkleProofTarget(
            siblings=[self.add_virtual_hash() for _ in range(len_siblings)])

    def connect_hashes(self, x: HashOutTarget, y: HashOutTarget) -> None:
        for a, b in zip(x, y):
            self.connect(a, b)

    def connect_merkle_caps(self, x, y) -> None:
        for h0, h1 in zip(x, y):
            self.connect_hashes(h0, h1)

    def verify_merkle_proof_to_cap_with_cap_index(
            self, leaf_data: List[Target], leaf_index_bits: List[Target],
            cap_index: Target, merkle_cap: List[HashOutTarget],
            proof: MerkleProofTarget) -> None:
        zero = self.zero()
        state = list(self.hash_or_noop(leaf_data))
        for bit, sibling in zip(leaf_index_bits, proof.siblings):
            perm_inputs = state[:4] + list(sibling) + [zero] * 4
            state = self.permute_swapped(perm_inputs, bit)[:4]
        for i in range(4):
            result = self.random_access(cap_index,
                                        [h[i] for h in merkle_cap])
            self.connect(result, state[i])
