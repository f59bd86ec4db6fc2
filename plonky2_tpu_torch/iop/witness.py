"""Witness containers (the port's copy of plonky2_tpu/iop/witness.py;
reference plonky2/src/iop/witness.rs).

``PartialWitness`` holds the values a caller sets.  ``PartitionWitness``
stores one value per copy-constraint class (its representative), so
setting any member of a class sets them all; that is what lets the
generators' fixpoint run each dependency chain in one pass.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .target import Target, target_index


class PartialWitness:
    def __init__(self):
        self.target_values: Dict[Target, int] = {}

    def set_target(self, t: Target, value: int) -> None:
        v = int(value)
        if self.target_values.get(t, v) != v:
            raise ValueError(f"conflicting value for {t}")
        self.target_values[t] = v

    def set_wire(self, row: int, column: int, value: int) -> None:
        self.set_target(("w", row, column), value)

    def set_extension_target(self, et, value) -> None:
        """An extension target (t0, t1) to the pair (v0, v1)."""
        self.set_target(et[0], value[0])
        self.set_target(et[1], value[1])

    def set_extension_targets(self, ets, values) -> None:
        for et, v in zip(ets, values):
            self.set_extension_target(et, v)

    def set_hash_target(self, ht, hash4) -> None:
        arr = np.asarray(hash4, dtype=np.uint64).reshape(4)
        for t, v in zip(ht, arr):
            self.set_target(t, int(v))

    # -- a proof and its verifier data, for a recursion circuit ------------

    def set_cap_target(self, cap_target, cap) -> None:
        digests = cap.digests if hasattr(cap, "digests") else cap
        for ht, d in zip(cap_target,
                         np.asarray(digests, dtype=np.uint64).reshape(-1, 4)):
            self.set_hash_target(ht, d)

    def set_merkle_proof_target(self, proof_target, proof) -> None:
        for ht, sib in zip(proof_target.siblings, proof.siblings):
            self.set_hash_target(ht, sib)

    def set_fri_proof_target(self, fri_target, fri_proof) -> None:
        self.set_target(fri_target.pow_witness, int(fri_proof.pow_witness))
        self.set_extension_targets(fri_target.final_poly.coeffs,
                                   fri_proof.final_poly)
        for cap_t, cap in zip(fri_target.commit_phase_merkle_caps,
                              fri_proof.commit_phase_merkle_caps):
            self.set_cap_target(cap_t, cap)
        for qt, q in zip(fri_target.query_round_proofs,
                         fri_proof.query_round_proofs):
            for (leaves_t, mp_t), (leaves, mp) in zip(
                    qt.initial_trees_proof.evals_proofs,
                    q.initial_trees_proof.evals_proofs):
                for t, v in zip(leaves_t, np.asarray(
                        leaves, dtype=np.uint64).reshape(-1)):
                    self.set_target(t, int(v))
                self.set_merkle_proof_target(mp_t, mp)
            for st, step in zip(qt.steps, q.steps):
                self.set_extension_targets(st.evals, step.evals)
                self.set_merkle_proof_target(st.merkle_proof,
                                             step.merkle_proof)

    def set_proof_with_pis_target(self, pt, proof_with_pis) -> None:
        proof = proof_with_pis.proof
        for t, v in zip(pt.public_inputs, proof_with_pis.public_inputs):
            self.set_target(t, int(v))
        self.set_cap_target(pt.proof.wires_cap, proof.wires_cap)
        self.set_cap_target(pt.proof.plonk_zs_partial_products_cap,
                            proof.plonk_zs_partial_products_cap)
        self.set_cap_target(pt.proof.quotient_polys_cap,
                            proof.quotient_polys_cap)
        ot, o = pt.proof.openings, proof.openings
        for name in ("constants", "plonk_sigmas", "wires", "plonk_zs",
                     "plonk_zs_next", "partial_products", "quotient_polys"):
            self.set_extension_targets(getattr(ot, name), getattr(o, name))
        self.set_fri_proof_target(pt.proof.opening_proof,
                                  proof.opening_proof)

    def set_verifier_data_target(self, vt, verifier_data) -> None:
        self.set_cap_target(vt.constants_sigmas_cap,
                            verifier_data.constants_sigmas_cap)
        self.set_hash_target(vt.circuit_digest, verifier_data.circuit_digest)


class PartitionWitness:
    """One slot per representative of the copy-constraint forest."""

    def __init__(self, num_wires: int, degree: int, representative_map):
        self.num_wires = num_wires
        self.degree = degree
        self.rep_map = representative_map
        n = len(representative_map)
        self.values = np.zeros(n, dtype=np.uint64)
        self.is_set = np.zeros(n, dtype=bool)

    def rep(self, t: Target) -> int:
        return int(self.rep_map[target_index(t, self.num_wires,
                                             self.degree)])

    def contains(self, t: Target) -> bool:
        return bool(self.is_set[self.rep(t)])

    def get_target(self, t: Target) -> int:
        r = self.rep(t)
        if not self.is_set[r]:
            raise ValueError(f"target {t} not set")
        return int(self.values[r])

    def try_get_target(self, t: Target) -> Optional[int]:
        r = self.rep(t)
        return int(self.values[r]) if self.is_set[r] else None

    def set_target_returning_rep(self, t: Target,
                                 value: int) -> Optional[int]:
        """The representative's index if it was newly set; None if it was
        set already (to the same value, or this raises)."""
        r = self.rep(t)
        v = int(value)
        if self.is_set[r]:
            if int(self.values[r]) != v:
                raise ValueError(
                    f"Partition containing {t} was set twice with different "
                    f"values: {int(self.values[r])} != {v}")
            return None
        self.values[r] = v
        self.is_set[r] = True
        return r

    def get_targets(self, targets) -> List[int]:
        return [self.get_target(t) for t in targets]

    def full_witness(self) -> np.ndarray:
        """(num_wires, degree) wire values (the reference's
        MatrixWitness)."""
        return self.full_witness_rowmajor().T.copy()

    def full_witness_rowmajor(self) -> np.ndarray:
        """(degree, num_wires) wire values, the forest's own order, with
        one gather."""
        reps = np.asarray(self.rep_map[:self.degree * self.num_wires])
        return self.values[reps].reshape(self.degree, self.num_wires)
