"""PLONK proof containers and the opening set.

The port's counterpart of plonky2_tpu/plonk/proof.py (``OpeningSet.new``,
``to_fri_openings``, ``Proof``, ``ProofWithPublicInputs``,
``ProofChallenges``), with the same field names.  The opened values come
from the commitments' resident coefficients (ops/openings.py); only the
(B, 2) values reach the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..field import extension as ext
from ..fri.proof import FriChallenges, FriProof
from ..fri.structure import FriOpeningBatch, FriOpenings
from ..hash import poseidon as pos
from ..hash.merkle import MerkleCap
from ..ops.openings import (eval_device_polys_ext, eval_openings_batched,
                            ext_powers)


@dataclass
class OpeningSet:
    constants: np.ndarray        # (k, 2) extension values
    plonk_sigmas: np.ndarray
    wires: np.ndarray
    plonk_zs: np.ndarray
    plonk_zs_next: np.ndarray
    partial_products: np.ndarray
    quotient_polys: np.ndarray

    @staticmethod
    def new(zeta, g: int, constants_sigmas_commitment, wires_commitment,
            zs_partial_products_commitment, quotient_polys_commitment,
            data) -> "OpeningSet":
        """All four oracles' polynomials at zeta and the Zs at g * zeta;
        ``data`` gives the ranges (a plonk.prover_data.ProverData)."""
        zeta_next = ext.s_mul(zeta, (g, 0))
        (cs_eval,), (wires_eval,), (zspp_eval,), (q_eval,) = \
            eval_openings_batched(
                [constants_sigmas_commitment, wires_commitment,
                 zs_partial_products_commitment, quotient_polys_commitment],
                [zeta])
        zs = zs_partial_products_commitment.coeffs_dev[
            data.zs_range().start:data.zs_range().stop]
        zs_next = eval_device_polys_ext(
            zs, ext_powers(zeta_next, zs.shape[-1], zs.device))
        rows = lambda a, r: a[r.start:r.stop]  # noqa: E731
        return OpeningSet(
            constants=rows(cs_eval, data.constants_range()),
            plonk_sigmas=rows(cs_eval, data.sigmas_range()),
            wires=wires_eval,
            plonk_zs=rows(zspp_eval, data.zs_range()),
            plonk_zs_next=zs_next,
            partial_products=rows(zspp_eval, data.partial_products_range()),
            quotient_polys=q_eval)

    def to_fri_openings(self) -> FriOpenings:
        zeta_values = np.concatenate([
            self.constants, self.plonk_sigmas, self.wires, self.plonk_zs,
            self.partial_products, self.quotient_polys], axis=0)
        as_pairs = lambda a: [(int(v[0]), int(v[1])) for v in a]  # noqa: E731
        return FriOpenings(batches=[
            FriOpeningBatch(values=as_pairs(zeta_values)),
            FriOpeningBatch(values=as_pairs(self.plonk_zs_next))])


@dataclass
class Proof:
    wires_cap: MerkleCap
    plonk_zs_partial_products_cap: MerkleCap
    quotient_polys_cap: MerkleCap
    openings: OpeningSet
    opening_proof: FriProof


@dataclass
class ProofWithPublicInputs:
    proof: Proof
    public_inputs: List[int]

    def get_public_inputs_hash(self) -> np.ndarray:
        return pos.hash_no_pad(np.array(self.public_inputs, dtype=np.uint64))


@dataclass
class ProofChallenges:
    plonk_betas: List[int]
    plonk_gammas: List[int]
    plonk_alphas: List[int]
    plonk_zeta: Tuple[int, int]
    fri_challenges: FriChallenges
