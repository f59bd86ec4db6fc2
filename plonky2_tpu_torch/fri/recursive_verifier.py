"""The FRI verifier in the circuit (the port's copy of
plonky2_tpu/fri/recursive_verifier.py; reference
plonky2/src/fri/recursive_verifier.rs, and the target types of
fri/proof.rs and fri/structure.rs).

The gadgets do the work: Merkle paths through swapped Poseidon gates, the
folds through the coset interpolation gates, the alpha reductions through
the Reducing gates.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from ..field import goldilocks as gl
from ..gadgets.merkle import HashOutTarget, MerkleProofTarget
from ..gadgets.polynomial import PolynomialCoeffsExtTarget
from ..gadgets.reducing import ReducingFactorTarget
from ..iop.target import Target
from ..utils.bits import log2_strict, reverse_bits
from .config import FriParams
from .proof import SALT_SIZE

ExtensionTarget = Tuple[Target, Target]


# -- target containers (reference fri/proof.rs:37-96) ------------------------

@dataclass
class FriInitialTreeProofTarget:
    evals_proofs: List[Tuple[List[Target], MerkleProofTarget]]

    def unsalted_eval(self, oracle_index: int, poly_index: int,
                      salted: bool) -> Target:
        evals = self.evals_proofs[oracle_index][0]
        n = len(evals) - (SALT_SIZE if salted else 0)
        return evals[:n][poly_index]


@dataclass
class FriQueryStepTarget:
    evals: List[ExtensionTarget]
    merkle_proof: MerkleProofTarget


@dataclass
class FriQueryRoundTarget:
    initial_trees_proof: FriInitialTreeProofTarget
    steps: List[FriQueryStepTarget]


@dataclass
class FriProofTarget:
    commit_phase_merkle_caps: List[List[HashOutTarget]]
    query_round_proofs: List[FriQueryRoundTarget]
    final_poly: PolynomialCoeffsExtTarget
    pow_witness: Target


@dataclass
class FriChallengesTarget:
    fri_alpha: ExtensionTarget
    fri_betas: List[ExtensionTarget]
    fri_pow_response: Target
    fri_query_indices: List[Target]


@dataclass
class FriBatchInfoTarget:
    point: ExtensionTarget
    polynomials: list  # List[FriPolynomialInfo]


@dataclass
class FriInstanceInfoTarget:
    oracles: list  # List[FriOracleInfo]
    batches: List[FriBatchInfoTarget]


@dataclass
class FriOpeningBatchTarget:
    values: List[ExtensionTarget]


@dataclass
class FriOpeningsTarget:
    batches: List[FriOpeningBatchTarget]


class PrecomputedReducedOpeningsTarget:
    def __init__(self, openings: FriOpeningsTarget, alpha: ExtensionTarget,
                 builder):
        self.reduced_openings_at_point = [
            ReducingFactorTarget(alpha).reduce(batch.values, builder)
            for batch in openings.batches]


# -- virtual-proof allocation (reference fri/recursive_verifier.rs:404-477) --

class FriRecursiveGadgets:
    """Mixed into CircuitBuilder."""

    def add_virtual_fri_proof(self, num_leaves_per_oracle: List[int],
                              params: FriParams) -> FriProofTarget:
        cap_height = params.config.cap_height
        return FriProofTarget(
            commit_phase_merkle_caps=[
                self.add_virtual_cap(cap_height)
                for _ in params.reduction_arity_bits],
            query_round_proofs=[
                self._add_virtual_fri_query(num_leaves_per_oracle, params)
                for _ in range(params.config.num_query_rounds)],
            final_poly=PolynomialCoeffsExtTarget(
                self.add_virtual_extension_targets(params.final_poly_len())),
            pow_witness=self.add_virtual_target())

    def _add_virtual_fri_query(self, num_leaves_per_oracle,
                               params) -> FriQueryRoundTarget:
        cap_height = params.config.cap_height
        if params.lde_bits() < cap_height:
            raise ValueError("the cap is higher than the LDE")
        merkle_proof_len = params.lde_bits() - cap_height
        evals_proofs = [
            (self.add_virtual_targets(n),
             self.add_virtual_merkle_proof(merkle_proof_len))
            for n in num_leaves_per_oracle]
        steps = []
        for arity_bits in params.reduction_arity_bits:
            if merkle_proof_len < arity_bits:
                raise ValueError("a FRI reduction below the cap")
            merkle_proof_len -= arity_bits
            steps.append(FriQueryStepTarget(
                evals=self.add_virtual_extension_targets(1 << arity_bits),
                merkle_proof=self.add_virtual_merkle_proof(merkle_proof_len)))
        return FriQueryRoundTarget(
            initial_trees_proof=FriInitialTreeProofTarget(evals_proofs),
            steps=steps)

    # -- verification (reference fri/recursive_verifier.rs:27-382) ----------

    def verify_fri_proof_circuit(self, instance: FriInstanceInfoTarget,
                                 openings: FriOpeningsTarget,
                                 challenges: FriChallengesTarget,
                                 initial_merkle_caps: list,
                                 proof: FriProofTarget,
                                 params: FriParams) -> None:
        if params.final_poly_len() != len(proof.final_poly):
            raise ValueError("Final polynomial has wrong degree.")
        n = params.lde_size()

        # PoW check: response must have proof_of_work_bits leading zeros.
        self.assert_leading_zeros(challenges.fri_pow_response,
                                  params.config.proof_of_work_bits)

        if params.config.num_query_rounds != len(proof.query_round_proofs):
            raise ValueError("wrong number of query rounds")

        precomputed = PrecomputedReducedOpeningsTarget(
            openings, challenges.fri_alpha, self)

        for i, round_proof in enumerate(proof.query_round_proofs):
            self._fri_verifier_query_round(
                instance, challenges, precomputed, initial_merkle_caps, proof,
                challenges.fri_query_indices[i], n, round_proof, params)

    def _fri_verify_initial_proof(self, x_index_bits, proof,
                                  initial_merkle_caps, cap_index) -> None:
        for (evals, merkle_proof), cap in zip(proof.evals_proofs,
                                              initial_merkle_caps):
            self.verify_merkle_proof_to_cap_with_cap_index(
                list(evals), x_index_bits, cap_index, cap, merkle_proof)

    def _fri_combine_initial(self, instance: FriInstanceInfoTarget,
                             proof: FriInitialTreeProofTarget,
                             alpha: ExtensionTarget, subgroup_x: Target,
                             precomputed,
                             params: FriParams) -> ExtensionTarget:
        subgroup_x_ext = self.convert_to_ext(subgroup_x)
        alpha_rf = ReducingFactorTarget(alpha)
        total = self.zero_extension()
        for batch, reduced_openings in zip(
                instance.batches, precomputed.reduced_openings_at_point):
            evals = []
            for p in batch.polynomials:
                blinding = instance.oracles[p.oracle_index].blinding
                salted = params.hiding and blinding
                evals.append(proof.unsalted_eval(p.oracle_index,
                                                 p.polynomial_index, salted))
            reduced_evals = alpha_rf.reduce_base(evals, self)
            numerator = self.sub_extension(reduced_evals, reduced_openings)
            denominator = self.sub_extension(subgroup_x_ext, batch.point)
            total = alpha_rf.shift(total, self)
            total = self.div_add_extension(numerator, denominator, total)
        # times X so final_poly has maximal degree (mir-protocol/plonky2#436)
        return self.mul_extension(total, subgroup_x_ext)

    def _compute_evaluation(self, x: Target, x_index_within_coset_bits,
                            arity_bits: int, evals: List[ExtensionTarget],
                            beta: ExtensionTarget) -> ExtensionTarget:
        arity = 1 << arity_bits
        if len(evals) != arity:
            raise ValueError(f"a fold step of {len(evals)} values, expected "
                             f"{arity}")
        g = gl.primitive_root_of_unity(arity_bits)
        g_inv = pow(g, arity - 1, gl.P)

        # reorder evals into natural coset order
        evals_ord = [evals[reverse_bits(i, arity_bits)] for i in range(arity)]
        # coset_start = x * g^(arity - rev_index) = x * g_inv^rev_index
        start = self.exp_from_bits_const_base(
            g_inv, list(reversed(x_index_within_coset_bits)))
        coset_start = self.mul(start, x)
        # HighDegreeInterpolationGate has degree = arity; fall back to the
        # low-degree gate if the arity exceeds the quotient degree factor
        # (reference recursive_verifier.rs:53-69)
        high = arity <= self.config.max_quotient_degree_factor
        return self.interpolate_coset(arity_bits, coset_start, evals_ord, beta,
                                      high_degree=high)

    def _fri_verifier_query_round(self, instance, challenges, precomputed,
                                  initial_merkle_caps, proof, x_index: Target,
                                  n: int, round_proof, params) -> None:
        n_log = log2_strict(n)
        # Non-canonical binary decompositions are allowed; negligible
        # soundness impact (reference recursive_verifier.rs:384-402).
        x_index_bits = self.low_bits(x_index, n_log, 64)
        cap_index = self.le_sum(
            x_index_bits[len(x_index_bits) - params.config.cap_height:])

        self._fri_verify_initial_proof(
            x_index_bits, round_proof.initial_trees_proof,
            initial_merkle_caps, cap_index)

        # subgroup_x = SHIFT * phi^(rev x_index)
        g = self.constant(gl.MULTIPLICATIVE_GROUP_GENERATOR)
        phi = gl.primitive_root_of_unity(n_log)
        phi_pow = self.exp_from_bits_const_base(
            phi, list(reversed(x_index_bits)))
        subgroup_x = self.mul(g, phi_pow)

        old_eval = self._fri_combine_initial(
            instance, round_proof.initial_trees_proof, challenges.fri_alpha,
            subgroup_x, precomputed, params)

        for i, arity_bits in enumerate(params.reduction_arity_bits):
            evals = round_proof.steps[i].evals
            coset_index_bits = x_index_bits[arity_bits:]
            x_index_within_coset_bits = x_index_bits[:arity_bits]
            x_index_within_coset = self.le_sum(x_index_within_coset_bits)

            # consistency with the previous round's inferred evaluation
            new_eval = self.random_access_extension(x_index_within_coset,
                                                    list(evals))
            self.connect_extension(new_eval, old_eval)

            old_eval = self._compute_evaluation(
                subgroup_x, x_index_within_coset_bits, arity_bits, evals,
                challenges.fri_betas[i])

            flat_evals = [t for et in evals for t in et]
            self.verify_merkle_proof_to_cap_with_cap_index(
                flat_evals, coset_index_bits, cap_index,
                proof.commit_phase_merkle_caps[i],
                round_proof.steps[i].merkle_proof)

            subgroup_x = self.exp_power_of_2(subgroup_x, arity_bits)
            x_index_bits = coset_index_bits

        eval_final = proof.final_poly.eval_scalar(self, subgroup_x)
        self.connect_extension(eval_final, old_eval)
