"""The PLONK verifier in the circuit, the entry point of recursion (the
port's copy of plonky2_tpu/plonk/recursive_verifier.py; reference
plonky2/src/recursion/recursive_verifier.rs, plonk/vanishing_poly.rs:343,
plonk/get_challenges.rs:238, plonk/plonk_common.rs:73).

The gates' constraints are each gate's one ``eval_unfiltered`` run on
plonk/algebra.py:CircuitExtAlgebra: no gate has a second, hand-written
evaluator for the circuit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from ..field import goldilocks as gl
from ..fri.proof import SALT_SIZE
from ..fri.recursive_verifier import (FriBatchInfoTarget,
                                      FriInstanceInfoTarget,
                                      FriOpeningBatchTarget,
                                      FriOpeningsTarget, FriProofTarget)
from ..gadgets.merkle import HashOutTarget
from ..gadgets.reducing import ReducingFactorTarget
from ..iop.challenger import RecursiveChallenger
from ..iop.target import Target
from .algebra import CircuitExtAlgebra, EvaluationVars
from .vanishing import evaluate_gate_constraints

ExtensionTarget = Tuple[Target, Target]


# -- target containers (reference plonk/proof.rs) -----------------------------

@dataclass
class OpeningSetTarget:
    constants: List[ExtensionTarget]
    plonk_sigmas: List[ExtensionTarget]
    wires: List[ExtensionTarget]
    plonk_zs: List[ExtensionTarget]
    plonk_zs_next: List[ExtensionTarget]
    partial_products: List[ExtensionTarget]
    quotient_polys: List[ExtensionTarget]

    def to_fri_openings(self) -> FriOpeningsTarget:
        zeta_batch = FriOpeningBatchTarget(
            values=(self.constants + self.plonk_sigmas + self.wires
                    + self.plonk_zs + self.partial_products
                    + self.quotient_polys))
        zeta_next_batch = FriOpeningBatchTarget(
            values=list(self.plonk_zs_next))
        return FriOpeningsTarget(batches=[zeta_batch, zeta_next_batch])


@dataclass
class ProofTarget:
    wires_cap: List[HashOutTarget]
    plonk_zs_partial_products_cap: List[HashOutTarget]
    quotient_polys_cap: List[HashOutTarget]
    openings: OpeningSetTarget
    opening_proof: FriProofTarget


@dataclass
class ProofWithPublicInputsTarget:
    proof: ProofTarget
    public_inputs: List[Target]


@dataclass
class VerifierCircuitTarget:
    constants_sigmas_cap: List[HashOutTarget]
    circuit_digest: HashOutTarget


@dataclass
class ProofChallengesTarget:
    plonk_betas: List[Target]
    plonk_gammas: List[Target]
    plonk_alphas: List[Target]
    plonk_zeta: ExtensionTarget
    fri_challenges: object  # FriChallengesTarget


def salt_size(hiding: bool) -> int:
    return SALT_SIZE if hiding else 0


# -- in-circuit helpers -------------------------------------------------------

def eval_l_0_circuit(builder, n: int, x: ExtensionTarget,
                     x_pow_n: ExtensionTarget) -> ExtensionTarget:
    """L_0(x) = (x^n - 1) / (n (x - 1)); assumes x != 1
    (reference plonk_common.rs:73-93)."""
    one = builder.one_extension()
    neg_one = builder.convert_to_ext(builder.neg_one())
    zero_poly = builder.sub_extension(x_pow_n, one)
    denominator = builder.arithmetic_extension(n % gl.P, n % gl.P, x, one,
                                               neg_one)
    return builder.div_extension(zero_poly, denominator)


def check_partial_products_circuit(builder, numerators, denominators, partials,
                                   z_x, z_gx, max_degree: int):
    accs = [z_x] + list(partials) + [z_gx]
    out = []
    idx = 0
    chunk_i = 0
    n = len(numerators)
    while idx < n:
        chunk = range(idx, min(idx + max_degree, n))
        num_prod = builder.mul_many_extension(numerators[j] for j in chunk)
        den_prod = builder.mul_many_extension(denominators[j] for j in chunk)
        prev_acc = accs[chunk_i]
        next_acc = accs[chunk_i + 1]
        lhs = builder.mul_extension(prev_acc, num_prod)
        rhs = builder.mul_extension(next_acc, den_prod)
        out.append(builder.sub_extension(lhs, rhs))
        idx += max_degree
        chunk_i += 1
    return out


def eval_vanishing_poly_circuit(builder, common_data,
                                x: ExtensionTarget, x_pow_deg: ExtensionTarget,
                                vars: EvaluationVars, local_zs, next_zs,
                                partial_products, s_sigmas, betas, gammas,
                                alphas) -> List[ExtensionTarget]:
    """(reference vanishing_poly.rs:343-439); challenges are base Targets."""
    max_degree = common_data.quotient_degree_factor
    num_prods = common_data.num_partial_products

    alg = CircuitExtAlgebra(builder)
    constraint_terms = evaluate_gate_constraints(alg, common_data, vars)

    l_0_x = eval_l_0_circuit(builder, common_data.degree(), x, x_pow_deg)

    # s_ids[j] = k_j * x
    s_ids = [builder.mul_const_extension(k, x) for k in common_data.k_is]

    vanishing_z_1_terms = []
    vanishing_partial_products_terms = []
    for i in range(common_data.config.num_challenges):
        z_x = local_zs[i]
        z_gx = next_zs[i]
        # L_0(x) (Z(x) - 1)
        vanishing_z_1_terms.append(
            builder.mul_sub_extension(l_0_x, z_x, l_0_x))

        beta_ext = builder.convert_to_ext(betas[i])
        gamma_ext = builder.convert_to_ext(gammas[i])
        numerators = []
        denominators = []
        for j in range(common_data.config.num_routed_wires):
            wire_value = vars.local_wires[j]
            wire_plus_gamma = builder.add_extension(wire_value, gamma_ext)
            numerators.append(
                builder.mul_add_extension(beta_ext, s_ids[j], wire_plus_gamma))
            denominators.append(
                builder.mul_add_extension(beta_ext, s_sigmas[j],
                                          wire_plus_gamma))

        pps = partial_products[i * num_prods:(i + 1) * num_prods]
        vanishing_partial_products_terms.extend(
            check_partial_products_circuit(builder, numerators, denominators,
                                           pps, z_x, z_gx, max_degree))

    terms = (vanishing_z_1_terms + vanishing_partial_products_terms
             + constraint_terms)
    out = []
    for alpha in alphas:
        alpha_ext = builder.convert_to_ext(alpha)
        out.append(ReducingFactorTarget(alpha_ext).reduce(terms, builder))
    return out


def get_fri_instance_target(builder, common_data,
                            zeta: ExtensionTarget) -> FriInstanceInfoTarget:
    """(reference circuit_data.rs get_fri_instance_target)."""
    from ..fri.structure import FriPolynomialInfo
    all_polys = [
        p for o, n in enumerate((common_data.num_preprocessed_polys(),
                                 common_data.config.num_wires,
                                 common_data.num_zs_partial_products_polys(),
                                 common_data.num_quotient_polys()))
        for p in FriPolynomialInfo.from_range(o, range(n))]
    zs_polys = FriPolynomialInfo.from_range(2, common_data.zs_range())
    g = gl.primitive_root_of_unity(common_data.degree_bits())
    zeta_next = builder.mul_const_extension(g, zeta)
    return FriInstanceInfoTarget(
        oracles=common_data.fri_oracles(),
        batches=[FriBatchInfoTarget(point=zeta, polynomials=all_polys),
                 FriBatchInfoTarget(point=zeta_next, polynomials=zs_polys)])


# -- builder mixin ------------------------------------------------------------

class RecursionGadgets:
    """Mixed into CircuitBuilder."""

    def add_virtual_proof_with_pis(
            self, common_data) -> ProofWithPublicInputsTarget:
        proof = self._add_virtual_proof(common_data)
        public_inputs = self.add_virtual_targets(common_data.num_public_inputs)
        return ProofWithPublicInputsTarget(proof=proof,
                                           public_inputs=public_inputs)

    def _add_virtual_proof(self, common_data) -> ProofTarget:
        config = common_data.config
        fri_params = common_data.fri_params
        cap_height = fri_params.config.cap_height
        salt = salt_size(fri_params.hiding)
        num_leaves_per_oracle = [
            common_data.num_preprocessed_polys(),
            config.num_wires + salt,
            common_data.num_zs_partial_products_polys() + salt,
            common_data.num_quotient_polys() + salt,
        ]
        return ProofTarget(
            wires_cap=self.add_virtual_cap(cap_height),
            plonk_zs_partial_products_cap=self.add_virtual_cap(cap_height),
            quotient_polys_cap=self.add_virtual_cap(cap_height),
            openings=self._add_opening_set(common_data),
            opening_proof=self.add_virtual_fri_proof(num_leaves_per_oracle,
                                                     fri_params))

    def _add_opening_set(self, common_data) -> OpeningSetTarget:
        config = common_data.config
        num_challenges = config.num_challenges
        total_partial_products = (num_challenges
                                  * common_data.num_partial_products)
        ext = self.add_virtual_extension_targets
        return OpeningSetTarget(
            constants=ext(common_data.num_constants),
            plonk_sigmas=ext(config.num_routed_wires),
            wires=ext(config.num_wires),
            plonk_zs=ext(num_challenges),
            plonk_zs_next=ext(num_challenges),
            partial_products=ext(total_partial_products),
            quotient_polys=ext(common_data.num_quotient_polys()))

    def add_virtual_verifier_data(self,
                                  cap_height: int) -> VerifierCircuitTarget:
        return VerifierCircuitTarget(
            constants_sigmas_cap=self.add_virtual_cap(cap_height),
            circuit_digest=self.add_virtual_hash())

    def get_challenges_target(
            self, proof_with_pis: ProofWithPublicInputsTarget,
            public_inputs_hash: HashOutTarget,
            inner_circuit_digest: HashOutTarget,
            inner_common_data) -> ProofChallengesTarget:
        config = inner_common_data.config
        num_challenges = config.num_challenges
        proof = proof_with_pis.proof

        ch = RecursiveChallenger(self)
        ch.observe_hash(inner_circuit_digest)
        ch.observe_hash(public_inputs_hash)

        ch.observe_cap(proof.wires_cap)
        plonk_betas = ch.get_n_challenges(self, num_challenges)
        plonk_gammas = ch.get_n_challenges(self, num_challenges)

        ch.observe_cap(proof.plonk_zs_partial_products_cap)
        plonk_alphas = ch.get_n_challenges(self, num_challenges)

        ch.observe_cap(proof.quotient_polys_cap)
        plonk_zeta = ch.get_extension_challenge(self)

        ch.observe_openings(proof.openings.to_fri_openings())

        return ProofChallengesTarget(
            plonk_betas=plonk_betas, plonk_gammas=plonk_gammas,
            plonk_alphas=plonk_alphas, plonk_zeta=plonk_zeta,
            fri_challenges=ch.fri_challenges(
                self, proof.opening_proof.commit_phase_merkle_caps,
                proof.opening_proof.final_poly,
                proof.opening_proof.pow_witness,
                config.fri_config))

    def verify_proof(self, proof_with_pis: ProofWithPublicInputsTarget,
                     inner_verifier_data: VerifierCircuitTarget,
                     inner_common_data) -> None:
        """Recursively verifies an inner proof
        (reference recursion/recursive_verifier.rs:17-127)."""
        if (len(proof_with_pis.public_inputs)
                != inner_common_data.num_public_inputs):
            raise ValueError("wrong number of public inputs")
        public_inputs_hash = tuple(
            self.hash_n_to_hash_no_pad(list(proof_with_pis.public_inputs)))
        challenges = self.get_challenges_target(
            proof_with_pis, public_inputs_hash,
            inner_verifier_data.circuit_digest, inner_common_data)
        self._verify_proof_with_challenges(
            proof_with_pis.proof, public_inputs_hash, challenges,
            inner_verifier_data, inner_common_data)

    def _verify_proof_with_challenges(self, proof: ProofTarget,
                                      public_inputs_hash, challenges,
                                      inner_verifier_data,
                                      inner_common_data) -> None:
        one = self.one_extension()
        openings = proof.openings
        vars = EvaluationVars(
            local_constants=list(openings.constants),
            local_wires=list(openings.wires),
            public_inputs_hash=[self.convert_to_ext(t)
                                for t in public_inputs_hash])

        zeta_pow_deg = self.exp_power_of_2_extension(
            challenges.plonk_zeta, inner_common_data.degree_bits())
        vanishing = eval_vanishing_poly_circuit(
            self, inner_common_data, challenges.plonk_zeta, zeta_pow_deg, vars,
            openings.plonk_zs, openings.plonk_zs_next,
            openings.partial_products, openings.plonk_sigmas,
            challenges.plonk_betas, challenges.plonk_gammas,
            challenges.plonk_alphas)

        # Z_H(zeta) * t(zeta) == vanishing(zeta), per challenge
        qdf = inner_common_data.quotient_degree_factor
        scale = ReducingFactorTarget(zeta_pow_deg)
        z_h_zeta = self.sub_extension(zeta_pow_deg, one)
        for i in range(inner_common_data.config.num_challenges):
            chunk = openings.quotient_polys[i * qdf:(i + 1) * qdf]
            recombined = scale.reduce(chunk, self)
            computed = self.mul_extension(z_h_zeta, recombined)
            self.connect_extension(vanishing[i], computed)

        merkle_caps = [
            inner_verifier_data.constants_sigmas_cap,
            proof.wires_cap,
            proof.plonk_zs_partial_products_cap,
            proof.quotient_polys_cap,
        ]

        fri_instance = get_fri_instance_target(self, inner_common_data,
                                               challenges.plonk_zeta)
        self.verify_fri_proof_circuit(
            fri_instance, openings.to_fri_openings(),
            challenges.fri_challenges, merkle_caps, proof.opening_proof,
            inner_common_data.fri_params)
