"""The STARK verifier in a circuit: a STARK proof wrapped in a plonky2
circuit (the port's copy of plonky2_tpu/stark/recursive_verifier.py;
reference starky/src/recursive_verifier.rs:28-330 and the circuit forms of
get_challenges.rs).

Every ``Stark.eval`` is written against an algebra, so the constraints the
prover compiles for K6 are evaluated here with ``CircuitExtAlgebra``, which
emits the check as gates: there is no evaluator written for the circuit
per STARK.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ..field import goldilocks as gl
from ..fri.recursive_verifier import (FriBatchInfoTarget, FriChallengesTarget,
                                      FriInstanceInfoTarget,
                                      FriOpeningBatchTarget, FriOpeningsTarget,
                                      FriProofTarget)
from ..fri.structure import FriOracleInfo, FriPolynomialInfo
from ..gadgets.reducing import ReducingFactorTarget
from ..iop.challenger import RecursiveChallenger
from ..plonk.algebra import CircuitExtAlgebra
from .permutation import get_permutation_batches
from .stark import ConstraintConsumer, Stark, StarkEvaluationVars


@dataclass
class PermutationChallengeTarget:
    beta: object   # Target
    gamma: object  # Target


@dataclass
class PermutationChallengeSetTarget:
    challenges: List[PermutationChallengeTarget]


@dataclass
class StarkOpeningSetTarget:
    local_values: list
    next_values: list
    permutation_zs: Optional[list]
    permutation_zs_next: Optional[list]
    quotient_polys: list

    def to_fri_openings(self) -> FriOpeningsTarget:
        zeta = list(self.local_values)
        if self.permutation_zs is not None:
            zeta += list(self.permutation_zs)
        zeta += list(self.quotient_polys)
        zeta_next = list(self.next_values)
        if self.permutation_zs_next is not None:
            zeta_next += list(self.permutation_zs_next)
        return FriOpeningsTarget(batches=[FriOpeningBatchTarget(zeta),
                                          FriOpeningBatchTarget(zeta_next)])


@dataclass
class StarkProofTarget:
    trace_cap: list
    permutation_zs_cap: Optional[list]
    quotient_polys_cap: list
    openings: StarkOpeningSetTarget
    opening_proof: FriProofTarget


@dataclass
class StarkProofWithPublicInputsTarget:
    proof: StarkProofTarget
    public_inputs: list


@dataclass
class StarkProofChallengesTarget:
    permutation_challenge_sets: Optional[List[PermutationChallengeSetTarget]]
    stark_alphas: list
    stark_zeta: tuple
    fri_challenges: FriChallengesTarget


def add_virtual_stark_proof_with_pis(builder, stark: Stark, config,
                                     degree_bits: int
                                     ) -> StarkProofWithPublicInputsTarget:
    """(reference recursive_verifier.rs:193-240)."""
    fri_params = config.fri_params(degree_bits)
    cap_height = fri_params.config.cap_height
    num_leaves_per_oracle = [stark.COLUMNS]
    if stark.uses_permutation_args():
        num_leaves_per_oracle.append(stark.num_permutation_batches(config))
    num_quotient = stark.quotient_degree_factor() * config.num_challenges
    num_leaves_per_oracle.append(num_quotient)

    ext = builder.add_virtual_extension_targets
    nz = (stark.num_permutation_batches(config)
          if stark.uses_permutation_args() else None)
    openings = StarkOpeningSetTarget(
        local_values=ext(stark.COLUMNS),
        next_values=ext(stark.COLUMNS),
        permutation_zs=ext(nz) if nz else None,
        permutation_zs_next=ext(nz) if nz else None,
        quotient_polys=ext(num_quotient))
    proof = StarkProofTarget(
        trace_cap=builder.add_virtual_cap(cap_height),
        permutation_zs_cap=(builder.add_virtual_cap(cap_height)
                            if stark.uses_permutation_args() else None),
        quotient_polys_cap=builder.add_virtual_cap(cap_height),
        openings=openings,
        opening_proof=builder.add_virtual_fri_proof(num_leaves_per_oracle,
                                                    fri_params))
    return StarkProofWithPublicInputsTarget(
        proof=proof, public_inputs=builder.add_virtual_targets(
            stark.PUBLIC_INPUTS))


def set_stark_proof_with_pis_target(pw, pt: StarkProofWithPublicInputsTarget,
                                    proof_with_pis) -> None:
    """(reference recursive_verifier.rs:262-314)."""
    proof = proof_with_pis.proof
    for t, v in zip(pt.public_inputs, proof_with_pis.public_inputs):
        pw.set_target(t, int(v))
    pw.set_cap_target(pt.proof.trace_cap, proof.trace_cap)
    if pt.proof.permutation_zs_cap is not None:
        pw.set_cap_target(pt.proof.permutation_zs_cap,
                          proof.permutation_zs_cap)
    pw.set_cap_target(pt.proof.quotient_polys_cap, proof.quotient_polys_cap)
    ot, o = pt.proof.openings, proof.openings
    pw.set_extension_targets(ot.local_values, o.local_values)
    pw.set_extension_targets(ot.next_values, o.next_values)
    if ot.permutation_zs is not None:
        pw.set_extension_targets(ot.permutation_zs, o.permutation_zs)
        pw.set_extension_targets(ot.permutation_zs_next, o.permutation_zs_next)
    pw.set_extension_targets(ot.quotient_polys, o.quotient_polys)
    pw.set_fri_proof_target(pt.proof.opening_proof, proof.opening_proof)


def get_stark_challenges_target(builder, stark: Stark,
                                proof_with_pis:
                                StarkProofWithPublicInputsTarget,
                                config) -> StarkProofChallengesTarget:
    """Fiat-Shamir transcript in-circuit, mirroring the native
    stark.verifier.get_challenges transcript order exactly."""
    proof = proof_with_pis.proof
    ch = RecursiveChallenger(builder)
    ch.observe_cap(proof.trace_cap)
    challenge_sets = None
    if proof.permutation_zs_cap is not None:
        challenge_sets = []
        for _ in range(stark.permutation_batch_size()):
            chs = []
            for _ in range(config.num_challenges):
                beta = ch.get_challenge(builder)
                gamma = ch.get_challenge(builder)
                chs.append(PermutationChallengeTarget(beta, gamma))
            challenge_sets.append(PermutationChallengeSetTarget(chs))
        ch.observe_cap(proof.permutation_zs_cap)
    stark_alphas = ch.get_n_challenges(builder, config.num_challenges)
    ch.observe_cap(proof.quotient_polys_cap)
    stark_zeta = ch.get_extension_challenge(builder)
    ch.observe_openings(proof.openings.to_fri_openings())
    return StarkProofChallengesTarget(
        permutation_challenge_sets=challenge_sets,
        stark_alphas=stark_alphas,
        stark_zeta=stark_zeta,
        fri_challenges=ch.fri_challenges(
            builder, proof.opening_proof.commit_phase_merkle_caps,
            proof.opening_proof.final_poly,
            proof.opening_proof.pow_witness, config.fri_config))


def _eval_l_0_and_l_last_circuit(builder, log_n: int, x, z_x):
    """L_0(x) = Z_H(x)/(n(x-1)), L_last(x) = Z_H(x)/(n(gx-1))
    (reference recursive_verifier.rs:174-192)."""
    n = 1 << log_n
    g = gl.primitive_root_of_unity(log_n)
    one = builder.one_extension()
    n_ext = builder.constant_extension((n, 0))
    l_0_deno = builder.mul_extension(
        n_ext, builder.sub_extension(x, one))
    gx = builder.mul_const_extension(g, x)
    l_last_deno = builder.mul_extension(
        n_ext, builder.sub_extension(gx, one))
    return (builder.div_extension(z_x, l_0_deno),
            builder.div_extension(z_x, l_last_deno))


def _eval_permutation_checks_circuit(builder, alg, stark, config, vars,
                                     local_zs, next_zs, challenge_sets,
                                     consumer) -> None:
    """Circuit variant of stark.permutation.eval_permutation_checks — here
    beta/gamma are circuit targets, so the beta-power weights are built with
    circuit multiplications instead of int scalars
    (reference permutation.rs eval_permutation_checks_circuit)."""
    one = alg.one()
    for z in local_zs:
        consumer.constraint_first_row(alg.sub(z, one))
    batches = get_permutation_batches(stark.permutation_pairs(),
                                      challenge_sets, config.num_challenges,
                                      stark.permutation_batch_size())
    for i, instances in enumerate(batches):
        lhs_prod = None
        rhs_prod = None
        for pair, ch in instances:
            beta = builder.convert_to_ext(ch.beta)
            lhs = builder.convert_to_ext(ch.gamma)
            rhs = lhs
            weight = one
            for (li, ri) in pair.column_pairs:
                lhs = alg.add(lhs, alg.mul(vars.local_values[li], weight))
                rhs = alg.add(rhs, alg.mul(vars.local_values[ri], weight))
                weight = alg.mul(weight, beta)
            lhs_prod = lhs if lhs_prod is None else alg.mul(lhs_prod, lhs)
            rhs_prod = rhs if rhs_prod is None else alg.mul(rhs_prod, rhs)
        consumer.constraint(alg.sub(alg.mul(next_zs[i], rhs_prod),
                                    alg.mul(local_zs[i], lhs_prod)))


def _stark_fri_instance_target(builder, stark: Stark, zeta, g: int,
                               config) -> FriInstanceInfoTarget:
    """Circuit mirror of Stark.fri_instance (reference stark.rs:139-178)."""
    oracles = [FriOracleInfo(stark.COLUMNS, False)]
    trace_info = FriPolynomialInfo.from_range(0, range(stark.COLUMNS))
    if stark.uses_permutation_args():
        nz = stark.num_permutation_batches(config)
        perm_info = FriPolynomialInfo.from_range(len(oracles), range(nz))
        oracles.append(FriOracleInfo(nz, False))
    else:
        perm_info = []
    nq = stark.quotient_degree_factor() * config.num_challenges
    quot_info = FriPolynomialInfo.from_range(len(oracles), range(nq))
    oracles.append(FriOracleInfo(nq, False))
    zeta_next = builder.mul_const_extension(g, zeta)
    return FriInstanceInfoTarget(
        oracles=oracles,
        batches=[FriBatchInfoTarget(point=zeta,
                                    polynomials=trace_info + perm_info
                                    + quot_info),
                 FriBatchInfoTarget(point=zeta_next,
                                    polynomials=trace_info + perm_info)])


def verify_stark_proof_circuit(builder, stark: Stark,
                               proof_with_pis:
                               StarkProofWithPublicInputsTarget,
                               inner_config, degree_bits: int) -> None:
    """(reference recursive_verifier.rs:28-172)."""
    if len(proof_with_pis.public_inputs) != stark.PUBLIC_INPUTS:
        raise ValueError(f"{stark.PUBLIC_INPUTS} public inputs expected")
    challenges = get_stark_challenges_target(builder, stark, proof_with_pis,
                                             inner_config)
    proof = proof_with_pis.proof
    openings = proof.openings
    alg = CircuitExtAlgebra(builder)
    vars = StarkEvaluationVars(
        local_values=list(openings.local_values),
        next_values=list(openings.next_values),
        public_inputs=[builder.convert_to_ext(t)
                       for t in proof_with_pis.public_inputs])

    zeta = challenges.stark_zeta
    one = builder.one_extension()
    zeta_pow_deg = builder.exp_power_of_2_extension(zeta, degree_bits)
    z_h_zeta = builder.sub_extension(zeta_pow_deg, one)
    l_0, l_last = _eval_l_0_and_l_last_circuit(builder, degree_bits, zeta,
                                               z_h_zeta)
    g = gl.primitive_root_of_unity(degree_bits)
    last = builder.constant_extension((gl.s_inv(g), 0))
    z_last = builder.sub_extension(zeta, last)

    consumer = ConstraintConsumer(
        alg, [builder.convert_to_ext(a) for a in challenges.stark_alphas],
        z_last, l_0, l_last)
    stark.eval(alg, vars, consumer)
    if stark.uses_permutation_args():
        _eval_permutation_checks_circuit(
            builder, alg, stark, inner_config, vars,
            list(openings.permutation_zs), list(openings.permutation_zs_next),
            challenges.permutation_challenge_sets, consumer)
    vanishing = consumer.accumulators()

    # vanishing(zeta) == Z_H(zeta) * quotient(zeta), per challenge
    qdf = stark.quotient_degree_factor()
    for i in range(inner_config.num_challenges):
        chunk = openings.quotient_polys[i * qdf:(i + 1) * qdf]
        recombined = ReducingFactorTarget(zeta_pow_deg).reduce(chunk, builder)
        computed = builder.mul_extension(z_h_zeta, recombined)
        builder.connect_extension(vanishing[i], computed)

    merkle_caps = [proof.trace_cap]
    if proof.permutation_zs_cap is not None:
        merkle_caps.append(proof.permutation_zs_cap)
    merkle_caps.append(proof.quotient_polys_cap)

    fri_instance = _stark_fri_instance_target(builder, stark, zeta, g,
                                              inner_config)
    builder.verify_fri_proof_circuit(
        fri_instance, openings.to_fri_openings(), challenges.fri_challenges,
        merkle_caps, proof.opening_proof,
        inner_config.fri_params(degree_bits))
