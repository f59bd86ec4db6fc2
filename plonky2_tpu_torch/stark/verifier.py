"""The STARK verifier: the port's counterpart of
plonky2_tpu/stark/verifier.py (reference starky/src/verifier.rs,
get_challenges.rs), on the host."""
from __future__ import annotations

from ..field import extension as ext
from ..field import goldilocks as gl
from ..fri.challenges import fri_challenges, observe_openings
from ..fri.verifier import verify_fri_proof
from ..iop.challenger import Challenger
from ..plonk.algebra import ScalarExt
from .permutation import (challenge_values, eval_permutation_checks,
                          get_n_permutation_challenge_sets)
from .proof import StarkProofChallenges, StarkProofWithPublicInputs
from .stark import ConstraintConsumer, Stark, StarkEvaluationVars


class StarkVerificationError(Exception):
    pass


def _ensure(cond, msg):
    if not cond:
        raise StarkVerificationError(msg)


def get_challenges(stark: Stark, proof_with_pis: StarkProofWithPublicInputs,
                   config, degree_bits: int) -> StarkProofChallenges:
    proof = proof_with_pis.proof
    ch = Challenger()
    ch.observe_cap(proof.trace_cap)
    challenge_sets = None
    if proof.permutation_zs_cap is not None:
        challenge_sets = get_n_permutation_challenge_sets(
            ch, config.num_challenges, stark.permutation_batch_size())
        ch.observe_cap(proof.permutation_zs_cap)
    stark_alphas = ch.get_n_challenges(config.num_challenges)
    ch.observe_cap(proof.quotient_polys_cap)
    stark_zeta = ch.get_extension_challenge()
    observe_openings(ch, proof.openings.to_fri_openings())
    return StarkProofChallenges(
        permutation_challenge_sets=challenge_sets,
        stark_alphas=stark_alphas,
        stark_zeta=stark_zeta,
        fri_challenges=fri_challenges(
            ch, proof.opening_proof.commit_phase_merkle_caps,
            proof.opening_proof.final_poly, proof.opening_proof.pow_witness,
            degree_bits, config.fri_config))


def eval_l_0_and_l_last(log_n: int, x):
    n = 1 << log_n
    g = gl.primitive_root_of_unity(log_n)
    z_x = ext.s_sub(ext.s_exp(x, n), (1, 0))
    d0 = ext.s_mul((n, 0), ext.s_sub(x, (1, 0)))
    d1 = ext.s_mul((n, 0), ext.s_sub(ext.s_mul(x, (g, 0)), (1, 0)))
    return ext.s_mul(z_x, ext.s_inv(d0)), ext.s_mul(z_x, ext.s_inv(d1))


def check_quotient(vanishing, quotient, zeta, degree_bits: int, qdf: int,
                   num_challenges: int, fail) -> None:
    """Z_H(zeta) t(zeta) == vanishing(zeta) for each challenge, t's chunks
    recombined with zeta^n."""
    zeta_pow_deg = ext.s_exp(zeta, 1 << degree_bits)
    z_h_zeta = ext.s_sub(zeta_pow_deg, (1, 0))
    for i in range(num_challenges):
        acc = (0, 0)
        for c in reversed(quotient[i * qdf:(i + 1) * qdf]):
            acc = ext.s_add(ext.s_mul(acc, zeta_pow_deg), c)
        if vanishing[i] != ext.s_mul(z_h_zeta, acc):
            fail(f"quotient mismatch for challenge {i}")


def verify_stark_proof(stark: Stark, proof_with_pis: StarkProofWithPublicInputs,
                       config) -> None:
    _ensure(len(proof_with_pis.public_inputs) == stark.PUBLIC_INPUTS,
            "wrong number of public inputs")
    degree_bits = proof_with_pis.proof.recover_degree_bits(config)
    challenges = get_challenges(stark, proof_with_pis, config, degree_bits)
    verify_stark_proof_with_challenges(stark, proof_with_pis, challenges,
                                       degree_bits, config)


def _to_ext(arr) -> list:
    return [(int(v[0]), int(v[1])) for v in arr]


def verify_stark_proof_with_challenges(stark, proof_with_pis, challenges,
                                       degree_bits: int, config) -> None:
    proof = proof_with_pis.proof
    _ensure((proof.permutation_zs_cap is not None)
            == stark.uses_permutation_args(), "permutation data mismatch")
    alg = ScalarExt()
    vars = StarkEvaluationVars(
        local_values=_to_ext(proof.openings.local_values),
        next_values=_to_ext(proof.openings.next_values),
        public_inputs=[alg.const(int(p))
                       for p in proof_with_pis.public_inputs])
    zeta = challenges.stark_zeta
    l_0, l_last = eval_l_0_and_l_last(degree_bits, zeta)
    g = gl.primitive_root_of_unity(degree_bits)
    z_last = ext.s_sub(zeta, (gl.s_inv(g), 0))
    consumer = ConstraintConsumer(
        alg, [alg.const(a) for a in challenges.stark_alphas], z_last, l_0,
        l_last)
    stark.eval(alg, vars, consumer)
    if stark.uses_permutation_args():
        eval_permutation_checks(
            alg, stark, config, vars,
            _to_ext(proof.openings.permutation_zs),
            _to_ext(proof.openings.permutation_zs_next),
            challenge_values(alg, challenges.permutation_challenge_sets),
            consumer)
    check_quotient(consumer.accumulators(),
                   _to_ext(proof.openings.quotient_polys), zeta, degree_bits,
                   stark.quotient_degree_factor(), config.num_challenges,
                   lambda msg: _ensure(False, msg))

    merkle_caps = [proof.trace_cap]
    if proof.permutation_zs_cap is not None:
        merkle_caps.append(proof.permutation_zs_cap)
    merkle_caps.append(proof.quotient_polys_cap)
    verify_fri_proof(stark.fri_instance(zeta, g, config),
                     proof.openings.to_fri_openings(),
                     challenges.fri_challenges, merkle_caps,
                     proof.opening_proof, config.fri_params(degree_bits))
