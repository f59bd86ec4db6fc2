"""The PLONK verifier (the port's copy of plonky2_tpu/plonk/verifier.py;
reference plonky2/src/plonk/verifier.rs): the transcript replayed from the
proof, the vanishing polynomial at zeta against the quotient's opened
chunks, then the FRI proof of every opening, with the hasher the circuit
names (its transcript and its Merkle paths).  Host Python throughout."""
from __future__ import annotations

from ..field import extension as ge
from ..fri.verifier import verify_fri_proof
from .algebra import EvaluationVars, ScalarExt
from .get_challenges import get_challenges
from .proof import ProofWithPublicInputs
from .vanishing import eval_l_0_ext, eval_vanishing_poly


class ProofVerificationError(Exception):
    pass


def _ensure(cond, msg):
    if not cond:
        raise ProofVerificationError(msg)


def verify(proof_with_pis: ProofWithPublicInputs, verifier_data,
           common_data) -> None:
    """Raises ProofVerificationError or fri.verifier.FriVerificationError
    unless the proof verifies."""
    public_inputs_hash = proof_with_pis.get_public_inputs_hash()
    _ensure(len(proof_with_pis.public_inputs)
            == common_data.num_public_inputs,
            "wrong number of public inputs")
    challenges = get_challenges(proof_with_pis, public_inputs_hash,
                                verifier_data.circuit_digest, common_data)
    verify_with_challenges(proof_with_pis.proof, public_inputs_hash,
                           challenges, verifier_data, common_data)


def vanishing_at_zeta(proof, public_inputs_hash, challenges,
                      common_data) -> list:
    """The num_challenges vanishing values at zeta from the opened
    values."""
    alg = ScalarExt()
    openings = proof.openings
    to_ext = lambda arr: [(int(v[0]), int(v[1])) for v in arr]  # noqa: E731
    vars = EvaluationVars(
        local_constants=to_ext(openings.constants),
        local_wires=to_ext(openings.wires),
        public_inputs_hash=[alg.const(int(x)) for x in public_inputs_hash])
    zeta = challenges.plonk_zeta
    return eval_vanishing_poly(
        alg, common_data, zeta, vars,
        to_ext(openings.plonk_zs), to_ext(openings.plonk_zs_next),
        to_ext(openings.partial_products), to_ext(openings.plonk_sigmas),
        challenges.plonk_betas, challenges.plonk_gammas,
        challenges.plonk_alphas,
        eval_l_0_ext(alg, common_data.degree(), zeta))


def verify_with_challenges(proof, public_inputs_hash, challenges,
                           verifier_data, common_data) -> None:
    vanishing = vanishing_at_zeta(proof, public_inputs_hash, challenges,
                                  common_data)
    # Z_H(zeta) * t(zeta) == vanishing(zeta), per challenge
    zeta = challenges.plonk_zeta
    zeta_pow_deg = ge.s_exp(zeta, common_data.degree())
    z_h_zeta = ge.s_sub(zeta_pow_deg, (1, 0))
    quotient = [(int(v[0]), int(v[1])) for v in proof.openings.quotient_polys]
    qdf = common_data.quotient_degree_factor
    for i in range(common_data.config.num_challenges):
        acc = (0, 0)
        for c in reversed(quotient[i * qdf:(i + 1) * qdf]):
            acc = ge.s_add(ge.s_mul(acc, zeta_pow_deg), c)
        _ensure(vanishing[i] == ge.s_mul(z_h_zeta, acc),
                f"vanishing polynomial check failed for challenge {i}")

    merkle_caps = [verifier_data.constants_sigmas_cap, proof.wires_cap,
                   proof.plonk_zs_partial_products_cap,
                   proof.quotient_polys_cap]
    verify_fri_proof(common_data.get_fri_instance(zeta),
                     proof.openings.to_fri_openings(),
                     challenges.fri_challenges, merkle_caps,
                     proof.opening_proof, common_data.fri_params,
                     common_data.hasher())
