"""The verifier's replay of the transcript (the port's copy of
plonky2_tpu/plonk/get_challenges.py; reference
plonky2/src/plonk/get_challenges.rs:25-72)."""
from __future__ import annotations

from ..fri.challenges import fri_challenges, observe_openings
from ..iop.challenger import Challenger
from .proof import ProofChallenges, ProofWithPublicInputs


def get_challenges(proof_with_pis: ProofWithPublicInputs, public_inputs_hash,
                   circuit_digest, common_data) -> ProofChallenges:
    config = common_data.config
    num_challenges = config.num_challenges
    proof = proof_with_pis.proof

    ch = Challenger(permutation=common_data.hasher().permute)
    ch.observe_hash(circuit_digest)
    ch.observe_hash(public_inputs_hash)

    ch.observe_cap(proof.wires_cap)
    plonk_betas = ch.get_n_challenges(num_challenges)
    plonk_gammas = ch.get_n_challenges(num_challenges)

    ch.observe_cap(proof.plonk_zs_partial_products_cap)
    plonk_alphas = ch.get_n_challenges(num_challenges)

    ch.observe_cap(proof.quotient_polys_cap)
    plonk_zeta = ch.get_extension_challenge()

    observe_openings(ch, proof.openings.to_fri_openings())

    return ProofChallenges(
        plonk_betas=plonk_betas, plonk_gammas=plonk_gammas,
        plonk_alphas=plonk_alphas, plonk_zeta=plonk_zeta,
        fri_challenges=fri_challenges(
            ch, proof.opening_proof.commit_phase_merkle_caps,
            proof.opening_proof.final_poly, proof.opening_proof.pow_witness,
            common_data.degree_bits(), config.fri_config))
