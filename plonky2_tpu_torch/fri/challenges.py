"""The FRI transcript (the port's counterpart of
plonky2_tpu/fri/challenges.py; reference plonky2/src/fri/challenges.rs):
the prover observes the claimed values; the verifier replays the rest
from a proof."""
from __future__ import annotations

from .config import FriConfig
from .proof import FriChallenges
from .structure import FriOpenings


def observe_openings(challenger, openings: FriOpenings) -> None:
    """Every claimed value, batch by batch, as extension elements."""
    for batch in openings.batches:
        for v in batch.values:
            challenger.observe_extension_element(v)


def fri_challenges(challenger, commit_phase_merkle_caps, final_poly,
                   pow_witness: int, degree_bits: int,
                   config: FriConfig) -> FriChallenges:
    """alpha, each layer cap's beta, the proof-of-work response and the
    query indices, as the prover drew them."""
    lde_size = 1 << (degree_bits + config.rate_bits)
    fri_alpha = challenger.get_extension_challenge()
    fri_betas = []
    for cap in commit_phase_merkle_caps:
        challenger.observe_cap(cap)
        fri_betas.append(challenger.get_extension_challenge())
    challenger.observe_extension_elements(final_poly)
    challenger.observe_element(pow_witness)
    fri_pow_response = challenger.get_challenge()
    fri_query_indices = [challenger.get_challenge() % lde_size
                         for _ in range(config.num_query_rounds)]
    return FriChallenges(fri_alpha=fri_alpha, fri_betas=fri_betas,
                         fri_pow_response=fri_pow_response,
                         fri_query_indices=fri_query_indices)
