"""The port's verifier against the JAX package's, on the CPU.

On the hash tree of 2^5 leaves under CircuitConfig.wide_ecc_config() (28
queries, 16 bits of proof of work, one fold layer) and the fibonacci
circuit under the fast test config:

- the port's verifier accepts the JAX prover's proof (read with the port's
  ``deserialize_proof`` from JAX's bytes) and the port's own;
- it replays JAX's challenges and computes JAX's vanishing values at zeta;
- both verifiers reject each corrupted copy: one opened value, one word of
  a cap, the proof-of-work witness, one Merkle sibling, one public input.
"""
import functools
import random

import pytest

from plonky2_tpu.fri.verifier import \
    FriVerificationError as JaxFriVerificationError
from plonky2_tpu.plonk.verifier import \
    ProofVerificationError as JaxProofVerificationError
from plonky2_tpu.utils.serialization import \
    deserialize_proof as jax_deserialize
from plonky2_tpu.utils.serialization import serialize_proof as jax_serialize
from plonky2_tpu_torch.fri.verifier import FriVerificationError
from plonky2_tpu_torch.plonk.get_challenges import get_challenges
from plonky2_tpu_torch.plonk.verifier import (ProofVerificationError,
                                              vanishing_at_zeta)
from plonky2_tpu_torch.runtime.session import ProverSession
from plonky2_tpu_torch.utils.serialization import (deserialize_proof,
                                                   serialize_proof)
from tests.test_torch_circuit_builder import circuits
from tests.test_torch_prover import one_torch_thread  # noqa: F401
from tests.test_torch_prover import P, pin_randomness

SEED = 0x5EED
CASES = [("hash_tree", 5), ("fibonacci", 99)]


@functools.lru_cache(maxsize=None)
def proofs(name: str, size: int):
    """(JAX proof bytes, the port's proof bytes) of one circuit, each
    prover's witness from the same seeded stream."""
    (jd, jpw, _), (td, tpw, _) = circuits(name, size)
    with pytest.MonkeyPatch.context() as mp:
        pin_randomness(mp, SEED)
        jax_bytes = jax_serialize(jd.prove(jpw))
    sess = ProverSession(td, device="cpu")
    port_bytes = serialize_proof(sess.prove(tpw, rng=random.Random(SEED)))
    return jax_bytes, port_bytes


@pytest.mark.parametrize("name,size", CASES)
def test_port_verifier_accepts_both_proofs(name, size):
    (jd, _, _), (td, _, _) = circuits(name, size)
    jax_bytes, port_bytes = proofs(name, size)
    for blob in (jax_bytes, port_bytes):
        td.verify(deserialize_proof(blob, td.common))
        jd.verify(jax_deserialize(blob, jd.common))


@pytest.mark.parametrize("name,size", CASES)
def test_challenges_and_vanishing_equal_jax(name, size):
    from plonky2_tpu.plonk.algebra import EvaluationVars, ScalarExt
    from plonky2_tpu.plonk.get_challenges import \
        get_challenges as jax_challenges
    from plonky2_tpu.plonk.vanishing import eval_l_0_ext, eval_vanishing_poly
    (jd, _, _), (td, _, _) = circuits(name, size)
    blob = proofs(name, size)[0]
    tp, jp = deserialize_proof(blob, td.common), jax_deserialize(blob,
                                                                 jd.common)
    pih = tp.get_public_inputs_hash()
    tch = get_challenges(tp, pih, td.verifier_only.circuit_digest, td.common)
    jch = jax_challenges(jp, jp.get_public_inputs_hash(),
                         jd.verifier_only.circuit_digest, jd.common)
    for f in ("plonk_betas", "plonk_gammas", "plonk_alphas", "plonk_zeta"):
        assert getattr(tch, f) == getattr(jch, f), f
    tf, jf = tch.fri_challenges, jch.fri_challenges
    assert (tf.fri_alpha, tf.fri_betas, tf.fri_pow_response,
            tf.fri_query_indices) == (jf.fri_alpha, jf.fri_betas,
                                      jf.fri_pow_response,
                                      jf.fri_query_indices)

    alg = ScalarExt()
    o = jp.proof.openings
    to_ext = lambda arr: [(int(v[0]), int(v[1])) for v in arr]  # noqa: E731
    jvars = EvaluationVars(to_ext(o.constants), to_ext(o.wires),
                           [alg.const(int(x)) for x in pih])
    want = eval_vanishing_poly(
        alg, jd.common, jch.plonk_zeta, jvars, to_ext(o.plonk_zs),
        to_ext(o.plonk_zs_next), to_ext(o.partial_products),
        to_ext(o.plonk_sigmas), jch.plonk_betas, jch.plonk_gammas,
        jch.plonk_alphas, eval_l_0_ext(alg, jd.common.degree(),
                                       jch.plonk_zeta))
    assert vanishing_at_zeta(tp.proof, pih, tch, td.common) == want


def _bump(arr, idx):
    arr[idx] = (int(arr[idx]) + 1) % P


CORRUPTIONS = {
    "opened value": lambda p: _bump(p.proof.openings.wires, (0, 0)),
    "cap word": lambda p: _bump(p.proof.wires_cap.digests, (0, 0)),
    "pow witness": lambda p: setattr(
        p.proof.opening_proof, "pow_witness",
        (p.proof.opening_proof.pow_witness + 1) % P),
    "merkle sibling": lambda p: _bump(
        p.proof.opening_proof.query_round_proofs[0].initial_trees_proof
        .evals_proofs[1][1].siblings[0], 0),
    "public input": lambda p: p.public_inputs.__setitem__(
        0, (p.public_inputs[0] + 1) % P),
}


@pytest.mark.parametrize("what", list(CORRUPTIONS))
@pytest.mark.parametrize("name,size", CASES)
def test_both_verifiers_reject_corrupted_proofs(name, size, what):
    (jd, _, _), (td, _, _) = circuits(name, size)
    blob = proofs(name, size)[1]
    tp, jp = deserialize_proof(blob, td.common), jax_deserialize(blob,
                                                                 jd.common)
    for p in (tp, jp):
        CORRUPTIONS[what](p)
    assert serialize_proof(tp) == jax_serialize(jp) != blob
    with pytest.raises((ProofVerificationError, FriVerificationError)):
        td.verify(tp)
    with pytest.raises((JaxProofVerificationError, JaxFriVerificationError)):
        jd.verify(jp)
