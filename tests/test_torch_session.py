"""ProverSession against the JAX package's prover, on the CPU.

The port's whole path, build -> host witness -> ProverSession.prove, on
the hash tree of 2^5 leaves under CircuitConfig.wide_ecc_config() (the
shipped quotient program) and on the fibonacci circuit under the fast test
config (its program from the JAX compiler, given as ``program=``):

- the proof serializes byte for byte like the JAX ``data.prove(pw)``
  under the same seeded witness randomness;
- both verifiers accept it, and ``deserialize_proof`` round-trips it;
- a second proof reuses the session's ProverContext and build()'s
  constants-sigmas commitment, which is not committed again.
"""
import random

import pytest

from plonky2_tpu.utils.serialization import \
    deserialize_proof as jax_deserialize
from plonky2_tpu.utils.serialization import serialize_proof as jax_serialize
from plonky2_tpu_torch.fri.oracle import PolynomialBatch
from plonky2_tpu_torch.runtime.session import ProverSession
from plonky2_tpu_torch.utils.serialization import (deserialize_proof,
                                                   serialize_proof)
from tests.test_torch_circuit_builder import circuits
from tests.test_torch_prover import one_torch_thread  # noqa: F401
from tests.test_torch_prover import pin_randomness
from tests.test_torch_verifier import jax_program

SEED = 0x5EED


@pytest.mark.parametrize("name,size", [("hash_tree", 5), ("fibonacci", 99)])
def test_session_proof_is_byte_identical_and_reused(monkeypatch, name,
                                                    size):
    (jd, jpw, jexp), (td, tpw, texp) = circuits(name, size)
    pin_randomness(monkeypatch, SEED)
    want = jax_serialize(jd.prove(jpw))

    commits = []
    orig = PolynomialBatch.from_coeffs

    def counted(polys, *args, **kwargs):
        commits.append(tuple(polys.shape))
        return orig(polys, *args, **kwargs)
    monkeypatch.setattr(PolynomialBatch, "from_coeffs",
                        staticmethod(counted))
    program = None if name == "hash_tree" else jax_program(jd.common)
    sess = ProverSession(td, program=program, device="cpu")
    cs = td.prover_only.constants_sigmas_commitment
    assert sess.context.cs_batch is cs
    assert commits == []               # no constants-sigmas commitment
    context, quotient = sess.context, sess.context.quotient

    proof = sess.prove(tpw, rng=random.Random(SEED))
    assert proof.public_inputs == texp == jexp
    blob = serialize_proof(proof)
    assert blob == want
    sess.verify(proof)
    jd.verify(jax_deserialize(blob, jd.common))
    again = deserialize_proof(blob, td.common)
    assert serialize_proof(again) == blob
    sess.verify(again)

    # the second proof: the same context, no constants-sigmas commitment
    # (the only commitment from coefficients is the quotient's)
    commits.clear()
    second = sess.prove(tpw, rng=random.Random(SEED))
    assert sess.context is context and sess.context.quotient is quotient
    assert sess.context.cs_batch is cs
    nq = td.common.num_quotient_polys()
    assert commits == [(nq, td.common.degree())]
    assert serialize_proof(second) == blob


def test_session_refuses_a_commitment_on_another_device(monkeypatch):
    """A session proves on the device build() committed on: a
    constants-sigmas commitment that lies elsewhere (here faked as a meta
    tensor) raises instead of being committed again."""
    (_, _, _), (td, _, _) = circuits("hash_tree", 2)
    cs = td.prover_only.constants_sigmas_commitment
    monkeypatch.setattr(cs, "leaves_dev", cs.leaves_dev.to("meta"))
    with pytest.raises(ValueError, match="constants-sigmas commitment"):
        ProverSession(td, device="cpu")


def test_session_defaults_to_cuda(monkeypatch):
    """A session proves on cuda unless told otherwise: given a circuit
    built on the CPU and no device, it raises rather than proving there
    with the plain versions."""
    import torch
    (_, _, _), (td, _, _) = circuits("hash_tree", 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="the context on cuda"):
        ProverSession(td)


def test_lies_on():
    import torch

    from plonky2_tpu_torch import lies_on
    t = torch.zeros(2)
    assert lies_on(t, torch.device("cpu"))
    assert not lies_on(t, torch.device("meta"))
    assert not lies_on(t.to("meta"), torch.device("cpu"))
