"""ProverSession against the JAX package's prover, on the CPU.

The port's whole path, build -> witness -> ProverSession.prove, with the
quotient program compiled by the session, on the hash tree of 2^5 leaves
under CircuitConfig.wide_ecc_config() and the fibonacci circuit under the
fast test config:

- the proof serializes byte for byte like the JAX ``data.prove(pw)``
  under the same seeded witness randomness;
- both verifiers accept it, and ``deserialize_proof`` round-trips it;
- a second proof reuses the session's ProverContext and build()'s
  constants-sigmas commitment, which is not committed again.

and, under standard_recursion_config, on the hash tree of 2^3 leaves and
the gate mix (models/gate_mix.py, one copy): the proof serializes byte
for byte like JAX's, and both verifiers accept it (the example circuits:
tests/test_torch_session_examples.py).  The device witness plan
refuses the gate mix, whose generators it has no batches for, and the
session runs the host engine.
"""
import random

import numpy as np
import pytest

import plonky2_tpu_torch.runtime.session as session_mod
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
from tests.test_torch_program_builder import circuit_pair

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
    sess = ProverSession(td, device="cpu")
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


@pytest.mark.parametrize("name,size", [("hash_tree_std", 3),
                                       ("gate_mix", 1)])
def test_compiled_session_proof_equals_jax(monkeypatch, name, size):
    """A circuit of the recursion gate set or of another config than the
    shipped program's proves through the session's compiled program, byte
    for byte like JAX's prover, and JAX's verifier accepts the proof."""
    assert_session_proof_equals_jax(monkeypatch, name, size)


def assert_session_proof_equals_jax(monkeypatch, name, size):
    (jd, jpw, jexp), (td, tpw, texp) = circuit_pair(name, size)
    pin_randomness(monkeypatch, SEED)
    want = jax_serialize(jd.prove(jpw))
    sess = ProverSession(td, device="cpu")
    proof = sess.prove(tpw, rng=random.Random(SEED))
    if texp is not None:
        assert proof.public_inputs == texp == jexp
    blob = serialize_proof(proof)
    assert blob == want
    sess.verify(proof)
    jd.verify(jax_deserialize(blob, jd.common))


def test_plan_refuses_the_gate_mix(monkeypatch):
    """The device witness plan has no batch for the recursion set's
    generators: it refuses the gate mix, and the session's proof runs the
    host engine (stage "witness", no "device witness")."""
    import contextlib

    from plonky2_tpu_torch.iop import device_witness as dw

    class Names:
        def __init__(self):
            self.names = []

        def scope(self, name):
            self.names.append(name)
            return contextlib.nullcontext()

    (_, _, _), (td, tpw, _) = circuit_pair("gate_mix", 1)
    assert dw.build_plan(td.prover_only, td.common, tpw, "cpu") is None
    timing = Names()
    sess = ProverSession(td, device="cpu", timing=timing)
    # the witness the proof would take (the proof itself stubbed out)
    monkeypatch.setattr(session_mod, "prove",
                        lambda data, witness, **kw: witness)
    witness = sess.prove(tpw, rng=random.Random(1), timing=timing)
    # ("witness plan" only where no earlier session of the circuit built
    # or refused its plan)
    assert timing.names[0] == "quotient program"
    assert timing.names[-1] == "witness"
    assert "device witness" not in timing.names
    np.testing.assert_array_equal(
        witness, sess.witness(tpw, rng=random.Random(1)))
