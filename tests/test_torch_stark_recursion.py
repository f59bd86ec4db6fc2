"""STARK wrapping in the port against the JAX package, on the CPU.

tests/test_stark_recursion.py's circuit: FibonacciStark(64)'s proof under
standard_fast_config verified in a circuit under
standard_recursion_config (stark/recursive_verifier.py;
models/stark_wrapper.py, written once for either builder), built by both
packages from their own STARK proofs (which tests/test_torch_stark.py
holds equal).
The tier-1 tests build it with each package's commitment recorded
(tests/test_torch_tree_recursion.py:recorded_commits):

- the wrapper's common data equals JAX's, its build commits JAX's
  constants and sigmas, value for value, and gives JAX's digest of the
  same cap;
- the witness the port's host engine generates from
  ``set_stark_proof_with_pis_target`` equals JAX's, wire for wire, under
  the same randomness;
- ``test_stark_circuit_constraints`` (stark/testing.py) passes on the
  Fibonacci STARK in both packages (the port's proves its circuit on the
  CPU);
- a copy of the STARK proof with one opened value changed is refused by
  the witness;
- built in full and proved (`heavy`, as the JAX package's wrapper proofs
  are `slow`): the circuit digest and cap equal JAX's, the port's proof
  equals JAX's byte for byte, and both verifiers accept it.

Exact equality.
"""
import contextlib
import random

import numpy as np
import pytest

import plonky2_tpu.plonk.circuit_builder as jcb
import plonky2_tpu_torch.plonk.circuit_builder as cb
from plonky2_tpu.iop.generator import \
    generate_partial_witness as jax_generate
from plonky2_tpu.hash.merkle import MerkleCap as JaxMerkleCap
from plonky2_tpu.iop.witness import PartialWitness as JaxPartialWitness
from plonky2_tpu.models.fibonacci_stark import \
    FibonacciStark as JaxFibonacciStark
from plonky2_tpu.plonk.circuit_builder import CircuitBuilder as JaxBuilder
from plonky2_tpu.plonk.config import CircuitConfig as JaxCircuitConfig
from plonky2_tpu.stark import recursive_verifier as jrv
from plonky2_tpu.stark import testing as jtesting
from plonky2_tpu.stark.config import StarkConfig as JaxStarkConfig
from plonky2_tpu.stark.prover import prove as jax_stark_prove
from plonky2_tpu.utils.serialization import \
    deserialize_proof as jax_deserialize
from plonky2_tpu.utils.serialization import serialize_proof as jax_serialize
from plonky2_tpu_torch.hash.merkle import MerkleCap
from plonky2_tpu_torch.iop.generator import generate_partial_witness
from plonky2_tpu_torch.iop.witness import PartialWitness
from plonky2_tpu_torch.models.fibonacci_stark import FibonacciStark
from plonky2_tpu_torch.models.stark_wrapper import place_stark_wrapper
from plonky2_tpu_torch.plonk.circuit_builder import CircuitBuilder
from plonky2_tpu_torch.plonk.config import CircuitConfig
from plonky2_tpu_torch.runtime.session import ProverSession
from plonky2_tpu_torch.stark import recursive_verifier as rv
from plonky2_tpu_torch.stark import testing
from plonky2_tpu_torch.stark.config import StarkConfig
from plonky2_tpu_torch.stark.prover import prove as stark_prove
from plonky2_tpu_torch.utils.serialization import serialize_proof
from tests.test_torch_prover import P, pin_randomness
from tests.test_torch_recursion import jax_randomness, torch_threads
from tests.test_torch_tree_recursion import recorded_commits

SEED = 0x5EED
ROWS = 64


def wrap(pkg_builder, config, rv_mod, stark, stark_config, proof):
    """The wrapper of `proof` on the package's builder, unbuilt."""
    b = pkg_builder(config)
    pt = place_stark_wrapper(b, rv_mod, stark, stark_config,
                             proof.proof.recover_degree_bits(stark_config))
    return b, pt


def wrapped_pair(record=None):
    """Both packages' STARK proofs, wrapper circuits, proof targets and
    witnesses; with `record` (a list), each build's commitment recorded
    there, [port's, JAX's], and a cap of zeros instead."""
    stark, jstark = FibonacciStark(ROWS), JaxFibonacciStark(ROWS)
    pis = [0, 1, stark.expected_result(0, 1)]
    config = StarkConfig.standard_fast_config()
    jconfig = JaxStarkConfig.standard_fast_config()
    with torch_threads(2):
        proof = stark_prove(stark, config, stark.generate_trace(0, 1), pis,
                            device="cpu")
    jproof = jax_stark_prove(jstark, jconfig, jstark.generate_trace(0, 1), pis)
    b, pt = wrap(CircuitBuilder, CircuitConfig.standard_recursion_config(),
                 rv, stark, config, proof)
    jb, jpt = wrap(JaxBuilder, JaxCircuitConfig.standard_recursion_config(),
                   jrv, jstark, jconfig, jproof)
    with contextlib.ExitStack() as stack:
        if record is not None:
            stack.enter_context(recorded_commits(cb, MerkleCap, record))
            stack.enter_context(recorded_commits(jcb, JaxMerkleCap, record))
        with torch_threads(2):
            data = b.build(device="cpu")
        jdata = jb.build()
    pw = PartialWitness()
    rv.set_stark_proof_with_pis_target(pw, pt, proof)
    jpw = JaxPartialWitness()
    jrv.set_stark_proof_with_pis_target(jpw, jpt, jproof)
    return dict(proof=proof, pt=pt, data=data, pw=pw, jdata=jdata, jpw=jpw)


@pytest.fixture(scope="module")
def wrapped():
    record = []
    out = wrapped_pair(record)
    out["commits"] = record
    return out


def test_wrapper_circuit_equals_jax(wrapped):
    c, jc = wrapped["data"].common, wrapped["jdata"].common
    commit, jcommit = wrapped["commits"]
    np.testing.assert_array_equal(commit, jcommit)
    assert [g.id() for g in c.gates] == [g.id() for g in jc.gates]
    for f in ("degree_bits", "num_public_inputs", "num_constants",
              "quotient_degree_factor", "num_partial_products"):
        v, jv = getattr(c, f), getattr(jc, f)
        assert (v() if callable(v) else v) == (jv() if callable(jv) else jv)
    assert c.k_is == jc.k_is
    assert c.selectors_info.selector_indices == \
        jc.selectors_info.selector_indices
    assert [int(x) for x in wrapped["data"].verifier_only.circuit_digest] \
        == [int(x) for x in wrapped["jdata"].verifier_only.circuit_digest]
    assert c.degree_bits() == 11


def test_wrapper_witness_equals_jax(wrapped, monkeypatch):
    data, jdata = wrapped["data"], wrapped["jdata"]
    with torch_threads(2):
        pwit = generate_partial_witness(wrapped["pw"], data.prover_only,
                                        data.common, rng=random.Random(SEED))
    pin_randomness(monkeypatch, SEED)
    want = jax_generate(wrapped["jpw"], jdata.prover_only,
                        jdata.common).full_witness()
    np.testing.assert_array_equal(pwit.full_witness(), want)
    assert pwit.get_targets(data.prover_only.public_inputs) == \
        [int(x) for x in wrapped["proof"].public_inputs]


def test_stark_circuit_constraints_both():
    with torch_threads(2):
        testing.test_stark_circuit_constraints(FibonacciStark(ROWS),
                                               device="cpu")
    jtesting.test_stark_circuit_constraints(JaxFibonacciStark(ROWS))


def test_tampered_stark_proof_refused(wrapped):
    """tests/test_stark_recursion.py:47-55: one opened value changed makes
    the circuit unsatisfiable: the host engine cannot complete the
    witness (a partition set twice, or a value that no split fits)."""
    data, pt, pw = wrapped["data"], wrapped["pt"], wrapped["pw"]
    bad = PartialWitness()
    bad.target_values = dict(pw.target_values)
    t = pt.proof.openings.local_values[0][0]
    bad.target_values[t] = (bad.target_values[t] + 1) % P
    with pytest.raises(ValueError):
        with torch_threads(2):
            generate_partial_witness(bad, data.prover_only, data.common,
                                     rng=random.Random(SEED))


@pytest.mark.heavy
def test_wrapper_proof_equals_jax():
    wrapped = wrapped_pair()
    data, jdata = wrapped["data"], wrapped["jdata"]
    vo, jvo = data.verifier_only, jdata.verifier_only
    assert [int(x) for x in vo.circuit_digest] == \
        [int(x) for x in jvo.circuit_digest]
    assert vo.constants_sigmas_cap.digests.tolist() == \
        jvo.constants_sigmas_cap.digests.tolist()
    with torch_threads(2):
        proof = ProverSession(data, "cpu").prove(wrapped["pw"],
                                                 rng=random.Random(SEED))
    with jax_randomness(SEED):
        jproof = jdata.prove(wrapped["jpw"])
    blob = serialize_proof(proof)
    assert blob == jax_serialize(jproof)
    assert proof.public_inputs == [int(x) for x in
                                   wrapped["proof"].public_inputs]
    data.verify(proof)
    jdata.verify(jax_deserialize(blob, jdata.common))
