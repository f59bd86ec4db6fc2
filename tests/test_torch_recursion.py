"""Recursion in the port against the JAX package, on the CPU.

Under a config of 135 wires with a small FRI (2 queries, cap height 1, one
bit of proof of work):

- the one-level recursion of models/bench_recursion.py: the no-op circuit
  of 2^6 rows (one fold) and its proof, and the circuit that verifies it
  (2^9 rows: the no-op circuit's gates are cheap to evaluate in the
  circuit): the circuits have JAX's gates, circuit digest and cap, the
  in-circuit challenges (``get_challenges_target``, read from the
  generated witness) equal the host's ``get_challenges``, the recursion
  proof serializes byte for byte like JAX's under the same witness
  randomness and both verifiers accept it, and a tampered opened wire
  makes the port's proof fail (tests/test_recursion.py:41-54);
- the one-level recursion circuit over the Fibonacci proof
  (tests/test_recursion.py:13-30; 2^11 rows) and the circuit that
  verifies the recursion proof have JAX's gates, circuit digest and cap;
- proved (`heavy`, as the JAX package's recursive proofs are `slow`):
  JAX's verifier accepts the port's double proof.

A recursion proof of 2^11 rows takes ~36 s on one core with the plain
versions; the tier-1 tests prove only the 2^9-row one, once, in the
module fixture.
"""
import contextlib
import random

import pytest
import torch

import plonky2_tpu.iop.generator as jgen_mod
from plonky2_tpu.fri.config import FriConfig as JaxFriConfig
from plonky2_tpu.fri.config import \
    FriReductionStrategy as JaxFriReductionStrategy
from plonky2_tpu.iop.witness import PartialWitness as JaxPartialWitness
from plonky2_tpu.models.fibonacci import \
    build_fibonacci_circuit as jax_fibonacci
from plonky2_tpu.plonk.circuit_builder import CircuitBuilder as JaxBuilder
from plonky2_tpu.plonk.config import CircuitConfig as JaxCircuitConfig
from plonky2_tpu.utils.serialization import \
    deserialize_proof as jax_deserialize
from plonky2_tpu.utils.serialization import serialize_proof as jax_serialize
from plonky2_tpu_torch.fri.config import FriConfig, FriReductionStrategy
from plonky2_tpu_torch.iop.generator import generate_partial_witness
from plonky2_tpu_torch.iop.witness import PartialWitness
from plonky2_tpu_torch.models import bench_recursion as br
from plonky2_tpu_torch.models.fibonacci import build_fibonacci_circuit
from plonky2_tpu_torch.plonk.config import CircuitConfig
from plonky2_tpu_torch.plonk.get_challenges import get_challenges
from plonky2_tpu_torch.plonk.recursive_verifier import RecursionGadgets
from plonky2_tpu_torch.runtime.session import ProverSession
from plonky2_tpu_torch.utils.serialization import serialize_proof
from tests.test_torch_prover import one_torch_thread  # noqa: F401
from tests.test_torch_prover import P

SEED = 0x5EED
FIXTURE_THREADS = 2
FRI = dict(rate_bits=3, cap_height=1, proof_of_work_bits=1,
           num_query_rounds=2)


def small_recursion_config():
    return CircuitConfig(fri_config=FriConfig(
        reduction_strategy=FriReductionStrategy.ConstantArityBits(4, 5),
        **FRI))


def jax_small_recursion_config():
    return JaxCircuitConfig(fri_config=JaxFriConfig(
        reduction_strategy=JaxFriReductionStrategy.ConstantArityBits(4, 5),
        **FRI))


@contextlib.contextmanager
def torch_threads(n: int):
    """n intra-op torch threads inside a module fixture (the suite's
    workers run one each).  These fixtures prove circuits of 2^11 and
    2^12 rows with the plain versions, minutes on one core: the cores the
    suite's workers leave idle shorten them."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@contextlib.contextmanager
def jax_randomness(seed: int = SEED):
    """The JAX host engine's random wires from random.Random(seed), as
    tests/test_torch_prover.py:pin_randomness draws them."""
    rng = random.Random(seed)

    def run_once(self, witness, out):
        out.append((self.target, rng.randrange(P)))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgen_mod.RandomValueGenerator, "run_once", run_once)
        yield


def jax_recursion_circuit(inner_data):
    b = JaxBuilder(jax_small_recursion_config())
    pt = b.add_virtual_proof_with_pis(inner_data.common)
    vt = b.add_virtual_verifier_data(FRI["cap_height"])
    b.verify_proof(pt, vt, inner_data.common)
    return b.build(), pt, vt


def jax_witness(pt, vt, proof_blob, inner_data):
    pw = JaxPartialWitness()
    pw.set_proof_with_pis_target(pt, jax_deserialize(proof_blob,
                                                     inner_data.common))
    pw.set_verifier_data_target(vt, inner_data.verifier_only)
    return pw


@pytest.fixture(scope="module")
def single():
    """The no-op proof of 2^6 rows and the one-level recursion over it, in
    both packages; the recursion circuit's challenge targets are kept."""
    config = small_recursion_config()
    with torch_threads(FIXTURE_THREADS):
        dummy = br.dummy_circuit_of_size(config, 6, device="cpu")
        dummy_proof = ProverSession(dummy, "cpu").prove(
            PartialWitness(), rng=random.Random(SEED))
        inner = (dummy_proof, dummy.verifier_only, dummy.common)

        kept = []
        orig = RecursionGadgets.get_challenges_target
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(RecursionGadgets, "get_challenges_target",
                       lambda self, *a: kept.append(orig(self, *a))
                       or kept[-1])
            data, pt, vt = br.recursion_circuit(dummy.common, config,
                                                device="cpu")
        pw = br.recursion_witness(pt, vt, inner)
        proof = ProverSession(data, "cpu").prove(pw, rng=random.Random(SEED))

    jdummy = jax_dummy_circuit(6)
    jdata, jpt, jvt = jax_recursion_circuit(jdummy)
    with jax_randomness():
        jproof = jdata.prove(jax_witness(
            jpt, jvt, serialize_proof(dummy_proof), jdummy))
    return dict(inner=inner, dummy=dummy, jdummy=jdummy, data=data, pt=pt,
                pw=pw, proof=proof, challenges=kept[0], jdata=jdata,
                jproof=jproof)


def jax_dummy_circuit(log2_size: int):
    """bench_recursion.rs:70-91's no-op circuit, built by the JAX
    package."""
    from plonky2_tpu.gates.basic import NoopGate as JaxNoopGate
    b = JaxBuilder(jax_small_recursion_config())
    for _ in range((1 << (log2_size - 1)) + 1):
        b.add_gate(JaxNoopGate(), [])
    return b.build()


def test_recursion_circuits_equal_jax(single):
    for data, jdata, bits in ((single["dummy"], single["jdummy"], 6),
                              (single["data"], single["jdata"], 9)):
        assert [g.id() for g in data.common.gates] == \
            [g.id() for g in jdata.common.gates]
        assert data.common.degree_bits() == jdata.common.degree_bits() == bits
        assert data.common.num_constants == jdata.common.num_constants
        assert [int(x) for x in data.verifier_only.circuit_digest] == \
            [int(x) for x in jdata.verifier_only.circuit_digest]
        assert data.verifier_only.constants_sigmas_cap.digests.tolist() == \
            jdata.verifier_only.constants_sigmas_cap.digests.tolist()
    single["dummy"].verify(single["inner"][0])


def test_fibonacci_recursion_circuit_equals_jax():
    """tests/test_recursion.py's outer circuit: it verifies the Fibonacci
    proof (2^11 rows, the recursion gate set's 11 gates)."""
    config = small_recursion_config()
    with torch_threads(FIXTURE_THREADS):
        fib, _, _ = build_fibonacci_circuit(config, device="cpu")
        data, _, _ = br.recursion_circuit(fib.common, config, device="cpu")
    jfib, _, _ = jax_fibonacci(jax_small_recursion_config())
    jdata, _, _ = jax_recursion_circuit(jfib)
    assert [g.id() for g in data.common.gates] == \
        [g.id() for g in jdata.common.gates]
    assert len(data.common.gates) == 11
    assert data.common.degree_bits() == jdata.common.degree_bits() == 11
    assert [int(x) for x in data.verifier_only.circuit_digest] == \
        [int(x) for x in jdata.verifier_only.circuit_digest]
    assert data.verifier_only.constants_sigmas_cap.digests.tolist() == \
        jdata.verifier_only.constants_sigmas_cap.digests.tolist()


def test_in_circuit_challenges_equal_host(single):
    proof, vd, cd = single["inner"]
    data, ch = single["data"], single["challenges"]
    with torch_threads(FIXTURE_THREADS):
        witness = generate_partial_witness(single["pw"], data.prover_only,
                                           data.common,
                                           rng=random.Random(SEED))
    want = get_challenges(proof, proof.get_public_inputs_hash(),
                          vd.circuit_digest, cd)

    def val(ts):
        return [witness.try_get_target(t) for t in ts]

    assert val(ch.plonk_betas) == list(want.plonk_betas)
    assert val(ch.plonk_gammas) == list(want.plonk_gammas)
    assert val(ch.plonk_alphas) == list(want.plonk_alphas)
    assert tuple(val(ch.plonk_zeta)) == tuple(want.plonk_zeta)
    fri, wfri = ch.fri_challenges, want.fri_challenges
    assert tuple(val(fri.fri_alpha)) == tuple(wfri.fri_alpha)
    assert [tuple(val(b)) for b in fri.fri_betas] == \
        [tuple(b) for b in wfri.fri_betas]
    assert val([fri.fri_pow_response]) == [wfri.fri_pow_response]
    # the circuit draws each query index as a field element, whose low
    # bits the FRI verifier takes; the host reduces it mod the LDE size
    lde_size = 1 << (cd.degree_bits() + cd.config.fri_config.rate_bits)
    assert [v % lde_size for v in val(fri.fri_query_indices)] == \
        list(wfri.fri_query_indices)


def test_recursion_proof_equals_jax_and_verifies(single):
    data, proof = single["data"], single["proof"]
    blob = serialize_proof(proof)
    assert blob == jax_serialize(single["jproof"])
    assert proof.public_inputs == []
    data.verify(proof)
    single["jdata"].verify(jax_deserialize(blob, single["jdata"].common))


def test_tampered_opened_wire_fails(single):
    """tests/test_recursion.py:test_recursive_verifier_rejects_tampered_
    proof: one opened wire value changed makes the in-circuit checks
    unsatisfiable (a conflict in the witness or a rejected proof)."""
    data, pt, pw = single["data"], single["pt"], single["pw"]
    bad = PartialWitness()
    bad.target_values = dict(pw.target_values)
    t = pt.proof.openings.wires[0][0]
    bad.target_values[t] = (bad.target_values[t] + 1) % P
    with pytest.raises(Exception):
        data.verify(ProverSession(data, "cpu").prove(
            bad, rng=random.Random(SEED)))


@pytest.mark.heavy
def test_double_recursion_proof(single):
    """bench_recursion's second link: a proof of the recursion proof; its
    circuit has JAX's degree, digest and cap, and JAX's verifier accepts
    the port's double proof."""
    middle = (single["proof"], single["data"].verifier_only,
              single["data"].common)
    with torch_threads(FIXTURE_THREADS):
        proof, vd, cd = br.recursive_proof(middle, small_recursion_config(),
                                           device="cpu",
                                           rng=random.Random(SEED))
    jdata, _, _ = jax_recursion_circuit(single["jdata"])
    assert cd.degree_bits() == jdata.common.degree_bits()
    assert [int(x) for x in vd.circuit_digest] == \
        [int(x) for x in jdata.verifier_only.circuit_digest]
    assert vd.constants_sigmas_cap.digests.tolist() == \
        jdata.verifier_only.constants_sigmas_cap.digests.tolist()
    jdata.verify(jax_deserialize(serialize_proof(proof), jdata.common))
