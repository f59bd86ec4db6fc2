"""The EVM tables' wrappers in the port against the JAX package, on the CPU.

On tests/test_evm_recursion.py's one-op proof under standard_fast_config
(the port's proof; tests/test_torch_evm.py holds the port's and JAX's
proofs equal word for word, and the JAX side reads the port's proof here
through utils/serialization.py:proof_from_plain):

- ``replay_challenger_states`` equals JAX's: the CTL challenges and each
  table's sponge states before and after its part of the transcript;
- ``PublicInputs.from_vec`` decodes a public-input vector as JAX's does;
- the memory table's wrapper circuit (evm/recursive_verifier.py:
  recursive_stark_circuit) has JAX's gates, circuit digest and cap;
- its witness, generated by the host engine, gives the public inputs
  that tests/test_evm_recursion.py:29-50 checks: the transcript's
  states, the CTL challenges, the proof's ``ctl_zs_last`` and trace cap;
- wrong CTL challenges are refused (tests/test_evm_recursion.py:54-70);
- proved (`heavy`): the memory wrapper's proof verifies with its decoded
  public inputs; every table wrapped (wrap_all_proof) passes
  verify_recursive_all_proof (tests/test_evm_recursion.py:73-81).

Exact equality.
"""
import random

import pytest

from plonky2_tpu.evm import all_stark as jast
from plonky2_tpu.evm import recursive_verifier as jrv
from plonky2_tpu.stark.config import StarkConfig as JaxStarkConfig
from plonky2_tpu_torch.evm import all_stark
from plonky2_tpu_torch.evm import recursive_verifier as rv
from plonky2_tpu_torch.evm.keccak_sponge import KeccakSpongeOp
from plonky2_tpu_torch.evm.prover import prove_all
from plonky2_tpu_torch.iop.generator import generate_partial_witness
from plonky2_tpu_torch.stark.config import StarkConfig
from plonky2_tpu_torch.utils.serialization import (proof_from_plain,
                                                   proof_to_plain)
from scripts.jax_verify_evm_proof import jax_classes
from tests.test_torch_prover import P
from tests.test_torch_recursion import torch_threads

SEED = 0x5EED
MEMORY = all_stark.MEMORY


@pytest.fixture(scope="module")
def evm():
    """The one-op proof in both packages' classes, and the replays."""
    stark = all_stark.make_all_stark()
    config = StarkConfig.standard_fast_config()
    traces = all_stark.generate_all_traces(
        [KeccakSpongeOp(0, 2, 0, 1, b"recursive aggregation")])
    with torch_threads(2):
        proof = prove_all(stark, config, traces, device="cpu")
    skeleton, arrays = proof_to_plain(proof)
    jproof = proof_from_plain(skeleton, arrays, jax_classes())
    jstark = jast.make_all_stark()
    jconfig = JaxStarkConfig.standard_fast_config()
    return dict(stark=stark, config=config, proof=proof, jstark=jstark,
                jconfig=jconfig, jproof=jproof,
                replay=rv.replay_challenger_states(stark, proof, config),
                jreplay=jrv.replay_challenger_states(jstark, jproof, jconfig))


@pytest.fixture(scope="module")
def memory_wrapper(evm):
    with torch_threads(2):
        wc = rv.recursive_stark_circuit(
            evm["stark"].starks[MEMORY], evm["stark"].cross_table_lookups,
            MEMORY, evm["proof"].degree_bits[MEMORY], evm["config"],
            device="cpu")
    jwc = jrv.recursive_stark_circuit(
        evm["jstark"].starks[MEMORY], evm["jstark"].cross_table_lookups,
        MEMORY, evm["jproof"].degree_bits[MEMORY], evm["jconfig"])
    return wc, jwc


def _challenges(gpcs):
    return [(int(c.beta), int(c.gamma)) for c in gpcs.challenges]


def test_replay_equals_jax(evm):
    (ch, states), (jch, jstates) = evm["replay"], evm["jreplay"]
    assert _challenges(ch) == _challenges(jch)
    assert states == jstates
    assert len(states) == 4
    for i in range(1, 4):        # each table's part starts where the
        assert states[i][0] == states[i - 1][1]     # last one's ended


def test_public_inputs_from_vec_equals_jax(evm):
    rng = random.Random(SEED)
    config, jconfig = evm["config"], evm["jconfig"]
    n = 4 * (1 << config.fri_config.cap_height) + 2 * config.num_challenges \
        + 24 + 6
    v = [rng.randrange(P) for _ in range(n)]
    pi, jpi = rv.PublicInputs.from_vec(v, config), \
        jrv.PublicInputs.from_vec(v, jconfig)
    assert pi.trace_cap == jpi.trace_cap
    assert _challenges(pi.ctl_challenges) == _challenges(jpi.ctl_challenges)
    assert pi.challenger_state_before == jpi.challenger_state_before
    assert pi.challenger_state_after == jpi.challenger_state_after
    assert pi.ctl_zs_last == jpi.ctl_zs_last == v[-6:]


def test_memory_wrapper_circuit_equals_jax(memory_wrapper):
    wc, jwc = memory_wrapper
    assert [g.id() for g in wc.data.common.gates] == \
        [g.id() for g in jwc.data.common.gates]
    assert wc.data.common.degree_bits() == jwc.data.common.degree_bits()
    assert wc.data.common.num_public_inputs == \
        jwc.data.common.num_public_inputs
    assert [int(x) for x in wc.data.verifier_only.circuit_digest] == \
        [int(x) for x in jwc.data.verifier_only.circuit_digest]
    assert wc.data.verifier_only.constants_sigmas_cap.digests.tolist() == \
        jwc.data.verifier_only.constants_sigmas_cap.digests.tolist()


def _wrapper_witness(wc, proof, state_before, ctl_challenges):
    pw = rv.table_witness(wc, proof, state_before, ctl_challenges)
    with torch_threads(2):
        return generate_partial_witness(pw, wc.data.prover_only,
                                        wc.data.common,
                                        rng=random.Random(SEED))


def test_memory_wrapper_public_inputs(evm, memory_wrapper):
    wc, _ = memory_wrapper
    ctl_challenges, states = evm["replay"]
    table_proof = evm["proof"].stark_proofs[MEMORY]
    witness = _wrapper_witness(wc, table_proof, states[MEMORY][0],
                               ctl_challenges)
    pi = rv.PublicInputs.from_vec(
        witness.get_targets(wc.data.prover_only.public_inputs),
        evm["config"])
    assert _challenges(pi.ctl_challenges) == _challenges(ctl_challenges)
    assert pi.challenger_state_before == states[MEMORY][0]
    assert pi.challenger_state_after == states[MEMORY][1]
    assert pi.ctl_zs_last == [int(v) for v in
                              table_proof.openings.ctl_zs_last]
    assert pi.trace_cap == [[int(x) for x in h]
                            for h in table_proof.trace_cap.digests]


def test_wrong_ctl_challenges_refused(evm, memory_wrapper):
    wc, _ = memory_wrapper
    ctl_challenges, states = evm["replay"]
    bad = type(ctl_challenges)(challenges=[
        type(c)(beta=(c.beta + 1) % P, gamma=c.gamma)
        for c in ctl_challenges.challenges])
    with pytest.raises(ValueError):
        _wrapper_witness(wc, evm["proof"].stark_proofs[MEMORY],
                         states[MEMORY][0], bad)


@pytest.mark.heavy
def test_memory_wrapper_proof(evm, memory_wrapper):
    wc, _ = memory_wrapper
    ctl_challenges, states = evm["replay"]
    with torch_threads(2):
        wrapped = rv.wrap_table_proof(
            wc, evm["proof"].stark_proofs[MEMORY], states[MEMORY][0],
            ctl_challenges, rng=random.Random(SEED))
    wc.data.verify(wrapped)
    pi = rv.PublicInputs.from_vec(wrapped.public_inputs, evm["config"])
    assert pi.challenger_state_after == states[MEMORY][1]


@pytest.mark.heavy
def test_full_recursive_aggregation(evm):
    """tests/test_evm_recursion.py:73-81: every table wrapped and proved,
    then the aggregate check and the four wrappers' verifier."""
    with torch_threads(2):
        wrapped, circuits = rv.wrap_all_proof(evm["stark"], evm["proof"],
                                              evm["config"], device="cpu",
                                              rng=random.Random(SEED))
    rv.verify_recursive_all_proof(wrapped, circuits,
                                  evm["stark"].cross_table_lookups,
                                  evm["config"])
