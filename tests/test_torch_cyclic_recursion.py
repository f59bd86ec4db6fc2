"""Cyclic recursion in the port against the JAX package, on the CPU: the
Poseidon hash chain of tests/test_cyclic_recursion.py
(plonky2_tpu_torch/models/cyclic_hash_chain.py), under the small FRI of
tests/test_torch_recursion.py (the cycle comes to 2^12 rows, as the JAX
test's).

- ``common_data_for_recursion`` gives JAX's CommonCircuitData, and the
  cyclic circuit JAX's gates, circuit digest and constants-sigmas cap,
  both packages building the cycle here;
- under the JAX test's own config (``fast_recursion_config``: cap
  height 4, 8 queries), which the card runs, the cycle keeps the
  ConstantGate its dummy circuit needs; under
  ``standard_recursion_config`` (28 queries) it has none, in either
  package;
- ``check_cyclic_proof_verifier_data`` takes public inputs that end with
  the cycle's verifier data and refuses others, as JAX's does;
- proved (`heavy`, as the JAX package's test is): the port proves two
  links (the first verifies a dummy proof, the second the first); its
  verifier, JAX's verifier and ``check_cyclic_proof_verifier_data``
  accept both, and the chain's public inputs are the iterated host
  Poseidon.

Building the cycle commits the cyclic circuit of 2^12 rows in each
package (the port's ``common_data_for_recursion`` commits nothing, JAX's
commits its three builds); the tier-1 tests build it once a package,
without the dummy circuit and proof, which only a proof needs.
"""
import random
from types import SimpleNamespace

import pytest

from plonky2_tpu.hash import poseidon as jpos
from plonky2_tpu.plonk import recursion as jrecursion
from plonky2_tpu.plonk.circuit_builder import CircuitBuilder as JaxBuilder
from plonky2_tpu.utils.serialization import \
    deserialize_proof as jax_deserialize
from plonky2_tpu_torch.models import cyclic_hash_chain
from plonky2_tpu_torch.models.cyclic_hash_chain import (
    HEADROOM, fast_recursion_config, iterate_poseidon)
from plonky2_tpu_torch.plonk import recursion
from plonky2_tpu_torch.plonk.config import CircuitConfig
from plonky2_tpu_torch.plonk.recursion import (
    check_cyclic_proof_verifier_data, verifier_data_from_pis)
from plonky2_tpu_torch.utils.serialization import serialize_proof
from tests.test_torch_prover import one_torch_thread  # noqa: F401
from tests.test_torch_recursion import (FIXTURE_THREADS,
                                        jax_small_recursion_config,
                                        small_recursion_config,
                                        torch_threads)

SEED = 0xC1C1E
INITIAL = [0, 1, 2, 3]
P = (1 << 64) - (1 << 32) + 1


def summary(data, common) -> dict:
    """The cycle's common data and the cyclic circuit's, digest and cap,
    as JSON-ready values (the same for either package's objects)."""
    def fields(c):
        return {"gates": [g.id() for g in c.gates],
                "degree_bits": c.degree_bits(),
                "selector_groups": [[r.start, r.stop]
                                    for r in c.selectors_info.groups],
                **{f: getattr(c, f) for f in (
                    "num_constants", "num_public_inputs",
                    "num_gate_constraints", "quotient_degree_factor",
                    "num_partial_products")}}
    vd = data.verifier_only
    return {"cycle_common": fields(common), "circuit_common":
            fields(data.common),
            "circuit_digest": [int(x) for x in vd.circuit_digest],
            "constants_sigmas_cap": [[int(x) for x in h] for h in
                                     vd.constants_sigmas_cap.digests]}


def jax_cyclic_circuit():
    """tests/test_cyclic_recursion.py's circuit, built by the JAX package
    under the small config; JAX's dummy circuit and proof are not made
    (the cyclic circuit needs only their targets)."""
    config = jax_small_recursion_config()
    b = JaxBuilder(config)
    one = b.one()
    initial_hash = b.add_virtual_hash()
    b.register_public_inputs(initial_hash)
    current_hash_in = b.add_virtual_hash()
    b.register_public_inputs(b.hash_n_to_hash_no_pad(list(current_hash_in)))
    counter = b.add_virtual_public_input()
    common_data = jrecursion.common_data_for_recursion(config, 9, 8)
    b.add_verifier_data_public_inputs()
    common_data.num_public_inputs = b.num_public_inputs()
    condition = b.add_virtual_bool_target_safe()
    inner = b.add_virtual_proof_with_pis(common_data)
    pis = inner.public_inputs
    b.connect_hashes(initial_hash, tuple(pis[0:4]))
    b.connect_hashes(current_hash_in, b.select_hash(
        condition, tuple(pis[4:8]), initial_hash))
    b.connect(counter, b.mul_add(condition, pis[8], one))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrecursion, "dummy_circuit",
                   lambda *a: SimpleNamespace(verifier_only=None))
        mp.setattr(jrecursion, "dummy_proof", lambda *a, **k: None)
        b.conditionally_verify_cyclic_proof_or_dummy(condition, inner,
                                                     common_data)
    return b.build(), common_data


@pytest.fixture(scope="module")
def jax_cycle():
    """The JAX package's cyclic circuit and the cycle's common data."""
    return jax_cyclic_circuit()


@pytest.fixture(scope="module")
def circuits():
    """The port's cycle and cyclic circuit, with no dummy circuit or
    proof (the circuit needs only their targets)."""
    with torch_threads(FIXTURE_THREADS), pytest.MonkeyPatch.context() as mp:
        mp.setattr(cyclic_hash_chain, "dummy_circuit",
                   lambda *a: SimpleNamespace(verifier_only=None))
        mp.setattr(recursion, "dummy_proof", lambda *a, **k: None)
        c = cyclic_hash_chain.build_cyclic_hash_chain(
            small_recursion_config(), device="cpu")
    return c


def test_cycle_equals_jax(circuits, jax_cycle):
    got = summary(circuits.data, circuits.common_data)
    assert got == summary(*jax_cycle)
    assert got["cycle_common"]["degree_bits"] == 12


@pytest.mark.parametrize("config, degree_bits, has_constant_gate", [
    (fast_recursion_config, 13, True),
    (CircuitConfig.standard_recursion_config, 14, False)],
    ids=["fast", "standard"])
def test_cycle_constant_gate(config, degree_bits, has_constant_gate):
    """The cycle's common data under the JAX test's config keeps a
    ConstantGate, which dummy_circuit needs to place the dummy proof's
    public inputs; under standard_recursion_config its constants all fit
    the spare constant slots of RandomAccessGate (bits 4) and it has no
    ConstantGate, so no dummy circuit has its common data (the JAX
    package's common_data_for_recursion gives the same gate sets)."""
    common = recursion.common_data_for_recursion(config(), *HEADROOM)
    assert common.degree_bits() == degree_bits
    assert any(g.id().startswith("ConstantGate")
               for g in common.gates) == has_constant_gate


def test_verifier_data_from_public_inputs(circuits):
    """Public inputs that end with the cycle's digest and cap pass
    check_cyclic_proof_verifier_data, in both packages; one word
    changed, they fail."""
    c = circuits
    vd = c.data.verifier_only
    tail = ([int(x) for x in vd.circuit_digest]
            + [int(x) for x in vd.constants_sigmas_cap.digests.reshape(-1)])
    pis = INITIAL + iterate_poseidon(INITIAL, 1) + [1] + tail
    assert len(pis) == c.data.common.num_public_inputs
    proof = SimpleNamespace(public_inputs=pis)
    check_cyclic_proof_verifier_data(proof, vd, c.data.common)
    jrecursion.check_cyclic_proof_verifier_data(proof, vd, c.data.common)
    digest, cap = verifier_data_from_pis(pis, c.data.common)
    assert list(digest) == tail[:4]
    assert [list(h) for h in cap] == [tail[4 + 4 * i:8 + 4 * i]
                                      for i in range(len(cap))]
    for i in (-1, len(pis) - len(tail)):
        bad = list(pis)
        bad[i] = (bad[i] + 1) % P
        with pytest.raises(ValueError):
            check_cyclic_proof_verifier_data(
                SimpleNamespace(public_inputs=bad), vd, c.data.common)
        with pytest.raises(AssertionError):
            jrecursion.check_cyclic_proof_verifier_data(
                SimpleNamespace(public_inputs=bad), vd, c.data.common)


@pytest.fixture(scope="module")
def chain(jax_cycle):
    """The port's cyclic circuit (its dummy proof made) and two links
    proved, and the JAX package's circuit."""
    rng = random.Random(SEED)
    with torch_threads(FIXTURE_THREADS):
        c = cyclic_hash_chain.build_cyclic_hash_chain(
            small_recursion_config(), device="cpu", rng=rng)
        first = cyclic_hash_chain.prove_link(c, None, INITIAL, "cpu", rng)
        second = cyclic_hash_chain.prove_link(c, first, INITIAL, "cpu", rng)
    return c, [first, second], jax_cycle[0]


@pytest.mark.heavy
@pytest.mark.parametrize("link", [0, 1])
def test_link_verifies_in_both_packages(chain, link):
    c, proofs, jdata = chain
    assert c.dummy.common == c.common_data
    proof = proofs[link]
    c.data.verify(proof)
    check_cyclic_proof_verifier_data(proof, c.data.verifier_only,
                                     c.data.common)
    jproof = jax_deserialize(serialize_proof(proof), jdata.common)
    jdata.verify(jproof)
    jrecursion.check_cyclic_proof_verifier_data(
        jproof, jdata.verifier_only, jdata.common)


@pytest.mark.heavy
@pytest.mark.parametrize("link", [0, 1])
def test_link_public_inputs_are_the_chain(chain, link):
    _, proofs, _ = chain
    pis = [int(x) for x in proofs[link].public_inputs]
    assert pis[0:4] == INITIAL
    assert pis[8] == link + 1
    cur = INITIAL
    for _ in range(link + 1):
        cur = [int(x) for x in jpos.hash_no_pad(cur)]
    assert pis[4:8] == cur == iterate_poseidon(INITIAL, link + 1)
