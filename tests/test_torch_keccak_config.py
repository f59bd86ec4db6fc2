"""The Keccak hasher configuration (hash/hashers.py:KeccakConfig) in the
port against the JAX package's, on the CPU.

- tests/test_keccak_config.py's known vectors, digest round trip and
  Merkle round trip (a changed leaf refused) run against the port
  (tests/torch_evm_twins.py:ported).
- The port's host-hashed tree (hash/merkle.py:MerkleTree), from host rows
  or from leaves on a device, and a Keccak commitment
  (PolynomialBatch.from_values(hasher=KECCAK_CONFIG)) have the JAX
  package's caps and paths.
- tests/test_keccak_config.py's Fibonacci circuit under its config, built
  by both packages with gc=KECCAK_CONFIG: equal digest and cap; its proof
  (utils/serialization.py:serialize_proof) byte for byte the JAX
  package's with the witness randomness pinned; both verifiers accept the
  port's proof and both refuse it under Poseidon's ``hasher_name``.
"""
import random

import numpy as np
import pytest
import torch

from plonky2_tpu.fri.config import FriConfig as JaxFriConfig
from plonky2_tpu.fri.config import \
    FriReductionStrategy as JaxFriReductionStrategy
from plonky2_tpu.fri.oracle import PolynomialBatch as JaxBatch
from plonky2_tpu.hash import merkle as jmk
from plonky2_tpu.hash.hashers import KECCAK_CONFIG as JAX_KECCAK
from plonky2_tpu.hash.hashers import POSEIDON_CONFIG as JAX_POSEIDON
from plonky2_tpu.iop.witness import PartialWitness as JaxPartialWitness
from plonky2_tpu.plonk.circuit_builder import CircuitBuilder as JaxBuilder
from plonky2_tpu.plonk.config import CircuitConfig as JaxCircuitConfig
from plonky2_tpu.utils.serialization import \
    deserialize_proof as jax_deserialize
from plonky2_tpu.utils.serialization import serialize_proof as jax_serialize
from plonky2_tpu_torch.field.convert import from_u64
from plonky2_tpu_torch.fri.oracle import PolynomialBatch
from plonky2_tpu_torch.fri.verifier import FriVerificationError
from plonky2_tpu_torch.hash import merkle as mk
from plonky2_tpu_torch.hash.hashers import KECCAK_CONFIG, POSEIDON_CONFIG
from plonky2_tpu_torch.models.fibonacci import (build_fibonacci_circuit,
                                                keccak_fibonacci_config)
from plonky2_tpu_torch.plonk.verifier import ProofVerificationError
from plonky2_tpu_torch.runtime.session import ProverSession
from plonky2_tpu_torch.utils.serialization import serialize_proof
from tests.test_torch_prover import pin_randomness
from tests.torch_evm_twins import ported

JAX_TEST = ported("test_keccak_config")
SEED = 0x5EED


@pytest.mark.parametrize("case", ["test_keccak256_known_vectors",
                                  "test_keccak_digest_element_roundtrip",
                                  "test_keccak_merkle_tree_roundtrip"])
def test_jax_keccak_case(case):
    getattr(JAX_TEST, case)()


@pytest.mark.parametrize("width", [2, 9, 40])
def test_keccak_tree_equals_jax(width):
    rng = np.random.default_rng(width)
    leaves = rng.integers(0, 1 << 63, size=(64, width), dtype=np.uint64)
    want = jmk.MerkleTree(leaves, cap_height=2, hasher=JAX_KECCAK)
    host = mk.MerkleTree(leaves, 2, KECCAK_CONFIG)
    dev = mk.MerkleTree(from_u64(leaves.T.copy(), "cpu"), 2, KECCAK_CONFIG)
    for tree in (host, dev):
        np.testing.assert_array_equal(tree.cap.digests, want.cap.digests)
        for i in (0, 17, 63):
            got = tree.prove(i).siblings
            assert [list(map(int, s)) for s in got] == \
                [list(map(int, s)) for s in want.prove(i).siblings]
            assert mk.verify_merkle_proof_to_cap(leaves[i], i, tree.cap,
                                                 tree.prove(i), KECCAK_CONFIG)
            assert not mk.verify_merkle_proof_to_cap(
                leaves[i], i, tree.cap, tree.prove(i), POSEIDON_CONFIG)


def test_keccak_commitment_equals_jax():
    rng = np.random.default_rng(3)
    values = rng.integers(0, 1 << 63, size=(5, 16), dtype=np.uint64)
    port = PolynomialBatch.from_values(values, 3, False, 2, device="cpu",
                                       hasher=KECCAK_CONFIG)
    ref = JaxBatch.from_values(values, 3, False, 2, use_device=False,
                               hasher=JAX_KECCAK)
    assert isinstance(port.merkle_tree, mk.MerkleTree)
    assert port.leaves_dev.device.type == "cpu"
    np.testing.assert_array_equal(port.merkle_tree.cap.digests,
                                  ref.merkle_tree.cap.digests)
    np.testing.assert_array_equal(port.leaves, ref.leaves)
    assert [list(map(int, s)) for s in port.merkle_tree.prove(5).siblings] \
        == [list(map(int, s)) for s in ref.merkle_tree.prove(5).siblings]


def jax_fibonacci():
    """tests/test_keccak_config.py:test_keccak_config_fibonacci_e2e's
    circuit and witness, built by the JAX package."""
    builder = JaxBuilder(jax_keccak_config())
    a = builder.add_virtual_target()
    b = builder.add_virtual_target()
    prev, cur = a, b
    for _ in range(99):
        prev, cur = cur, builder.add(prev, cur)
    builder.register_public_inputs([a, b, cur])
    pw = JaxPartialWitness()
    pw.set_target(a, 0)
    pw.set_target(b, 1)
    return builder.build(gc=JAX_KECCAK), pw


def jax_keccak_config():
    return JaxCircuitConfig(fri_config=JaxFriConfig(
        rate_bits=3, cap_height=4, proof_of_work_bits=8,
        reduction_strategy=JaxFriReductionStrategy.ConstantArityBits(4, 5),
        num_query_rounds=28))


@pytest.fixture(scope="module")
def fib():
    """(port data, port proof, its bytes, JAX data, JAX proof bytes)."""
    with pytest.MonkeyPatch.context() as mp:
        pin_randomness(mp, SEED)
        jdata, jpw = jax_fibonacci()
        want = jax_serialize(jdata.prove(jpw))
    data, pw, _ = build_fibonacci_circuit(keccak_fibonacci_config(),
                                          device="cpu", gc=KECCAK_CONFIG)
    proof = ProverSession(data, device="cpu").prove(
        pw, rng=random.Random(SEED))
    return data, proof, serialize_proof(proof), jdata, want


def test_keccak_fibonacci_circuit_equals_jax(fib):
    data, _, _, jdata, _ = fib
    assert data.common.hasher_name == "KeccakGoldilocksConfig"
    assert data.common.hasher() is KECCAK_CONFIG
    assert [int(x) for x in data.verifier_only.circuit_digest] == \
        [int(x) for x in jdata.verifier_only.circuit_digest]
    np.testing.assert_array_equal(
        data.verifier_only.constants_sigmas_cap.digests,
        jdata.verifier_only.constants_sigmas_cap.digests)
    assert isinstance(data.prover_only.constants_sigmas_commitment
                      .merkle_tree, mk.MerkleTree)


def test_keccak_fibonacci_proof_equals_jax(fib):
    _, proof, raw, _, want = fib
    assert raw == want
    assert proof.public_inputs[:2] == [0, 1]


def test_keccak_fibonacci_proof_verifies_in_both(fib):
    data, proof, raw, jdata, _ = fib
    data.verify(proof)
    jdata.verify(jax_deserialize(raw, jdata.common))


def test_keccak_fibonacci_proof_refused_under_poseidon(fib):
    data, proof, raw, jdata, _ = fib
    jproof = jax_deserialize(raw, jdata.common)
    try:
        data.common.hasher_name = POSEIDON_CONFIG.name
        jdata.common.hasher_name = JAX_POSEIDON.name
        with pytest.raises((ProofVerificationError, FriVerificationError)):
            data.verify(proof)
        with pytest.raises(Exception):      # the JAX verifiers' kinds
            jdata.verify(jproof)
    finally:
        data.common.hasher_name = KECCAK_CONFIG.name
        jdata.common.hasher_name = JAX_KECCAK.name


def test_keccak_tree_stays_beside_its_leaves():
    leaves = torch.arange(4 * 32, dtype=torch.int64).reshape(4, 32)
    tree = mk.MerkleTree(leaves, 1, KECCAK_CONFIG)
    assert tree.leaves_dev is leaves
    assert all(lv.device == leaves.device for lv in tree.levels_dev)
    assert [tuple(lv.shape) for lv in tree.levels_dev] == [
        (4, 32), (4, 16), (4, 8), (4, 4), (4, 2)]


def test_keccak_fibonacci_witness_comes_from_the_plan(fib):
    """The witness does not depend on the hasher: the session's proof, whose
    bytes are the JAX package's, took its witness from the device plan."""
    data = fib[0]
    plan = data.prover_only._device_witness_plans["cpu"]
    assert plan is not None and plan.waves


def test_host_tree_refuses_an_algebraic_hasher():
    leaves = np.arange(4 * 32, dtype=np.uint64).reshape(32, 4)
    with pytest.raises(ValueError, match="on the device"):
        mk.MerkleTree(leaves, 1, POSEIDON_CONFIG)
    assert not hasattr(POSEIDON_CONFIG, "hash_leaves")
