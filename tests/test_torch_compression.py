"""Proof compression in the port against the JAX package, on the CPU
(tests/test_compression.py's two tests, and the compressed bytes).

- Merkle path compression: on the proofs of a JAX-built tree, the port's
  compressed paths equal JAX's and decompress to the proofs.
- The Fibonacci proof under standard_recursion_config (28 queries; 4 bits
  of proof of work, where the plain grind of 16 takes minutes here):
  compressed, it verifies (``verify_compressed_proof``, in both packages),
  its compressed bytes equal JAX's compression of the same proof, it is
  smaller, its bytes round-trip, and decompressing restores the proof
  byte for byte.
"""
import random
from dataclasses import replace

import numpy as np
import pytest

from plonky2_tpu.hash import merkle as jmk
from plonky2_tpu.hash.path_compression import \
    compress_merkle_proofs as jax_compress_paths
from plonky2_tpu.models.fibonacci import \
    build_fibonacci_circuit as jax_fibonacci
from plonky2_tpu.plonk.compression import compress_proof as jax_compress
from plonky2_tpu.plonk.config import CircuitConfig as JaxCircuitConfig
from plonky2_tpu.plonk.compression import \
    verify_compressed_proof as jax_verify_compressed
from plonky2_tpu.utils.serialization import \
    deserialize_compressed_proof as jax_deserialize_compressed
from plonky2_tpu.utils.serialization import \
    deserialize_proof as jax_deserialize
from plonky2_tpu.utils.serialization import \
    serialize_compressed_proof as jax_serialize_compressed
from plonky2_tpu_torch.hash.merkle import MerkleProof
from plonky2_tpu_torch.hash.path_compression import (compress_merkle_proofs,
                                                     decompress_merkle_proofs)
from plonky2_tpu_torch.models.fibonacci import build_fibonacci_circuit
from plonky2_tpu_torch.plonk.compression import (compress_proof,
                                                 decompress_proof,
                                                 verify_compressed_proof)
from plonky2_tpu_torch.plonk.config import CircuitConfig
from plonky2_tpu_torch.plonk.verifier import ProofVerificationError
from plonky2_tpu_torch.runtime.session import ProverSession
from plonky2_tpu_torch.utils.serialization import (
    deserialize_compressed_proof, serialize_compressed_proof,
    serialize_proof)
from tests.test_torch_prover import one_torch_thread  # noqa: F401


def siblings(proofs):
    return [[np.asarray(s, dtype=np.uint64).tolist() for s in p.siblings]
            for p in proofs]


def test_merkle_path_compression_equals_jax():
    rng = np.random.default_rng(42)
    h, cap_height = 8, 3
    leaves = rng.integers(0, 1 << 62, size=(1 << h, 5), dtype=np.uint64)
    tree = jmk.MerkleTree(leaves, cap_height)
    indices = [int(i) for i in rng.integers(0, 1 << h, size=17)]
    jproofs = [tree.prove(i) for i in indices]
    proofs = [MerkleProof(list(p.siblings)) for p in jproofs]

    compressed = compress_merkle_proofs(cap_height, indices, proofs)
    assert siblings(compressed) == siblings(
        jax_compress_paths(cap_height, indices, jproofs))
    assert (sum(len(p.siblings) for p in compressed)
            < sum(len(p.siblings) for p in proofs))
    restored = decompress_merkle_proofs(
        [leaves[i] for i in indices], indices, compressed, h, cap_height)
    assert siblings(restored) == siblings(proofs)


@pytest.fixture(scope="module")
def fib():
    config = CircuitConfig.standard_recursion_config()
    config = replace(config, fri_config=replace(config.fri_config,
                                                proof_of_work_bits=4))
    data, pw, _ = build_fibonacci_circuit(config, device="cpu")
    proof = ProverSession(data, "cpu").prove(pw, rng=random.Random(7))
    data.verify(proof)
    jconfig = JaxCircuitConfig.standard_recursion_config()
    jdata, _, _ = jax_fibonacci(replace(jconfig, fri_config=replace(
        jconfig.fri_config, proof_of_work_bits=4)))
    return data, proof, jdata


def test_proof_compression_roundtrip(fib):
    data, proof, _ = fib
    original = serialize_proof(proof)
    digest = data.verifier_only.circuit_digest
    compressed = compress_proof(proof, digest, data.common)
    verify_compressed_proof(compressed, data.verifier_only, data.common)

    restored = decompress_proof(compressed, digest, data.common)
    assert serialize_proof(restored) == original
    data.verify(restored)

    cbytes = serialize_compressed_proof(compressed)
    assert len(cbytes) < len(original)
    again = deserialize_compressed_proof(cbytes, data.common)
    assert serialize_compressed_proof(again) == cbytes
    verify_compressed_proof(again, data.verifier_only, data.common)
    with pytest.raises(ValueError):
        deserialize_compressed_proof(cbytes + b"\0", data.common)


def test_compressed_bytes_equal_jax(fib):
    data, proof, jdata = fib
    cbytes = serialize_compressed_proof(compress_proof(
        proof, data.verifier_only.circuit_digest, data.common))
    jproof = jax_deserialize(serialize_proof(proof), jdata.common)
    jcompressed = jax_compress(jproof, jdata.verifier_only.circuit_digest,
                               jdata.common)
    assert cbytes == jax_serialize_compressed(jcompressed)
    jax_verify_compressed(jax_deserialize_compressed(cbytes, jdata.common),
                          jdata.verifier_only, jdata.common)


def test_tampered_compressed_proof_is_rejected(fib):
    from plonky2_tpu_torch.fri.verifier import FriVerificationError
    data, proof, _ = fib
    compressed = compress_proof(proof, data.verifier_only.circuit_digest,
                                data.common)
    compressed.proof.openings.wires[0][0] ^= np.uint64(1)
    with pytest.raises((ProofVerificationError, FriVerificationError)):
        verify_compressed_proof(compressed, data.verifier_only, data.common)
    with pytest.raises(ProofVerificationError):
        decompress_proof(compressed, data.verifier_only.circuit_digest,
                         data.common)
