"""Recursion's shrinking chain: a dummy proof, a proof that verifies it,
and a proof that verifies that one, with the serialized and compressed
sizes (the port's copy of plonky2_tpu/models/bench_recursion.py; reference
plonky2/examples/bench_recursion.rs:93-215).

Every proof goes through runtime/session.py:ProverSession on `device`
(cuda unless given); the recursion circuits' witnesses come from the host
engine (iop/generator.py), whose generators the device witness plan has
no batches for.

Run: ``python -m plonky2_tpu_torch.models.bench_recursion [log2_inner]``.
"""
from __future__ import annotations

import time

from ..gates.basic import NoopGate
from ..iop.witness import PartialWitness
from ..plonk.circuit_builder import CircuitBuilder
from ..plonk.compression import compress_proof, decompress_proof
from ..plonk.config import CircuitConfig
from ..runtime.session import ProverSession
from ..utils.serialization import (serialize_compressed_proof,
                                   serialize_proof)


def dummy_circuit_of_size(config: CircuitConfig, log2_size: int,
                          device=None):
    """A no-op circuit padded to 2^log2_size gates (reference
    bench_recursion.rs:70-91)."""
    builder = CircuitBuilder(config)
    num_dummy_gates = (1 << (log2_size - 1)) + 1 if log2_size > 1 else 0
    for _ in range(num_dummy_gates):
        builder.add_gate(NoopGate(), [])
    return builder.build(device=device)


def dummy_proof_tuple(config: CircuitConfig, log2_size: int, device=None,
                      rng=None):
    """(proof, verifier data, common data) of the no-op circuit."""
    data = dummy_circuit_of_size(config, log2_size, device)
    proof = ProverSession(data, device).prove(PartialWitness(), rng=rng)
    data.verify(proof)
    return proof, data.verifier_only, data.common


def recursion_circuit(inner_cd, config: CircuitConfig, min_degree_bits=None,
                      device=None, timing=None, gc=None):
    """(CircuitData, proof target, verifier-data target) of a circuit that
    verifies one proof of `inner_cd`'s shape (reference
    bench_recursion.rs:93-142); ``gc`` is the circuit's own hasher
    configuration (CircuitBuilder.build; KECCAK_CONFIG for the final
    wrapper of a chain), whatever the inner proof's."""
    builder = CircuitBuilder(config)
    pt = builder.add_virtual_proof_with_pis(inner_cd)
    vt = builder.add_virtual_verifier_data(
        inner_cd.config.fri_config.cap_height)
    builder.verify_proof(pt, vt, inner_cd)
    if min_degree_bits is not None:
        min_gates = (1 << (min_degree_bits - 1)) + 1
        while builder.num_gates() < min_gates:
            builder.add_gate(NoopGate(), [])
    return builder.build(gc=gc, device=device, timing=timing), pt, vt


def recursion_witness(pt, vt, inner) -> PartialWitness:
    """The recursion circuit's inputs: the inner proof and verifier data."""
    inner_proof, inner_vd, _ = inner
    pw = PartialWitness()
    pw.set_proof_with_pis_target(pt, inner_proof)
    pw.set_verifier_data_target(vt, inner_vd)
    return pw


def recursive_proof(inner, config: CircuitConfig, min_degree_bits=None,
                    device=None, rng=None, timing=None):
    """(proof, verifier data, common data) of a proof that verifies the
    `inner` (proof, verifier data, common data)."""
    data, pt, vt = recursion_circuit(inner[2], config, min_degree_bits,
                                     device)
    proof = ProverSession(data, device, timing=timing).prove(
        recursion_witness(pt, vt, inner), rng=rng, timing=timing)
    data.verify(proof)
    return proof, data.verifier_only, data.common


def report_serialization(proof, vd, cd) -> dict:
    """The proof's bytes and compressed bytes, and the seconds of the
    compression and of the decompression, which must restore the proof
    byte for byte (reference bench_recursion.rs:146-174)."""
    proof_bytes = serialize_proof(proof)
    t0 = time.perf_counter()
    compressed = compress_proof(proof, vd.circuit_digest, cd)
    t1 = time.perf_counter()
    restored = decompress_proof(compressed, vd.circuit_digest, cd)
    t2 = time.perf_counter()
    if serialize_proof(restored) != proof_bytes:
        raise RuntimeError("decompression did not restore the proof")
    cbytes = serialize_compressed_proof(compressed)
    return {"proof_bytes": len(proof_bytes),
            "compressed_bytes": len(cbytes),
            "compress_seconds": t1 - t0, "decompress_seconds": t2 - t1}


def benchmark(config: CircuitConfig | None = None,
              log2_inner_size: int = 8, device=None, rng=None) -> dict:
    """(reference bench_recursion.rs:177-215)."""
    config = config or CircuitConfig.standard_recursion_config()
    inner = dummy_proof_tuple(config, log2_inner_size, device, rng)
    print(f"Initial proof degree 2^{inner[2].degree_bits()}")
    middle = recursive_proof(inner, config, device=device, rng=rng)
    print(f"Single recursion proof degree 2^{middle[2].degree_bits()}")
    outer = recursive_proof(middle, config, device=device, rng=rng)
    print(f"Double recursion proof degree 2^{outer[2].degree_bits()}")
    sizes = report_serialization(*outer)
    print(sizes)
    return sizes


if __name__ == "__main__":
    import sys
    benchmark(log2_inner_size=int(sys.argv[1]) if len(sys.argv) > 1 else 8)
