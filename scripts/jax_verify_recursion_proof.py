"""Check the double-recursion proof made by the port (scripts/
port_recursion_proof.py) with the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/jax_verify_recursion_proof.py OUTDIR

The JAX package builds the same chain of circuits under
standard_recursion_config (the no-op circuit of 2^log2_inner rows, the
circuit that verifies its proofs, the circuit that verifies those), with
no proof: each link's degree, circuit digest and constants-sigmas cap
must equal the port's (OUTDIR/chain.json).  Then JAX's verifier must
accept the port's double proof (OUTDIR/double.bin), its compressed form
(OUTDIR/double_compressed.bin, through verify_compressed_proof) and JAX's
decompression of that, and must reject a copy with one opened wire
flipped.  Exits 0 only if all hold.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def jax_chain(log2_inner: int):
    """The JAX package's three circuits, built without proving."""
    from plonky2_tpu.gates.basic import NoopGate
    from plonky2_tpu.plonk.circuit_builder import CircuitBuilder
    from plonky2_tpu.plonk.config import CircuitConfig
    config = CircuitConfig.standard_recursion_config()
    b = CircuitBuilder(config)
    for _ in range((1 << (log2_inner - 1)) + 1):
        b.add_gate(NoopGate(), [])
    chain = [b.build()]
    for _ in range(2):
        b = CircuitBuilder(config)
        pt = b.add_virtual_proof_with_pis(chain[-1].common)
        vt = b.add_virtual_verifier_data(config.fri_config.cap_height)
        b.verify_proof(pt, vt, chain[-1].common)
        chain.append(b.build())
    return chain


def main() -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    from plonky2_tpu.plonk.compression import (decompress_proof,
                                               verify_compressed_proof)
    from plonky2_tpu.utils.serialization import (
        deserialize_compressed_proof, deserialize_proof, serialize_proof)
    outdir = sys.argv[1]
    with open(os.path.join(outdir, "chain.json")) as f:
        meta = json.load(f)
    t = time.perf_counter()
    chain = jax_chain(meta["log2_inner"])
    print(f"the JAX package built the chain's three circuits in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    for data, link in zip(chain, meta["links"]):
        got = (data.common.degree_bits(),
               [int(x) for x in data.verifier_only.circuit_digest],
               data.verifier_only.constants_sigmas_cap.digests.tolist())
        want = (link["degree_bits"], link["circuit_digest"],
                link["constants_sigmas_cap"])
        if got != want:
            print(f"the {link['name']} circuit differs: JAX {got[:2]}, "
                  f"port {want[:2]}")
            return 1
        print(f"  {link['name']}: 2^{got[0]} rows, circuit digest and cap "
              "equal the port's")
    double = chain[-1]
    with open(os.path.join(outdir, "double.bin"), "rb") as f:
        blob = f.read()
    with open(os.path.join(outdir, "double_compressed.bin"), "rb") as f:
        cblob = f.read()
    proof = deserialize_proof(blob, double.common)
    t = time.perf_counter()
    double.verify(proof)
    print(f"the JAX verifier accepts the port's double proof in "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    compressed = deserialize_compressed_proof(cblob, double.common)
    verify_compressed_proof(compressed, double.verifier_only, double.common)
    restored = decompress_proof(compressed,
                                double.verifier_only.circuit_digest,
                                double.common)
    if serialize_proof(restored) != blob:
        print("JAX's decompression of the port's compressed proof differs")
        return 1
    double.verify(restored)
    print("the JAX verifier accepts the compressed proof, and JAX's "
          "decompression of it restores the double proof byte for byte")
    bad = deserialize_proof(blob, double.common)
    bad.proof.openings.wires[0][0] ^= np.uint64(1)
    try:
        double.verify(bad)
    except Exception as e:          # the verifiers raise several kinds
        print(f"the JAX verifier rejects the flipped copy: "
              f"{type(e).__name__}: {e}")
        return 0
    print("the JAX verifier accepted a flipped copy")
    return 1


if __name__ == "__main__":
    sys.exit(main())
