"""Check a flagship proof made by the port (scripts/port_flagship_proof.py)
with the JAX package's verifier, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/jax_verify_flagship_proof.py PROOF.bin

Reads the JAX package's flagship circuit from the tracked
.bench_cache/hash_tree_k17.pkl after its sha256 pin is checked (the pickle
may run code), deserializes the proof with the JAX package's
``deserialize_proof``, checks its public inputs against the pinned root
and runs ``plonky2_tpu.plonk.verifier.verify``; raises unless it verifies.
"""
from __future__ import annotations

import hashlib
import os
import pickle
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
PICKLE = os.path.join(REPO, ".bench_cache", "hash_tree_k17.pkl")
SHA256 = "ec7e94f7288e5c0b2b2a021ae34aabfd7dfced0f1e1c38782e5e057fe3381f58"


def main() -> int:
    from plonky2_tpu.plonk.verifier import verify
    from plonky2_tpu.utils.serialization import deserialize_proof
    h = hashlib.sha256()
    with open(PICKLE, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    if h.hexdigest() != SHA256:
        raise RuntimeError("flagship pickle digest changed")
    with open(PICKLE, "rb") as f:
        payload = pickle.load(f)
    common, verifier_only = payload["common"], payload["verifier_only"]
    root = [int(x) for x in payload["extra"][1]]
    with open(sys.argv[1], "rb") as f:
        blob = f.read()
    proof = deserialize_proof(blob, common)
    if proof.public_inputs != root:
        raise RuntimeError("public inputs differ from the pinned root")
    t = time.perf_counter()
    verify(proof, verifier_only, common)
    print(f"JAX verifier: the {len(blob)}-byte proof (sha256 "
          f"{hashlib.sha256(blob).hexdigest()}) verifies against the "
          f"pinned flagship circuit in {time.perf_counter() - t:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
