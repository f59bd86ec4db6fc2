"""Check a flagship proof made by the port (scripts/port_flagship_proof.py)
with the JAX package's verifier, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/jax_verify_flagship_proof.py PROOF.bin
        [--config wide_ecc|standard]

wide_ecc (the default): reads the JAX package's flagship circuit from the
tracked .bench_cache/hash_tree_k17.pkl after its sha256 pin is checked
(the pickle may run code) and checks the proof's public inputs against
the pinned root.

standard: the same tree under standard_recursion_config, whose 2^18-row
circuit the JAX package has no pinned build of (building it takes many
minutes and gigabytes on the CPU).  The JAX package builds the same tree
at 2^3 leaves under that config, whose common data differ from the full
tree's only in the FRI parameters of its degree; those are made for the
degree bits that PROOF.json (written beside the proof) gives, and its
gate ids must equal the small build's.  The verifier data, the
constants-sigmas cap and the circuit digest, come from PROOF.json (the
port's build on the card); the digest is recomputed from the cap with the
JAX package's hasher and must agree.  The root is recomputed from the
leaves (numpy seed 0) with the JAX package's Poseidon.  So this checks
the proof against the port's own commitment to the circuit; the port's
build of the same tree at 2^10 leaves is held against the JAX package's
(plonky2_tpu_torch/plonk/programs/hash_tree_standard_k10.json) by
chip_smoke.py phase 9c.

Either way it deserializes the proof with the JAX package's
``deserialize_proof`` and runs ``plonky2_tpu.plonk.verifier.verify``;
raises unless it verifies.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
PICKLE = os.path.join(REPO, ".bench_cache", "hash_tree_k17.pkl")
SHA256 = "ec7e94f7288e5c0b2b2a021ae34aabfd7dfced0f1e1c38782e5e057fe3381f58"


def wide_ecc_circuit():
    """(common, verifier_only, root) of the pinned flagship circuit."""
    h = hashlib.sha256()
    with open(PICKLE, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    if h.hexdigest() != SHA256:
        raise RuntimeError("flagship pickle digest changed")
    with open(PICKLE, "rb") as f:
        payload = pickle.load(f)
    return (payload["common"], payload["verifier_only"],
            [int(x) for x in payload["extra"][1]])


def standard_circuit(ref_path: str):
    """(common, verifier_only, root) of the tree of 2^17 leaves under
    standard_recursion_config, from a 2^3-leaf JAX build and the port's
    circuit file (module docstring)."""
    import dataclasses

    import numpy as np

    from plonky2_tpu.field import goldilocks as gl
    from plonky2_tpu.hash import poseidon as pos
    from plonky2_tpu.hash.hashers import POSEIDON_CONFIG
    from plonky2_tpu.hash.merkle import MerkleCap
    from plonky2_tpu.models.hash_tree import build_hash_tree_circuit
    from plonky2_tpu.plonk.circuit_data import VerifierOnlyCircuitData
    from plonky2_tpu.plonk.config import CircuitConfig
    with open(ref_path) as f:
        ref = json.load(f)
    config = CircuitConfig.standard_recursion_config()
    small, _, _ = build_hash_tree_circuit(config, 3)
    if [g.id() for g in small.common.gates] != ref["gate_ids"]:
        raise RuntimeError("the port's gates differ from the JAX build's")
    bits = ref["degree_bits"]
    common = dataclasses.replace(
        small.common, fri_params=config.fri_config.fri_params(
            bits, config.zero_knowledge))
    cap = np.array(ref["constants_sigmas_cap"], dtype=np.uint64)
    digest = POSEIDON_CONFIG.hash_no_pad_elements(np.concatenate([
        cap.reshape(-1), POSEIDON_CONFIG.hash_pad_elements([]),
        np.array([bits], dtype=np.uint64)]))
    if [int(x) for x in digest] != ref["circuit_digest"]:
        raise RuntimeError("the circuit digest does not follow from the cap")
    leaves = np.random.default_rng(0).integers(
        0, gl.P, size=(1 << (bits - 1), 4), dtype=np.uint64)
    while leaves.shape[0] > 1:
        state = np.zeros((leaves.shape[0] // 2, 12), dtype=np.uint64)
        state[:, :8] = leaves.reshape(-1, 8)
        leaves = pos.poseidon(state)[:, :4]
    root = [int(x) for x in leaves[0]]
    if root != ref["root"]:
        raise RuntimeError("the root differs from the port's")
    return (common, VerifierOnlyCircuitData(
        constants_sigmas_cap=MerkleCap(cap), circuit_digest=digest), root)


def main() -> int:
    import argparse

    from plonky2_tpu.plonk.verifier import verify
    from plonky2_tpu.utils.serialization import deserialize_proof
    ap = argparse.ArgumentParser()
    ap.add_argument("proof")
    ap.add_argument("--config", choices=("wide_ecc", "standard"),
                    default="wide_ecc")
    args = ap.parse_args()
    if args.config == "wide_ecc":
        common, verifier_only, root = wide_ecc_circuit()
    else:
        common, verifier_only, root = standard_circuit(
            os.path.splitext(args.proof)[0] + ".json")
    with open(args.proof, "rb") as f:
        blob = f.read()
    proof = deserialize_proof(blob, common)
    if proof.public_inputs != root:
        raise RuntimeError("public inputs differ from the pinned root")
    t = time.perf_counter()
    verify(proof, verifier_only, common)
    print(f"JAX verifier: the {len(blob)}-byte proof (sha256 "
          f"{hashlib.sha256(blob).hexdigest()}) verifies against the "
          f"{args.config} flagship circuit in "
          f"{time.perf_counter() - t:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
