"""Build the flagship circuit with the port, prove it on one CUDA card and
write the serialized proof, for the JAX package's verifier to check on a
machine with JAX (scripts/jax_verify_flagship_proof.py).

    python3 scripts/port_flagship_proof.py OUT.bin [--seed N]
        [--config wide_ecc|standard]

The hash tree of 2^17 leaves (numpy seed 0) under
CircuitConfig.wide_ecc_config() (234 wires) or, with --config standard,
standard_recursion_config() (135 wires), 2^18 rows, built by
plonky2_tpu_torch (its constants-sigmas commitment on the card), proved
by ProverSession (its quotient program compiled) from
random.Random(seed) and verified by the port's verifier before it is
written.  Beside OUT.bin it writes OUT.json: the circuit's degree bits,
constants-sigmas cap, circuit digest, gate ids and root, which the JAX
verifier takes for a config whose full-size circuit the JAX package has
not built.  Prints the card's name and power limit, then one JSON line:
seconds, proof bytes and sha256.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--config", choices=("wide_ecc", "standard"),
                    default="wide_ecc")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from plonky2_tpu_torch.models.hash_tree import build_hash_tree_circuit
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    from plonky2_tpu_torch.runtime.session import ProverSession
    from plonky2_tpu_torch.utils.serialization import serialize_proof
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    t = time.perf_counter()
    config = (CircuitConfig.wide_ecc_config() if args.config == "wide_ecc"
              else CircuitConfig.standard_recursion_config())
    data, pw, root = build_hash_tree_circuit(config, 17, device="cuda")
    build_s = time.perf_counter() - t
    sess = ProverSession(data, device="cuda")
    t = time.perf_counter()
    proof = sess.prove(pw, rng=random.Random(args.seed))
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t
    if proof.public_inputs != root:
        raise RuntimeError("the proof's public inputs are not the root")
    sess.verify(proof)
    blob = serialize_proof(proof)
    with open(args.out, "wb") as f:
        f.write(blob)
    ints = lambda a: [int(x) for x in np.asarray(a).reshape(-1)]  # noqa: E731
    with open(os.path.splitext(args.out)[0] + ".json", "w") as f:
        json.dump({"config": args.config,
                   "degree_bits": data.common.degree_bits(),
                   "constants_sigmas_cap": [
                       ints(d) for d in
                       data.verifier_only.constants_sigmas_cap.digests],
                   "circuit_digest": ints(data.prover_only.circuit_digest),
                   "gate_ids": [g.id() for g in data.common.gates],
                   "root": root}, f)
    print(json.dumps({"build_s": build_s, "prove_s": prove_s,
                      "bytes": len(blob),
                      "sha256": hashlib.sha256(blob).hexdigest(),
                      "circuit_digest": [int(x) for x in
                                         data.prover_only.circuit_digest],
                      "root": root}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
