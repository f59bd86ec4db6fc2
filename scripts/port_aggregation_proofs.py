"""Make the recursive-aggregation proofs of chip_smoke.py phases 9i-9k with
the port and write them.

    python3 scripts/port_aggregation_proofs.py OUTDIR [--device cpu]
        [--parts fib_wrapper,memory_wrapper,gate_set,tree]
        [--evm-proof EVM.npz]

Every proof goes through ProverSession on the device (cuda unless
--device is given), its witness randomness random.Random(0) (the tree's
as chip_smoke.py:phase_tree draws it), and is verified by the port:

- fib_wrapper: the Fibonacci STARK's proof at 2^20 rows under
  StarkConfig.standard_fast_config() (its sha256 chip_smoke.py's
  FIB_PROOF_SHA256) in tests/test_stark_recursion.py's circuit under
  standard_recursion_config (models/stark_wrapper.py);
- memory_wrapper: the EVM memory table's wrapper
  (evm/recursive_verifier.py) over the four-table proof of 640 sponge
  ops, read from EVM.npz (scripts/port_evm_proof.py's file; its sha256
  must be chip_smoke.py's EVM_PROOF_SHA256) or proved on the device,
  proved through wrap_table_proof in the wrapper's own session;
- gate_set: phase 9k's circuit (models/gate_set.py);
- tree: phase 9j's tree (models/recursion_tree.py), its inner proof,
  four leaves, two nodes and the root.

Writes OUTDIR/<part>.bin (the serialized proof; the tree's root as
tree.bin) and OUTDIR/proofs.json (each proof's sha256, bytes, seconds,
and its circuit's degree bits, digest and constants-sigmas cap).
``scripts/jax_verify_aggregation_proofs.py OUTDIR`` builds the
Fibonacci wrapper and the tree's node circuit with the JAX package and
checks fib_wrapper.bin and tree.bin with its verifier.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PARTS = ("fib_wrapper", "memory_wrapper", "gate_set", "tree")


def evm_proof(path, device):
    """The 640-op EVM proof: read from `path`, or proved on `device`."""
    from plonky2_tpu_torch.evm import all_stark
    from plonky2_tpu_torch.evm.prover import prove_all
    from plonky2_tpu_torch.evm.workload import sponge_ops
    from plonky2_tpu_torch.stark.config import StarkConfig
    import chip_smoke
    if path is None:
        return prove_all(all_stark.make_all_stark(),
                         StarkConfig.standard_fast_config(),
                         all_stark.generate_all_traces(
                             sponge_ops(chip_smoke.EVM_OPS)), device=device)
    from plonky2_tpu_torch.evm import proof as ep
    from plonky2_tpu_torch.fri import proof as fp
    from plonky2_tpu_torch.hash import merkle
    from plonky2_tpu_torch.utils.serialization import proof_from_plain
    f = np.load(path)
    arrays = [f[f"a{i}"] for i in range(len(f.files) - 2)]
    classes = {c.__name__: c for c in (
        merkle.MerkleCap, merkle.MerkleProof, fp.FriProof, fp.FriQueryRound,
        fp.FriQueryStep, fp.FriInitialTreeProof, ep.AllProof,
        ep.EvmStarkProof, ep.EvmStarkOpeningSet)}
    return proof_from_plain(json.loads(str(f["skeleton"])), arrays, classes)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir")
    ap.add_argument("--device", default=None)
    ap.add_argument("--parts", default=",".join(PARTS))
    ap.add_argument("--evm-proof", default=None)
    args = ap.parse_args()
    parts = args.parts.split(",")
    if not set(parts) <= set(PARTS):
        raise SystemExit(f"--parts takes {PARTS}")
    import chip_smoke
    from plonky2_tpu_torch.iop.witness import PartialWitness
    from plonky2_tpu_torch.runtime.session import ProverSession
    from plonky2_tpu_torch.stark.config import StarkConfig
    from plonky2_tpu_torch.utils.serialization import (proof_sha256,
                                                       serialize_proof)
    dev = args.device
    config = StarkConfig.standard_fast_config()
    os.makedirs(args.outdir, exist_ok=True)
    out = {}

    def prove(name, data, pw, seed=0, write=True, make=None):
        """Prove `pw` in a new session of `data`, or call `make(rng)`."""
        t = time.perf_counter()
        rng = random.Random(seed)
        proof = (make(rng) if make is not None
                 else ProverSession(data, dev).prove(pw, rng=rng))
        seconds = time.perf_counter() - t
        data.verify(proof)
        blob = serialize_proof(proof)
        vo = data.verifier_only
        out[name] = {
            "degree_bits": data.common.degree_bits(),
            "circuit_digest": [int(x) for x in vo.circuit_digest],
            "constants_sigmas_cap": vo.constants_sigmas_cap.digests.tolist(),
            "proof_bytes": len(blob), "seconds": seconds,
            "sha256": hashlib.sha256(blob).hexdigest()}
        print(f"{name}: 2^{data.common.degree_bits()} rows, proof "
              f"{len(blob)} bytes in {seconds:.2f} s, sha256 "
              f"{out[name]['sha256']}", flush=True)
        if write:
            with open(os.path.join(args.outdir, f"{name}.bin"), "wb") as f:
                f.write(blob)
        return proof

    if "fib_wrapper" in parts:
        from plonky2_tpu_torch.models.fibonacci_stark import FibonacciStark
        from plonky2_tpu_torch.models.stark_wrapper import \
            stark_wrapper_builder
        from plonky2_tpu_torch.stark import recursive_verifier as srv
        from plonky2_tpu_torch.stark.prover import prove as stark_prove
        stark = FibonacciStark(1 << chip_smoke.FIB_LOG_N)
        pis = [0, 1, stark.expected_result(0, 1)]
        sproof = stark_prove(stark, config, stark.generate_trace(0, 1), pis,
                             device=dev)
        if proof_sha256(sproof) != chip_smoke.FIB_PROOF_SHA256:
            raise SystemExit("the Fibonacci STARK proof is not "
                             "FIB_PROOF_SHA256")
        b, pt = stark_wrapper_builder(stark, config, chip_smoke.FIB_LOG_N)
        pw = PartialWitness()
        srv.set_stark_proof_with_pis_target(pw, pt, sproof)
        prove("fib_wrapper", b.build(device=dev), pw)

    if "memory_wrapper" in parts:
        from plonky2_tpu_torch.evm import all_stark
        from plonky2_tpu_torch.evm import recursive_verifier as erv
        proof = evm_proof(args.evm_proof, dev)
        if proof_sha256(proof) != chip_smoke.EVM_PROOF_SHA256:
            raise SystemExit("the EVM proof is not EVM_PROOF_SHA256")
        astark = all_stark.make_all_stark()
        challenges, states = erv.replay_challenger_states(astark, proof,
                                                          config)
        mem = all_stark.MEMORY
        wc = erv.recursive_stark_circuit(
            astark.starks[mem], astark.cross_table_lookups, mem,
            proof.degree_bits[mem], config, device=dev)
        prove("memory_wrapper", wc.data, None,
              make=lambda rng: erv.wrap_table_proof(
                  wc, proof.stark_proofs[mem], states[mem][0], challenges,
                  rng=rng))

    if "gate_set" in parts:
        from plonky2_tpu_torch.models.gate_set import build_gate_set_circuit
        prove("gate_set", *build_gate_set_circuit(device=dev))

    if "tree" in parts:
        from plonky2_tpu_torch.models.recursion_tree import (
            build_tree_circuits, tree_witnesses)
        tree = build_tree_circuits(device=dev)
        leaf, node = tree["leaf"], tree["node"]
        inner_proof = prove("tree_inner", tree["inner"], tree["inner_pw"],
                            write=False)
        leaf_pw, node_pw = tree_witnesses(tree, inner_proof)
        leaves = [prove(f"tree_leaf{i}", leaf, leaf_pw(), i, write=False)
                  for i in range(4)]
        nodes = [prove(f"tree_node{j}", node,
                       node_pw(*leaves[2 * j:2 * j + 2]), 4 + j, write=False)
                 for j in range(2)]
        prove("tree", node, node_pw(*nodes), 6)

    with open(os.path.join(args.outdir, "proofs.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
