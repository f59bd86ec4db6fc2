"""Check a four-table EVM proof made by the port (scripts/
port_evm_proof.py) with the JAX package's verifier, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/jax_verify_evm_proof.py PROOF.npz

Rebuilds the proof as the JAX package's classes (the port's field names
are the JAX package's), runs plonky2_tpu/evm/verifier.py:verify_all_proof
on plonky2_tpu.evm.all_stark.make_all_stark() under
StarkConfig.standard_fast_config(), then flips the low bit of one opened
value (the sponge table's first local value) and requires the verifier to
reject that copy.  Exits 0 only if both hold.
"""
from __future__ import annotations

import copy
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from plonky2_tpu_torch.utils.serialization import \
    proof_from_plain as from_plain  # noqa: E402


def jax_classes() -> dict:
    from plonky2_tpu.evm import proof as ep
    from plonky2_tpu.fri import proof as fp
    from plonky2_tpu.hash import merkle
    return {c.__name__: c for c in (
        merkle.MerkleCap, merkle.MerkleProof, fp.FriProof, fp.FriQueryRound,
        fp.FriQueryStep, fp.FriInitialTreeProof, ep.AllProof,
        ep.EvmStarkProof, ep.EvmStarkOpeningSet)}


def main() -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    from plonky2_tpu.evm.all_stark import make_all_stark
    from plonky2_tpu.evm.verifier import verify_all_proof
    from plonky2_tpu.stark.config import StarkConfig
    f = np.load(sys.argv[1])
    arrays = [f[f"a{i}"] for i in range(len(f.files) - 2)]
    proof = from_plain(json.loads(str(f["skeleton"])), arrays, jax_classes())
    all_stark = make_all_stark()
    config = StarkConfig.standard_fast_config()
    t = time.perf_counter()
    verify_all_proof(all_stark, proof, config)
    print(f"the JAX verifier accepts the proof of {int(f['ops'])} sponge "
          f"ops (degree bits {proof.degree_bits}) in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    bad = copy.deepcopy(proof)
    bad.stark_proofs[1].openings.local_values[0][0] ^= np.uint64(1)
    try:
        verify_all_proof(all_stark, bad, config)
    except Exception as e:          # the verifiers raise several kinds
        print(f"the JAX verifier rejects the flipped copy: "
              f"{type(e).__name__}: {e}")
        return 0
    print("the JAX verifier accepted a flipped copy")
    return 1


if __name__ == "__main__":
    sys.exit(main())
