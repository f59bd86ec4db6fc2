"""Check a System Zero proof made by the port (scripts/
port_system_zero_proof.py) with the JAX package's verifier, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/jax_verify_system_zero_proof.py \
        PROOF.npz

Rebuilds the proof as the JAX package's classes (the port's field names
are the JAX package's), runs plonky2_tpu/stark/verifier.py:
verify_stark_proof on plonky2_tpu.system_zero.SystemZero under
StarkConfig.standard_fast_config(), then flips the low bit of one opened
value (the first local value) and requires the verifier to reject that
copy.  Exits 0 only if both hold.
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

from scripts.jax_verify_evm_proof import from_plain  # noqa: E402


def jax_classes() -> dict:
    from plonky2_tpu.fri import proof as fp
    from plonky2_tpu.hash import merkle
    from plonky2_tpu.stark import proof as sp
    return {c.__name__: c for c in (
        merkle.MerkleCap, merkle.MerkleProof, fp.FriProof, fp.FriQueryRound,
        fp.FriQueryStep, fp.FriInitialTreeProof, sp.StarkOpeningSet,
        sp.StarkProof, sp.StarkProofWithPublicInputs)}


def main() -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    from plonky2_tpu.stark.config import StarkConfig
    from plonky2_tpu.stark.verifier import verify_stark_proof
    from plonky2_tpu.system_zero.system_zero import SystemZero
    f = np.load(sys.argv[1])
    arrays = [f[f"a{i}"] for i in range(len(f.files) - 2)]
    proof = from_plain(json.loads(str(f["skeleton"])), arrays, jax_classes())
    stark, config = SystemZero(), StarkConfig.standard_fast_config()
    t = time.perf_counter()
    verify_stark_proof(stark, proof, config)
    print(f"the JAX verifier accepts the System Zero proof of "
          f"{int(f['rows'])} rows in {time.perf_counter() - t:.1f} s",
          flush=True)
    bad = copy.deepcopy(proof)
    bad.proof.openings.local_values[0][0] ^= np.uint64(1)
    try:
        verify_stark_proof(stark, bad, config)
    except Exception as e:          # the verifiers raise several kinds
        print(f"the JAX verifier rejects the flipped copy: "
              f"{type(e).__name__}: {e}")
        return 0
    print("the JAX verifier accepted a flipped copy")
    return 1


if __name__ == "__main__":
    sys.exit(main())
