"""The JAX package's pins for chip_smoke.py phase 9n, and its check of the
port's block proof, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/jax_block_pins.py
    JAX_PLATFORMS=cpu python3 scripts/jax_block_pins.py --proof BLOCK.npz

Without ``--proof``: assembles the JAX package's block kernel
(plonky2_tpu/evm/block.py:block_kernel, in-kernel ecrecover), generates
the six traces of tests/test_evm_transfer.py's block with the sender
recovered in the kernel and the arithmetic table's range check on
(phase 9n's setting; about 200 s on a CPU), and prints, as chip_smoke.py
holds them: the sha256 of the kernel's code bytes, its code hash (the
eight 32-bit limbs as hex), each trace's shape and the sha256 of its
bytes (uint64, row-major), and the public values.

With ``--proof BLOCK.npz`` (written by scripts/port_evm_block_proof.py on
the card): rebuilds the proof as the JAX package's classes, runs
plonky2_tpu/evm/verifier.py:verify_all_proof on
make_all_stark_with_cpu(block_kernel(), range_check=True) under
StarkConfig.standard_fast_config(), then flips the low bit of one opened
value of the CPU table and requires the verifier to reject that copy.
Exits 0 only if both hold.
"""
from __future__ import annotations

import argparse
import copy
import hashlib
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def pins() -> int:
    from plonky2_tpu.evm.block import block_kernel, generate_block_traces
    from test_evm_transfer import _expected_state_after, _inputs
    kernel = block_kernel(in_kernel_ecrecover=True)
    print(f"BLOCK_KERNEL_SHA256 = "
          f"\"{hashlib.sha256(bytes(kernel.code)).hexdigest()}\"")
    code_hash = b"".join(int(x).to_bytes(4, "little")
                         for x in kernel.code_hash)
    print(f"BLOCK_CODE_HASH = \"{code_hash.hex()}\"")
    print(f"# {len(kernel.code)} code bytes", flush=True)
    inputs, sender_account = _inputs()
    t = time.perf_counter()
    traces, pv, _ = generate_block_traces(inputs, in_kernel_ecrecover=True,
                                          range_check=True)
    print(f"# traces generated in {time.perf_counter() - t:.1f} s")
    print("BLOCK_TRACES = (")
    for tr in traces:
        digest = hashlib.sha256(np.ascontiguousarray(
            tr, dtype=np.uint64).tobytes()).hexdigest()
        print(f"    ({tr.shape[0]}, {tr.shape[1]}, \"{digest}\"),")
    print(")")
    after = _expected_state_after(sender_account).calc_hash()
    if pv.trie_roots_after.state_root != after:
        print("the state root after the block is not the hand-built trie's")
        return 1
    print(f"# public values: before {vars(pv.trie_roots_before)}, after "
          f"{vars(pv.trie_roots_after)}")
    return 0


def check_proof(path: str) -> int:
    from plonky2_tpu.evm.all_stark import make_all_stark_with_cpu
    from plonky2_tpu.evm.block import block_kernel
    from plonky2_tpu.evm.verifier import verify_all_proof
    from plonky2_tpu.stark.config import StarkConfig
    from scripts.jax_verify_evm_proof import from_plain, jax_classes
    f = np.load(path)
    n = sum(1 for k in f.files if k.startswith("a"))
    proof = from_plain(json.loads(str(f["skeleton"])),
                       [f[f"a{i}"] for i in range(n)], jax_classes())
    all_stark = make_all_stark_with_cpu(block_kernel(True), range_check=True)
    config = StarkConfig.standard_fast_config()
    t = time.perf_counter()
    verify_all_proof(all_stark, proof, config)
    print(f"the JAX verifier accepts the port's block proof (degree bits "
          f"{proof.degree_bits}, sha256 {str(f['sha256'])}) in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    bad = copy.deepcopy(proof)
    bad.stark_proofs[0].openings.local_values[0][0] ^= np.uint64(1)
    try:
        verify_all_proof(all_stark, bad, config)
    except Exception as e:          # the verifiers raise several kinds
        print(f"the JAX verifier rejects the copy with one opened value of "
              f"the CPU table flipped: {type(e).__name__}: {e}")
        return 0
    print("the JAX verifier accepted a flipped copy")
    return 1


def main() -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser()
    ap.add_argument("--proof")
    args = ap.parse_args()
    return check_proof(args.proof) if args.proof else pins()


if __name__ == "__main__":
    sys.exit(main())
