"""Prove the block of one signed transfer with the port on the card and
write the proof as plain arrays.

    python3 scripts/port_evm_block_proof.py OUT.npz

Generates the six traces of ``plonky2_tpu_torch/evm/workload.py:
transfer_inputs()`` (tests/test_evm_transfer.py's block) with the sender
recovered in the kernel and the arithmetic table's range check on
(``evm/block.py:generate_block_traces``), proves them under
``StarkConfig.standard_fast_config()`` on cuda (``prove_block_traces``),
verifies the proof with the port's verifier, and writes OUT.npz:
``skeleton`` (the proof's tree without its public values as JSON, from
utils/serialization.py:proof_to_plain), the arrays ``a0``, ``a1``, ...,
``sha256`` (utils/serialization.py:proof_sha256 of that tree, which
chip_smoke.py phase 9n pins) and ``public_values`` (JSON, the roots as
decimal strings).  ``JAX_PLATFORMS=cpu python3 scripts/jax_block_pins.py
--proof OUT.npz`` checks it with the JAX package's verifier on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    args = ap.parse_args()
    import torch
    from plonky2_tpu_torch.evm.block import (generate_block_traces,
                                             prove_block_traces)
    from plonky2_tpu_torch.evm.verifier import verify_all_proof
    from plonky2_tpu_torch.evm.workload import transfer_inputs
    from plonky2_tpu_torch.stark.config import StarkConfig
    from plonky2_tpu_torch.utils.serialization import (proof_sha256,
                                                       proof_to_plain)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    config = StarkConfig.standard_fast_config()
    inputs, after = transfer_inputs()
    t = time.perf_counter()
    traces, public_values, kernel = generate_block_traces(
        inputs, range_check=True, in_kernel_ecrecover=True)
    print(f"traces {[t.shape for t in traces]} in "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    if public_values.trie_roots_after.state_root != after.calc_hash():
        raise SystemExit("the state root after the block is not the "
                         "hand-built trie's")
    torch.cuda.synchronize()
    t = time.perf_counter()
    proof, all_stark = prove_block_traces(traces, public_values, kernel,
                                          config)
    torch.cuda.synchronize()
    print(f"prove_block_traces {time.perf_counter() - t:.3f} s", flush=True)
    t = time.perf_counter()
    verify_all_proof(all_stark, proof, config)
    print(f"verified in {time.perf_counter() - t:.2f} s", flush=True)
    bare = dataclasses.replace(proof, public_values=None)
    skeleton, arrays = proof_to_plain(bare)
    sha = proof_sha256(bare)
    pv = {k: {f: str(v) for f, v in vars(getattr(public_values, k)).items()}
          for k in ("trie_roots_before", "trie_roots_after",
                    "block_metadata")}
    np.savez(args.out, skeleton=np.array(json.dumps(skeleton)),
             sha256=np.array(sha), public_values=np.array(json.dumps(pv)),
             **{f"a{i}": a for i, a in enumerate(arrays)})
    print(f"wrote {args.out}: {len(arrays)} arrays, proof sha256 {sha}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
