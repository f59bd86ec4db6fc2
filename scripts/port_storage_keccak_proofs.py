"""Prove chip_smoke.py's phases 9o and 9p with the port on the card and
write both proofs for the JAX package's verifier.

    python3 scripts/port_storage_keccak_proofs.py OUT_DIR

9o: tests/test_storage_ops.py's kernel (evm/workload.py:
storage_ops_kernel) executed with its tries, its six traces proved under
StarkConfig.standard_fast_config() on cuda (evm/block.py:
prove_block_traces) and verified by the port; written as
OUT_DIR/storage.npz: ``skeleton`` (the proof's tree as JSON, from
utils/serialization.py:proof_to_plain), the arrays ``a0``, ``a1``, ...,
and ``sha256`` (utils/serialization.py:proof_sha256, which chip_smoke.py
pins).  9p: tests/test_keccak_config.py's Fibonacci circuit built under
KECCAK_CONFIG on cuda (models/fibonacci.py), proved through ProverSession
with its random wires from random.Random(0), verified by the port;
written as OUT_DIR/keccak.bin (utils/serialization.py:serialize_proof).

``JAX_PLATFORMS=cpu python3 scripts/jax_storage_keccak_pins.py
--storage-proof OUT_DIR/storage.npz --keccak-proof OUT_DIR/keccak.bin``
checks both with the JAX package's verifier on the CPU.
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

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    args = ap.parse_args()
    import torch
    from plonky2_tpu_torch.evm import workload
    from plonky2_tpu_torch.evm.all_stark import generate_all_traces_with_cpu
    from plonky2_tpu_torch.evm.block import prove_block_traces
    from plonky2_tpu_torch.evm.verifier import verify_all_proof
    from plonky2_tpu_torch.hash.hashers import KECCAK_CONFIG
    from plonky2_tpu_torch.models.fibonacci import (build_fibonacci_circuit,
                                                    keccak_fibonacci_config)
    from plonky2_tpu_torch.runtime.session import ProverSession
    from plonky2_tpu_torch.stark.config import StarkConfig
    from plonky2_tpu_torch.utils.serialization import (proof_sha256,
                                                       proof_to_plain,
                                                       serialize_proof)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    os.makedirs(args.out_dir, exist_ok=True)

    config = StarkConfig.standard_fast_config()
    kernel = workload.storage_ops_kernel()
    t = time.perf_counter()
    ex = workload.storage_ops_execution(kernel)
    traces = generate_all_traces_with_cpu(kernel, execution=ex)
    print(f"traces {[tr.shape for tr in traces]} in "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    if workload.storage_ops_readback(ex) != workload.storage_ops_inputs()[1]:
        raise SystemExit("the read-backs or the state root differ from the "
                         "hand-built trie's")
    torch.cuda.synchronize()
    t = time.perf_counter()
    proof, all_stark = prove_block_traces(traces, None, kernel, config)
    torch.cuda.synchronize()
    print(f"prove_block_traces {time.perf_counter() - t:.3f} s", flush=True)
    verify_all_proof(all_stark, proof, config)
    skeleton, arrays = proof_to_plain(proof)
    sha = proof_sha256(proof)
    out = os.path.join(args.out_dir, "storage.npz")
    np.savez(out, skeleton=np.array(json.dumps(skeleton)),
             sha256=np.array(sha),
             **{f"a{i}": a for i, a in enumerate(arrays)})
    print(f"wrote {out}: {len(arrays)} arrays, proof sha256 {sha}")

    data, pw, _ = build_fibonacci_circuit(keccak_fibonacci_config(),
                                          gc=KECCAK_CONFIG)
    sess = ProverSession(data)
    fib = sess.prove(pw, rng=random.Random(0))
    sess.verify(fib)
    raw = serialize_proof(fib)
    out = os.path.join(args.out_dir, "keccak.bin")
    with open(out, "wb") as f:
        f.write(raw)
    print(f"wrote {out}: {len(raw)} bytes, sha256 "
          f"{hashlib.sha256(raw).hexdigest()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
