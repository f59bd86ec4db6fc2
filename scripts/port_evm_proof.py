"""Prove the four-table EVM workload with the port on the card and write
the proof as plain arrays.

    python3 scripts/port_evm_proof.py OUT.npz [--ops 640]

Generates the traces of ``plonky2_tpu_torch/evm/workload.py:sponge_ops``
(``--ops`` operations), proves them under
``StarkConfig.standard_fast_config()`` on cuda, verifies the proof with
the port's verifier, and writes OUT.npz: ``skeleton`` (the proof's tree
as JSON, from utils/serialization.py:proof_to_plain), the arrays
``a0``, ``a1``, ..., and ``ops`` (the operation count).
``scripts/jax_verify_evm_proof.py OUT.npz`` checks it with the JAX
package's verifier on the CPU.
"""
from __future__ import annotations

import argparse
import hashlib
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
    ap.add_argument("--ops", type=int, default=640)
    args = ap.parse_args()
    import torch
    from plonky2_tpu_torch.evm import all_stark
    from plonky2_tpu_torch.evm.prover import prove_all
    from plonky2_tpu_torch.evm.verifier import verify_all_proof
    from plonky2_tpu_torch.evm.workload import sponge_ops
    from plonky2_tpu_torch.stark.config import StarkConfig
    from plonky2_tpu_torch.utils.serialization import proof_to_plain
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    config = StarkConfig.standard_fast_config()
    t = time.perf_counter()
    traces = all_stark.generate_all_traces(sponge_ops(args.ops))
    print(f"traces {[t.shape for t in traces]} in "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    stark = all_stark.make_all_stark()
    t = time.perf_counter()
    stark.programs(config)
    print(f"programs compiled in {time.perf_counter() - t:.2f} s",
          flush=True)
    for run in ("cold", "warm"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        proof = prove_all(stark, config, traces)
        torch.cuda.synchronize()
        print(f"{run} prove_all {time.perf_counter() - t:.3f} s", flush=True)
    t = time.perf_counter()
    verify_all_proof(stark, proof, config)
    print(f"verified in {time.perf_counter() - t:.2f} s", flush=True)
    skeleton, arrays = proof_to_plain(proof)
    np.savez(args.out, skeleton=np.array(json.dumps(skeleton)),
             ops=np.int64(args.ops),
             **{f"a{i}": a for i, a in enumerate(arrays)})
    h = hashlib.sha256()
    for a in arrays:
        h.update(a.tobytes())
    print(f"wrote {args.out}: {len(arrays)} arrays, sha256 of the arrays "
          f"{h.hexdigest()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
