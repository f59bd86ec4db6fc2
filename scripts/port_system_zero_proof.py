"""Prove System Zero at 2^16 rows with the port and write the proof as
plain arrays.

    python3 scripts/port_system_zero_proof.py OUT.npz [--device cpu]

Generates the trace (plonky2_tpu_torch/system_zero/system_zero.py,
MIN_TRACE_ROWS rows), proves it under StarkConfig.standard_fast_config()
on the device (cuda unless --device is given), verifies it with the
port's verifier, and writes OUT.npz: ``skeleton`` (the proof's tree as
JSON, utils/serialization.py:proof_to_plain), the arrays ``a0``, ``a1``,
..., and ``rows``.  It prints the proof's proof_sha256, which
chip_smoke.py pins as SYSTEM_ZERO_PROOF_SHA256.
``scripts/jax_verify_system_zero_proof.py OUT.npz`` checks it with the
JAX package's verifier on the CPU.
"""
from __future__ import annotations

import argparse
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
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    import torch
    from plonky2_tpu_torch.stark.config import StarkConfig
    from plonky2_tpu_torch.stark.prover import prove
    from plonky2_tpu_torch.stark.verifier import verify_stark_proof
    from plonky2_tpu_torch.system_zero.system_zero import SystemZero
    from plonky2_tpu_torch.utils.serialization import (proof_sha256,
                                                       proof_to_plain)
    stark, config = SystemZero(), StarkConfig.standard_fast_config()
    t = time.perf_counter()
    trace = stark.generate_trace()
    print(f"trace {trace.shape} in {time.perf_counter() - t:.2f} s",
          flush=True)
    for run in ("cold", "warm"):
        t = time.perf_counter()
        proof = prove(stark, config, trace, [0, 0], device=args.device)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        print(f"{run} prove {time.perf_counter() - t:.3f} s", flush=True)
        if args.device == "cpu":
            break
    t = time.perf_counter()
    verify_stark_proof(stark, proof, config)
    print(f"verified in {time.perf_counter() - t:.2f} s", flush=True)
    skeleton, arrays = proof_to_plain(proof)
    np.savez(args.out, skeleton=np.array(json.dumps(skeleton)),
             rows=np.int64(trace.shape[1]),
             **{f"a{i}": a for i, a in enumerate(arrays)})
    print(f"wrote {args.out}: {len(arrays)} arrays; proof_sha256 "
          f"{proof_sha256(proof)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
