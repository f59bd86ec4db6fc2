"""Make the proofs of chip_smoke.py phases 9l and 9m with the port and
write them.

    python3 scripts/port_ecdsa_arithmetic_proofs.py OUTDIR [--device cpu]
        [--parts ecdsa,arithmetic]

Every proof is made on the device (cuda unless --device is given) and
verified by the port:

- ecdsa: tests/test_ecdsa_verify.py's circuit (models/ecdsa_verify.py,
  98,660 gates, 2^17 rows under standard_ecc_config), built on the
  device and proved through ProverSession from random.Random(0) (host
  witness); chip_smoke.py pins its sha256 as ECDSA_PROOF_SHA256.
- arithmetic: ArithmeticStark(range_check=True) on evm/workload.py:
  arithmetic_ops() (41,692 ops in 65,516 of 2^16 rows, 237 columns)
  under StarkConfig.standard_fast_config(); chip_smoke.py pins its
  proof_sha256 as ARITHMETIC_PROOF_SHA256.

Writes OUTDIR/ecdsa.bin (the serialized proof), OUTDIR/arithmetic.npz
(``skeleton``, the proof's tree as JSON, and its arrays ``a0``, ``a1``,
...; utils/serialization.py:proof_to_plain) and OUTDIR/proofs.json (each
proof's sha256 and seconds, the circuit's degree bits, digest and
constants-sigmas cap, the trace's sha256 and the op stream's size and
seed).  ``scripts/jax_verify_ecdsa_arithmetic.py OUTDIR`` checks both
with the JAX package on the CPU.
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


def sync():
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def ecdsa(outdir, device) -> dict:
    from plonky2_tpu_torch.ecdsa import curve
    from plonky2_tpu_torch.models.ecdsa_verify import build_ecdsa_circuit
    from plonky2_tpu_torch.runtime.session import ProverSession
    from plonky2_tpu_torch.utils.serialization import serialize_proof
    t = time.perf_counter()
    data, pw, inputs = build_ecdsa_circuit(device)
    sync()
    build_s = time.perf_counter() - t
    print(f"ecdsa: built 2^{data.common.degree_bits()} rows in "
          f"{build_s:.2f} s", flush=True)
    if not curve.verify_message(inputs.msg, inputs.sig, inputs.pk):
        raise ValueError("the native verifier refuses the signature")
    sess = ProverSession(data, device)
    t = time.perf_counter()
    proof = sess.prove(pw, rng=random.Random(0))
    sync()
    prove_s = time.perf_counter() - t
    t = time.perf_counter()
    sess.verify(proof)
    verify_s = time.perf_counter() - t
    blob = serialize_proof(proof)
    with open(os.path.join(outdir, "ecdsa.bin"), "wb") as f:
        f.write(blob)
    meta = {"degree_bits": data.common.degree_bits(),
            "circuit_digest": [int(x) for x in
                               data.verifier_only.circuit_digest],
            "constants_sigmas_cap": np.asarray(
                data.verifier_only.constants_sigmas_cap.digests).tolist(),
            "sha256": hashlib.sha256(blob).hexdigest(), "bytes": len(blob),
            "build_s": build_s, "prove_s": prove_s, "verify_s": verify_s}
    print(f"ecdsa: proved in {prove_s:.2f} s, verified in {verify_s:.2f} "
          f"s; {len(blob)} bytes, sha256 {meta['sha256']}", flush=True)
    return meta


def arithmetic(outdir, device) -> dict:
    from plonky2_tpu_torch.evm.arithmetic import ArithmeticStark
    from plonky2_tpu_torch.evm.workload import (ARITHMETIC_GROUPS,
                                                arithmetic_ops)
    from plonky2_tpu_torch.stark.config import StarkConfig
    from plonky2_tpu_torch.stark.prover import prove
    from plonky2_tpu_torch.stark.verifier import verify_stark_proof
    from plonky2_tpu_torch.utils.serialization import (proof_sha256,
                                                       proof_to_plain)
    stark, config = (ArithmeticStark(range_check=True),
                     StarkConfig.standard_fast_config())
    t = time.perf_counter()
    ops = arithmetic_ops(ARITHMETIC_GROUPS, 0)
    trace = stark.generate_trace(ops)
    trace_s = time.perf_counter() - t
    t = time.perf_counter()
    proof = prove(stark, config, trace, [], device=device)
    sync()
    prove_s = time.perf_counter() - t
    t = time.perf_counter()
    verify_stark_proof(stark, proof, config)
    verify_s = time.perf_counter() - t
    skeleton, arrays = proof_to_plain(proof)
    np.savez(os.path.join(outdir, "arithmetic.npz"),
             skeleton=np.array(json.dumps(skeleton)),
             **{f"a{i}": a for i, a in enumerate(arrays)})
    meta = {"groups": ARITHMETIC_GROUPS, "ops": len(ops), "seed": 0,
            "rows": int(trace.shape[1]),
            "trace_sha256": hashlib.sha256(
                np.ascontiguousarray(trace).tobytes()).hexdigest(),
            "sha256": proof_sha256(proof), "trace_s": trace_s,
            "prove_s": prove_s, "verify_s": verify_s}
    print(f"arithmetic: trace {trace.shape} in {trace_s:.2f} s, proved in "
          f"{prove_s:.2f} s, verified in {verify_s:.2f} s; proof_sha256 "
          f"{meta['sha256']}", flush=True)
    return meta


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir")
    ap.add_argument("--device", default=None)
    ap.add_argument("--parts", default="ecdsa,arithmetic")
    args = ap.parse_args()
    os.makedirs(args.outdir, exist_ok=True)
    path = os.path.join(args.outdir, "proofs.json")
    meta = {}
    if os.path.exists(path):
        with open(path) as f:
            meta = json.load(f)
    for part in args.parts.split(","):
        meta[part] = {"ecdsa": ecdsa,
                      "arithmetic": arithmetic}[part](args.outdir,
                                                      args.device)
        with open(path, "w") as f:
            json.dump(meta, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
