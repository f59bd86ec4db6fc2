"""Check the port's ECDSA circuit proof and range-checked arithmetic table
proof with the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/jax_verify_ecdsa_arithmetic.py DIR
        [--parts ecdsa,arithmetic] [--circuit-cache FILE] [--build-only]

DIR is what ``scripts/port_ecdsa_arithmetic_proofs.py DIR`` wrote (on the
card): ecdsa.bin, arithmetic.npz and proofs.json.

- ecdsa: the JAX package builds tests/test_ecdsa_verify.py's circuit
  (models/ecdsa_verify.py, under standard_ecc_config), which must have
  the port's degree, circuit digest and constants-sigmas cap; its
  verifier must accept ecdsa.bin and reject a copy with one opened value
  changed.  The build takes tens of minutes: with --circuit-cache the
  circuit's CommonCircuitData and VerifierOnlyCircuitData are pickled to
  FILE after the build and read from it when FILE exists, and
  --build-only stops after the build (and prints the JAX digest).
- arithmetic: the JAX package generates the trace of the same op stream
  (evm/workload.py:arithmetic_ops), which must hash as the port's did; its
  verifier must accept arithmetic.npz under ArithmeticStark(
  range_check=True) and StarkConfig.standard_fast_config(), and reject
  a copy with one opened value changed.

Exits 0 only if all hold.
"""
from __future__ import annotations

import argparse
import copy
import hashlib
import json
import os
import pickle
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

P = 0xFFFFFFFF00000001


def jax_ecdsa_circuit(cache):
    """(common, verifier_only, build seconds) of the JAX build, from the
    cache when it holds them."""
    if cache and os.path.exists(cache):
        with open(cache, "rb") as f:
            return pickle.load(f)
    from plonky2_tpu.ecdsa import curve, gadgets
    from plonky2_tpu.plonk.circuit_builder import CircuitBuilder
    from plonky2_tpu.plonk.config import CircuitConfig
    from plonky2_tpu_torch.models.ecdsa_verify import (ecdsa_inputs,
                                                       place_ecdsa_verify)
    t = time.perf_counter()
    b = CircuitBuilder(CircuitConfig.standard_ecc_config())
    place_ecdsa_verify(b, curve, gadgets, ecdsa_inputs(curve))
    print(f"ecdsa: the JAX builder placed {b.num_gates()} gates in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    data = b.build()
    out = (data.common, data.verifier_only, time.perf_counter() - t)
    if cache:
        with open(cache, "wb") as f:
            pickle.dump(out, f)
    return out


def circuit_key(common, verifier_only):
    return (common.degree_bits(),
            [int(x) for x in verifier_only.circuit_digest],
            np.asarray(verifier_only.constants_sigmas_cap.digests).tolist())


def check_ecdsa(outdir, meta, cache, build_only) -> bool:
    from plonky2_tpu.plonk.verifier import verify
    from plonky2_tpu.utils.serialization import deserialize_proof
    common, verifier_only, build_s = jax_ecdsa_circuit(cache)
    got = circuit_key(common, verifier_only)
    print(f"ecdsa: the JAX package built the circuit (2^{got[0]} rows, "
          f"digest {got[1]}) in {build_s:.1f} s", flush=True)
    if build_only:
        return True
    m = meta["ecdsa"]
    want = (m["degree_bits"], m["circuit_digest"], m["constants_sigmas_cap"])
    if got != want:
        print(f"ecdsa: the JAX circuit differs: {got[:2]} against the "
              f"port's {want[:2]}")
        return False
    with open(os.path.join(outdir, "ecdsa.bin"), "rb") as f:
        raw = f.read()
    if hashlib.sha256(raw).hexdigest() != m["sha256"]:
        print("ecdsa: ecdsa.bin is not the proof that proofs.json names")
        return False
    proof = deserialize_proof(raw, common)
    t = time.perf_counter()
    verify(proof, verifier_only, common)
    print(f"ecdsa: the JAX verifier accepts the port's proof in "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    bad = copy.deepcopy(proof)
    w = bad.proof.openings.wires
    w[0] = ((int(w[0][0]) + 1) % P,) + tuple(w[0][1:])
    try:
        verify(bad, verifier_only, common)
    except Exception as e:          # the verifiers raise several kinds
        print(f"ecdsa: ... and rejects it with one opened wire changed "
              f"({type(e).__name__})", flush=True)
        return True
    print("ecdsa: the JAX verifier accepted a changed copy")
    return False


def check_arithmetic(outdir, meta) -> bool:
    from plonky2_tpu.evm.arithmetic import ArithmeticStark, Operation
    from plonky2_tpu.stark.config import StarkConfig
    from plonky2_tpu.stark.verifier import verify_stark_proof
    from plonky2_tpu_torch.evm.workload import arithmetic_ops
    from plonky2_tpu_torch.utils.serialization import proof_from_plain
    from scripts.jax_verify_system_zero_proof import jax_classes
    m = meta["arithmetic"]
    stark = ArithmeticStark(range_check=True)
    t = time.perf_counter()
    trace = stark.generate_trace(arithmetic_ops(m["groups"], m["seed"],
                                                operation=Operation))
    trace_s = time.perf_counter() - t
    digest = hashlib.sha256(np.ascontiguousarray(trace).tobytes()).hexdigest()
    if digest != m["trace_sha256"]:
        print("arithmetic: the JAX trace differs from the port's")
        return False
    print(f"arithmetic: the JAX package generated the port's trace "
          f"({trace.shape[0]} x {trace.shape[1]}, {m['ops']} ops) in "
          f"{trace_s:.1f} s", flush=True)
    f = np.load(os.path.join(outdir, "arithmetic.npz"))
    arrays = [f[f"a{i}"] for i in range(len(f.files) - 1)]
    proof = proof_from_plain(json.loads(str(f["skeleton"])), arrays,
                             jax_classes())
    config = StarkConfig.standard_fast_config()
    t = time.perf_counter()
    verify_stark_proof(stark, proof, config)
    print(f"arithmetic: the JAX verifier accepts the port's proof in "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    bad = copy.deepcopy(proof)
    bad.proof.openings.local_values[0][0] ^= np.uint64(1)
    try:
        verify_stark_proof(stark, bad, config)
    except Exception as e:          # the verifiers raise several kinds
        print(f"arithmetic: ... and rejects it with one opened value "
              f"flipped ({type(e).__name__})", flush=True)
        return True
    print("arithmetic: the JAX verifier accepted a flipped copy")
    return False


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir")
    ap.add_argument("--parts", default="ecdsa,arithmetic")
    ap.add_argument("--circuit-cache")
    ap.add_argument("--build-only", action="store_true")
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    meta = {}
    if not args.build_only:
        with open(os.path.join(args.outdir, "proofs.json")) as f:
            meta = json.load(f)
    ok = True
    for part in args.parts.split(","):
        if part == "ecdsa":
            ok &= check_ecdsa(args.outdir, meta, args.circuit_cache,
                              args.build_only)
        elif not args.build_only:
            ok &= check_arithmetic(args.outdir, meta)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
