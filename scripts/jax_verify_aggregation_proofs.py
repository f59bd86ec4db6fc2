"""Check the port's Fibonacci wrapper proof and tree root proof with the
JAX package's verifier, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/jax_verify_aggregation_proofs.py DIR

DIR is what ``scripts/port_aggregation_proofs.py DIR`` wrote (on the
card): fib_wrapper.bin, tree.bin and proofs.json.  The JAX package builds
the same circuits (tests/test_stark_recursion.py's wrapper of the
Fibonacci STARK of 2^20 rows under standard_fast_config, written once
in models/stark_wrapper.py; the tree's node
circuit over common_data_for_recursion(standard_recursion_config(), 5,
2), as chip_smoke.py phase 9j builds it), which must have the port's
degree, circuit digest and constants-sigmas cap; then its verifier must
accept each proof (and check_tree_proof_verifier_data the root) and
reject a copy with one public input changed.  Exits 0 only if all hold.
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

FIB_LOG_N = 20


def jax_fib_wrapper():
    from plonky2_tpu.models.fibonacci_stark import FibonacciStark
    from plonky2_tpu.plonk.circuit_builder import CircuitBuilder
    from plonky2_tpu.plonk.config import CircuitConfig
    from plonky2_tpu.stark import recursive_verifier as rv
    from plonky2_tpu.stark.config import StarkConfig
    from plonky2_tpu_torch.models.stark_wrapper import place_stark_wrapper
    stark, config = FibonacciStark(1 << FIB_LOG_N), \
        StarkConfig.standard_fast_config()
    b = CircuitBuilder(CircuitConfig.standard_recursion_config())
    place_stark_wrapper(b, rv, stark, config, FIB_LOG_N)
    return b.build(), None


def jax_tree_node():
    from plonky2_tpu.plonk.circuit_builder import CircuitBuilder
    from plonky2_tpu.plonk.config import CircuitConfig
    from plonky2_tpu.plonk.recursion import common_data_for_recursion
    config = CircuitConfig.standard_recursion_config()
    common = common_data_for_recursion(config, 5, 2)
    b = CircuitBuilder(config)
    b.tree_recursion_node(common)
    return b.build(), common


def main() -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    from plonky2_tpu.plonk.tree_recursion import \
        check_tree_proof_verifier_data
    from plonky2_tpu.utils.serialization import deserialize_proof
    outdir = sys.argv[1]
    with open(os.path.join(outdir, "proofs.json")) as f:
        meta = json.load(f)
    for name, build in (("fib_wrapper", jax_fib_wrapper),
                        ("tree", jax_tree_node)):
        t = time.perf_counter()
        data, common = build()
        build_s = time.perf_counter() - t
        got = (data.common.degree_bits(),
               [int(x) for x in data.verifier_only.circuit_digest],
               data.verifier_only.constants_sigmas_cap.digests.tolist())
        want = (meta[name]["degree_bits"], meta[name]["circuit_digest"],
                meta[name]["constants_sigmas_cap"])
        if got != want:
            print(f"{name}: the JAX circuit differs: {got[:2]} against the "
                  f"port's {want[:2]}")
            return 1
        with open(os.path.join(outdir, f"{name}.bin"), "rb") as f:
            proof = deserialize_proof(f.read(), data.common)
        t = time.perf_counter()
        data.verify(proof)
        if common is not None:
            check_tree_proof_verifier_data(proof, data.verifier_only, common)
        verify_s = time.perf_counter() - t
        print(f"{name}: the JAX package built the circuit (2^{got[0]} rows, "
              f"the port's digest and cap) in {build_s:.1f} s; its verifier "
              f"accepts the port's proof in {verify_s:.2f} s", flush=True)
        proof.public_inputs[0] = (proof.public_inputs[0] + 1) \
            % 0xFFFFFFFF00000001
        try:
            data.verify(proof)
        except Exception as e:      # the verifiers raise several kinds
            print(f"{name}: ... and rejects it with one public input "
                  f"changed ({type(e).__name__})", flush=True)
            continue
        print(f"{name}: the JAX verifier accepted a changed copy")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
