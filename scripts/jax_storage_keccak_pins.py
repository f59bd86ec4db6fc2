"""The JAX package's pins for chip_smoke.py phases 9o and 9p, and its
check of the port's proofs of both, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/jax_storage_keccak_pins.py
    JAX_PLATFORMS=cpu python3 scripts/jax_storage_keccak_pins.py \
        --storage-proof STORAGE.npz --keccak-proof KECCAK.bin

Without arguments: assembles tests/test_storage_ops.py's kernel with the
JAX package, executes it with that test's tries (about 30 s on a CPU),
generates its six traces (about 40 s) and prints, as chip_smoke.py holds
them: the sha256 of the kernel's code bytes, each trace's shape and the
sha256 of its bytes (uint64, row-major), and the read-backs and state
root.  Then builds tests/test_keccak_config.py's Fibonacci circuit under
KECCAK_CONFIG, proves it with the witness randomness pinned as
tests/test_prover_session.py:22-38 pins it (the random wires drawn from
random.Random(0), the stream chip_smoke.py's sessions pass), and prints
its circuit digest and the sha256 and length of the serialized proof.

With ``--storage-proof STORAGE.npz`` (scripts/port_storage_keccak_proofs.py
on the card): rebuilds the proof as the JAX package's classes, runs
plonky2_tpu/evm/verifier.py:verify_all_proof on
make_all_stark_with_cpu(the kernel) under
StarkConfig.standard_fast_config(), then flips the low bit of one opened
value of the CPU table and requires the verifier to reject that copy.
With ``--keccak-proof KECCAK.bin`` (the same script): reads the proof's
bytes with the JAX package's deserialize_proof against the JAX build of
the circuit, verifies it, and requires a copy with one opened wire
flipped, and the proof under Poseidon's hasher name, to be rejected.
Exits 0 only if all of it holds.
"""
from __future__ import annotations

import argparse
import copy
import hashlib
import json
import os
import random
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def storage_run():
    """(JAX kernel, its execution) of tests/test_storage_ops.py."""
    import test_storage_ops as st
    from plonky2_tpu.evm.generation import generate_kernel_execution
    from plonky2_tpu.evm.mpt import all_mpt_prover_inputs
    state, storage, _ = st._fixture()
    kernel = st._kernel(st._addr_key(st.ADDR).packed)
    data = all_mpt_prover_inputs(st.TrieInputs(
        state_trie=state, storage_tries=[(st.ADDR, storage)]))
    ex = generate_kernel_execution(
        kernel, prover_input_factory=lambda: st.Provider(data))
    return kernel, ex


def storage_pins() -> int:
    from plonky2_tpu.evm.all_stark import generate_all_traces_with_cpu
    from plonky2_tpu.evm.memory import Segment
    t = time.perf_counter()
    kernel, ex = storage_run()
    print(f"# executed in {time.perf_counter() - t:.1f} s")
    print(f"STORAGE_KERNEL_SHA256 = "
          f"\"{hashlib.sha256(bytes(kernel.code)).hexdigest()}\"")
    print(f"# {len(kernel.code)} code bytes")
    gm = int(Segment.GlobalMetadata)
    mem = ex.final_state.memory
    print("# read-backs and root: "
          f"{ {ix: hex(mem.get((0, gm, ix), 0)) for ix in (20, 21, 22, 11)} }")
    t = time.perf_counter()
    traces = generate_all_traces_with_cpu(kernel, execution=ex)
    print(f"# traces generated in {time.perf_counter() - t:.1f} s")
    print("STORAGE_TRACES = (")
    for tr in traces:
        digest = hashlib.sha256(np.ascontiguousarray(
            tr, dtype=np.uint64).tobytes()).hexdigest()
        print(f"    ({tr.shape[0]}, {tr.shape[1]}, \"{digest}\"),")
    print(")", flush=True)
    return 0


def keccak_fibonacci(seed: int = 0):
    """(JAX CircuitData, the serialized proof) of tests/
    test_keccak_config.py's circuit, its random wires from
    random.Random(seed)."""
    import plonky2_tpu.iop.generator as gen_mod
    from plonky2_tpu.field import goldilocks as gl
    from plonky2_tpu.hash.hashers import KECCAK_CONFIG
    from plonky2_tpu.utils.serialization import serialize_proof
    from test_torch_keccak_config import jax_fibonacci
    rng = random.Random(seed)
    orig = gen_mod.RandomValueGenerator.run_once

    def run_once(self, witness, out):
        out.append((self.target, rng.randrange(gl.P)))
    gen_mod.RandomValueGenerator.run_once = run_once
    try:
        data, pw = jax_fibonacci()
        assert data.common.hasher_name == KECCAK_CONFIG.name
        raw = serialize_proof(data.prove(pw))
    finally:
        gen_mod.RandomValueGenerator.run_once = orig
    return data, raw


def keccak_pins() -> int:
    t = time.perf_counter()
    data, raw = keccak_fibonacci()
    print(f"# built and proved in {time.perf_counter() - t:.1f} s, "
          f"2^{data.common.degree_bits()} rows")
    print(f"KECCAK_FIB_DIGEST = "
          f"{[int(x) for x in data.verifier_only.circuit_digest]}")
    print(f"KECCAK_FIB_PROOF_SHA256 = \"{hashlib.sha256(raw).hexdigest()}\""
          f"  # {len(raw)} bytes", flush=True)
    return 0


def check_storage_proof(path: str) -> int:
    from plonky2_tpu.evm.all_stark import make_all_stark_with_cpu
    from plonky2_tpu.evm.verifier import verify_all_proof
    from plonky2_tpu.stark.config import StarkConfig
    from scripts.jax_verify_evm_proof import from_plain, jax_classes
    f = np.load(path)
    n = sum(1 for k in f.files if k.startswith("a"))
    proof = from_plain(json.loads(str(f["skeleton"])),
                       [f[f"a{i}"] for i in range(n)], jax_classes())
    kernel, _ = storage_run()
    all_stark = make_all_stark_with_cpu(kernel)
    config = StarkConfig.standard_fast_config()
    t = time.perf_counter()
    verify_all_proof(all_stark, proof, config)
    print(f"the JAX verifier accepts the port's storage-op proof (degree "
          f"bits {proof.degree_bits}, sha256 {str(f['sha256'])}) in "
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


def check_keccak_proof(path: str) -> int:
    from plonky2_tpu.hash.hashers import KECCAK_CONFIG, POSEIDON_CONFIG
    from plonky2_tpu.utils.serialization import deserialize_proof
    raw = open(path, "rb").read()
    data, want = keccak_fibonacci()
    print(f"the card's Keccak proof: {len(raw)} bytes, sha256 "
          f"{hashlib.sha256(raw).hexdigest()}; the JAX package's "
          f"{hashlib.sha256(want).hexdigest()} (equal: {raw == want})")
    proof = deserialize_proof(raw, data.common)
    t = time.perf_counter()
    data.verify(proof)
    print(f"the JAX verifier accepts it in {time.perf_counter() - t:.2f} s",
          flush=True)
    bad = copy.deepcopy(proof)
    bad.proof.openings.wires[0][0] ^= np.uint64(1)
    refusals = 0
    for label, candidate, name in (
            ("one opened wire flipped", bad, KECCAK_CONFIG.name),
            ("Poseidon's hasher name", proof, POSEIDON_CONFIG.name)):
        data.common.hasher_name = name
        try:
            data.verify(candidate)
            print(f"the JAX verifier accepted the proof with {label}")
        except Exception as e:      # the verifiers raise several kinds
            refusals += 1
            print(f"the JAX verifier rejects the proof with {label}: "
                  f"{type(e).__name__}: {e}")
        finally:
            data.common.hasher_name = KECCAK_CONFIG.name
    return 0 if refusals == 2 else 1


def main() -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser()
    ap.add_argument("--storage-proof")
    ap.add_argument("--keccak-proof")
    args = ap.parse_args()
    if not (args.storage_proof or args.keccak_proof):
        return storage_pins() or keccak_pins()
    rc = 0
    if args.keccak_proof:
        rc |= check_keccak_proof(args.keccak_proof)
    if args.storage_proof:
        rc |= check_storage_proof(args.storage_proof)
    return rc


if __name__ == "__main__":
    sys.exit(main())
