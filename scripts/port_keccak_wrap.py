"""The final wrapper of a recursion chain under the Keccak hasher
configuration, proved at its real size, beside the same circuit under
Poseidon.

    python3 scripts/port_keccak_wrap.py [--device cuda] [--inner-log 16]
                                        [--out FILE]

models/bench_recursion.py's chain under standard_recursion_config (135
wires, rate 3, cap 4, 28 queries, 16 bits of proof of work): the no-op
proof of 2^inner_log rows and the proof that verifies it, both Poseidon.
Then the circuit that verifies that proof, built twice: with
POSEIDON_CONFIG (chip_smoke.py phase 9h's "double" circuit) and with
KECCAK_CONFIG, the final wrapper whose proof a contract on Ethereum
checks (its trees, digest, transcript and grind are Keccak; the LDEs and
the quotient stay on the device).  Each wrapper is proved cold and warm
through ProverSession from random.Random(0), both proofs one sha256,
verified by the port's verifier, and refused with one opened wire
flipped.

Printed and written (as JSON to --out) for each proof: its wall, the
prover's stages (each between two synchronizations of the device), the
host Keccak seconds and calls by trees and by permutations, the bytes of
leaves copied down to the host and of digest levels put back beside them,
peak ``max_memory_allocated`` and the kernels' launches; for the warm run
on a CUDA device, the device's busy time and idle share (torch.profiler);
and the card's name and power limit.  ``--device cpu`` runs the same
steps with the kernels' plain versions (no profile, no peak).
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import hashlib
import json
import os
import random
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


class Timer:
    """The prover's ``timing``: stage walls, synchronizing a CUDA device
    at each edge so that host stages count as well as device ones."""

    def __init__(self, device):
        import torch
        self.sync = (torch.cuda.synchronize if device.type == "cuda"
                     else (lambda: None))
        self.ms = {}

    @contextlib.contextmanager
    def scope(self, name):
        self.sync()
        t = time.perf_counter()
        try:
            yield
        finally:
            self.sync()
            self.ms[name] = (self.ms.get(name, 0.0)
                             + (time.perf_counter() - t) * 1e3)


def prove_wrapper(name, data, pw, device, log) -> dict:
    """Cold and warm proofs of `pw` in one session of `data`, with their
    numbers; the port's verifier accepts both and refuses a flipped
    opened wire."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from plonky2_tpu_torch.fri.verifier import FriVerificationError
    from plonky2_tpu_torch.plonk.verifier import ProofVerificationError
    from plonky2_tpu_torch.runtime.session import ProverSession
    from plonky2_tpu_torch.utils.serialization import serialize_proof
    cuda = device.type == "cuda"
    timer = Timer(device)
    sess = ProverSession(data, device, timing=timer)
    runs = []
    for i in range(2):
        timer = Timer(device)
        clock, profile = {}, {}
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        cs.reset_launch_counts()
        with contextlib.ExitStack() as stack:
            stack.enter_context(cs.host_keccak_clock(clock))
            if cuda and i:
                stack.enter_context(cs.device_trace(profile))
            t = time.perf_counter()
            proof = sess.prove(pw, rng=random.Random(0), timing=timer)
            timer.sync()
            wall = time.perf_counter() - t
        launches = {k: v for k, v in cs.read_launch_counts().items() if v}
        t = time.perf_counter()
        sess.verify(proof)
        verify_s = time.perf_counter() - t
        blob = serialize_proof(proof)
        host = sum(v["s"] for v in clock.values())
        run = {"wall_s": wall, "verify_s": verify_s, "stages_ms": timer.ms,
               "host_keccak_s": host, "host_keccak": clock,
               "leaf_bytes_down": clock["hash_leaves"]["bytes_in"],
               "level_bytes_up": clock["hash_leaves"]["bytes_out"]
               + clock["compress_batch"]["bytes_out"],
               "peak_bytes": torch.cuda.max_memory_allocated() if cuda
               else None,
               "launches": launches, "bytes": len(blob),
               "sha256": hashlib.sha256(blob).hexdigest(),
               "busy_ms": profile.get("busy_ms"),
               "traced_wall_ms": profile.get("wall_ms")}
        runs.append(run)
        log(f"  {name} {'warm' if i else 'cold'}: {wall:.4f} s, host "
            f"Keccak {host:.4f} s ({100 * host / wall:.1f}%: permutations "
            f"{clock['permute']['calls']} in {clock['permute']['s']:.4f} s, "
            f"trees {clock['hash_leaves']['s'] + clock['compress_batch']['s']:.4f} s)"
            f"; leaves down {run['leaf_bytes_down']} B, levels up "
            f"{run['level_bytes_up']} B; peak "
            f"{(run['peak_bytes'] or 0) / 2**30:.3f} GiB; verify "
            f"{verify_s:.3f} s; {len(blob)} bytes, sha256 {run['sha256']}")
        for stage, ms in timer.ms.items():
            log(f"    stage {stage}: {ms:.3f} ms")
        log(f"    launches {launches}")
    cs.check(runs[0]["sha256"] == runs[1]["sha256"],
             f"the {name}'s cold and warm proofs differ")
    bad = copy.deepcopy(proof)
    bad.proof.openings.wires[0][0] ^= np.uint64(1)
    why = cs.refused(lambda: sess.verify(bad), (ProofVerificationError,
                                                FriVerificationError), "")
    cs.check(why is not None, f"the port's verifier accepted the {name} "
             "proof with an opened wire flipped")
    log(f"  {name}: refused with one opened wire flipped ({why[:100]})")
    return {"degree_bits": data.common.degree_bits(),
            "hasher": data.common.hasher_name, "runs": runs}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--inner-log", type=int, default=16)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from plonky2_tpu_torch import resolve_device
    from plonky2_tpu_torch.hash.hashers import KECCAK_CONFIG, POSEIDON_CONFIG
    from plonky2_tpu_torch.models import bench_recursion as br
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    device = resolve_device(args.device)
    log = cs.log
    out = {"device": str(device)}
    if device.type == "cuda":
        out["card"] = cs.phase_device(device)
        out["nvcc_s"] = cs.phase_build()
    config = CircuitConfig.standard_recursion_config()
    t = time.perf_counter()
    inner = br.dummy_proof_tuple(config, args.inner_log, device,
                                 random.Random(0))
    single = br.recursive_proof(inner, config, device=device,
                                rng=random.Random(0))
    out["chain_s"] = time.perf_counter() - t
    log(f"no-op proof (2^{inner[2].degree_bits()} rows) and the proof that "
        f"verifies it (2^{single[2].degree_bits()} rows): "
        f"{out['chain_s']:.3f} s")
    for gc in (POSEIDON_CONFIG, KECCAK_CONFIG):
        clock = {}
        with cs.host_keccak_clock(clock):
            t = time.perf_counter()
            data, pt, vt = br.recursion_circuit(single[2], config,
                                                device=device, gc=gc)
            if device.type == "cuda":
                torch.cuda.synchronize()
            build_s = time.perf_counter() - t
        pw = br.recursion_witness(pt, vt, single)
        log(f"wrapper under {gc.name}: 2^{data.common.degree_bits()} rows, "
            f"built in {build_s:.3f} s (host Keccak "
            f"{sum(v['s'] for v in clock.values()):.4f} s)")
        res = prove_wrapper(gc.name, data, pw, device, log)
        res.update(build_s=build_s, build_keccak=clock)
        out[gc.name] = res
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({k: {"warm_s": v["runs"][1]["wall_s"],
                          "host_keccak_s": v["runs"][1]["host_keccak_s"]}
                      for k, v in out.items() if isinstance(v, dict)
                      and "runs" in v}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
