"""Run recursion's shrinking chain with the port and write the double
proof.

    python3 scripts/port_recursion_proof.py OUTDIR [--device cpu]
        [--log2-inner 16]

Under CircuitConfig.standard_recursion_config(): the no-op circuit of
2^log2-inner rows and its proof, the circuit that verifies it and its
proof, and the circuit that verifies that one and its proof
(plonky2_tpu_torch/models/bench_recursion.py), every proof through
ProverSession on the device (cuda unless --device is given) with the
witness randomness random.Random(0), each verified by the port.  The
double proof is compressed and decompressed, which must restore it byte
for byte.  Writes OUTDIR/double.bin (the serialized proof),
OUTDIR/double_compressed.bin and OUTDIR/chain.json (each link's degree
bits, circuit digest and constants-sigmas cap, and the proof's sha256).
``scripts/jax_verify_recursion_proof.py OUTDIR`` builds the same chain
of circuits with the JAX package and checks the proof with its verifier.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir")
    ap.add_argument("--device", default=None)
    ap.add_argument("--log2-inner", type=int, default=16)
    args = ap.parse_args()
    from plonky2_tpu_torch.models import bench_recursion as br
    from plonky2_tpu_torch.plonk.compression import (compress_proof,
                                                     decompress_proof)
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    from plonky2_tpu_torch.utils.serialization import (
        serialize_compressed_proof, serialize_proof)
    config = CircuitConfig.standard_recursion_config()
    os.makedirs(args.outdir, exist_ok=True)
    links = []

    def note(name, link, seconds):
        proof, vd, cd = link
        blob = serialize_proof(proof)
        links.append({
            "name": name, "degree_bits": cd.degree_bits(),
            "circuit_digest": [int(x) for x in vd.circuit_digest],
            "constants_sigmas_cap": vd.constants_sigmas_cap.digests
            .tolist(), "proof_bytes": len(blob),
            "sha256": hashlib.sha256(blob).hexdigest(), "seconds": seconds})
        print(f"{name}: 2^{cd.degree_bits()} rows, proof {len(blob)} bytes "
              f"in {seconds:.2f} s, sha256 {links[-1]['sha256']}",
              flush=True)
        return blob

    t = time.perf_counter()
    inner = br.dummy_proof_tuple(config, args.log2_inner, args.device,
                                 random.Random(0))
    note("dummy", inner, time.perf_counter() - t)
    t = time.perf_counter()
    middle = br.recursive_proof(inner, config, device=args.device,
                                rng=random.Random(0))
    note("single", middle, time.perf_counter() - t)
    t = time.perf_counter()
    outer = br.recursive_proof(middle, config, device=args.device,
                               rng=random.Random(0))
    blob = note("double", outer, time.perf_counter() - t)

    proof, vd, cd = outer
    t = time.perf_counter()
    compressed = compress_proof(proof, vd.circuit_digest, cd)
    compress_s = time.perf_counter() - t
    restored = decompress_proof(compressed, vd.circuit_digest, cd)
    if serialize_proof(restored) != blob:
        raise SystemExit("decompression did not restore the double proof")
    cblob = serialize_compressed_proof(compressed)
    with open(os.path.join(args.outdir, "double.bin"), "wb") as f:
        f.write(blob)
    with open(os.path.join(args.outdir, "double_compressed.bin"), "wb") as f:
        f.write(cblob)
    with open(os.path.join(args.outdir, "chain.json"), "w") as f:
        json.dump({"log2_inner": args.log2_inner, "links": links,
                   "compressed_bytes": len(cblob),
                   "compress_seconds": compress_s}, f, indent=1)
    print(f"double proof {len(blob)} bytes, compressed {len(cblob)} bytes "
          f"in {compress_s:.3f} s; decompressed byte for byte; wrote "
          f"{args.outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
