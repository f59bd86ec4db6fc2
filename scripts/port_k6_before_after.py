"""Time kernel K6 on the flagship's quotient program in two source trees,
in turns, on one CUDA card.

    python3 scripts/port_k6_before_after.py BEFORE_DIR AFTER_DIR [--out F]

Each directory is a checkout of the repository (for example the parent
commit unpacked with ``git archive`` into a directory that .gitignore
lists).  The trees run in the order before, after, after, before, each in
a process of its own that builds its own kernels and imports only its own
``plonky2_tpu_torch``.  Each process loads the flagship program
(plonk/programs/hash_tree_wide_ecc.npz), draws the rows its linear form
reads on 2^21 lanes (the quotient coset of a 2^18-row proof, one launch)
from numpy seed 0, and times REPS launches of K6 one by one with CUDA
events after a warm-up launch; the outputs' sha256 must agree across the
trees.  It prints the card's name and power limit (``nvidia-smi``), one
JSON line per process (each launch's ms, the median) and a summary;
``--out`` also writes all of it as JSON.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

RUNS = ("before", "after", "after", "before")
REPS = 7
LANES = 1 << 21


def worker(tree: str) -> dict:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from plonky2_tpu_torch.field.convert import from_u64, to_u64
    from plonky2_tpu_torch.field.goldilocks import P
    from plonky2_tpu_torch.plonk import constraint_program as cp
    from plonky2_tpu_torch.plonk.constraint_program_cuda import \
        run_program_cuda
    dev = torch.device("cuda", 0)
    prog, _ = cp.load(os.path.join(tree, "plonky2_tpu_torch", "plonk",
                                   "programs", "hash_tree_wide_ecc.npz"))
    lin = cp.linearize(prog)
    rng = np.random.default_rng(0)
    rows = from_u64(rng.integers(0, P, size=(lin.n_read, LANES),
                                 dtype=np.uint64), dev)
    bank = from_u64(prog.scalar_bank([int(x) for x in rng.integers(
        0, P, size=prog.n_scalar_inputs, dtype=np.uint64)]), dev)
    out = run_program_cuda(prog, rows, bank)
    ms = []
    for _ in range(REPS):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        s.record()
        out = run_program_cuda(prog, rows, bank)
        e.record()
        torch.cuda.synchronize()
        ms.append(s.elapsed_time(e))
    return {"tree": tree, "ms": ms, "median_ms": float(np.median(ms)),
            "sha256": hashlib.sha256(to_u64(out).tobytes()).hexdigest()}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        print(json.dumps(worker(sys.argv[2])), flush=True)
        return 0
    ap = argparse.ArgumentParser()
    ap.add_argument("before")
    ap.add_argument("after")
    ap.add_argument("--out")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    trees = {"before": os.path.abspath(args.before),
             "after": os.path.abspath(args.after)}
    results = []
    for which in RUNS:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--worker", trees[which]], capture_output=True,
                           text=True, check=True, cwd=trees[which])
        res = json.loads(r.stdout.strip().splitlines()[-1])
        res["which"] = which
        results.append(res)
        print(json.dumps(res), flush=True)
    if len({r["sha256"] for r in results}) != 1:
        raise RuntimeError("K6's outputs differ between the trees")
    summary = {w: [r["median_ms"] for r in results if r["which"] == w]
               for w in ("before", "after")}
    print(json.dumps({"card": smi, "lanes": LANES, "median_ms": summary}),
          flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "runs": results, "summary": summary}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
