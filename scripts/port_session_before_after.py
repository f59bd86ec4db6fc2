"""Time the flagship session proof of two source trees in turns, on one
CUDA card.

    python3 scripts/port_session_before_after.py BEFORE_DIR AFTER_DIR \
        [--out F]

Each directory is a checkout of the repository (for example the parent
commit unpacked with ``git archive`` into a directory that .gitignore
lists).  The trees run in the order before, after, after, before, each in
a process of its own that builds its own kernels and imports only its own
``plonky2_tpu_torch``.  Each process builds the flagship circuit (the hash
tree of 2^17 leaves under CircuitConfig.wide_ecc_config(), 2^18 rows),
opens a ProverSession, makes one cold proof and WARM warm ones from
random.Random(0), and records each warm proof's wall time and stages
(each stage between two synchronisations, in a run of its own), one
traced warm proof's device busy time and idle share (torch.profiler), and
the proofs' sha256.  It prints the card's name and power limit
(``nvidia-smi``), one JSON line per process and a summary; ``--out`` also
writes all of it as JSON.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import random
import subprocess
import sys
import time

RUNS = ("before", "after", "after", "before")
WARM = 5


class StageTimer:
    """Each stage's wall time between two synchronisations of the card."""

    def __init__(self):
        self.ms = {}

    @contextlib.contextmanager
    def scope(self, name: str):
        import torch
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            yield
        finally:
            torch.cuda.synchronize()
            self.ms[name] = (self.ms.get(name, 0.0)
                             + (time.perf_counter() - t) * 1e3)


def worker(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from plonky2_tpu_torch import kernels
    from plonky2_tpu_torch.models.hash_tree import build_hash_tree_circuit
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    from plonky2_tpu_torch.runtime.session import ProverSession
    from plonky2_tpu_torch.utils.serialization import serialize_proof

    kernels.library()
    data, pw, _ = build_hash_tree_circuit(CircuitConfig.wide_ecc_config(),
                                          17, seed=0)
    sess = ProverSession(data)

    def prove(timing=None):
        proof = sess.prove(pw, rng=random.Random(0), timing=timing)
        torch.cuda.synchronize()
        return hashlib.sha256(serialize_proof(proof)).hexdigest()

    t = time.perf_counter()
    shas = {prove()}
    cold_s = time.perf_counter() - t
    warm_s = []
    for _ in range(WARM):
        t = time.perf_counter()
        shas.add(prove())
        warm_s.append(time.perf_counter() - t)
    timer = StageTimer()
    shas.add(prove(timer))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        shas.add(prove())
        traced_ms = (time.perf_counter() - t) * 1e3
    busy_ms = sum(getattr(e, "self_device_time_total", getattr(
        e, "self_cuda_time_total", 0)) for e in prof.key_averages()
        if str(getattr(e, "device_type", "")).endswith("CUDA")) / 1e3
    return {"tree": tree, "cold_s": cold_s, "warm_s": warm_s,
            "stages_ms": timer.ms, "traced_ms": traced_ms,
            "busy_ms": busy_ms, "idle_share": 1 - busy_ms / traced_ms,
            "sha256": sorted(shas)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("before")
    ap.add_argument("after")
    ap.add_argument("--out")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:     # one measurement of the tree in `before`
        print(json.dumps(worker(os.path.abspath(args.before))), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    trees = {"before": os.path.abspath(args.before),
             "after": os.path.abspath(args.after)}
    results = []
    for which in RUNS:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            trees[which], trees[which], "--worker"],
                           cwd=trees[which], capture_output=True, text=True,
                           timeout=900)
        if r.returncode != 0:
            print(r.stdout[-4000:], r.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(r.stdout.strip().splitlines()[-1])
        res["which"] = which
        results.append(res)
        print(json.dumps(res), flush=True)
    shas = {s for r in results for s in r["sha256"]}
    summary = {"card": smi, "order": list(RUNS), "same_proof": len(shas) == 1,
               "warm_s": {w: sorted(x for r in results if r["which"] == w
                                    for x in r["warm_s"])
                          for w in ("before", "after")}}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({**summary, "runs": results}, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0 if summary["same_proof"] else 1


if __name__ == "__main__":
    sys.exit(main())
