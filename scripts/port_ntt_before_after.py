"""Time the port's NTT kernels and the flagship commitment on two source
trees in turns, on one CUDA card.

    python3 scripts/port_ntt_before_after.py BEFORE_DIR AFTER_DIR [--out F]

Each directory is a checkout of the repository (for example the parent
commit unpacked with ``git archive`` into a directory that .gitignore
lists).  The trees are measured in the order before, after, after, before,
each in a process of its own that builds its own kernels and imports only
its own ``plonky2_tpu_torch``.  Each process measures, on inputs made from
numpy seed 0:

* the wires commitment ``PolynomialBatch.from_values`` (234 x 2^18, rate
  bits 3, cap height 4): cold wall time, the median of 3 warm ones, the
  peak ``torch.cuda.max_memory_allocated`` of a warm run, and each C
  entry's time in the warm runs (CUDA events around every launch);
* the device time of everything else the card ran in one warm commitment
  (``torch.profiler``): on a tree that transposes between the four-step
  passes, these are the ``.transpose().contiguous()`` copies;
* the natural-order LDE of 20 x 2^18 coefficients (the Z/PP polynomials'
  ``lde_coset_ntt``) and the coset INTT of 2 x 2^21 values (the quotient's),
  each C entry's time (median of 3).

It prints one JSON line per process, the card's name and power limit
(``nvidia-smi``), and a summary; ``--out`` also writes all of it as JSON.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

RUNS = ("before", "after", "after", "before")
WARM = 3


def worker(tree: str) -> dict:
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from plonky2_tpu_torch import kernels
    from plonky2_tpu_torch.field.convert import from_u64
    from plonky2_tpu_torch.field.goldilocks import P
    from plonky2_tpu_torch.fri.oracle import PolynomialBatch
    from plonky2_tpu_torch.ops import ntt

    dev = torch.device("cuda", 0)
    t = time.perf_counter()
    kernels.library()
    build_s = time.perf_counter() - t
    rng = np.random.default_rng(0)

    def rand(shape):
        return from_u64(rng.integers(0, P, size=shape, dtype=np.uint64), dev)

    orig = kernels.call
    records = []

    def timed(name, *args):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        orig(name, *args)
        e.record()
        records.append((name, s, e))

    def per_entry(fn, runs=WARM):
        """fn() run `runs` times: wall seconds of each run and the median
        over the runs of each C entry's summed time."""
        walls, per_run = [], []
        kernels.call = timed
        try:
            for _ in range(runs):
                records.clear()
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t)
                ms = {}
                for name, s, e in records:
                    ms[name] = ms.get(name, 0.0) + s.elapsed_time(e)
                per_run.append(ms)
                del out
        finally:
            kernels.call = orig
        return walls, {k: float(np.median([r.get(k, 0.0) for r in per_run]))
                       for k in per_run[0]}

    values = rand((234, 1 << 18))

    def commit():
        return PolynomialBatch.from_values(values, 3, False, 4, device=dev)

    torch.cuda.synchronize()
    t = time.perf_counter()
    commit()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t
    walls, commit_ms = per_entry(commit)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    commit()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()

    # everything but the port's own kernels in one warm commitment
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        commit()
        torch.cuda.synchronize()
    own = ("ntt_", "hash_leaves", "compress", "poseidon")
    dev_ms = lambda e: getattr(  # noqa: E731
        e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)
    ) / 1e3
    other = {}
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        if dev_ms(e) and not any(o in e.key for o in own):
            other[e.key[:100]] = [dev_ms(e), e.count]

    coeffs = rand((20, 1 << 18))
    lde_walls, lde_ms = per_entry(lambda: ntt.lde_coset_ntt(coeffs, 3))
    qvals = rand((2, 1 << 21))
    intt_walls, intt_ms = per_entry(lambda: ntt.coset_intt(qvals))
    return {"tree": tree, "build_s": build_s,
            "commit": {"cold_s": cold_s, "warm_s": walls,
                       "warm_median_s": float(np.median(walls)),
                       "peak_bytes": peak, "entry_ms": commit_ms,
                       "other_device_ms": sum(v[0] for v in other.values()),
                       "other_kernels": other},
            "natural_lde_20x2^18": {"warm_s": lde_walls, "entry_ms": lde_ms},
            "coset_intt_2x2^21": {"warm_s": intt_walls,
                                  "entry_ms": intt_ms}}


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
        c = res["commit"]
        print(json.dumps({"which": which, "build_s": res["build_s"],
                          "commit_warm_s": c["warm_s"],
                          "commit_peak_GiB": c["peak_bytes"] / 2**30,
                          "commit_entry_ms": c["entry_ms"],
                          "commit_other_device_ms": c["other_device_ms"],
                          "natural_lde_entry_ms":
                              res["natural_lde_20x2^18"]["entry_ms"],
                          "coset_intt_entry_ms":
                              res["coset_intt_2x2^21"]["entry_ms"]}),
              flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "runs": results}, f, indent=1)
    print(json.dumps({"card": smi, "order": list(RUNS)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
