"""Where the device witness plan's one-off build goes, and what a proof's
witness costs after it.

    python3 scripts/port_witness_plan_profile.py [--log2-leaves K] [--device D] [--reps R]

Builds the hash tree of 2^K leaves under CircuitConfig.wide_ecc_config()
with the port (K = 17: the flagship, 2^18 rows), then runs
iop/device_witness.py:build_plan once under cProfile (the engine's index,
iop/generator.py:_GenCache, included) and prints its wall time and the
functions that took the most of it; then R runs of the plan
(DeviceWitnessPlan.run, each ended by a synchronize on a card), one line
of JSON at the end.  Runs on `cuda` by default; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import random
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log2-leaves", type=int, default=17)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch

    from plonky2_tpu_torch.iop.device_witness import build_plan
    from plonky2_tpu_torch.models.hash_tree import build_hash_tree_circuit
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    dev = torch.device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t = time.perf_counter()
    data, pw, root = build_hash_tree_circuit(CircuitConfig.wide_ecc_config(),
                                             args.log2_leaves, device=dev)
    build_s = time.perf_counter() - t
    prof = cProfile.Profile()
    t = time.perf_counter()
    prof.enable()
    plan = build_plan(data.prover_only, data.common, pw, dev)
    sync()
    prof.disable()
    plan_s = time.perf_counter() - t
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(15)
    print(out.getvalue(), flush=True)
    run_s = []
    for _ in range(args.reps):
        t = time.perf_counter()
        _, pis = plan.run(pw, random.Random(0))
        sync()
        run_s.append(time.perf_counter() - t)
    assert pis == root, "the plan's public inputs are not the tree's root"
    card = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(json.dumps({"log2_leaves": args.log2_leaves, "device": card,
                      "circuit_build_s": build_s, "build_plan_s": plan_s,
                      "waves": len(plan.waves), "n_slots": plan.n_slots,
                      "run_s": run_s,
                      "run_median_s": statistics.median(run_s)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
