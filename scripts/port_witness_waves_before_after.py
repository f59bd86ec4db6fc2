"""Time kernel K7 (the Poseidon gate's witness waves) and the FRI
proof-of-work grind on two source trees in turns, on one CUDA card.

    python3 scripts/port_witness_waves_before_after.py BEFORE_DIR AFTER_DIR \
        [--out F]

Each directory is a checkout of the repository (for example the parent
commit unpacked with ``git archive`` into a directory that .gitignore
lists).  The trees are measured in the order before, after, after, before,
each in a process of its own that builds its own kernels and imports only
its own ``plonky2_tpu_torch``.  Each process measures, on inputs made from
numpy seed 0:

* K7 on the flagship witness plan's 18 Poseidon wave sizes (2^16 rows down
  to 1, then 1), as a chain in which each wave reads the wave before it,
  its wires laid out in rows as the witness plan lays them (row r's wire c
  at slot r * 234 + c) and scattered at random:
  each wave as a launch of its own (a tree with
  ``poseidon_wires_cuda``: one thread a row; a tree with
  ``poseidon_wires_waves_cuda``: a run of one wave, four lanes a row), and
  where the tree has it all 18 in one launch; device time, queued behind a
  K1 launch on 234 x 2^18 leaves, and host-paced on an idle card (CUDA
  events between consecutive launches, medians of 5 runs);
* ``fri/prover.py:fri_proof_of_work`` at 16 bits from three seeded
  transcript states (wall time of each, and its witness): the host numpy
  grind or kernel K8, whichever the tree runs.

It prints one JSON line per process, the card's name and power limit
(``nvidia-smi``), and a summary; ``--out`` also writes all of it as JSON.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

RUNS = ("before", "after", "after", "before")
REPS = 5
WAVES = tuple(1 << k for k in range(16, -1, -1)) + (1,)
POW_BITS = 16


def wave_chain(rng, sizes, P, rows):
    """(buf, dep (13, R), out (122, R), offsets) of a chain of Poseidon
    waves: row i of wave j > 0 reads its words 0-7 from the outputs 0-3 of
    wave j - 1's rows 2i and 2i + 1 (mod its size).  Slots at random
    (rows=False), or as the witness plan lays a gate's wires: row r's wire
    c at slot r * 234 + c, in the Poseidon gate's columns."""
    import numpy as np

    from plonky2_tpu_torch.gates import poseidon_gate as pg
    R = sum(sizes)
    if rows:
        n_slots = 234 * R
        base = np.arange(R, dtype=np.int64)[None] * 234
        dep = (base + pg.DEP_WIRES[:, None]).astype(np.int32)
        out = (base + pg.OUTPUT_WIRES[:, None]).astype(np.int32)
    else:
        n_slots = 135 * R + 7
        slots = rng.permutation(n_slots)[:135 * R].astype(np.int32)
        dep = slots[:13 * R].reshape(13, R).copy()
        out = slots[13 * R:].reshape(122, R)
    buf = rng.integers(0, P, size=n_slots, dtype=np.uint64)
    buf[dep[12]] = rng.integers(0, 2, size=R)
    offsets = tuple(int(x) for x in np.cumsum((0,) + tuple(sizes)))
    for j in range(1, len(sizes)):
        a0, a, g0 = offsets[j - 1], offsets[j], sizes[j - 1]
        i = np.arange(sizes[j])
        dep[0:4, a:a + sizes[j]] = out[110:114, a0 + (2 * i) % g0]
        dep[4:8, a:a + sizes[j]] = out[110:114, a0 + (2 * i + 1) % g0]
    return buf, dep, out, offsets


def time_k7(dev, leaves, chain) -> dict:
    """K7 on one chain: each wave a launch, and all in one launch where the
    tree has it; device time and host-paced; and a fingerprint of the
    slot buffer after the waves."""
    import numpy as np
    import torch

    from plonky2_tpu_torch.field.convert import from_u64
    from plonky2_tpu_torch.hash import poseidon_cuda as pc
    buf, dep, out, offsets = chain
    values = from_u64(buf, dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    n = len(offsets) - 1
    fused = hasattr(pc, "poseidon_wires_waves_cuda")
    if fused:
        dep_d = torch.from_numpy(dep).to(dev)
        out_d = torch.from_numpy(out).to(dev)

        def run(lo, hi):
            return lambda: pc.poseidon_wires_waves_cuda(
                values, dep_d, out_d, offsets[lo:hi + 1], err)
    else:
        parts = [(torch.from_numpy(dep[:, a:b].copy()).to(dev),
                  torch.from_numpy(out[:, a:b].copy()).to(dev))
                 for a, b in zip(offsets, offsets[1:])]

        def run(lo, hi):
            assert hi == lo + 1
            return lambda: pc.poseidon_wires_cuda(values, *parts[lo], err)

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def step_ms(steps, behind):
        runs = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            if behind:
                pc.hash_leaves_cols_cuda(leaves)
            evs = [event()]
            for fn in steps:
                fn()
                evs.append(event())
            torch.cuda.synchronize()
            runs.append([a.elapsed_time(b) for a, b in zip(evs, evs[1:])])
        return [float(np.median(c)) for c in zip(*runs)]

    each = [run(j, j + 1) for j in range(n)]
    for fn in each + ([run(0, n)] if fused else []):   # warm-up
        fn()
    torch.cuda.synchronize()
    res = {}
    for mode, behind in (("device", True), ("host-paced", False)):
        per = step_ms(each, behind)
        res[mode] = {"per_wave_ms": per, "per_wave_sum_ms": sum(per)}
        if fused:
            res[mode]["one_launch_ms"] = step_ms([run(0, n)], behind)[0]
    res["values_sum"] = int(values.sum().item())
    return res


def worker(tree: str) -> dict:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from plonky2_tpu_torch import kernels
    from plonky2_tpu_torch.field.convert import from_u64
    from plonky2_tpu_torch.field.goldilocks import P
    from plonky2_tpu_torch.fri import prover
    from plonky2_tpu_torch.hash import poseidon_cuda as pc
    from plonky2_tpu_torch.iop.challenger import Challenger

    dev = torch.device("cuda", 0)
    t = time.perf_counter()
    kernels.library()
    build_s = time.perf_counter() - t
    rng = np.random.default_rng(0)
    leaves = from_u64(rng.integers(0, P, size=(234, 1 << 18),
                                   dtype=np.uint64), dev)
    k7 = {}
    for layout in ("rows", "scattered"):
        k7[layout] = time_k7(dev, leaves, wave_chain(rng, WAVES, P,
                                                     layout == "rows"))
    grind = []
    for seed in range(3):
        ch = Challenger()
        ch.observe_elements(np.random.default_rng(100 + seed).integers(
            0, P, size=13 + seed, dtype=np.uint64))
        config = SimpleNamespace(proof_of_work_bits=POW_BITS)
        args = (copy.deepcopy(ch), config)
        if "device" in prover.fri_proof_of_work.__code__.co_varnames:
            args += (dev,)
        t = time.perf_counter()
        witness = prover.fri_proof_of_work(*args)
        grind.append({"seed": seed, "witness": witness,
                      "ms": (time.perf_counter() - t) * 1e3})
    return {"tree": tree, "build_s": build_s,
            "fused": hasattr(pc, "poseidon_wires_waves_cuda"),
            "waves": list(WAVES), "k7": k7, "grind": grind}


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
        brief = {"which": which, "build_s": res["build_s"],
                 "grind": res["grind"]}
        for layout, k in res["k7"].items():
            brief[layout] = {
                "device_per_wave_ms": k["device"]["per_wave_ms"],
                "device_sum_ms": k["device"]["per_wave_sum_ms"],
                "device_one_launch_ms": k["device"].get("one_launch_ms"),
                "host_paced_sum_ms": k["host-paced"]["per_wave_sum_ms"],
                "host_paced_one_launch_ms": k["host-paced"].get(
                    "one_launch_ms")}
        print(json.dumps(brief), flush=True)
    sums = {tuple(k["values_sum"] for k in r["k7"].values())
            for r in results}
    witnesses = {tuple(g["witness"] for g in r["grind"]) for r in results}
    summary = {"card": smi, "order": list(RUNS),
               "same_wires": len(sums) == 1,
               "same_witnesses": len(witnesses) == 1}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({**summary, "runs": results}, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0 if summary["same_wires"] and summary["same_witnesses"] else 1


if __name__ == "__main__":
    sys.exit(main())
