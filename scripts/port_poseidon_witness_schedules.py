"""Time the Poseidon gate's host witness batch on its two schedules.

    python3 scripts/port_poseidon_witness_schedules.py [--rows G] [--reps R]

gates/poseidon_gate.py:PoseidonGenerator.run_batch computes the wires of G
Poseidon rows at once on (G, 12) numpy states with the naive schedule:
every partial round runs the whole 12 x 12 MDS, whose small coefficients
let it go through two uint64 matrix products on 32-bit halves.  The fast
partial-round schedule (hash/poseidon.py:permute_ints) does fewer field
products (an 11 x 11 dense matrix once, then 22 rounds of 23 products),
but its coefficients are full field elements, so every one is a 128-bit
numpy product.  This script runs both on the same random rows (swap bits
included), holds their wires equal, and prints the median seconds of each
for one batch and for the 2^17 Poseidon rows of the flagship circuit.
Runs on the host only; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from plonky2_tpu_torch.field import goldilocks as gl  # noqa: E402
from plonky2_tpu_torch.gates.poseidon_gate import (  # noqa: E402
    HALF, NPR, WIDTH, PoseidonGenerator)
from plonky2_tpu_torch.hash import poseidon as pos  # noqa: E402

FLAGSHIP_ROWS = 1 << 17
_M32 = np.uint64(0xFFFFFFFF)


def _modsum(x, axis):
    """Sum of canonical uint64 field elements along `axis`, mod p."""
    lo = (x & _M32).sum(axis, dtype=np.uint64)
    hi = (x >> np.uint64(32)).sum(axis, dtype=np.uint64)
    with np.errstate(over="ignore"):
        low = lo + ((hi & _M32) << np.uint64(32))
    high = (hi >> np.uint64(32)) + (low < lo).astype(np.uint64)
    return gl.reduce128(low, high)


def run_batch_fast(dep_vals):
    """run_batch's (G, 122) wires on the fast partial-round schedule."""
    init = pos.FAST_PARTIAL_ROUND_INITIAL_MATRIX.astype(np.uint64)
    prc = pos.fast_round_constants_after_sbox()
    w_hats = pos.FAST_PARTIAL_ROUND_W_HATS.astype(np.uint64)
    vs = pos.FAST_PARTIAL_ROUND_VS.astype(np.uint64)
    first = pos.FAST_PARTIAL_FIRST_ROUND_CONSTANT.astype(np.uint64)
    ms0 = np.uint64(pos.FAST_MS0)
    rc = pos.ALL_ROUND_CONSTANTS.reshape(-1, WIDTH)

    inputs = np.array(dep_vals[:, :WIDTH], dtype=np.uint64)
    swap = dep_vals[:, WIDTH]
    cols = [gl.mul(swap[:, None], gl.sub(inputs[:, 4:8], inputs[:, 0:4]))]
    inputs[:, :8] = np.where((swap == 1)[:, None],
                             np.concatenate([inputs[:, 4:8],
                                             inputs[:, 0:4]], axis=1),
                             inputs[:, :8])
    state = inputs
    for r in range(HALF):
        state = gl.add(state, rc[r])
        if r:
            cols.append(state)
        state = pos._mds_np(pos._sbox_np(state))
    state = gl.add(state, first)
    s0 = state[:, 0]
    rest = _modsum(gl.mul(state[:, 1:, None], init[None]), axis=1)
    for r in range(NPR):
        cols.append(s0[:, None])
        x0 = gl.add(pos._sbox_np(s0), prc[r])
        s0 = gl.add(gl.mul(x0, ms0), _modsum(gl.mul(rest, w_hats[r]), -1))
        rest = gl.add(rest, gl.mul(x0[:, None], vs[r]))
    state = np.concatenate([s0[:, None], rest], axis=1)
    for r in range(HALF + NPR, 2 * HALF + NPR):
        state = gl.add(state, rc[r])
        cols.append(state)
        state = pos._mds_np(pos._sbox_np(state))
    cols.append(state)
    return np.concatenate(cols, axis=1)


def median_seconds(fn, arg, reps):
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn(arg)
        times.append(time.perf_counter() - t)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=PoseidonGenerator.batch_chunk)
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    rng = np.random.default_rng(0)
    dep = np.concatenate([
        rng.integers(0, gl.P, (args.rows, WIDTH), dtype=np.uint64),
        rng.integers(0, 2, (args.rows, 1)).astype(np.uint64)], axis=1)
    dep[0, :WIDTH] = gl.P - 1
    dep[1, :WIDTH] = 0
    naive = PoseidonGenerator.run_batch(None, dep)
    fast = run_batch_fast(dep)
    if not np.array_equal(naive, fast):
        print("the two schedules' wires differ", file=sys.stderr)
        return 1
    res = {"rows": args.rows, "reps": args.reps,
           "host_cpus": os.cpu_count()}
    for name, fn in (("naive", lambda d: PoseidonGenerator.run_batch(None, d)),
                     ("fast", run_batch_fast)):
        s = median_seconds(fn, dep, args.reps)
        res[f"{name}_s"] = s
        res[f"{name}_flagship_s"] = s * FLAGSHIP_ROWS / args.rows
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
