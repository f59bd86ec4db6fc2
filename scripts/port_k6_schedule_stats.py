"""Statistics of the flagship constraint program's linear form
(plonky2_tpu_torch/plonk/constraint_program.py:linearize), on the CPU.

    python3 scripts/port_k6_schedule_stats.py

Prints the slots the greedy list schedule needs with each tie-break (the
latest op in wave order, which linearize uses, and the earliest), the
share of ops that read the op just before (or one of the two before), and
what the values live at the schedule's peak are: kept inputs, values that
feed the Horner chains which combine the constraints into the outputs,
and the other intermediates.
"""
from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from plonky2_tpu_torch.plonk import constraint_program as cp  # noqa: E402


def greedy(ops, outs, n_in, latest: bool):
    """linearize's schedule with either tie-break: (order, peak live set,
    most values live)."""
    operands = {k: cp._vector_operands(op) for k, op in enumerate(ops)}
    remaining = {}
    for k in operands:
        for v in operands[k]:
            remaining[v] = remaining.get(v, 0) + 1
    for v in outs:
        remaining[v] = remaining.get(v, 0) + 1
    readers, pending = {}, {}
    for k in operands:
        deps = [v for v in operands[k] if v >= n_in]
        pending[k] = len(deps)
        for v in deps:
            readers.setdefault(v, []).append(k)
    live, order, peak = set(), [], set()

    def delta(k):
        d = 1
        for v in operands[k]:
            if v in live:
                d -= remaining[v] == 1
            elif v < n_in and remaining[v] > 1:
                d += 1
        return d

    ready = {k for k in operands if pending[k] == 0}
    while ready:
        k = min(ready, key=lambda j: (delta(j), -j if latest else j))
        ready.remove(k)
        order.append(k)
        for v in operands[k]:
            remaining[v] -= 1
            if remaining[v] and v < n_in:
                live.add(v)
            elif not remaining[v]:
                live.discard(v)
        live.add(n_in + k)
        if len(live) > len(peak):
            peak = set(live)
        for j in readers.get(n_in + k, ()):
            pending[j] -= 1
            if pending[j] == 0:
                ready.add(j)
    return order, peak


def main() -> int:
    prog, _ = cp.load(os.path.join(REPO, "plonky2_tpu_torch", "plonk",
                                   "programs", "hash_tree_wide_ecc.npz"))
    ops, outs = cp._ssa(prog)
    n_in = prog.n_inputs
    lin = cp.linearize(prog)
    print(f"linearize: {lin.n_ops} ops, {lin.n_slots} slots, "
          f"{lin.n_read} of {n_in} inputs read")
    for latest in (True, False):
        _, peak = greedy(ops, outs, n_in, latest)
        print(f"greedy, {'latest' if latest else 'earliest'} on a tie: "
              f"{len(peak)} values live at most")
    # how far back each op's nearest operand was made
    f = lin.fields()
    made, dist = {}, []
    for k in range(lin.n_ops):
        code = int(f["opcode"][k])
        fields = [f["a"][k]] + ([] if code in cp.SCALAR_B else [f["b"][k]])
        if code in (cp.MULADD, cp.MULADDS):
            fields.append(f["c"][k])
        back = [k - made[int(x)] for x in fields
                if not int(x) & cp.OPERAND_INPUT and int(x) in made]
        dist.append(min(back) if back else 1 << 30)
        made[int(f["dst"][k])] = k
    dist = np.array(dist)
    print(f"ops reading the op just before: {(dist <= 1).mean():.3f}; "
          f"one of the two before: {(dist <= 2).mean():.3f}")
    # the Horner chains: from each output back along its newest operand
    chain = set()
    for o in outs:
        v = o
        while v >= n_in:
            chain.add(v - n_in)
            newer = [x for x in cp._vector_operands(ops[v - n_in])
                     if x >= n_in]
            if not newer:
                break
            v = max(newer)
    feeds = {x for k in chain for x in cp._vector_operands(ops[k])
             if x >= n_in and x - n_in not in chain}
    _, peak = greedy(ops, outs, n_in, True)
    n_inputs = sum(1 for v in peak if v < n_in)
    n_feed = len(peak & feeds)
    n_chain = sum(1 for v in peak if v >= n_in and v - n_in in chain)
    print(f"at the peak ({len(peak)} live): {n_inputs} kept inputs, {n_feed} "
          f"values feeding the {len(outs)} Horner chains ({len(chain)} ops), "
          f"{n_chain} chain values, {len(peak) - n_inputs - n_feed - n_chain} "
          "other intermediates")
    return 0


if __name__ == "__main__":
    sys.exit(main())
