"""The gate base class and the selector filters (the port's copy of
plonky2_tpu/gates/gate.py; reference plonky2/src/gates/gate.rs,
gates/selectors.rs).

Each gate defines its constraints once, in ``eval_unfiltered(alg, vars)``,
against an algebra (plonk/algebra.py); the verifier runs them on the
extension at zeta.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..plonk.algebra import EvaluationVars

UNUSED_SELECTOR = 0xFFFFFFFF  # u32::MAX (reference selectors.rs:11)


class Gate:
    def id(self) -> str:
        raise NotImplementedError

    def eval_unfiltered(self, alg, vars: EvaluationVars) -> list:
        raise NotImplementedError

    def generators(self, row: int, local_constants: List[int]) -> list:
        return []

    def num_wires(self) -> int:
        raise NotImplementedError

    def num_constants(self) -> int:
        raise NotImplementedError

    def degree(self) -> int:
        raise NotImplementedError

    def num_constraints(self) -> int:
        raise NotImplementedError

    def num_ops(self) -> int:
        return len(self.generators(0, [0] * self.num_constants()))

    def extra_constant_wires(self) -> List[Tuple[int, int]]:
        return []

    def eval_filtered(self, alg, vars: EvaluationVars, row: int,
                      selector_index: int, group_range: range,
                      num_selectors: int) -> list:
        f = compute_filter(alg, row, group_range,
                           vars.local_constants[selector_index],
                           num_selectors > 1)
        inner = vars.remove_prefix(num_selectors)
        return [alg.mul(f, c) for c in self.eval_unfiltered(alg, inner)]

    # equal and hashed by id, so that gate sets deduplicate
    def __eq__(self, other):
        return isinstance(other, Gate) and self.id() == other.id()

    def __hash__(self):
        return hash(self.id())


def compute_filter(alg, row: int, group_range: range, s,
                   many_selectors: bool):
    """prod_{i in group, i != row} (i - s), times (UNUSED - s) when there
    are several selectors (reference gate.rs:261-268)."""
    out = None
    terms = [i for i in group_range if i != row]
    if many_selectors:
        terms.append(UNUSED_SELECTOR)
    for i in terms:
        t = alg.sub(alg.const(i), s)
        out = t if out is None else alg.mul(out, t)
    return out if out is not None else alg.one()


@dataclass
class SelectorsInfo:
    selector_indices: List[int]
    groups: List[range]

    def num_selectors(self) -> int:
        return len(self.groups)


def selector_polynomials(gates: List[Gate], instances, max_degree: int):
    """(the selector polynomials' values as a (num_groups, n) uint64
    array, SelectorsInfo) (reference selectors.rs:37-108)."""
    n = len(instances)
    num_gates = len(gates)
    max_gate_degree = gates[-1].degree()
    index = {g.id(): i for i, g in enumerate(gates)}
    inst_index = np.array([index[inst.gate.id()] for inst in instances],
                          dtype=np.int64)

    if max_gate_degree + num_gates - 1 <= max_degree:
        return (inst_index.astype(np.uint64)[None, :],
                SelectorsInfo([0] * num_gates, [range(0, num_gates)]))

    if max_gate_degree >= max_degree:
        raise ValueError(f"{gates[-1].id()} has too high degree")

    groups = []
    start = 0
    while start < num_gates:
        size = 0
        while (start + size < num_gates
               and size + gates[start + size].degree() < max_degree):
            size += 1
        groups.append(range(start, start + size))
        start += size

    selector_indices = [next(g for g, r in enumerate(groups) if i in r)
                        for i in range(num_gates)]
    polys = np.full((len(groups), n), UNUSED_SELECTOR, dtype=np.uint64)
    inst_group = np.array(selector_indices, dtype=np.int64)[inst_index]
    polys[inst_group, np.arange(n)] = inst_index.astype(np.uint64)
    return polys, SelectorsInfo(selector_indices, groups)
