"""The copy-constraint forest and the sigma polynomials (the port's copy
of plonky2_tpu/plonk/permutation.py; reference
plonky2/src/plonk/permutation_argument.rs).

The forest is a numpy parent array over every wire slot (row-major) and
then the virtual targets.  ``merge_many`` runs the unions in order on a
dict of the slots that have a parent other than themselves, so a root is
the one a union-find over the whole array would choose; path compression
is vectorized pointer jumping; the sigma cycles come from one stable sort
over the representatives.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..field import goldilocks as gl
from ..iop.target import target_index


class Forest:
    def __init__(self, num_wires: int, num_routed_wires: int, degree: int):
        self.num_wires = num_wires
        self.num_routed_wires = num_routed_wires
        self.degree = degree
        self.parents: np.ndarray = np.empty(0, dtype=np.int64)

    def init_slots(self, num_virtual: int) -> None:
        """Every wire slot (row-major), then the virtual targets, each its
        own root."""
        n = self.degree * self.num_wires + num_virtual
        self.parents = np.arange(n, dtype=np.int64)

    def merge_many(self, constraints) -> None:
        """Union each (a, b) Target pair in order: b's root gets a's root
        as its parent."""
        nw, deg = self.num_wires, self.degree
        p = self.parents
        up: Dict[int, int] = {}   # slot -> parent, where not itself

        def find(x: int) -> int:
            root = x
            while True:
                nxt = up.get(root)
                if nxt is None:
                    nxt = int(p[root])
                    if nxt == root:
                        break
                root = nxt
            while x != root:      # compress the path just walked
                nxt = up.get(x)
                if nxt is None:
                    nxt = int(p[x])
                up[x] = root
                x = nxt
            return root

        for a, b in constraints:
            ra = find(target_index(a, nw, deg))
            rb = find(target_index(b, nw, deg))
            if ra != rb:
                up[rb] = ra
        if up:
            p[np.fromiter(up.keys(), np.int64, len(up))] = np.fromiter(
                up.values(), np.int64, len(up))

    def compress_paths(self) -> None:
        """Every slot's parent becomes its root, by pointer jumping."""
        p = self.parents
        while True:
            pp = p[p]
            if np.array_equal(pp, p):
                break
            p = pp
        self.parents = p

    def sigma_polys(self, k_is: List[int],
                    subgroup: np.ndarray) -> np.ndarray:
        """(num_routed, degree) sigma values: column c at row r holds
        k[neighbor.col] * subgroup[neighbor.row], the neighbor being the
        next routed wire of the cycle through its class, in row-major scan
        order (reference permutation_argument.rs:106-155)."""
        degree = self.degree
        nw, nr = self.num_wires, self.num_routed_wires
        rows = np.arange(degree, dtype=np.int64)
        slot = rows[:, None] * nw + np.arange(nr, dtype=np.int64)[None, :]
        reps = self.parents[slot.ravel()]               # scan order
        n = reps.shape[0]

        order = np.argsort(reps, kind="stable")         # classes, in scan order
        sorted_reps = reps[order]
        change = np.empty(n, dtype=bool)
        change[0] = True
        change[1:] = sorted_reps[1:] != sorted_reps[:-1]
        starts = np.flatnonzero(change)
        nxt_pos = np.arange(1, n + 1, dtype=np.int64)
        ends = np.concatenate([starts[1:] - 1, [n - 1]])
        nxt_pos[ends] = starts                          # close each cycle

        neighbor = np.empty(n, dtype=np.int64)          # scan id -> scan id
        neighbor[order] = order[nxt_pos]

        k_arr = np.array(k_is, dtype=np.uint64)
        nb_row = neighbor // nr
        nb_col = neighbor % nr
        vals = gl.mul(k_arr[nb_col], subgroup[nb_row])  # scan order
        return vals.reshape(degree, nr).T.copy()
