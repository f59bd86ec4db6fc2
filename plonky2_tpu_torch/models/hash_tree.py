"""The Poseidon hash-tree circuit, the flagship (the port's copy of
plonky2_tpu/models/hash_tree.py).

It proves knowledge of 2^k leaves, 4 elements each, whose Poseidon Merkle
root is the public input.  Each two-to-one compression is one PoseidonGate
row, so k = 17 gives 2^18 rows under CircuitConfig.wide_ecc_config() (234
wires).
"""
from __future__ import annotations

import numpy as np

from ..field import goldilocks as gl
from ..hash import poseidon as pos
from ..iop.witness import PartialWitness
from ..plonk.circuit_builder import CircuitBuilder
from ..plonk.config import CircuitConfig
from ..utils.timing import NoopTiming


def build_hash_tree_circuit(config: CircuitConfig, log2_leaves: int,
                            seed: int = 0, device=None, timing=None):
    """(CircuitData, PartialWitness, expected root).  The leaves come from
    ``np.random.default_rng(seed)``; ``device`` and ``timing`` go to
    CircuitBuilder.build (the commitment runs on cuda by default)."""
    timing = timing if timing is not None else NoopTiming()
    builder = CircuitBuilder(config)
    n = 1 << log2_leaves
    with timing.scope("gates and wiring"):
        leaf_targets = [builder.add_virtual_targets(4) for _ in range(n)]
        level = leaf_targets
        while len(level) > 1:
            level = [builder.hash_n_to_hash_no_pad(level[2 * i]
                                                   + level[2 * i + 1])
                     for i in range(len(level) // 2)]
        builder.register_public_inputs(level[0])
    data = builder.build(device=device, timing=timing)

    with timing.scope("inputs and root"):
        rng = np.random.default_rng(seed)
        leaves = rng.integers(0, gl.P, size=(n, 4), dtype=np.uint64)
        pw = PartialWitness()
        for t4, row in zip(leaf_targets, leaves):
            for t, v in zip(t4, row):
                pw.set_target(t, int(v))

        # the expected root, one batched permutation a level
        cur = leaves
        while cur.shape[0] > 1:
            state = np.zeros((cur.shape[0] // 2, 12), dtype=np.uint64)
            state[:, :8] = cur.reshape(-1, 8)
            cur = pos.poseidon(state)[:, :4]
    return data, pw, [int(x) for x in cur[0]]
