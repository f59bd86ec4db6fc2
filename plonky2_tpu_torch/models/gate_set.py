"""The U32, comparison and permutation gate set in one circuit.

The circuit repeats the blocks of the JAX package's gadget tests
(tests/test_insertion_waksman.py, tests/test_u32_biguint.py): memory
operations of distinct (address, timestamp) sorted (``sort_memory_ops``:
AS-Waksman switches and less-than gates) and connected to their sorted
values; pairs of field elements and a permutation of them
(``assert_permutation``); insertions into vectors of extension elements
at random indices, each output connected to its element; then copies of
the U32 block: x * y + z, a sum of ten with its carry, a difference with
its borrow, a range check of four and a comparison, each result connected
to its value.  Its values come from ``np.random.default_rng(seed)``.

``place_u32_block`` and ``place_gate_set`` take any builder and
PartialWitness with the U32, insertion and permutation gadgets, so that
the JAX package's builder can build the same circuit (the tests hold the
two against each other); ``build_gate_set_circuit`` builds it with the
port's.  At the defaults under standard_ecc_config (136 wires) it fills
2^LOG_N rows.
"""
from __future__ import annotations

import random

import numpy as np

from ..field.goldilocks import P
from ..gadgets.permutation import MemoryOpTarget
from ..iop.witness import PartialWitness
from ..plonk.circuit_builder import CircuitBuilder
from ..plonk.config import CircuitConfig

MEMORY_OPS = 1024
ADDRESS_BITS = 16
TIMESTAMP_BITS = 16
CHUNKS = 1024
INSERTS = 256
VEC = 16
U32_BLOCKS = 1459
LOG_N = 14


def place_u32_block(b, pw, rng) -> None:
    """tests/test_u32_biguint.py:20-55's block on `b`, its inputs set in
    `pw` from the numpy Generator `rng`."""
    x, y, z = (int(v) for v in rng.integers(0, 1 << 32, size=3))
    xt = b.add_virtual_u32_target()
    pw.set_target(xt, x)
    lo, hi = b.mul_add_u32(xt, b.constant_u32(y), b.constant_u32(z))
    b.connect(lo, b.constant_u32((x * y + z) & 0xFFFFFFFF))
    b.connect(hi, b.constant_u32((x * y + z) >> 32))
    vals = [int(v) for v in rng.integers(0, 1 << 32, size=10)]
    vts = b.add_virtual_u32_targets(len(vals))
    for t, v in zip(vts, vals):
        pw.set_target(t, v)
    lo, hi = b.add_many_u32(vts)
    b.connect(lo, b.constant_u32(sum(vals) & 0xFFFFFFFF))
    b.connect(hi, b.constant_u32(sum(vals) >> 32))
    s_lo, s_borrow = b.sub_u32(vts[0], vts[1], b.zero_u32())
    borrow = int(vals[0] < vals[1])
    b.connect(s_lo, b.constant_u32(vals[0] - vals[1] + (borrow << 32)))
    b.connect(s_borrow, b.constant(borrow))
    b.range_check_u32(vts[:4])
    b.connect(b.list_le_u32([vts[0]], [vts[1]]),
              b.constant(int(vals[0] <= vals[1])))


def place_gate_set(b, pw, memory_op, seed: int = 0,
                   memory_ops: int = MEMORY_OPS, chunks: int = CHUNKS,
                   inserts: int = INSERTS, u32_blocks: int = U32_BLOCKS
                   ) -> None:
    """The gate set on `b`, its values set in `pw` from numpy's
    default_rng(seed); `memory_op` is the MemoryOpTarget class of the
    builder's package."""
    rng = np.random.default_rng(seed)
    keys = rng.choice(1 << (ADDRESS_BITS + TIMESTAMP_BITS), size=memory_ops,
                      replace=False)
    ops = [(int(k) >> TIMESTAMP_BITS, int(k) & ((1 << TIMESTAMP_BITS) - 1),
            int(w), int(v))
           for k, w, v in zip(keys, rng.integers(0, 2, size=memory_ops),
                              rng.integers(0, P, size=memory_ops,
                                           dtype=np.uint64))]
    ops_t = []
    for addr, ts, w, v in ops:
        op = memory_op(*b.add_virtual_targets(4))
        for t, val in zip((op.is_write, op.address, op.timestamp, op.value),
                          (w, addr, ts, v)):
            pw.set_target(t, val)
        ops_t.append(op)
    out = b.sort_memory_ops(ops_t, ADDRESS_BITS, TIMESTAMP_BITS)
    for op_t, op in zip(out, sorted(ops)):
        for t, val in zip((op_t.address, op_t.timestamp, op_t.is_write,
                           op_t.value), op):
            b.connect(t, b.constant(val))

    values = rng.integers(0, P, size=(chunks, 2), dtype=np.uint64)
    perm = rng.permutation(chunks)
    a_t = [b.add_virtual_targets(2) for _ in range(chunks)]
    b_t = [b.add_virtual_targets(2) for _ in range(chunks)]
    for i in range(chunks):
        for j in range(2):
            pw.set_target(a_t[i][j], int(values[i, j]))
            pw.set_target(b_t[i][j], int(values[perm[i], j]))
    b.assert_permutation(a_t, b_t)

    for _ in range(inserts):
        vals = rng.integers(0, P, size=(VEC + 1, 2), dtype=np.uint64)
        index = int(rng.integers(0, VEC + 1))
        vec = b.add_virtual_extension_targets(VEC)
        element = b.add_virtual_extension_target()
        pw.set_extension_targets(vec + [element],
                                 [(int(x), int(y)) for x, y in vals])
        index_t = b.add_virtual_target()
        pw.set_target(index_t, index)
        want = vec[:index] + [element] + vec[index:]
        for got, w in zip(b.insert(index_t, element, vec), want):
            b.connect_extension(got, w)

    for _ in range(u32_blocks):
        place_u32_block(b, pw, rng)


def build_gate_set_circuit(device=None, build: bool = True, **sizes):
    """The gate set under standard_ecc_config with the port's builder:
    (CircuitData, its PartialWitness), built on `device` (default cuda);
    with build=False, (its CommonCircuitData, None), nothing committed.
    `sizes` go to place_gate_set."""
    b, pw = CircuitBuilder(CircuitConfig.standard_ecc_config()), \
        PartialWitness()
    place_gate_set(b, pw, MemoryOpTarget, **sizes)
    return (b.build(device=device), pw) if build else (b.build_common(), None)


def build_non_permutation_circuit(device=None):
    """tests/test_insertion_waksman.py:65-84: four chunks of one element
    and the same list with its first value changed, under
    standard_recursion_config; (CircuitData, PartialWitness).  Its
    witness cannot be generated: the routing refuses the lists."""
    rng = random.Random(0x1A5)
    b, pw = CircuitBuilder(CircuitConfig.standard_recursion_config()), \
        PartialWitness()
    a_vals = [rng.randrange(P) for _ in range(4)]
    b_vals = [(a_vals[0] + 1) % P] + a_vals[1:]
    a_t = [[b.add_virtual_target()] for _ in range(4)]
    b_t = [[b.add_virtual_target()] for _ in range(4)]
    for (t,), v in zip(a_t + b_t, a_vals + b_vals):
        pw.set_target(t, v)
    b.assert_permutation(a_t, b_t)
    return b.build(device=device), pw
