"""Sponge-operation workloads for the four-table EVM proof.

``sponge_ops(n)``: n Keccak sponge operations, operation i reading its
input at context 0, segment 2 (main memory), virtual address 1024 i, at
timestamp i + 1.  The input lengths are drawn first from numpy's
``default_rng(seed)``, uniform in [0, 135] bytes, so each input absorbs
one block; then all input bytes at once from the same generator, in
operation order.  At n = 640 the tables are keccak 2,481 x 2^14 (640
permutations), sponge 414 x 2^10, logic 523 x 2^12 and memory 21 x 2^16
(45,029 reads).

``small_sponge_ops()``: the two operations of the tests (one of two
blocks, one of one).

``arithmetic_ops(groups)``: the arithmetic table's stream, `groups`
repeats of the mix of tests/test_evm_arithmetic.py:mixed_ops (add, sub,
mul, lt, gt, addmod, submod, mulmod, mod and div, then mod, div and
mulmod by a zero modulus and lt of equal inputs: 14 ops in 22 rows), its
256-bit values drawn from numpy's ``default_rng(seed)``.  At the default
2,978 groups (41,692 ops) it fills 65,516 of the 2^16 rows of the
range-checked table."""
from __future__ import annotations

from typing import List

import numpy as np

from .arithmetic import Operation
from .keccak_sponge import KECCAK_RATE_BYTES, KeccakSpongeOp

ARITHMETIC_GROUPS = 2978


def sponge_ops(n_ops: int, seed: int = 0) -> List[KeccakSpongeOp]:
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, KECCAK_RATE_BYTES, size=n_ops)
    data = rng.integers(0, 256, size=int(lengths.sum()),
                        dtype=np.uint8).tobytes()
    ends = np.cumsum(lengths)
    return [KeccakSpongeOp(context=0, segment=2, virt=1024 * i,
                           timestamp=i + 1,
                           input=data[int(e - k):int(e)])
            for i, (k, e) in enumerate(zip(lengths, ends))]


def small_sponge_ops() -> List[KeccakSpongeOp]:
    return [KeccakSpongeOp(0, 2, 0, 1, bytes(range(136)) + b"tail"),
            KeccakSpongeOp(0, 2, 1024, 7, b"plonky2 on tpu")]


def arithmetic_ops(groups: int = ARITHMETIC_GROUPS, seed: int = 0,
                   operation=Operation) -> list:
    """The stream of `operation`s (the port's Operation class unless
    given, so that the JAX package's can be)."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 64, size=(groups, 19, 4), dtype=np.uint64)
    ops = []
    for g in words:
        v = [int.from_bytes(w.astype("<u8").tobytes(), "little") for w in g]
        m = v[18] or 1
        ops += [operation("add", v[0], v[1]), operation("sub", v[2], v[3]),
                operation("mul", v[4], v[5]), operation("lt", v[6], v[7]),
                operation("gt", v[8], v[9]),
                operation("addmod", v[10], v[11], m),
                operation("submod", v[12], v[13], m),
                operation("mulmod", v[14], v[15], m),
                operation("mod", v[16], 0, m),
                operation("div", v[17], 0, m),
                operation("mod", v[0], 0, 0), operation("div", v[1], 0, 0),
                operation("mulmod", v[2], v[3], 0),
                operation("lt", v[4], v[4])]
    return ops
