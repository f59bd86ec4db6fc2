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
blocks, one of one)."""
from __future__ import annotations

from typing import List

import numpy as np

from .keccak_sponge import KECCAK_RATE_BYTES, KeccakSpongeOp


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
