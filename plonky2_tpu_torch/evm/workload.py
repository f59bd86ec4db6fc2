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
range-checked table.

``transfer_inputs()``: the block of one signed transfer that
tests/test_evm_transfer.py proves (upstream transfer_to_new_addr.rs):
the type-0 transaction TRANSFER_TXN (nonce 5, gas price 10, gas 22,000,
to a0..a0, value 100, data 0x4242) against a state trie holding only its
sender's account (nonce 5, 10^23 wei); with the state trie that the
upstream test builds by hand for after the block."""
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


# upstream transfer_to_new_addr.rs:60, signed by TRANSFER_SENDER
TRANSFER_TXN = bytes.fromhex(
    "f861050a8255f094a0a0a0a0a0a0a0a0a0a0a0a0a0a0a0a0a0a0a0a06482424"
    "21ba02c89eb757d9deeb1f5b3859a9d4d679951ef610ac47ad4608dc142beb1"
    "b7e313a05af7e9fbab825455d36c36c7f4cfcafbeafa9a77bdff936b52afb36"
    "d4fe4bcdd")
TRANSFER_SENDER = 0x2c7536e3605d9c16a7a3d7b1898e529396a65c23
TRANSFER_TO = 0xA0A0A0A0A0A0A0A0A0A0A0A0A0A0A0A0A0A0A0A0
TRANSFER_VALUE = 100


def transfer_inputs():
    """(GenerationInputs of the transfer's block, the state trie expected
    after it, built by hand as transfer_to_new_addr.rs:76-103 builds
    it)."""
    from ..hash.keccak import keccak256
    from .block import BlockMetadata, GenerationInputs, TrieInputs
    from .mpt import AccountRlp, Nibbles, PartialTrie, trie_insert

    def key(addr):
        return Nibbles.from_bytes(keccak256(addr.to_bytes(20, "big")))

    sender = AccountRlp(nonce=5, balance=100_000 * 10 ** 18)
    inputs = GenerationInputs(
        signed_txns=[TRANSFER_TXN],
        tries=TrieInputs(state_trie=PartialTrie.leaf(
            key(TRANSFER_SENDER), sender.encode())),
        block_metadata=BlockMetadata())
    after = PartialTrie.leaf(key(TRANSFER_SENDER), AccountRlp(
        nonce=sender.nonce, balance=sender.balance - TRANSFER_VALUE).encode())
    after = trie_insert(after, key(TRANSFER_TO),
                        AccountRlp(balance=TRANSFER_VALUE).encode())
    return inputs, after
