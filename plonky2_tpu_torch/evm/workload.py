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
upstream test builds by hand for after the block.

``storage_ops_kernel()``, ``storage_ops_inputs()``: the kernel and tries
of tests/test_storage_ops.py.  The kernel loads a state trie of one
account (nonce 3, 10^18 wei) whose storage holds slot 7; user SLOAD of
slot 7 and of the absent slot 9, SSTORE of both, SLOAD of slot 7 again
(through the syscall jumptable to evm/storage_asm.py's handlers), then
it hashes the state trie.  ``storage_ops_execution(kernel)`` runs it
(the CPU table 2^17 rows, memory 2^19) and ``storage_ops_readback``
reads the three slots and the root it stored."""
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


# tests/test_storage_ops.py's account and its storage slots
STORAGE_ADDR = 0xA11CE00000000000000000000000000000000001
STORAGE_SLOT_A, STORAGE_SLOT_B = 7, 9
STORAGE_VAL_A, STORAGE_NEW_A, STORAGE_VAL_B = 0xABC, 0xDEAD, 0x1234567890


def _storage_keys():
    from ..hash.keccak import keccak256
    from .mpt import Nibbles

    def slot_key(slot):
        return Nibbles.from_bytes(keccak256(slot.to_bytes(32, "big")))

    def addr_key(addr):
        return Nibbles.from_bytes(keccak256(addr.to_bytes(20, "big")))
    return slot_key, addr_key


def storage_ops_kernel():
    """The kernel of tests/test_storage_ops.py: load the tries, read the
    account, SLOAD slot A (present) and slot B (absent), SSTORE both,
    SLOAD slot A again, hash the state trie, halt; the read-backs go to
    GlobalMetadata[20], [21], [22] and the root to [11].  User SLOAD and
    SSTORE trap through the syscall jumptable to evm/storage_asm.py's
    handlers."""
    from .kernel import assemble, parse
    from .kernel.asm_util import UTIL_ASM
    from .kernel.constants import evm_constants
    from .kernel.stdlib import SHIFT_TABLE_INIT
    from .mpt_asm import MPT_ASM
    from .storage_asm import STORAGE_ASM
    addr_key_packed = _storage_keys()[1](STORAGE_ADDR).packed
    entries = ["jt_panic"] * 256
    entries[0x54] = "sys_sload"
    entries[0x55] = "sys_sstore"
    main = f"""
GLOBAL main:
{SHIFT_TABLE_INIT}
    PUSH main_loaded
    PUSH load_all_mpts
    JUMP
main_loaded:
    // current account value ptr -> GlobalMetadata[18]
    PUSH {addr_key_packed}
    PUSH 64
    PUSH 4
    PUSH @SEGMENT_GLOBAL_METADATA
    PUSH 0
    MLOAD_GENERAL
    %stack (root, cnt, key) -> (root, cnt, key, main_acct)
    PUSH mpt_read
    JUMP
main_acct:
    // vptr
    DUP1
    ISZERO
    PUSH jt_panic
    JUMPI
    %stack (vptr) -> (0, @SEGMENT_GLOBAL_METADATA, 18, vptr)
    MSTORE_GENERAL

    // SLOAD existing slot -> GlobalMetadata[20]
    PUSH {STORAGE_SLOT_A}
    SLOAD
    %stack (v) -> (0, @SEGMENT_GLOBAL_METADATA, 20, v)
    MSTORE_GENERAL

    // SLOAD absent slot -> GlobalMetadata[21]
    PUSH {STORAGE_SLOT_B}
    SLOAD
    %stack (v) -> (0, @SEGMENT_GLOBAL_METADATA, 21, v)
    MSTORE_GENERAL

    // SSTORE overwrite + SSTORE fresh slot (pops key then value)
    PUSH {STORAGE_NEW_A}
    PUSH {STORAGE_SLOT_A}
    SSTORE
    PUSH {STORAGE_VAL_B}
    PUSH {STORAGE_SLOT_B}
    SSTORE

    // re-read the overwritten slot -> GlobalMetadata[22]
    PUSH {STORAGE_SLOT_A}
    SLOAD
    %stack (v) -> (0, @SEGMENT_GLOBAL_METADATA, 22, v)
    MSTORE_GENERAL

    // state root after -> GlobalMetadata[11]
    PUSH main_hashed
    PUSH mpt_hash_state_trie
    JUMP
main_hashed:
    %stack (root) -> (0, @SEGMENT_GLOBAL_METADATA, 11, root)
    MSTORE_GENERAL
    PUSH halt_pc0
    JUMP

GLOBAL jt_panic:
    PANIC

GLOBAL halt_pc0:
    PUSH halt_pc0
GLOBAL halt_pc1:
    JUMP
""" + "GLOBAL syscall_jumptable:\n    JUMPTABLE " + ", ".join(entries) + "\n"
    return assemble([parse(main), parse(UTIL_ASM), parse(MPT_ASM),
                     parse(STORAGE_ASM)], evm_constants(), optimize=False)


def storage_ops_inputs():
    """(the prover inputs that load tests/test_storage_ops.py's tries, the
    GlobalMetadata words the kernel must end with: {20: slot A's value,
    21: 0 for the absent slot B, 22: slot A's new value, 11: the state
    root of the trie built by hand after both writes})."""
    from . import rlp
    from .block import TrieInputs
    from .mpt import AccountRlp, PartialTrie, all_mpt_prover_inputs, \
        trie_insert
    slot_key, addr_key = _storage_keys()

    def value(v):
        return rlp.encode(rlp.encode_int(v))

    storage = trie_insert(PartialTrie.empty(), slot_key(STORAGE_SLOT_A),
                          value(STORAGE_VAL_A))
    acct = AccountRlp(nonce=3, balance=10**18,
                      storage_root=storage.calc_hash(), code_hash=777)
    state = trie_insert(PartialTrie.empty(), addr_key(STORAGE_ADDR),
                        acct.encode())
    data = all_mpt_prover_inputs(TrieInputs(
        state_trie=state, storage_tries=[(STORAGE_ADDR, storage)]))
    storage2 = trie_insert(storage, slot_key(STORAGE_SLOT_A),
                           value(STORAGE_NEW_A))
    storage2 = trie_insert(storage2, slot_key(STORAGE_SLOT_B),
                           value(STORAGE_VAL_B))
    acct2 = AccountRlp(nonce=acct.nonce, balance=acct.balance,
                       storage_root=storage2.calc_hash(),
                       code_hash=acct.code_hash)
    state2 = trie_insert(state, addr_key(STORAGE_ADDR), acct2.encode())
    return data, {20: STORAGE_VAL_A, 21: 0, 22: STORAGE_NEW_A,
                  11: state2.calc_hash()}


class ListProvider:
    """The `mpt` prover inputs, handed out in order (tests/
    test_storage_ops.py:Provider)."""

    def __init__(self, data):
        self.data, self.pos = list(data), 0

    def __call__(self, fn, state):
        if fn[0] != "mpt":
            raise ValueError(f"unexpected prover input {fn}")
        v = self.data[self.pos]
        self.pos += 1
        return v


def storage_ops_execution(kernel):
    """The kernel's execution (evm/generation.py:
    generate_kernel_execution) with storage_ops_inputs()'s prover
    inputs."""
    from .generation import generate_kernel_execution
    data = storage_ops_inputs()[0]
    return generate_kernel_execution(
        kernel, prover_input_factory=lambda: ListProvider(data))


def storage_ops_readback(execution) -> dict:
    """The GlobalMetadata words 20, 21, 22 and 11 the execution ended
    with."""
    from .memory import Segment
    gm = int(Segment.GlobalMetadata)
    mem = execution.final_state.memory
    return {ix: mem.get((0, gm, ix), 0) for ix in (20, 21, 22, 11)}
