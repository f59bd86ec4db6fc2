"""The port's copy of plonky2_tpu/evm/transactions.py.

Signed-transaction handling: type-0 (legacy) decode, signing hash,
sender recovery, and the host-side state application that defines the
post-transaction tries.

Reference correspondence: the kernel asm `process_txn.asm` /
`transaction_parsing` routines (sources absent from the reference tree;
spec'd by cpu/kernel/tests/transaction_parsing/parse_type_0_txn.rs) parse
the RLP in-kernel — mirrored by the asm in evm/txn_asm.py — and sender
recovery (the kernel's ecrecover.asm) runs IN-KERNEL via evm/secp_asm.py
when block.py assembles the block kernel with ``in_kernel_ecrecover=True``
(the default at block scale).
The host-side ecrecover here (ecdsa/curve.py) remains for unit-scale
proofs that opt into the cheaper PROVER_INPUT splice and as the oracle
the in-kernel routine is tested against.

Semantics of `apply_transactions` follow the reference's
transfer_to_new_addr expectation (evm/tests/transfer_to_new_addr.rs:76-84):
balance moves by `value`; the sender nonce bump and gas-cost deduction are
explicitly TODO there, and are matched here so the roots agree.  The
transactions trie inserts rlp(index) -> signed txn bytes and the receipts
trie a minimal legacy receipt, per the yellow paper.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from ..hash.keccak import keccak256
from . import rlp
from .mpt import (AccountRlp, Nibbles, PartialTrie, trie_get, trie_insert)

GAS_TX = 21_000
GAS_TXCREATE = 32_000
GAS_TXDATAZERO = 4
GAS_TXDATANONZERO = 16


@dataclass(frozen=True)
class Type0Txn:
    nonce: int
    gas_price: int
    gas_limit: int
    to: int            # 160-bit address; 0 with to_empty=True for create
    to_empty: bool
    value: int
    data: bytes
    v: int
    r: int
    s: int

    @property
    def chain_id_present(self) -> bool:
        return self.v >= 35

    @property
    def chain_id(self) -> int:
        return (self.v - 35) // 2 if self.chain_id_present else 0

    @property
    def y_parity(self) -> int:
        return (self.v - 35) % 2 if self.chain_id_present else self.v - 27


def decode_type0_txn(raw: bytes) -> Type0Txn:
    items = rlp.decode_list(raw)
    assert len(items) == 9, "type-0 txn must have 9 fields"
    nonce, gas_price, gas_limit, to, value, data, v, r, s = items
    return Type0Txn(
        nonce=int.from_bytes(nonce, "big"),
        gas_price=int.from_bytes(gas_price, "big"),
        gas_limit=int.from_bytes(gas_limit, "big"),
        to=int.from_bytes(to, "big"), to_empty=len(to) == 0,
        value=int.from_bytes(value, "big"), data=data,
        v=int.from_bytes(v, "big"), r=int.from_bytes(r, "big"),
        s=int.from_bytes(s, "big"))


def sighash_type0(txn: Type0Txn) -> int:
    fields = [rlp.encode_int(txn.nonce), rlp.encode_int(txn.gas_price),
              rlp.encode_int(txn.gas_limit),
              b"" if txn.to_empty else txn.to.to_bytes(20, "big"),
              rlp.encode_int(txn.value), txn.data]
    if txn.chain_id_present:                      # EIP-155
        fields += [rlp.encode_int(txn.chain_id), rlp.encode_int(0),
                   rlp.encode_int(0)]
    return int.from_bytes(keccak256(rlp.encode(fields)), "big")


def recover_sender(txn: Type0Txn) -> int:
    from ..ecdsa.curve import ecrecover
    q = ecrecover(sighash_type0(txn), txn.y_parity, txn.r, txn.s)
    pub = q.x.to_bytes(32, "big") + q.y.to_bytes(32, "big")
    return int.from_bytes(keccak256(pub)[12:], "big")


def intrinsic_gas(txn: Type0Txn) -> int:
    """reference intrinsic_gas.asm, spec'd by
    cpu/kernel/tests/core/intrinsic_gas.rs."""
    g = GAS_TX + (GAS_TXCREATE if txn.to_empty else 0)
    for b in txn.data:
        g += GAS_TXDATAZERO if b == 0 else GAS_TXDATANONZERO
    return g


def _account_key(addr: int) -> Nibbles:
    return Nibbles.from_bytes(keccak256(addr.to_bytes(20, "big")))


def apply_transactions(tries, signed_txns: List[bytes]
                       ) -> Tuple[PartialTrie, PartialTrie, PartialTrie,
                                  List[Type0Txn], List[int]]:
    """Returns (state_after, txn_trie_after, receipts_after, txns, senders).

    Balance-only transfers (reference transfer_to_new_addr.rs semantics:
    no nonce bump, no gas deduction from balances — both TODO upstream).
    Use ``creates_accounts`` to check whether any recipient leaf is NEW —
    a structural trie change the kernel's in-place balance mutation cannot
    reproduce (block.py picks the after-root binding mode from it)."""
    state = tries.state_trie
    txn_trie = tries.transactions_trie
    rcpt_trie = tries.receipts_trie
    txns: List[Type0Txn] = []
    senders: List[int] = []
    cum_gas = 0
    for i, raw in enumerate(signed_txns):
        txn = decode_type0_txn(raw)
        sender = recover_sender(txn)
        txns.append(txn)
        senders.append(sender)

        skey = _account_key(sender)
        sacct_raw = trie_get(state, skey)
        assert sacct_raw is not None, "sender account missing from state"
        sacct = AccountRlp.decode(sacct_raw)
        assert sacct.balance >= txn.value, "insufficient balance"
        state = trie_insert(state, skey, AccountRlp(
            nonce=sacct.nonce, balance=sacct.balance - txn.value,
            storage_root=sacct.storage_root,
            code_hash=sacct.code_hash).encode())

        if not txn.to_empty:
            tkey = _account_key(txn.to)
            tacct_raw = trie_get(state, tkey)
            tacct = (AccountRlp.decode(tacct_raw) if tacct_raw
                     else AccountRlp())
            state = trie_insert(state, tkey, AccountRlp(
                nonce=tacct.nonce, balance=tacct.balance + txn.value,
                storage_root=tacct.storage_root,
                code_hash=tacct.code_hash).encode())

        txn_trie = trie_insert(txn_trie,
                               Nibbles.from_bytes(rlp.encode_int(i)), raw)
        cum_gas += intrinsic_gas(txn)
        receipt = rlp.encode([rlp.encode_int(1),        # status
                              rlp.encode_int(cum_gas),
                              bytes(256),               # logs bloom
                              []])                      # logs
        rcpt_trie = trie_insert(rcpt_trie,
                                Nibbles.from_bytes(rlp.encode_int(i)),
                                receipt)
    return state, txn_trie, rcpt_trie, txns, senders


def creates_accounts(tries, signed_txns: List[bytes]) -> bool:
    """True if any transaction credits an account absent from the initial
    state trie (a structural insert, not an in-place balance update).
    An account first credited by an earlier txn in the same block was also
    absent initially, so scanning against the initial trie is complete."""
    state = tries.state_trie
    for raw in signed_txns:
        txn = decode_type0_txn(raw)
        if txn.to_empty:
            continue
        if trie_get(state, _account_key(txn.to)) is None:
            return True
    return False
