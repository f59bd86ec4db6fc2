"""The port's copy of plonky2_tpu/evm/mpt.py.

Partial Merkle-Patricia tries (reference evm/src/generation/mpt.rs and
the `eth_trie_utils` PartialTrie it builds on).

Provides the trie shape the EVM generation layer consumes: node variants
Empty / Hash / Branch / Extension / Leaf, Ethereum yellow-paper Keccak
hashing (`calc_hash`), the `AccountRlp` leaf payload, and the prover-input
linearization `all_mpt_prover_inputs` that serializes tries into the U256
stream the kernel's trie loader reads (mpt.rs:37-104).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..hash.keccak import keccak256
from . import rlp

# node type tags (reference cpu/kernel/constants/trie_type.rs)
TYPE_EMPTY = 0
TYPE_HASH = 1
TYPE_BRANCH = 2
TYPE_EXTENSION = 3
TYPE_LEAF = 4

EMPTY_TRIE_ROOT = int.from_bytes(keccak256(rlp.encode(b"")), "big")
EMPTY_CODE_HASH = int.from_bytes(keccak256(b""), "big")


@dataclass(frozen=True)
class Nibbles:
    """A packed big-endian nibble string (reference eth_trie_utils)."""
    count: int
    packed: int

    def __post_init__(self):
        assert 0 <= self.packed < (1 << (4 * self.count)) if self.count \
            else self.packed == 0

    def nibble(self, i: int) -> int:
        """i-th nibble from the most significant end."""
        return (self.packed >> (4 * (self.count - 1 - i))) & 0xF

    def merge(self, other: "Nibbles") -> "Nibbles":
        return Nibbles(self.count + other.count,
                       (self.packed << (4 * other.count)) | other.packed)

    @staticmethod
    def from_bytes(b: bytes) -> "Nibbles":
        return Nibbles(2 * len(b), int.from_bytes(b, "big"))

    def to_hex_prefix(self, is_leaf: bool) -> bytes:
        """Yellow-paper HP encoding."""
        odd = self.count & 1
        flag = (2 if is_leaf else 0) + odd
        if odd:
            first = flag << 4 | self.nibble(0)
            rest = self.packed & ((1 << (4 * (self.count - 1))) - 1)
            return bytes([first]) + rest.to_bytes((self.count - 1) // 2,
                                                  "big")
        return bytes([flag << 4]) + self.packed.to_bytes(self.count // 2,
                                                         "big")


EMPTY_NIBBLES = Nibbles(0, 0)


@dataclass
class PartialTrie:
    """Tagged union; exactly the fields for its `kind` are meaningful."""
    kind: int
    hash: int = 0                                   # TYPE_HASH: 256-bit
    children: Optional[List["PartialTrie"]] = None  # TYPE_BRANCH: 16
    value: bytes = b""                              # branch/leaf payload
    nibbles: Nibbles = EMPTY_NIBBLES                # extension/leaf key part
    child: Optional["PartialTrie"] = None           # TYPE_EXTENSION

    # -- constructors ------------------------------------------------------

    @staticmethod
    def empty() -> "PartialTrie":
        return PartialTrie(TYPE_EMPTY)

    @staticmethod
    def hash_node(h: int) -> "PartialTrie":
        return PartialTrie(TYPE_HASH, hash=h)

    @staticmethod
    def leaf(nibbles: Nibbles, value: bytes) -> "PartialTrie":
        return PartialTrie(TYPE_LEAF, nibbles=nibbles, value=value)

    @staticmethod
    def extension(nibbles: Nibbles, child: "PartialTrie") -> "PartialTrie":
        return PartialTrie(TYPE_EXTENSION, nibbles=nibbles, child=child)

    @staticmethod
    def branch(children: List["PartialTrie"],
               value: bytes = b"") -> "PartialTrie":
        assert len(children) == 16
        return PartialTrie(TYPE_BRANCH, children=children, value=value)

    # -- hashing (yellow paper appendix D) ---------------------------------

    def _encoded(self):
        """Returns the RLP structure of this node (bytes or list)."""
        if self.kind == TYPE_EMPTY:
            return b""
        if self.kind == TYPE_HASH:
            return self.hash.to_bytes(32, "big")
        if self.kind == TYPE_LEAF:
            return [self.nibbles.to_hex_prefix(True), self.value]
        if self.kind == TYPE_EXTENSION:
            return [self.nibbles.to_hex_prefix(False),
                    self.child._child_ref()]
        if self.kind == TYPE_BRANCH:
            return [c._child_ref() for c in self.children] + [self.value]
        raise AssertionError(self.kind)

    class _Raw(bytes):
        """Pre-encoded RLP embedded verbatim in a parent list."""

    def _child_ref(self):
        """c(J): inline if the encoding is < 32 bytes, else keccak hash."""
        if self.kind == TYPE_EMPTY:
            return b""
        if self.kind == TYPE_HASH:
            return self.hash.to_bytes(32, "big")
        enc = _rlp_encode_node(self._encoded())
        if len(enc) < 32:
            return PartialTrie._Raw(enc)
        return keccak256(enc)

    def calc_hash(self) -> int:
        """Root hash as a 256-bit integer (reference PartialTrie::calc_hash)."""
        if self.kind == TYPE_HASH:
            return self.hash
        return int.from_bytes(keccak256(_rlp_encode_node(self._encoded())),
                              "big")


def _rlp_encode_node(item) -> bytes:
    """rlp.encode, but `_Raw` children embed their bytes verbatim."""
    if isinstance(item, PartialTrie._Raw):
        return bytes(item)
    if isinstance(item, (bytes, bytearray)):
        return rlp.encode(bytes(item))
    payload = b"".join(_rlp_encode_node(x) for x in item)
    return rlp._length_prefix(len(payload), 0xC0) + payload


# ---------------------------------------------------------------------------
# account leaves
# ---------------------------------------------------------------------------

@dataclass
class AccountRlp:
    """State-trie leaf payload (reference mpt.rs:12-28)."""
    nonce: int = 0
    balance: int = 0
    storage_root: int = EMPTY_TRIE_ROOT
    code_hash: int = EMPTY_CODE_HASH

    def encode(self) -> bytes:
        return rlp.encode([rlp.encode_int(self.nonce),
                           rlp.encode_int(self.balance),
                           self.storage_root.to_bytes(32, "big"),
                           self.code_hash.to_bytes(32, "big")])

    @staticmethod
    def decode(data: bytes) -> "AccountRlp":
        n, b, sr, ch = rlp.decode_list(data)
        return AccountRlp(int.from_bytes(n, "big"), int.from_bytes(b, "big"),
                          int.from_bytes(sr, "big"),
                          int.from_bytes(ch, "big"))


# ---------------------------------------------------------------------------
# prover-input linearization (reference mpt.rs:37-184)
# ---------------------------------------------------------------------------

def _common_prefix(a: Nibbles, b: Nibbles) -> int:
    n = min(a.count, b.count)
    for i in range(n):
        if a.nibble(i) != b.nibble(i):
            return i
    return n


def _suffix(n: Nibbles, start: int) -> Nibbles:
    cnt = n.count - start
    return Nibbles(cnt, n.packed & ((1 << (4 * cnt)) - 1) if cnt else 0)


def trie_insert(trie: PartialTrie, key: Nibbles, value: bytes
                ) -> PartialTrie:
    """Standard MPT insert (yellow paper; the reference delegates to
    eth_trie_utils::PartialTrie::insert).  Returns a NEW trie; the input
    is not mutated.  Inserting under a HASH node is an error (the partial
    trie doesn't contain that subtree)."""
    k = trie.kind
    if k == TYPE_EMPTY:
        return PartialTrie.leaf(key, value)
    if k == TYPE_HASH:
        raise ValueError("cannot insert below a hashed-out subtree")
    if k == TYPE_BRANCH:
        if key.count == 0:
            return PartialTrie.branch(list(trie.children), value)
        i = key.nibble(0)
        children = list(trie.children)
        children[i] = trie_insert(children[i], _suffix(key, 1), value)
        return PartialTrie.branch(children, trie.value)
    # leaf / extension: split on the common prefix
    node_nibs = trie.nibbles
    cp = _common_prefix(node_nibs, key)
    if k == TYPE_LEAF and cp == node_nibs.count and cp == key.count:
        return PartialTrie.leaf(key, value)          # overwrite
    if k == TYPE_EXTENSION and cp == node_nibs.count:
        child = trie_insert(trie.child, _suffix(key, cp), value)
        return PartialTrie.extension(node_nibs, child)
    # diverge at nibble cp: build a branch
    children = [PartialTrie.empty() for _ in range(16)]
    branch_value = b""
    old_rest = _suffix(node_nibs, cp)
    if k == TYPE_LEAF:
        old_node = (PartialTrie.leaf(_suffix(old_rest, 1), trie.value)
                    if old_rest.count else None)
        if old_node is None:
            branch_value = trie.value
        else:
            children[old_rest.nibble(0)] = old_node
    else:
        assert old_rest.count, "extension exhausted without divergence"
        rest = _suffix(old_rest, 1)
        inner = trie.child if rest.count == 0 else \
            PartialTrie.extension(rest, trie.child)
        children[old_rest.nibble(0)] = inner
    new_rest = _suffix(key, cp)
    if new_rest.count == 0:
        branch_value = value
    else:
        children[new_rest.nibble(0)] = PartialTrie.leaf(
            _suffix(new_rest, 1), value)
    branch = PartialTrie.branch(children, branch_value)
    if cp == 0:
        return branch
    return PartialTrie.extension(Nibbles(cp, key.packed >> (4 * (key.count - cp))), branch)


def trie_get(trie: PartialTrie, key: Nibbles) -> Optional[bytes]:
    k = trie.kind
    if k == TYPE_EMPTY or k == TYPE_HASH:
        return None
    if k == TYPE_BRANCH:
        if key.count == 0:
            return trie.value or None
        return trie_get(trie.children[key.nibble(0)], _suffix(key, 1))
    cp = _common_prefix(trie.nibbles, key)
    if cp != trie.nibbles.count:
        return None
    if k == TYPE_LEAF:
        return trie.value if cp == key.count else None
    return trie_get(trie.child, _suffix(key, cp))


def all_mpt_prover_inputs(trie_inputs) -> List[int]:
    """Serialize the initial tries into the U256 stream the kernel's trie
    loader consumes (reference mpt.rs:37-63)."""
    inputs: List[int] = []
    storage_by_key: Dict[Nibbles, PartialTrie] = {
        Nibbles.from_bytes(keccak256(addr.to_bytes(20, "big"))): t
        for addr, t in trie_inputs.storage_tries}
    _state_trie_inputs(trie_inputs.state_trie, EMPTY_NIBBLES, inputs,
                       storage_by_key)
    # txn/receipt values stream as FAITHFUL BYTES ([len, b0..]) — the
    # reference's decode_list/empty parse (generation/mpt.rs:53-60) is
    # lossy, which forced its txn/receipt root digests to stay
    # PROVER_INPUTs; byte-exact values let mpt_asm.py hash (and insert
    # into) all three tries in-kernel.
    _mpt_inputs(trie_inputs.transactions_trie, inputs, _bytes_value)
    _mpt_inputs(trie_inputs.receipts_trie, inputs, _bytes_value)
    return inputs


def _bytes_value(v: bytes) -> List[int]:
    return [len(v)] + list(v)


def _mpt_inputs(trie: PartialTrie, inputs: List[int], parse_value) -> None:
    inputs.append(trie.kind)
    if trie.kind == TYPE_EMPTY:
        return
    if trie.kind == TYPE_HASH:
        inputs.append(trie.hash)
    elif trie.kind == TYPE_BRANCH:
        if trie.value:
            inputs.append(1)
            inputs.extend(parse_value(trie.value))
        else:
            inputs.append(0)
        for child in trie.children:
            _mpt_inputs(child, inputs, parse_value)
    elif trie.kind == TYPE_EXTENSION:
        inputs.append(trie.nibbles.count)
        inputs.append(trie.nibbles.packed)
        _mpt_inputs(trie.child, inputs, parse_value)
    elif trie.kind == TYPE_LEAF:
        inputs.append(trie.nibbles.count)
        inputs.append(trie.nibbles.packed)
        inputs.extend(parse_value(trie.value))


def _state_trie_inputs(trie: PartialTrie, key: Nibbles, inputs: List[int],
                       storage_by_key) -> None:
    """reference mpt.rs:106-173: account leaves recurse into their storage
    tries."""
    inputs.append(trie.kind)
    if trie.kind == TYPE_EMPTY:
        return
    if trie.kind == TYPE_HASH:
        inputs.append(trie.hash)
    elif trie.kind == TYPE_BRANCH:
        assert not trie.value, "State trie should not have branch values"
        inputs.append(0)
        for i, child in enumerate(trie.children):
            _state_trie_inputs(child, key.merge(Nibbles(1, i)), inputs,
                               storage_by_key)
    elif trie.kind == TYPE_EXTENSION:
        inputs.append(trie.nibbles.count)
        inputs.append(trie.nibbles.packed)
        _state_trie_inputs(trie.child, key.merge(trie.nibbles), inputs,
                           storage_by_key)
    elif trie.kind == TYPE_LEAF:
        account = AccountRlp.decode(trie.value)
        full_key = key.merge(trie.nibbles)
        storage = storage_by_key.get(
            full_key, PartialTrie.hash_node(account.storage_root))
        assert storage.calc_hash() == account.storage_root, (
            "account storage_root doesn't match its storage trie hash")
        inputs.append(trie.nibbles.count)
        inputs.append(trie.nibbles.packed)
        inputs.append(account.nonce)
        inputs.append(account.balance)
        _mpt_inputs(storage, inputs,
                    lambda v: [rlp.decode_int(v)])
        inputs.append(account.code_hash)
