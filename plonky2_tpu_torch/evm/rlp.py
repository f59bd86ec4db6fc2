"""The port's copy of plonky2_tpu/evm/rlp.py.

RLP encoding/decoding + the prover-input linearization of signed
transactions (reference evm/src/generation/rlp.rs; the codec itself mirrors
what the reference gets from the `rlp` crate).

RLP items are bytes or (recursively) lists of items.
"""
from __future__ import annotations

from typing import List, Tuple, Union

Item = Union[bytes, list]


def encode_int(x: int) -> bytes:
    """Minimal big-endian byte string (scalar RLP encoding)."""
    if x == 0:
        return b""
    return x.to_bytes((x.bit_length() + 7) // 8, "big")


def encode(item: Item) -> bytes:
    if isinstance(item, (bytes, bytearray)):
        b = bytes(item)
        if len(b) == 1 and b[0] < 0x80:
            return b
        return _length_prefix(len(b), 0x80) + b
    if isinstance(item, int):
        return encode(encode_int(item))
    payload = b"".join(encode(x) for x in item)
    return _length_prefix(len(payload), 0xC0) + payload


def _length_prefix(n: int, offset: int) -> bytes:
    if n <= 55:
        return bytes([offset + n])
    nb = encode_int(n)
    return bytes([offset + 55 + len(nb)]) + nb


def decode(data: bytes) -> Item:
    item, rest = _decode_one(bytes(data))
    if rest:
        raise ValueError(f"{len(rest)} trailing bytes after RLP item")
    return item


def decode_int(data: bytes) -> int:
    item = decode(data)
    if not isinstance(item, bytes):
        raise ValueError("expected RLP string for integer")
    if item and item[0] == 0:
        raise ValueError("leading zero in RLP integer")
    return int.from_bytes(item, "big")


def decode_list(data: bytes) -> list:
    item = decode(data)
    if not isinstance(item, list):
        raise ValueError("expected RLP list")
    return item


def _decode_one(data: bytes) -> Tuple[Item, bytes]:
    if not data:
        raise ValueError("empty RLP input")
    b0 = data[0]
    if b0 < 0x80:
        return data[:1], data[1:]
    if b0 <= 0xB7:
        n = b0 - 0x80
        _need(data, 1 + n)
        if n == 1 and data[1] < 0x80:
            raise ValueError("non-canonical single-byte RLP string")
        return data[1:1 + n], data[1 + n:]
    if b0 <= 0xBF:
        ln = b0 - 0xB7
        _need(data, 1 + ln)
        n = int.from_bytes(data[1:1 + ln], "big")
        if n <= 55 or data[1] == 0:
            raise ValueError("non-canonical RLP length")
        _need(data, 1 + ln + n)
        return data[1 + ln:1 + ln + n], data[1 + ln + n:]
    if b0 <= 0xF7:
        n = b0 - 0xC0
        _need(data, 1 + n)
        return _decode_items(data[1:1 + n]), data[1 + n:]
    ln = b0 - 0xF7
    _need(data, 1 + ln)
    n = int.from_bytes(data[1:1 + ln], "big")
    if n <= 55 or data[1] == 0:
        raise ValueError("non-canonical RLP length")
    _need(data, 1 + ln + n)
    return _decode_items(data[1 + ln:1 + ln + n]), data[1 + ln + n:]


def _decode_items(payload: bytes) -> list:
    items = []
    while payload:
        item, payload = _decode_one(payload)
        items.append(item)
    return items


def _need(data: bytes, n: int) -> None:
    if len(data) < n:
        raise ValueError("truncated RLP input")


def all_rlp_prover_inputs(signed_txns: List[bytes]) -> List[int]:
    """[len, byte, byte, ...] per txn (reference rlp.rs:9-18)."""
    inputs: List[int] = []
    for txn in signed_txns:
        inputs.append(len(txn))
        inputs.extend(txn)
    return inputs
