"""Keccak-f[1600] and Keccak-256: the port's copy of the permutation, the
hash and the round constants of plonky2_tpu/hash/keccak.py (reference
plonky2/src/hash/keccak.rs), on python ints.  The EVM tables use them
(evm/keccak_stark.py, evm/keccak_sponge.py)."""
from __future__ import annotations

from typing import List

ROT = [[0, 36, 3, 41, 18], [1, 44, 10, 45, 2], [62, 6, 43, 15, 61],
       [28, 55, 25, 21, 56], [27, 20, 39, 8, 14]]
RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_M64 = (1 << 64) - 1
RATE_BYTES = 136


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (64 - n))) & _M64


def keccak_f1600(state: List[int]) -> List[int]:
    """The permutation on 25 lanes, lane x + 5 y at index x + 5 y."""
    a = [[state[x + 5 * y] for y in range(5)] for x in range(5)]
    for rc in RC:
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(a[x][y], ROT[x][y])
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y])
        a[0][0] ^= rc
    return [a[x][y] for y in range(5) for x in range(5)]


def keccak256(data: bytes) -> bytes:
    """Original Keccak-256 (pre-SHA3 padding, as Ethereum uses it)."""
    state = [0] * 25
    padded = bytearray(data)
    pad_len = RATE_BYTES - (len(padded) % RATE_BYTES)
    padded += (b"\x01" + b"\x00" * (pad_len - 2) + b"\x80" if pad_len >= 2
               else b"\x81")
    for start in range(0, len(padded), RATE_BYTES):
        block = padded[start:start + RATE_BYTES]
        for i in range(RATE_BYTES // 8):
            state[i] ^= int.from_bytes(block[8 * i:8 * i + 8], "little")
        state = keccak_f1600(state)
    return b"".join(state[i].to_bytes(8, "little") for i in range(4))
