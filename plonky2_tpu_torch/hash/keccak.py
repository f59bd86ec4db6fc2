"""Keccak-f[1600] and Keccak-256: the port's copy of the permutation, the
hash and the round constants of plonky2_tpu/hash/keccak.py (reference
plonky2/src/hash/keccak.rs), on python ints.  The EVM tables use them
(evm/keccak_stark.py, evm/keccak_sponge.py).

``KeccakHasher`` is the hasher of the non-algebraic Keccak configuration
(hash/hashers.py:KeccakConfig): 25-byte digests and the hash-onion
challenger permutation, as the JAX package's.  The Merkle trees of that
configuration hash many leaves or pairs at once on the host:
``keccak_f1600_lanes`` runs the permutation on N states in numpy, and
``hash_or_noop_batch``/``two_to_one_batch`` give the digests as field
elements, the same values as the scalar hasher's.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..field import goldilocks as gl

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


HASH_SIZE = 25


class KeccakHasher:
    """Hasher with 25-byte digests (reference KeccakHash<25>; JAX
    hash/keccak.py:KeccakHasher)."""

    @staticmethod
    def hash_no_pad(inputs: Sequence[int]) -> bytes:
        buf = b"".join(int(x).to_bytes(8, "little") for x in inputs)
        return keccak256(buf)[:HASH_SIZE]

    @staticmethod
    def two_to_one(left: bytes, right: bytes) -> bytes:
        return keccak256(left + right)[:HASH_SIZE]

    @staticmethod
    def hash_or_noop(inputs: Sequence[int]) -> bytes:
        """The inputs' bytes, zero-padded, where they fit in a digest
        (reference hashing.rs hash_or_noop), else their hash."""
        if len(inputs) * 8 <= HASH_SIZE:
            buf = b"".join(int(x).to_bytes(8, "little") for x in inputs)
            return buf + b"\x00" * (HASH_SIZE - len(buf))
        return KeccakHasher.hash_no_pad(inputs)

    @staticmethod
    def hash_to_elements(digest: bytes) -> List[int]:
        """A digest as field elements: 7-byte little-endian chunks
        (reference hash_types.rs:179-189)."""
        return [int.from_bytes(digest[i:i + 7], "little")
                for i in range(0, len(digest), 7)]

    @staticmethod
    def permute(state: Sequence[int]) -> List[int]:
        """The hash-onion pseudo-permutation of the challenger (reference
        keccak.rs:18-51): the words below p of H(state), H(H(state)), ...
        until there are 12."""
        current = b"".join(int(x).to_bytes(8, "little") for x in state)
        out: List[int] = []
        while len(out) < 12:
            current = keccak256(current)
            for i in range(0, 32, 8):
                word = int.from_bytes(current[i:i + 8], "little")
                if word < gl.P:         # rejection sampling
                    out.append(word)
                    if len(out) == 12:
                        break
        return out


# lane i = x + 5 y goes to lane y + 5 ((2 x + 3 y) mod 5), rotated by
# ROT[x][y]
_PI_DST = np.array([y + 5 * ((2 * x + 3 * y) % 5)
                    for y in range(5) for x in range(5)])
_PI_ROT = np.array([ROT[x][y] for y in range(5) for x in range(5)],
                   dtype=np.uint64)[:, None]
_RC = np.array(RC, dtype=np.uint64)


def keccak_f1600_lanes(state: np.ndarray) -> np.ndarray:
    """The permutation on (25, N) uint64 lanes, N states at once (lane
    x + 5 y in row x + 5 y), as keccak_f1600 on each."""
    a = np.array(state, dtype=np.uint64)
    rot_back = (np.uint64(64) - _PI_ROT) % np.uint64(64)
    one, sixty_three = np.uint64(1), np.uint64(63)
    for rc in _RC:
        c = a[0:5] ^ a[5:10] ^ a[10:15] ^ a[15:20] ^ a[20:25]   # (5, N)
        up = np.roll(c, -1, axis=0)
        d = np.roll(c, 1, axis=0) ^ ((up << one) | (up >> sixty_three))
        a ^= np.tile(d, (5, 1))
        b = np.empty_like(a)
        b[_PI_DST] = (a << _PI_ROT) | (a >> rot_back)
        rows = b.reshape(5, 5, -1)                  # [y][x]
        a = (rows ^ (~np.roll(rows, -1, axis=1)
                     & np.roll(rows, -2, axis=1))).reshape(25, -1)
        a[0] ^= rc
    return a


_RATE_WORDS = RATE_BYTES // 8


def _absorb_words(words: np.ndarray) -> np.ndarray:
    """Keccak-256 of N messages of W little-endian 64-bit words, (N, W)
    -> the first four lanes of each digest's state, (4, N)."""
    n, w = words.shape
    total = -(-(w + 1) // _RATE_WORDS) * _RATE_WORDS
    msg = np.zeros((total, n), dtype=np.uint64)
    msg[:w] = words.T
    msg[w] ^= np.uint64(0x01)
    msg[total - 1] ^= np.uint64(0x80 << 56)
    state = np.zeros((25, n), dtype=np.uint64)
    for start in range(0, total, _RATE_WORDS):
        state[:_RATE_WORDS] ^= msg[start:start + _RATE_WORDS]
        state = keccak_f1600_lanes(state)
    return state[:4]


def _mask(bits: int) -> np.uint64:
    return np.uint64((1 << bits) - 1)


def _lanes_to_elements(lanes: np.ndarray) -> np.ndarray:
    """The first 25 bytes of (4, N) lanes as 7-byte chunks, (N, 4)."""
    l0, l1, l2, l3 = lanes
    return np.stack([
        l0 & _mask(56),
        (l0 >> np.uint64(56)) | ((l1 & _mask(48)) << np.uint64(8)),
        (l1 >> np.uint64(48)) | ((l2 & _mask(40)) << np.uint64(16)),
        (l2 >> np.uint64(40)) | ((l3 & _mask(8)) << np.uint64(24))], axis=1)


def hash_or_noop_batch(leaves: np.ndarray) -> np.ndarray:
    """KeccakHasher.hash_or_noop of each row of (N, L) uint64 leaves, as
    its field elements, (N, 4)."""
    leaves = np.ascontiguousarray(leaves, dtype=np.uint64)
    n, length = leaves.shape
    if length * 8 <= HASH_SIZE:
        lanes = np.zeros((4, n), dtype=np.uint64)
        lanes[:length] = leaves.T
        return _lanes_to_elements(lanes)
    return _lanes_to_elements(_absorb_words(leaves))


def _place(lanes: np.ndarray, value: np.ndarray, bit: int, width: int):
    lane, shift = divmod(bit, 64)
    lanes[lane] |= value << np.uint64(shift)
    if shift + width > 64:
        lanes[lane + 1] |= value >> np.uint64(64 - shift)


_DIGEST_WIDTHS = (56, 56, 56, 32)       # bits of a digest's elements


def two_to_one_batch(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """KeccakHasher.two_to_one of N digest pairs, each given as its field
    elements, (N, 4) and (N, 4) -> (N, 4)."""
    pair = [np.asarray(left, dtype=np.uint64),
            np.asarray(right, dtype=np.uint64)]
    for d in pair:
        for j, width in enumerate(_DIGEST_WIDTHS):
            if (d[:, j] >> np.uint64(width)).any():
                raise ValueError("not the elements of a Keccak digest")
    n = pair[0].shape[0]
    lanes = np.zeros((25, n), dtype=np.uint64)
    bit = 0
    for d in pair:
        for j, width in enumerate(_DIGEST_WIDTHS):
            _place(lanes, d[:, j], bit, width)
            bit += width
    lanes[bit // 64] ^= np.uint64(0x01) << np.uint64(bit % 64)   # byte 50
    lanes[_RATE_WORDS - 1] ^= np.uint64(0x80 << 56)
    return _lanes_to_elements(keccak_f1600_lanes(lanes)[:4])
